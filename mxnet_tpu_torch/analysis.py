"""Runtime concurrency analysis: the lock-order recorder (MXNET_DEBUG_SYNC).

The port's own copy of the lock-order half of `mxnet_tpu/analysis.py`
(which imports no jax there either): a lock acquisition-order recorder
that turns the port's concurrency rules into machine-checked facts.

What it checks, when ``MXNET_DEBUG_SYNC=1``:

* **Lock-order inversions.** Every tracked lock acquisition while another
  tracked lock is held records a directed edge ``held -> acquired`` in a
  process-global order graph. An acquisition that closes a cycle (the
  classic ABBA: thread 1 takes A then B, thread 2 takes B then A) is
  reported with BOTH stacks: the stack that first established the
  opposite ordering and the stack that just inverted it.
* **Blocking hazards.** Holding any tracked lock while entering an
  operation that can block on other threads or hosts (a blocking
  collective, a drain) is a deadlock in waiting even when today's
  interleaving works. Call sites mark such regions with
  :func:`check_blocking`; a non-empty held set is reported with the
  held-acquisition stacks and the blocking-entry stack.

Reports surface three ways: ``analysis.*`` telemetry counters (recorded
unconditionally once the gate is on, as ``compile.*`` are), a health
journal event when the health layer is live, and the :func:`report` /
:func:`assert_clean` API that tests assert on.

Overhead: the gate is read when a lock is *created*: :func:`make_lock` /
:func:`make_rlock` / :func:`make_condition` return plain ``threading``
primitives when it is off, so steady-state code pays nothing per
acquire. :func:`check_blocking` call sites gate on ``analysis._enabled``
themselves.

The JAX module's second half (compiled-program summaries parsed from
XLA's HLO text: `program_summary`, `parse_collectives`,
`cache_inventory`) has no counterpart: a CUDA graph carries no program
text. The collective bytes that the port's `parallel.dist` calls count
(``dist.*_bytes``) stand in for its collective inventory.
"""
from __future__ import annotations

import sys
import threading

from . import telemetry
from .base import MXNetError, getenv, register_env

__all__ = ["enabled", "enable", "make_lock", "make_rlock", "make_condition",
           "check_blocking", "report", "clean", "assert_clean", "reset",
           "format_report"]

register_env("MXNET_DEBUG_SYNC", False,
             "record lock acquisition order + blocking hazards; zero cost "
             "when off (locks are plain threading primitives)")

# THE gate — read at lock creation time (and by check_blocking call
# sites). Flipping it at runtime via enable() affects locks created
# afterwards; the CI reruns set the env var so every lock in the process
# is tracked from import.
_enabled = bool(getenv("MXNET_DEBUG_SYNC"))

_STACK_LIMIT = 16

# recorder state — one process-global order graph. _state_lock is a plain
# lock and is never itself tracked; the per-thread `busy` flag keeps the
# recorder's own bookkeeping (telemetry increments, journal writes) from
# re-entering the recorder.
_state_lock = threading.Lock()
_edges = {}        # (a, b) -> {count, held_stack, acquire_stack}
_order = {}        # a -> set of b (a held when b acquired)
_inversions = []   # deduped by unordered lock pair
_inv_seen = set()
_hazards = []      # deduped by (kind, held-name tuple)
_haz_seen = set()
_locks_seen = set()

_tls = threading.local()


def enabled():
    return _enabled


def enable(on=True):
    """Flip the gate at runtime. Only locks created AFTER the flip are
    tracked (module-level locks made at import stay plain) — tests use
    this; production runs set ``MXNET_DEBUG_SYNC=1`` in the environment."""
    global _enabled
    _enabled = bool(on)


def _thread_state():
    st = getattr(_tls, "state", None)
    if st is None:
        st = _tls.state = {"held": [], "busy": False}
    return st


def _stack(skip=2):
    """Lightweight stack capture: (file:line func) strings via a raw frame
    walk — no source-line reads, cheap enough for every tracked acquire."""
    try:
        f = sys._getframe(skip)
    except ValueError:  # pragma: no cover — shallow stack
        return []
    out = []
    while f is not None and len(out) < _STACK_LIMIT:
        code = f.f_code
        out.append(f"{code.co_filename}:{f.f_lineno} {code.co_name}")
        f = f.f_back
    return out


def _reaches(src, dst):
    """True when ``dst`` is reachable from ``src`` in the order graph
    (iterative DFS; called under _state_lock)."""
    stack, seen = [src], set()
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_order.get(n, ()))
    return False


def _journal(event_kind, **detail):
    """Best-effort health-journal event (lazy import: health imports this
    module for its own locks)."""
    try:
        from . import health

        if health._enabled:
            health.event(event_kind, **detail)
    except Exception:  # noqa: BLE001 — the journal is additive
        pass


def _record_edge(a_name, a_stack, b_name, b_stack):
    """Called under the caller thread's busy guard; takes _state_lock."""
    if a_name == b_name:
        # two DISTINCT instances sharing a name (every Beacon is
        # "health.beacon", every prefix cache "generation.prefix_cache"):
        # order within a name class cannot be validated by name, and a
        # self-edge would instantly read as a bogus cycle — skip, the
        # same trade lockdep makes for same-class nesting
        return None
    key = (a_name, b_name)
    with _state_lock:
        rec = _edges.get(key)
        if rec is not None:
            rec["count"] += 1
            return None
        _edges[key] = {"count": 1, "held_stack": list(a_stack),
                       "acquire_stack": list(b_stack)}
        _order.setdefault(a_name, set()).add(b_name)
        telemetry.gauge("analysis.lock_edges").set(len(_edges))
        if not _reaches(b_name, a_name):
            return None
        # the new edge closes a cycle: the opposite ordering was already
        # observed. Report once per unordered pair, with both stacks —
        # the first-seen opposite edge's and this acquisition's.
        pair = frozenset((a_name, b_name))
        if pair in _inv_seen:
            return None
        _inv_seen.add(pair)
        rev = _edges.get((b_name, a_name))
        inv = {"first": b_name, "then": a_name,
               "held": a_name, "acquiring": b_name,
               "held_stack": list(a_stack),
               "acquire_stack": list(b_stack),
               "opposite_stack": (list(rev["acquire_stack"])
                                  if rev else []),
               "thread": threading.current_thread().name}
        _inversions.append(inv)
    telemetry.counter("analysis.lock_inversions").inc()
    return inv


def _note_acquire(lock):
    st = _thread_state()
    if st["busy"]:
        return
    st["busy"] = True
    try:
        held = st["held"]
        for entry in held:
            if entry[0] is lock:   # reentrant re-acquire: bump, no edge
                entry[2] += 1
                return
        stack = _stack(skip=3)
        inv = None
        if held:
            for other, other_stack, _n in held:
                got = _record_edge(other.name, other_stack, lock.name,
                                   stack)
                inv = inv or got
        else:
            with _state_lock:
                _locks_seen.add(lock.name)
        held.append([lock, stack, 1])
        if inv is not None:
            _journal("lock_inversion", held=inv["held"],
                     acquiring=inv["acquiring"], thread=inv["thread"])
    finally:
        st["busy"] = False


def _note_release(lock):
    st = _thread_state()
    if st["busy"]:
        return
    held = st["held"]
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is lock:
            held[i][2] -= 1
            if held[i][2] == 0:
                del held[i]
            return
    # release of a lock acquired before tracking began — ignore


class _TrackedLock:
    """``threading.Lock``/``RLock`` wrapper that feeds the order graph.
    Implements the Condition lock protocol (``_is_owned`` /
    ``_release_save`` / ``_acquire_restore``) so
    ``threading.Condition(_TrackedLock(...))`` keeps bookkeeping balanced
    across ``wait()``."""

    __slots__ = ("name", "_lock", "_reentrant")

    def __init__(self, name, reentrant=False):
        self.name = name
        self._reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()
        with _state_lock:
            _locks_seen.add(name)

    def acquire(self, blocking=True, timeout=-1):
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _note_acquire(self)
        return ok

    def release(self):
        _note_release(self)
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        inner = getattr(self._lock, "locked", None)
        if inner is not None:
            return inner()
        # threading.RLock grows locked() only in 3.13 — probe instead so
        # the tracked wrapper stays drop-in on 3.10 (an owned-by-us RLock
        # reports False, same blind spot the acquire-probe always had)
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    # -- Condition lock protocol -------------------------------------------

    def _is_owned(self):
        if self._reentrant:
            return self._lock._is_owned()
        # plain-Lock fallback (what Condition would do itself)
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def _release_save(self):
        if not self._reentrant:
            _note_release(self)
            self._lock.release()
            return None
        # fully drop a possibly-recursive hold; remember our bookkeeping
        # count so _acquire_restore can rebuild it
        st = _thread_state()
        count = 0
        for i in range(len(st["held"]) - 1, -1, -1):
            if st["held"][i][0] is self:
                count = st["held"][i][2]
                del st["held"][i]
                break
        return (self._lock._release_save(), count)

    def _acquire_restore(self, state):
        if not self._reentrant:
            self._lock.acquire()
            _note_acquire(self)
            return
        inner, count = state
        self._lock._acquire_restore(inner)
        _note_acquire(self)
        if count > 1:
            st = _thread_state()
            for entry in st["held"]:
                if entry[0] is self:
                    entry[2] = count
                    break

    def __repr__(self):
        return f"<TrackedLock {self.name!r} reentrant={self._reentrant}>"


# ---------------------------------------------------------------------------
# factories — THE api instrumented modules use
# ---------------------------------------------------------------------------


def make_lock(name):
    """A mutex for subsystem ``name`` ("generation.tick"): plain
    ``threading.Lock`` when the gate is off, tracked when on."""
    if _enabled:
        return _TrackedLock(name)
    return threading.Lock()


def make_rlock(name):
    """Reentrant variant; only the outermost acquire records an edge."""
    if _enabled:
        return _TrackedLock(name, reentrant=True)
    return threading.RLock()


def make_condition(name):
    """``threading.Condition`` whose underlying lock is tracked; ``wait``
    releases/re-acquires through the recorder so held-state stays exact."""
    if _enabled:
        return threading.Condition(_TrackedLock(name, reentrant=True))
    return threading.Condition()


def check_blocking(kind, exempt=()):
    """Record a blocking hazard if this thread holds any tracked lock
    while entering blocking region ``kind`` ("collective.barrier",
    "engine.drain"). ``exempt`` lists lock objects that are legitimately
    held around the region. Call sites gate on ``analysis._enabled`` first."""
    if not _enabled:
        return None
    st = _thread_state()
    if st["busy"]:
        return None
    held = [e for e in st["held"] if e[0] not in exempt]
    if not held:
        return None
    st["busy"] = True
    try:
        names = tuple(e[0].name for e in held)
        stack = _stack(skip=2)
        with _state_lock:
            key = (kind, names)
            if key in _haz_seen:
                for h in _hazards:
                    if h["kind"] == kind and tuple(h["held"]) == names:
                        h["count"] += 1
                        break
                return None
            _haz_seen.add(key)
            haz = {"kind": kind, "held": list(names), "count": 1,
                   "held_stacks": [list(e[1]) for e in held],
                   "blocking_stack": stack,
                   "thread": threading.current_thread().name}
            _hazards.append(haz)
        telemetry.counter("analysis.blocking_hazards").inc()
        _journal("lock_blocking_hazard", kind=kind, held=list(names))
        return haz
    finally:
        st["busy"] = False


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------


def report():
    """Snapshot: {enabled, locks, edges, inversions, hazards}. ``edges``
    is the observed acquisition-order list (a, b, count); ``inversions``
    and ``hazards`` carry both stacks each (see module docstring)."""
    with _state_lock:
        return {
            "enabled": _enabled,
            "locks": sorted(_locks_seen),
            "edges": sorted((a, b, rec["count"])
                            for (a, b), rec in _edges.items()),
            "inversions": [dict(i) for i in _inversions],
            "hazards": [dict(h) for h in _hazards],
        }


def clean():
    """True when no inversion or blocking hazard has been recorded."""
    with _state_lock:
        return not _inversions and not _hazards


def format_report(rep=None):
    """Human-readable rendering of :func:`report` (what
    :func:`assert_clean` raises with)."""
    rep = rep or report()
    lines = [f"lock-order analysis: {len(rep['locks'])} locks, "
             f"{len(rep['edges'])} order edges, "
             f"{len(rep['inversions'])} inversions, "
             f"{len(rep['hazards'])} blocking hazards"]
    for inv in rep["inversions"]:
        lines.append(f"\nINVERSION: held {inv['held']!r} while acquiring "
                     f"{inv['acquiring']!r} (thread {inv['thread']}), but "
                     f"the opposite order {inv['acquiring']!r} -> "
                     f"{inv['held']!r} was already established")
        lines.append("  stack holding %r:" % inv["held"])
        lines.extend("    " + s for s in inv["held_stack"][:8])
        lines.append("  stack acquiring %r:" % inv["acquiring"])
        lines.extend("    " + s for s in inv["acquire_stack"][:8])
        if inv["opposite_stack"]:
            lines.append("  stack that established the opposite order:")
            lines.extend("    " + s for s in inv["opposite_stack"][:8])
    for haz in rep["hazards"]:
        lines.append(f"\nBLOCKING HAZARD: {haz['held']} held entering "
                     f"{haz['kind']!r} (thread {haz['thread']}, "
                     f"seen {haz['count']}x)")
        lines.append("  blocking-entry stack:")
        lines.extend("    " + s for s in haz["blocking_stack"][:8])
        for name, st in zip(haz["held"], haz["held_stacks"]):
            lines.append(f"  stack holding {name!r}:")
            lines.extend("    " + s for s in st[:8])
    return "\n".join(lines)


def assert_clean():
    """Raise :class:`MXNetError` with the full report when any inversion
    or hazard was recorded (a concurrency test's closing check)."""
    if not clean():
        raise MXNetError("lock-order analysis found violations:\n"
                         + format_report())


def reset():
    """Clear the order graph and reports (tests; the per-thread held
    stacks are left alone — live locks stay balanced)."""
    with _state_lock:
        _edges.clear()
        _order.clear()
        _inversions.clear()
        _inv_seen.clear()
        _hazards.clear()
        _haz_seen.clear()
        _locks_seen.clear()
