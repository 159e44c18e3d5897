"""Span tracing: per-request and per-step causality across threads and queues.

The port's own copy of `mxnet_tpu/tracing.py` (which imports no jax).
Telemetry answers *how much*; this layer answers *which one and where*:
every serving request and every training step becomes a tree of spans
(admission wait, queue, pad, execute, reassembly for a request; fwdbwd,
update, sync, data for a step), stitched across the thread and queue
handoffs the runtime makes (the batcher's worker, caller-runs assist).

Concepts (OpenTelemetry-shaped, chrome-trace rendered):

* a **trace** is one causal unit (one request, one step) with a 16-hex
  ``trace_id``. Steps derive their ids DETERMINISTICALLY from ``(tag,
  epoch, step)`` (:func:`deterministic_trace_id`), so every worker of a
  distributed run labels the same step with the same id.
* a **span** is one timed stage inside a trace, with a ``parent_id``
  link. Spans propagate through a :mod:`contextvars` variable, so nested
  ``span()`` scopes parent automatically within a thread; crossing a
  thread or queue is explicit: :func:`inject` captures the current
  context into a plain dict carried with the work item, and
  :func:`attach` re-establishes it on the far side.
* **flow events** (:func:`flow_start` / :func:`flow_end`) draw the
  cross-thread arrow from the span that enqueued work to the one that ran
  it.

Spans are chrome-trace complete (``"X"``) events carrying
``trace_id``/``span_id``/``parent_id`` in ``args``, buffered here
(bounded, drops counted) and merged into ``profiler.dump()``.

Spans are host spans: one around a CUDA-graph replay measures the
enqueue, and a span inside a captured function runs once, at capture, and
never on a replay, so every call site sits in the host code around
``replay()``.

The **flight recorder** keeps the span tree of the worst (slowest)
training step since it was last read (``BaseModule.fit`` feeds it,
``Speedometer`` reads it, the HTTP endpoint serves it under ``/trace``);
``tick_recorder`` does the same for the generation engine's ticks.

Overhead: everything gates on the module-level ``_enabled`` flag
(``MXNET_TRACING=1`` or :func:`enable`); call sites read it before any
timestamp, so a disabled plane costs one attribute read a site.
"""
from __future__ import annotations

import contextlib
import contextvars
import hashlib
import os
import random
import threading
import time

from . import analysis
from .base import getenv, register_env

__all__ = ["Span", "span", "emit_span", "begin", "inject", "attach",
           "current", "flow_start", "flow_end", "new_flow_id",
           "deterministic_trace_id",
           "enabled", "enable", "disable", "take_events", "peek_events",
           "dropped_events", "reset", "FlightRecorder", "flight_recorder",
           "tick_recorder", "now_us"]

register_env("MXNET_TRACING", False,
             "enable span tracing (per-request / per-step span trees "
             "merged into profiler.dump())")
register_env("MXNET_TRACING_MAX_EVENTS", 1 << 19,
             "span event buffer cap; overflow counts into "
             "tracing.dropped_events()")

# memoized buffer cap — _push() runs under the global lock on every
# event, so it must not re-parse the environment there; keying the memo
# on the raw env string keeps runtime changes honored at the cost of one
# dict lookup per event. The sentinel first entry (False is never a raw
# env value) defers the first parse to first use — import stays
# side-effect-free
_max_memo = (False, 0)


def _max_events():
    global _max_memo
    raw = os.environ.get("MXNET_TRACING_MAX_EVENTS")
    if raw != _max_memo[0]:
        _max_memo = (raw, int(getenv("MXNET_TRACING_MAX_EVENTS")))
    return _max_memo[1]

# THE gate — call sites read `tracing._enabled` (one attribute fetch)
# before any other tracing work, including timestamps.
_enabled = bool(getenv("MXNET_TRACING"))

# context value: the innermost open Span, or a _RemoteCtx re-attached from
# an inject() carrier. Both expose .trace_id / .span_id; only a local open
# Span collects finished-child records (the flight-recorder tree).
_ctx = contextvars.ContextVar("mxnet_tpu_torch_trace", default=None)

_events = []
_dropped = 0
_unmirrored = 0  # drops not yet flushed into the telemetry counter
_lock = analysis.make_lock("tracing.events")
_rand = random.Random()


def now_us():
    """Wall-clock microseconds — the SAME timebase as profiler events, so
    spans and op dispatch line up on one chrome-trace timeline."""
    return time.time() * 1e6


def _new_id():
    return f"{_rand.getrandbits(64):016x}"


def deterministic_trace_id(*parts):
    """A trace id every worker of a dist run computes identically from the
    same logical coordinates (e.g. ``("fit", epoch, step)``): the key that
    joins per-worker dumps without any cross-process id exchange."""
    h = hashlib.md5(repr(parts).encode()).hexdigest()
    return h[:16]


def enabled():
    return _enabled


def enable(on=True):
    """Turn span tracing on (also: ``MXNET_TRACING=1`` at import)."""
    global _enabled
    _enabled = bool(on)


def disable():
    enable(False)


def reset():
    """Drop buffered events and the flight recorder (tests)."""
    global _dropped, _unmirrored
    with _lock:
        _events.clear()
        _dropped = 0
        _unmirrored = 0
    flight_recorder.reset()
    tick_recorder.reset()


def dropped_events():
    """Span events discarded because the buffer was full."""
    return _dropped


def _push(ev):
    global _dropped, _unmirrored
    with _lock:
        # once the buffer is full the drop path IS the steady state:
        # only count here, flush into the telemetry counter at capture
        # time (take_events) so no per-event registry-lock take
        if len(_events) >= _max_events():
            _dropped += 1
            _unmirrored += 1
            return
        _events.append(ev)


def take_events(reset=False):
    """Snapshot ``(events, dropped)``; ``reset`` drains in the same
    critical section (profiler._capture merges through this so a span is
    in exactly one dump). Flushes accumulated drops into the monotonic
    ``tracing.dropped_events`` telemetry counter."""
    global _dropped, _unmirrored
    with _lock:
        events = list(_events)
        dropped = _dropped
        mirror = _unmirrored
        _unmirrored = 0
        if reset:
            _events.clear()
            _dropped = 0
    if mirror:
        try:  # mirror into the metrics plane, like profiler drops
            from . import telemetry

            telemetry.counter("tracing.dropped_events").inc(mirror)
        except Exception:  # noqa: BLE001
            pass
    return events, dropped


def peek_events():
    return take_events(reset=False)[0]


class _RemoteCtx:
    """A context re-attached from an inject() carrier: parent linkage
    only, no local open Span to collect children into."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id):
        self.trace_id = trace_id
        self.span_id = span_id


class Span:
    """One timed stage. Use the :func:`span` context manager for the
    common in-thread case; :func:`begin` + :meth:`finish` for spans whose
    start and end live on different threads (a serving request's root)."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "t0", "args", "children", "_token", "record",
                 "pid", "tid")

    def __init__(self, name, cat="host", trace_id=None, parent=None,
                 args=None):
        self.name = name
        self.cat = cat
        # lane identity is where the span BEGAN: a cross-thread root
        # (begun on the submitting client thread, finished by the batcher
        # worker) must render on the client's lane — stamping the finisher
        # would pile every concurrent request root onto the worker's lane
        # as overlapping, non-nestable slices
        self.pid = os.getpid()
        self.tid = threading.get_ident()
        if parent is None:
            parent = _ctx.get()
            # an explicit trace_id that DIFFERS from the ambient context's
            # starts a new trace (a deterministic step id under a
            # user-opened outer span): keep no parent link, or the merge
            # audit would flag every such span as a cross-trace orphan.
            # An explicitly-passed parent is kept as given.
            if (parent is not None and trace_id
                    and parent.trace_id != trace_id):
                parent = None
        self.parent_id = parent.span_id if parent is not None else None
        self.trace_id = (trace_id or
                         (parent.trace_id if parent is not None else None)
                         or _new_id())
        self.span_id = _new_id()
        self.t0 = now_us()
        self.args = dict(args) if args else {}
        self.children = []   # finished child records (flight-recorder tree)
        self._token = None
        self.record = None   # set by finish()

    # -- context-manager use (same-thread begin/end) -------------------------

    def __enter__(self):
        self._token = _ctx.set(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _ctx.reset(self._token)
            self._token = None
        if exc is not None:
            self.args.setdefault("error", repr(exc))
        self.finish()
        return False

    # -- explicit lifecycle (cross-thread spans) -----------------------------

    def set(self, **kwargs):
        """Attach extra args to the span (rendered in the trace viewer)."""
        self.args.update(kwargs)
        return self

    def child(self, name, cat=None, args=None):
        """An explicitly-parented child (for cross-thread trees where the
        contextvar does not carry this span)."""
        return Span(name, cat or self.cat, parent=self, args=args)

    def finish(self, ts=None, dur=None):
        """Emit the chrome-trace complete event (idempotent). ``ts``/
        ``dur`` (us) override the measured window — used for spans
        reconstructed after the fact from recorded timestamps."""
        if self.record is not None:
            return self.record
        t0 = self.t0 if ts is None else ts
        d = (now_us() - t0) if dur is None else dur
        args = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id is not None:
            args["parent_id"] = self.parent_id
        args.update(self.args)
        self.record = {"name": self.name, "ph": "X", "cat": self.cat,
                       "pid": self.pid, "tid": self.tid,
                       "ts": t0, "dur": d, "args": args}
        if self.children:
            # the flight-recorder tree rides on the record, NOT into the
            # chrome event (viewers reconstruct nesting from ts/dur)
            self.record = dict(self.record, children=self.children)
        _push({k: v for k, v in self.record.items() if k != "children"})
        parent = _ctx.get()
        if isinstance(parent, Span) and parent.span_id == self.parent_id:
            parent.children.append(self.tree())
        return self.record

    def tree(self):
        """The finished span as a nested dict (children included) — the
        flight-recorder / HTTP representation."""
        rec = self.record or {}
        out = {"name": self.name, "cat": self.cat, "ts": rec.get("ts"),
               "dur": rec.get("dur"), "trace_id": self.trace_id,
               "span_id": self.span_id, "parent_id": self.parent_id,
               "args": dict(self.args)}
        if self.children:
            out["children"] = list(self.children)
        return out

    def adopt(self, child_tree):
        """Graft an externally-built child record onto this (still open)
        span's tree (cross-thread children that finished elsewhere)."""
        self.children.append(child_tree)


class _NullSpan:
    """The disabled path: one shared, stateless object — entering it,
    setting args on it and finishing it are all no-ops."""

    __slots__ = ()
    trace_id = None
    span_id = None
    children = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def set(self, **kwargs):
        return self

    def child(self, name, cat=None, args=None):
        return self

    def finish(self, ts=None, dur=None):
        return None

    def tree(self):
        return None

    def adopt(self, child_tree):
        pass


_NULL = _NullSpan()


def span(name, cat="host", trace_id=None, **args):
    """Context manager for one in-thread span, parented to the current
    context. Returns a shared no-op when tracing is off."""
    if not _enabled:
        return _NULL
    return Span(name, cat, trace_id=trace_id, args=args)


def begin(name, cat="host", trace_id=None, parent=None, **args):
    """Start a span WITHOUT entering the context var — for spans finished
    on another thread (:meth:`Span.finish`). No-op span when off."""
    if not _enabled:
        return _NULL
    return Span(name, cat, trace_id=trace_id, parent=parent, args=args)


def emit_span(name, t0_us, dur_us, cat="host", parent=None, trace_id=None,
              **args):
    """Emit a complete span after the fact from recorded timestamps —
    the spelling for hot loops that mark boundaries cheaply and
    reconstruct the tree once per step. Returns the span's tree record."""
    if not _enabled:
        return None
    sp = Span(name, cat, trace_id=trace_id, parent=parent, args=args)
    sp.t0 = t0_us
    return sp.finish(ts=t0_us, dur=dur_us)


def current():
    """The innermost open span (or re-attached remote context), or None."""
    return _ctx.get()


def inject():
    """Capture the current context as a plain dict to carry across a
    thread/queue boundary (None when off or no context)."""
    if not _enabled:
        return None
    cur = _ctx.get()
    if cur is None:
        return None
    return {"trace_id": cur.trace_id, "span_id": cur.span_id}


@contextlib.contextmanager
def attach(carrier):
    """Re-establish an injected context on the receiving thread: spans
    opened inside parent to the carrier's span. ``None`` carriers (tracing
    off at inject time) attach nothing."""
    if carrier is None or not _enabled:
        yield None
        return
    if isinstance(carrier, (Span, _RemoteCtx)):
        ctx = carrier
    else:
        ctx = _RemoteCtx(carrier["trace_id"], carrier["span_id"])
    token = _ctx.set(ctx)
    try:
        yield ctx
    finally:
        _ctx.reset(token)


def new_flow_id():
    """A fresh id for one flow arrow (the same id must be passed to both
    :func:`flow_start` and :func:`flow_end`)."""
    return _new_id()


def flow_start(flow_id, name="flow", cat="flow"):
    """Chrome-trace flow-start (``"s"``): the enqueue side of a
    cross-thread arrow. Must be emitted from within a duration event's
    window on this thread (i.e. inside an open span)."""
    if not _enabled:
        return
    _push({"name": name, "ph": "s", "cat": cat, "id": flow_id,
           "pid": os.getpid(), "tid": threading.get_ident(),
           "ts": now_us()})


def flow_end(flow_id, name="flow", cat="flow"):
    """Chrome-trace flow-end (``"f"``, binding point enclosing slice):
    the execute side of the arrow."""
    if not _enabled:
        return
    _push({"name": name, "ph": "f", "cat": cat, "id": flow_id, "bp": "e",
           "pid": os.getpid(), "tid": threading.get_ident(),
           "ts": now_us()})


class FlightRecorder:
    """Keeps the worst (longest-duration) span tree observed since the
    last read — the slow-step black box. ``BaseModule.fit`` observes every
    step's root span; ``Speedometer`` reads (and resets) per log
    interval; :func:`worst` without reset is the on-demand dump (HTTP
    ``/trace`` serves it)."""

    def __init__(self):
        self._lock = analysis.make_lock("tracing.flight")
        self._worst = None
        self._count = 0

    def observe(self, tree):
        """Consider one finished span tree (dict with ``dur``)."""
        if tree is None or tree.get("dur") is None:
            return
        with self._lock:
            self._count += 1
            if self._worst is None or tree["dur"] > self._worst["dur"]:
                self._worst = tree

    def worst(self, reset=False):
        """The worst span tree since the last reset (None if none seen);
        ``reset=True`` also restarts the observation window (the
        Speedometer per-log-interval contract)."""
        with self._lock:
            out = self._worst
            if reset:
                self._worst = None
                self._count = 0
        return out

    @property
    def observed(self):
        return self._count

    def reset(self):
        self.worst(reset=True)


flight_recorder = FlightRecorder()

# the generation-plane analog of the slow-step recorder: the worst
# scheduler DECODE TICK's span tree since last read (`GenerationEngine`
# feeds it per tick; the HTTP /trace endpoint serves it as `worst_tick`
# beside `worst_step`, and watchdog diagnostic bundles capture it) —
# the "what did the slow tick actually do" black box for serving
tick_recorder = FlightRecorder()
