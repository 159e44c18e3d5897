"""Fleet health: SLOs, liveness/readiness, a stall watchdog, an event journal.

The port's own copy of `mxnet_tpu/health.py` (which imports no jax): the
layer that *acts* on the telemetry and tracing signals.

* **SLO tracker** (:class:`SloTracker`): declarative objectives over the
  telemetry registry (``serving.generation.ttft_us:p99<500ms``,
  ``compile.cache_misses:rate<=0``, ``step.total_us:p99<8*p50``), parsed
  from ``MXNET_SLO_SPEC``, evaluated on rolling windows with a
  multi-window error-budget burn rate (a short window for fast detection,
  a long one for budget exhaustion). Published as ``slo.*`` gauges and
  served at ``/slo``; readiness consults the budget.
* **liveness / readiness registries**: per-object probes
  (:func:`register_liveness` / :func:`register_readiness`, weakly held)
  aggregated by :func:`liveness` / :func:`readiness` and served at
  ``/healthz`` / ``/readyz``. The serving layer registers every
  Predictor, DynamicBatcher and GenerationEngine; the
  ``GenerationRouter`` drains unready replicas and re-admits them.
* **stall watchdog**: :class:`Beacon` progress markers on the paths that
  must make progress (the generation scheduler's tick, ``fit``'s step).
  A beacon that is *armed* (work pending) but silent for longer than
  ``max(MXNET_HEALTH_STALL_FACTOR x rolling-median gap,
  MXNET_HEALTH_STALL_FLOOR_S)`` fires a one-shot diagnostic capture
  (:func:`capture_diagnostics`): all-thread stacks, the flight recorders'
  worst step and tick span trees, a telemetry snapshot, the compile-cache
  ledger and the journal's tail, written atomically under
  ``MXNET_HEALTH_DIR`` and counted in ``health.stalls``. Progress after a
  stall re-arms the capture.
* **event journal**: a bounded ring of structured runtime events
  (rejections, evictions, drains, swaps, watchdog firings), served at
  ``/events`` and merged into ``profiler.dump()`` as instant events.
* **autoscale signal**: the ``health.desired_engines`` gauge derived from
  fleet slot fill, queue depth and SLO burn (:func:`autoscale_signal`),
  with :func:`on_autoscale` callbacks for an external controller.

Overhead: everything gates on the module-level ``_enabled`` flag
(``MXNET_HEALTH=1`` or :func:`enable`). Call sites read one attribute
when it is off, and no monitor thread exists. The watchdog and SLO
threads stop on :func:`disable` and :func:`reset` (which starts them
again while the layer is on).
"""
from __future__ import annotations

import collections
import json
import os
import re
import sys
import tempfile
import threading
import time
import traceback
import weakref

from . import analysis
from . import telemetry
from .base import getenv, register_env
from .log import get_logger

__all__ = ["enabled", "enable", "disable", "reset", "unregister",
           "event", "events", "trace_instant_events",
           "Beacon", "beacon", "beacons", "check_beacons",
           "capture_diagnostics", "last_bundle",
           "Objective", "SloTracker", "tracker", "slo_report", "budget_ok",
           "register_liveness", "register_readiness",
           "liveness", "readiness",
           "register_fleet", "on_autoscale", "autoscale_signal"]

register_env("MXNET_HEALTH", False,
             "enable the fleet-health layer: SLO tracker, liveness/"
             "readiness probes, stall watchdog + diagnostic capture, "
             "event journal, autoscale signal")
register_env("MXNET_HEALTH_DIR", "",
             "directory for watchdog diagnostic bundles (all-thread "
             "stacks + worst-step/tick trees + telemetry snapshot, "
             "written atomically); empty = <tmpdir>/mxnet_tpu_torch_health")
register_env("MXNET_HEALTH_EVENTS", 512,
             "event-journal ring capacity (oldest events drop off)")
register_env("MXNET_HEALTH_WATCHDOG_S", 0.5,
             "stall-watchdog poll interval in seconds")
register_env("MXNET_HEALTH_STALL_FACTOR", 8.0,
             "a beacon armed but silent for longer than this multiple of "
             "its rolling-median progress gap is a stall")
register_env("MXNET_HEALTH_STALL_FLOOR_S", 5.0,
             "minimum silence before any beacon counts as stalled — "
             "sized to absorb a cold first use (a capture or a kernel "
             "build takes seconds), which is a pause, not a stall")
register_env("MXNET_HEALTH_QUEUE_WATERMARK", 0.8,
             "readiness watermark: a serving/generation intake queue "
             "above this fraction of MXNET_SERVING_MAX_QUEUE reports "
             "not-ready (the router stops placing there)")
register_env("MXNET_SLO_SPEC", "",
             "semicolon-separated SLO objectives over telemetry metrics, "
             "each `metric:stat op value[unit]` (stat p50/p95/p99/avg/"
             "min/max/count/rate/value; unit us/ms/s; value may be "
             "`K*p50` for a same-histogram multiple). Empty = the "
             "built-in serving/compile/step defaults")
register_env("MXNET_SLO_WINDOWS", "60,600",
             "short,long burn-rate windows in seconds (SRE multi-window "
             "pattern: short detects fast burn, long tracks budget "
             "exhaustion)")
register_env("MXNET_SLO_BUDGET", 0.01,
             "error budget: allowed fraction of violating evaluations "
             "per window (burn rate = violating fraction / this)")
register_env("MXNET_SLO_GRACE_S", 60.0,
             "rate-kind objectives (e.g. compile.cache_misses:rate<=0) "
             "pass vacuously for this long after tracker start — warmup "
             "compiles are not an SLO breach")
register_env("MXNET_SLO_INTERVAL_S", 5.0,
             "background SLO-evaluation cadence once health is enabled "
             "(0 = evaluate only on demand: /slo scrapes and tests)")
register_env("MXNET_HEALTH_TARGET_FILL", 0.75,
             "autoscale target: desired engine count sizes the fleet so "
             "demand / (slots * engines) approaches this fill ratio")

# THE gate — call sites read `health._enabled` (one attribute fetch)
# before any other health work, including timestamps.
_enabled = bool(getenv("MXNET_HEALTH"))

_lock = analysis.make_lock("health.registry")


def _logger():
    return get_logger("mxnet_tpu_torch.health")


def enabled():
    return _enabled


def enable(on=True):
    """Turn the health layer on (also: ``MXNET_HEALTH=1`` at import).
    Enabling starts the watchdog (and, when ``MXNET_SLO_INTERVAL_S`` > 0,
    the SLO evaluation) thread; disabling parks them."""
    global _enabled
    _enabled = bool(on)
    if _enabled:
        _start_threads()
    else:
        _stop_threads()


def disable():
    enable(False)


def reset():
    """Drop journal, beacons, probes, tracker and autoscale state
    (tests). The enabled flag is kept; the monitor threads stop, and start
    again at once while the layer is on."""
    global _tracker, _last_bundle, _bundle_seq
    _stop_threads()
    if _enabled:
        _start_threads()
    with _lock:
        _journal.clear()
        _beacons.clear()
        _liveness.clear()
        _readiness.clear()
        _fleets.clear()
        _autoscale_cbs.clear()
        _tracker = None
        _last_bundle = None
        _bundle_seq = 0
        _autoscale_state["desired"] = None


# ---------------------------------------------------------------------------
# Event journal
# ---------------------------------------------------------------------------

_journal = collections.deque(maxlen=int(getenv("MXNET_HEALTH_EVENTS")))


def event(kind, **detail):
    """Append one structured event to the bounded journal (no-op when the
    health layer is off — call sites gate on ``health._enabled`` first so
    the disabled cost is one attribute read)."""
    if not _enabled:
        return None
    ev = {"ts": time.time(), "kind": str(kind)}
    ev.update(detail)
    with _lock:
        _journal.append(ev)
    telemetry.counter("health.events").inc()
    return ev


def events(n=None, kind=None):
    """The journal, oldest first (``n`` caps to the newest n; ``kind``
    filters)."""
    with _lock:
        out = list(_journal)
    if kind is not None:
        out = [e for e in out if e["kind"] == kind]
    if n is not None:
        out = out[-int(n):]
    return out


def trace_instant_events():
    """The journal as chrome-trace instant (``"i"``) events, for merging
    into ``profiler.dump()`` — runtime events (evictions, drains,
    watchdog firings) land on the same timeline as spans and counters."""
    pid = os.getpid()
    out = []
    for ev in events():
        args = {k: v for k, v in ev.items() if k not in ("ts", "kind")}
        out.append({"name": f"health/{ev['kind']}", "ph": "i", "s": "p",
                    "cat": "health", "pid": pid, "tid": 0,
                    "ts": ev["ts"] * 1e6, "args": args})
    return out


# ---------------------------------------------------------------------------
# Progress beacons + the stall watchdog
# ---------------------------------------------------------------------------

_beacons = {}


class Beacon:
    """One progress marker the watchdog monitors.

    A beacon is **armed** while its owner has pending work (a submitted
    generation session, a training loop between steps, a captured lazy
    segment) and **touched** whenever progress happens (a scheduler tick,
    a completed step, a flush). Armed + silent past
    ``max(factor × rolling-median gap, floor)`` = stalled; progress after
    a stall is a recovery. Idle owners (nothing pending) are never
    stalls."""

    __slots__ = ("name", "_owner", "_lock", "last", "active", "stalled",
                 "gaps", "touches", "stall_count")

    WINDOW = 64  # rolling gap samples for the median

    def __init__(self, name, owner=None):
        self.name = name
        self._owner = weakref.ref(owner) if owner is not None else None
        self._lock = analysis.make_lock("health.beacon")
        self.last = None          # monotonic of the last progress
        self.active = False       # work pending (silence counts as stall)
        self.stalled = False      # set by the watchdog, cleared by touch()
        self.gaps = collections.deque(maxlen=self.WINDOW)
        self.touches = 0
        self.stall_count = 0

    @property
    def owner(self):
        return self._owner() if self._owner is not None else None

    def arm(self):
        """Mark work pending. An idle->armed transition RESTARTS the
        silence clock — the stale last-progress stamp of a beacon that
        idled an hour ago must not count as an hour of stall silence the
        moment new work arrives."""
        with self._lock:
            if not self.active:
                self.active = True
                self.last = time.monotonic()

    def touch(self):
        """Record progress. Returns True when this touch RECOVERED a
        stalled beacon (the caller may want to log/flip readiness)."""
        now = time.monotonic()
        with self._lock:
            if self.active and self.last is not None:
                self.gaps.append(now - self.last)
            self.last = now
            self.touches += 1
            recovered = self.stalled
            self.stalled = False
        if recovered:
            event("watchdog_recovered", beacon=self.name)
            telemetry.counter("health.recoveries").inc()
            _logger().warning("beacon %r recovered after stall", self.name)
        return recovered

    def idle(self):
        """No work pending: silence is not a stall anymore."""
        with self._lock:
            self.active = False
            self.stalled = False

    def median_gap(self):
        with self._lock:
            gaps = sorted(self.gaps)
        if not gaps:
            return None
        return gaps[len(gaps) // 2]

    def silence(self, now=None):
        """Seconds since the last progress (None when never touched)."""
        if self.last is None:
            return None
        return (time.monotonic() if now is None else now) - self.last

    def overdue(self, now, factor, floor):
        """Armed and silent past the stall threshold?"""
        with self._lock:
            if not self.active or self.last is None:
                return False
            silence = now - self.last
        med = self.median_gap()
        threshold = max(factor * med if med else 0.0, floor)
        return silence > threshold

    def snapshot(self):
        return {"name": self.name, "active": self.active,
                "stalled": self.stalled, "touches": self.touches,
                "silence_s": self.silence(),
                "median_gap_s": self.median_gap(),
                "stalls": self.stall_count}


def beacon(name, owner=None):
    """Get-or-create the beacon named ``name``. Creation is cheap (a tiny
    object in a dict) so owners may create beacons unconditionally at
    construction; only ``arm``/``touch`` calls are gated on
    ``health._enabled`` at the call site."""
    with _lock:
        b = _beacons.get(name)
        if b is None:
            if len(_beacons) > 256:
                # opportunistic bound: with the watchdog off (health
                # disabled) nothing else prunes dead-owner beacons, and
                # per-engine names are unique
                for k in [k for k, v in _beacons.items()
                          if v._owner is not None and v.owner is None]:
                    del _beacons[k]
            b = _beacons[name] = Beacon(name, owner)
        elif owner is not None:
            # re-bind: names can legitimately recur (lazy beacons are
            # keyed by thread id, which CPython recycles) — the latest
            # owner wins, or a dead-owner prune would silently drop a
            # beacon a LIVE owner still arms and touches
            b._owner = weakref.ref(owner)
        return b


def beacons():
    with _lock:
        return dict(_beacons)


def check_beacons(now=None):
    """One watchdog sweep: fire a diagnostic capture for every beacon
    that just became overdue (dead owners are unregistered instead).
    Returns the list of beacons that stalled THIS sweep — the monitor
    thread calls this every ``MXNET_HEALTH_WATCHDOG_S``; tests call it
    directly for determinism."""
    if not _enabled:
        return []
    now = time.monotonic() if now is None else now
    factor = float(getenv("MXNET_HEALTH_STALL_FACTOR"))
    floor = float(getenv("MXNET_HEALTH_STALL_FLOOR_S"))
    fired = []
    with _lock:
        items = list(_beacons.items())
    for name, b in items:
        if b._owner is not None and b.owner is None:
            with _lock:
                if _beacons.get(name) is b:
                    del _beacons[name]
            continue
        if b.stalled or not b.overdue(now, factor, floor):
            continue
        b.stalled = True
        b.stall_count += 1
        fired.append(b)
        telemetry.counter("health.stalls").inc()
        _logger().error(
            "beacon %r stalled: %.2fs silent (median gap %s, factor %.1f, "
            "floor %.1fs) — capturing diagnostics", name,
            b.silence(now) or 0.0, b.median_gap(), factor, floor)
        try:
            path = capture_diagnostics(f"stall:{name}", beacon=b)
        except Exception as e:  # noqa: BLE001 — the watchdog must survive
            path = None
            _logger().error("diagnostic capture failed: %r", e)
        event("watchdog_stall", beacon=name, bundle=path,
              silence_s=b.silence(now))
    return fired


# ---------------------------------------------------------------------------
# Diagnostic capture
# ---------------------------------------------------------------------------

_last_bundle = None
_bundle_seq = 0


def last_bundle():
    """Path of the most recent diagnostic bundle (None if none yet)."""
    return _last_bundle


def _health_dir():
    d = str(getenv("MXNET_HEALTH_DIR") or "")
    if not d:
        d = os.path.join(tempfile.gettempdir(), "mxnet_tpu_torch_health")
    return d


def _thread_stacks():
    """{thread name/id: [frame lines]} for every live thread — the
    in-process rendering of a faulthandler dump, structured for the
    bundle JSON."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        label = f"{names.get(tid, '?')} (tid={tid})"
        out[label] = [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)]
    return out


def capture_diagnostics(reason, beacon=None, extra=None):
    """One diagnostic bundle, written atomically to ``MXNET_HEALTH_DIR``:

    * all-thread stacks (``sys._current_frames``; a ``faulthandler``
      text dump rides next to the JSON as ``<bundle>.stacks.txt`` for
      the cases where JSON assembly itself would be the casualty),
    * the flight recorders' worst-step and worst-decode-tick span trees,
    * a full telemetry snapshot,
    * the compile-cache per-name ledger (``compile_cache.name_totals``),
    * the event-journal tail.

    Returns the bundle path. Counted in ``health.captures``."""
    global _last_bundle, _bundle_seq
    with _lock:
        _bundle_seq += 1
        seq = _bundle_seq
    doc = {"ts": time.time(), "pid": os.getpid(), "reason": str(reason),
           "threads": _thread_stacks()}
    if beacon is not None:
        doc["beacon"] = beacon.snapshot()
    try:
        from . import tracing

        doc["worst_step"] = tracing.flight_recorder.worst()
        doc["worst_tick"] = tracing.tick_recorder.worst()
    except Exception:  # noqa: BLE001 — every section is best-effort
        pass
    try:
        doc["telemetry"] = telemetry.snapshot()
    except Exception:  # noqa: BLE001
        pass
    try:
        from . import compile_cache

        doc["compile_caches"] = compile_cache.name_totals()
    except Exception:  # noqa: BLE001
        pass
    doc["events"] = events(n=64)
    if extra:
        doc["extra"] = extra

    d = _health_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"stall-{os.getpid()}-{seq}.json")
    tmp = path + ".tmp~"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, default=repr)
        f.flush()
        os.fsync(f.fileno())
    try:
        from .resilience import durable_replace

        durable_replace(tmp, path)
    except Exception:  # noqa: BLE001 — plain rename is still atomic
        os.replace(tmp, path)
    try:
        import faulthandler

        with open(path + ".stacks.txt", "w") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
    except Exception:  # noqa: BLE001
        pass
    telemetry.counter("health.captures").inc()
    _last_bundle = path
    _logger().error("diagnostic bundle written: %s (%s)", path, reason)
    return path


# ---------------------------------------------------------------------------
# SLO tracker
# ---------------------------------------------------------------------------

_DEFAULT_SPEC = ("serving.generation.ttft_us:p99<500ms;"
                 "serving.e2e_us:p99<250ms;"
                 "compile.cache_misses:rate<=0;"
                 "step.total_us:p99<8*p50;"
                 # MFU collapse: achieved step FLOP/s under 0.1% of the
                 # MEASURED matmul peak (observatory.summary publishes
                 # step.mfu) means the step path stopped doing real work
                 # per wall second — a bug, not a ceiling, on any backend
                 "step.mfu:value>=0.001;"
                 # projected peak-HBM headroom went negative: resident
                 # census + the worst warmed executable's temp working
                 # set exceed device capacity (memory.census) — the next
                 # dispatch of that program OOMs even though today's
                 # resident bytes still fit
                 "memory.headroom_bytes:value>=0")

_OBJ_RE = re.compile(
    r"^(p\d{1,2}|avg|min|max|count|rate|value)\s*"
    r"(<=|>=|==|!=|<|>)\s*(.+)$")
_VAL_RE = re.compile(r"^([0-9]*\.?[0-9]+)\s*(us|ms|s)?$")
_REL_RE = re.compile(r"^([0-9]*\.?[0-9]+)\s*\*\s*(p\d{1,2}|avg)$")

_UNIT_US = {"us": 1.0, "ms": 1e3, "s": 1e6}

_OPS = {"<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
        ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
        "==": lambda a, b: a == b, "!=": lambda a, b: a != b}


class Objective:
    """One parsed SLO objective: ``metric:stat op value[unit]``.

    ``stat`` selects how the metric is read — a histogram quantile/field
    (``p99``/``avg``/``min``/``max``/``count``), a counter ``rate``
    (delta per second between evaluations) or the raw gauge/counter
    ``value``. The threshold may reference the SAME histogram
    (``8*p50``) for relative objectives like "no step slower than 8× the
    rolling median"."""

    def __init__(self, spec):
        self.spec = spec.strip()
        try:
            metric, rest = self.spec.split(":", 1)
        except ValueError:
            raise ValueError(
                f"SLO objective {spec!r}: expected 'metric:stat op value'")
        m = _OBJ_RE.match(rest.strip())
        if not m:
            raise ValueError(
                f"SLO objective {spec!r}: bad stat/comparison {rest!r} "
                "(stat one of pNN/avg/min/max/count/rate/value)")
        self.metric = metric.strip()
        self.stat, self.op = m.group(1), m.group(2)
        val = m.group(3).strip()
        rel = _REL_RE.match(val)
        if rel:
            self.threshold = float(rel.group(1))
            self.rel_stat = rel.group(2)
        else:
            v = _VAL_RE.match(val)
            if not v:
                raise ValueError(
                    f"SLO objective {spec!r}: bad threshold {val!r}")
            self.threshold = float(v.group(1)) * _UNIT_US.get(v.group(2), 1.0)
            self.rel_stat = None
        # labeled metric names (QoS per-tenant rows like
        # ``qos.ttft_us|tenant=acme``) carry ``|``/``=`` — sanitized here
        # so the key stays a clean telemetry-name segment
        # (``slo.<key>.burn_short`` gauges, report rows)
        self.key = (f"{self.metric}_{self.stat}".replace("*", "x")
                    .replace("|", ".").replace("=", "_"))

    def _hist_field(self, h, stat):
        if stat.startswith("p"):
            q = {"p50": "p50", "p95": "p95", "p99": "p99"}.get(stat)
            if q is not None:
                return h.get(q)
            # off-grid quantile: fall back to the nearest snapshot field
            qn = int(stat[1:])
            return h.get("p50" if qn <= 72 else "p95" if qn <= 97
                         else "p99")
        return h.get(stat)

    def evaluate(self, snap, rates):
        """(value, ok, threshold) against one telemetry snapshot.
        ``ok`` is True vacuously when the metric has no data yet — an
        objective over traffic that never happened is not a breach."""
        value = None
        threshold = self.threshold
        if self.stat == "rate":
            value = rates.get(self.metric)
        elif self.stat == "value":
            value = snap["gauges"].get(self.metric)
            if value is None:
                value = snap["counters"].get(self.metric)
        else:
            h = snap["histograms"].get(self.metric)
            if h and h.get("count"):
                value = self._hist_field(h, self.stat)
                if self.rel_stat is not None:
                    ref = self._hist_field(h, self.rel_stat)
                    threshold = (self.threshold * ref
                                 if ref is not None else None)
        if value is None or threshold is None:
            return None, True, threshold
        return value, _OPS[self.op](value, threshold), threshold


def parse_spec(spec=None):
    """``MXNET_SLO_SPEC`` (or the built-in defaults) as a list of
    :class:`Objective`."""
    spec = getenv("MXNET_SLO_SPEC") if spec is None else spec
    spec = (spec or "").strip() or _DEFAULT_SPEC
    return [Objective(tok) for tok in spec.split(";") if tok.strip()]


class SloTracker:
    """Rolling evaluation of a set of objectives with multi-window
    error-budget burn rates.

    Every :meth:`evaluate` records one (ts, ok) sample per objective;
    the burn rate over a window is ``violating fraction / budget`` — a
    burn of 1.0 consumes exactly the budget, >1 is on track to exhaust
    it, and the LONG window at >= 1 means the budget is spent
    (:attr:`exhausted`, which readiness consults). Gauges published per
    objective: ``slo.<key>.ok`` / ``.burn_short`` / ``.burn_long``,
    plus the overall ``slo.healthy``."""

    def __init__(self, objectives=None, windows=None, budget=None,
                 grace_s=None):
        self.objectives = (parse_spec() if objectives is None
                           else list(objectives))
        if windows is None:
            toks = str(getenv("MXNET_SLO_WINDOWS")).split(",")
            windows = tuple(float(t) for t in toks if t.strip())[:2]
        if len(windows) != 2 or windows[0] <= 0 or windows[1] < windows[0]:
            raise ValueError(f"need short,long SLO windows, got {windows}")
        self.windows = tuple(windows)
        self.budget = float(getenv("MXNET_SLO_BUDGET")
                            if budget is None else budget)
        self.grace_s = float(getenv("MXNET_SLO_GRACE_S")
                             if grace_s is None else grace_s)
        self.started_at = time.monotonic()
        self._samples = {o.key: collections.deque()
                         for o in self.objectives}
        self._last_counters = {}
        self._last_ts = None
        self._lock = analysis.make_lock("health.slo")
        self.evaluations = 0
        self.exhausted = False

    def _rates(self, snap, now):
        """Per-counter delta/dt since the previous evaluation (first
        evaluation yields no rates)."""
        rates = {}
        counters = snap["counters"]
        if self._last_ts is not None:
            dt = max(now - self._last_ts, 1e-9)
            for name, v in counters.items():
                # a counter ABSENT from the previous snapshot was 0 then
                # (counters are monotonic from 0) — skipping it instead
                # would hide exactly the increment that created it, i.e.
                # the first stall/miss ever, the one that matters most
                rates[name] = (v - self._last_counters.get(name, 0)) / dt
        self._last_counters = dict(counters)
        self._last_ts = now
        return rates

    def _burn(self, samples, now, window):
        """(burn, n) over one window; burn None when no samples."""
        lo = now - window
        total = bad = 0
        for ts, ok in samples:
            if ts >= lo:
                total += 1
                bad += 0 if ok else 1
        if not total:
            return None, 0
        return (bad / total) / max(self.budget, 1e-9), total

    def evaluate(self, snap=None, now=None):
        """One evaluation pass: read the registry, score every objective,
        roll the windows, publish the ``slo.*`` gauges. Returns the
        report dict (also what ``/slo`` serves)."""
        now = time.monotonic() if now is None else now
        snap = telemetry.snapshot() if snap is None else snap
        with self._lock:
            rates = self._rates(snap, now)
            in_grace = (now - self.started_at) < self.grace_s
            self.evaluations += 1
            report = {"budget": self.budget,
                      "windows_s": list(self.windows),
                      "evaluations": self.evaluations,
                      "in_grace": in_grace,
                      "objectives": []}
            healthy = True
            exhausted = False
            for o in self.objectives:
                value, ok, threshold = o.evaluate(snap, rates)
                if o.stat == "rate" and in_grace:
                    # warmup compiles (and their ilk) are not a breach
                    ok = True
                samples = self._samples[o.key]
                samples.append((now, ok))
                lo = now - self.windows[1]
                while samples and samples[0][0] < lo:
                    samples.popleft()
                burn_s, n_s = self._burn(samples, now, self.windows[0])
                burn_l, n_l = self._burn(samples, now, self.windows[1])
                healthy = healthy and ok
                if burn_l is not None and burn_l >= 1.0:
                    exhausted = True
                report["objectives"].append({
                    "spec": o.spec, "key": o.key, "value": value,
                    "threshold": threshold, "ok": ok,
                    "burn_short": burn_s, "burn_long": burn_l,
                    "samples": n_l})
                telemetry.gauge(f"slo.{o.key}.ok").set(1 if ok else 0)
                if burn_s is not None:
                    telemetry.gauge(f"slo.{o.key}.burn_short").set(burn_s)
                if burn_l is not None:
                    telemetry.gauge(f"slo.{o.key}.burn_long").set(burn_l)
            self.exhausted = exhausted
            report["healthy"] = healthy
            report["exhausted"] = exhausted
            telemetry.gauge("slo.healthy").set(1 if healthy else 0)
            telemetry.gauge("slo.budget_exhausted").set(
                1 if exhausted else 0)
        return report


_tracker = None


def tracker():
    """The process SLO tracker (built lazily from ``MXNET_SLO_SPEC``)."""
    global _tracker
    if _tracker is None:
        with _lock:
            if _tracker is None:
                _tracker = SloTracker()
    return _tracker


def slo_report():
    """Evaluate now and return the report (the ``/slo`` endpoint body).
    ``{"enabled": False}`` when the health layer is off."""
    if not _enabled:
        return {"enabled": False}
    report = tracker().evaluate()
    report["enabled"] = True
    report["stalls"] = telemetry.counter("health.stalls").value
    report["desired_engines"] = autoscale_signal()
    return report


def budget_ok():
    """False once the long-window error budget is exhausted (readiness
    consults this; True when health is off or nothing evaluated yet)."""
    t = _tracker
    return t is None or not t.exhausted


# ---------------------------------------------------------------------------
# Liveness / readiness registries
# ---------------------------------------------------------------------------

# name -> (weakref(owner), probe). probe(owner) returns (ok, detail) or a
# plain bool. Dead owners drop out at read time.
_liveness = {}
_readiness = {}


def register_liveness(name, owner, probe):
    with _lock:
        _liveness[name] = (weakref.ref(owner), probe)


def register_readiness(name, owner, probe):
    with _lock:
        _readiness[name] = (weakref.ref(owner), probe)


def unregister(name):
    """Remove ``name`` from both probe registries (a deliberately closed
    server is no longer a serving participant — its drain must not pin
    the process ``/readyz`` false forever)."""
    with _lock:
        _liveness.pop(name, None)
        _readiness.pop(name, None)


def _run_probes(registry):
    with _lock:
        items = list(registry.items())
    ok_all = True
    out = {}
    for name, (ref, probe) in items:
        owner = ref()
        if owner is None:
            with _lock:
                if registry.get(name) == (ref, probe):
                    del registry[name]
            continue
        try:
            r = probe(owner)
        except Exception as e:  # noqa: BLE001 — a probe bug is "not ok"
            r = (False, f"probe error: {e!r}")
        ok, detail = r if isinstance(r, tuple) else (bool(r), "")
        out[name] = {"ok": bool(ok), "detail": detail}
        ok_all = ok_all and bool(ok)
    return ok_all, out


def liveness():
    """(ok, {probe: {ok, detail}}): process up + every registered
    liveness probe (scheduler/worker threads alive). An empty registry is
    alive — the process answered. With the health layer OFF the probes
    are not consulted (a deployment that only wanted /metrics must not
    grow new 503s from probes it never opted into)."""
    if not _enabled:
        return True, {}
    return _run_probes(_liveness)


def readiness():
    """(ok, {probe: ...}): every readiness probe (warmup complete, queue
    below watermark) AND the SLO error budget not exhausted. Trivially
    ready when the health layer is off (same opt-in rule as
    :func:`liveness`)."""
    if not _enabled:
        return True, {}
    ok, probes = _run_probes(_readiness)
    if not budget_ok():
        probes["slo.budget"] = {"ok": False,
                                "detail": "long-window error budget "
                                          "exhausted"}
        ok = False
    return ok, probes


# ---------------------------------------------------------------------------
# Autoscale signal
# ---------------------------------------------------------------------------

_fleets = []          # weakrefs to objects exposing .engines
_autoscale_cbs = []
_autoscale_state = {"desired": None}


def register_fleet(fleet):
    """Register an engine fleet (anything with ``.engines``, e.g. a
    :class:`~mxnet_tpu_torch.serving.generation.router.GenerationRouter`) as an
    autoscale source. Weakly held."""
    with _lock:
        _fleets.append(weakref.ref(fleet))


def on_autoscale(cb):
    """Register ``cb(desired, info)`` — fired whenever the computed
    ``health.desired_engines`` CHANGES (the hook an external controller
    plugs into). Returns ``cb`` for decorator use."""
    with _lock:
        _autoscale_cbs.append(cb)
    return cb


def autoscale_signal(engines=None):
    """Compute the desired engine count from live fleet state: demand
    (live + queued sessions) over capacity at the target fill ratio,
    bumped one replica when the SLO short-window burn is over budget.
    Publishes ``health.desired_engines`` and fires the
    :func:`on_autoscale` callbacks on change. Returns the desired count
    (None when no fleet/engines are registered)."""
    if engines is None:
        engines = []
        with _lock:
            _fleets[:] = [r for r in _fleets if r() is not None]
            refs = list(_fleets)
        for ref in refs:
            f = ref()
            if f is not None:
                engines.extend(f.engines)
    engines = list(engines)
    if not engines:
        return None
    n = len(engines)
    # QoS active: demand is fairness-WEIGHTED (an interactive session
    # votes harder for replicas than a batch one — the fleet scales for
    # its latency-sensitive load, not its backlog); engines without the
    # hook (or with QoS off → qos_demand() is None) fall back to the raw
    # live + queued count, so the signal is unchanged by default
    demand = 0.0
    for e in engines:
        w = (e.qos_demand() if hasattr(e, "qos_demand") else None)
        demand += (e.live_slots + e.queue_depth) if w is None else w
    slots = sum(e.max_slots for e in engines) / n
    fill = float(getenv("MXNET_HEALTH_TARGET_FILL"))
    desired = max(1, -(-demand // max(slots * fill, 1e-9)))
    desired = int(desired)
    burning = False
    t = _tracker
    if t is not None:
        with t._lock:
            for key in t._samples:
                g = telemetry.get(f"slo.{key}.burn_short")
                if g is not None and g.value is not None \
                        and g.value > 1.0:
                    burning = True
                    break
    if burning:
        desired = max(desired, n + 1)
    telemetry.gauge("health.desired_engines").set(desired)
    info = {"engines": n, "demand": demand, "slots_per_engine": slots,
            "target_fill": fill, "slo_burning": burning}
    with _lock:
        changed = _autoscale_state["desired"] != desired
        _autoscale_state["desired"] = desired
        cbs = list(_autoscale_cbs)
    if changed:
        event("autoscale", desired=desired, **info)
        for cb in cbs:
            try:
                cb(desired, info)
            except Exception as e:  # noqa: BLE001 — a controller bug must
                _logger().error("autoscale callback failed: %r", e)
    return desired


# ---------------------------------------------------------------------------
# Monitor threads
# ---------------------------------------------------------------------------

_watchdog_thread = None
_slo_thread = None
_threads_lock = analysis.make_lock("health.threads")


_stop = threading.Event()


def _watchdog_loop(stop):
    while not stop.wait(max(float(getenv("MXNET_HEALTH_WATCHDOG_S")),
                            0.05)):
        if not _enabled:
            continue
        try:
            check_beacons()
        except Exception as e:  # noqa: BLE001 — the watchdog never dies
            _logger().error("watchdog sweep failed: %r", e)


def _slo_loop(stop, interval):
    while not stop.wait(interval):
        if not _enabled:
            continue
        try:
            tracker().evaluate()
            autoscale_signal()
        except Exception as e:  # noqa: BLE001
            _logger().error("SLO evaluation failed: %r", e)


def _start_threads():
    """Start the watchdog (and optional SLO) daemon threads once. Only
    called from :func:`enable` and :func:`reset` while the layer is on:
    with ``MXNET_HEALTH`` off no thread exists."""
    global _watchdog_thread, _slo_thread, _stop
    with _threads_lock:
        if _stop.is_set():
            _stop = threading.Event()
        if _watchdog_thread is None or not _watchdog_thread.is_alive():
            _watchdog_thread = threading.Thread(
                target=_watchdog_loop, args=(_stop,), daemon=True,
                name="mxnet_tpu_torch.health.watchdog")
            _watchdog_thread.start()
        interval = float(getenv("MXNET_SLO_INTERVAL_S"))
        if interval > 0 and (_slo_thread is None
                             or not _slo_thread.is_alive()):
            _slo_thread = threading.Thread(
                target=_slo_loop, args=(_stop, interval), daemon=True,
                name="mxnet_tpu_torch.health.slo")
            _slo_thread.start()


def _stop_threads():
    """Stop and join the monitor threads (:func:`disable`, :func:`reset`):
    a thread left running would poll in every later test of a worker."""
    global _watchdog_thread, _slo_thread
    with _threads_lock:
        _stop.set()
        threads = [t for t in (_watchdog_thread, _slo_thread)
                   if t is not None]
        _watchdog_thread = _slo_thread = None
    for t in threads:
        if t is not threading.current_thread():
            t.join(timeout=2.0)


if _enabled:
    _start_threads()
