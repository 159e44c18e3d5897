"""Runtime telemetry: a process-wide metrics registry and its exports.

The port's own copy of `mxnet_tpu/telemetry.py` (which imports no jax).
Every hot path the port owns reports into one registry:

* ``kvstore.*`` / ``dist.*``: push and pull bytes and latency, collective
  bytes (`kvstore`, `parallel.dist`);
* ``checkpoint.*``: save and load duration and bytes (`model`,
  `ndarray.utils`);
* ``step.*``: the per-step breakdown (fwdbwd / update / sync / data)
  recorded by ``BaseModule.fit`` and surfaced through
  ``BatchEndParam.step_stats``, so ``Speedometer`` logs p50/p99 step
  latency beside samples/sec; the ``step.fused`` gauge is 1 while
  training runs the captured fused step and 0 on the eager path;
* ``serving.*`` / ``rollout.*`` / ``serving.generation.*``: the Predictor,
  the batcher, weight rollout and the generation engine with its prefix
  and speculative lanes;
* ``compile.*``: the `compile_cache` plane (``compile.cache_hits`` /
  ``compile.cache_misses`` counters, ``compile.seconds``, the
  ``compile.cache_entries`` gauge and the derived
  ``compile.cache_hit_ratio``). Unlike the rest these are recorded
  unconditionally: rebuild churn must be visible even when the wider
  plane is off.

Metric kinds: :class:`Counter` (monotonic), :class:`Gauge` (set/inc/dec),
:class:`Histogram` (exact count/sum/min/max and a bounded reservoir for
quantiles). Names are dotted ``subsystem.metric``; latencies are
microseconds (``*_us``), sizes bytes (``*_bytes``).

Host timestamps taken around a CUDA-graph replay or a kernel launch
measure enqueue, not device time (the JAX package's async dispatch had the
same property); device time comes from CUDA events in
`observatory.summary`.

Export, three ways:

1. :func:`dumps`: a JSON snapshot; ``MXNET_TELEMETRY_DUMP=<path>`` writes
   it at interpreter exit through the checkpoint writers' temp-file, fsync
   and atomic-rename path (`resilience.durable_replace`), so a crash
   mid-dump never leaves a torn snapshot.
2. :func:`trace_counter_events`: chrome-trace ``"C"`` (counter) events
   merged into ``profiler.dump()`` output, so metrics line up with the
   device trace.
3. periodic log summaries (``MXNET_TELEMETRY_LOG_INTERVAL_S``), and the
   HTTP endpoint (:func:`start_http_server`).

Overhead: everything gates on the module-level ``_enabled`` flag
(``MXNET_TELEMETRY=1`` or :func:`enable`). Call sites read the flag
BEFORE taking any timestamp, so a disabled registry costs one attribute
read a call. The log thread stops on :func:`disable` and :func:`reset`.
"""
from __future__ import annotations

import atexit
import json
import os
import random
import sys
import threading
import time

from .base import getenv, register_env
from .log import get_logger

__all__ = ["Counter", "Gauge", "Histogram",
           "counter", "gauge", "histogram", "get", "labeled",
           "enabled", "enable", "disable", "reset",
           "snapshot", "dumps", "dump", "dumps_table", "prom_text",
           "trace_counter_events", "start_log_thread", "stop_log_thread",
           "start_http_server", "stop_http_server"]

register_env("MXNET_TELEMETRY", False, "enable the runtime metrics registry")
register_env("MXNET_TELEMETRY_DUMP", "",
             "write a telemetry.dumps() JSON snapshot to this path at exit")
register_env("MXNET_TELEMETRY_LOG_INTERVAL_S", 0.0,
             "log a telemetry summary every N seconds (0 = off)")
register_env("MXNET_TELEMETRY_RESERVOIR", 1024,
             "histogram reservoir size (quantile accuracy vs. memory)")
register_env("MXNET_TELEMETRY_HTTP_PORT", 0,
             "serve /metrics (Prometheus text), /trace (chrome trace + "
             "worst-step/tick span trees), /memory (device-buffer census) "
             "and the health plane (/slo, /healthz, /readyz, /events) on "
             "this port from a background thread (0 = off)")
register_env("MXNET_TELEMETRY_HTTP_HOST", "127.0.0.1",
             "bind address for the telemetry HTTP endpoint — loopback by "
             "default; traces carry request args and file paths, so expose "
             "on other interfaces (e.g. 0.0.0.0 for a Prometheus scrape "
             "from another host) deliberately")

# THE gate. Call sites read `telemetry._enabled` (one attribute fetch)
# before doing any telemetry work, including taking timestamps.
_enabled = bool(getenv("MXNET_TELEMETRY"))

_registry = {}            # name -> metric
_registry_lock = threading.Lock()


def _logger():
    from . import log as _log

    return get_logger("mxnet_tpu_torch.telemetry", level=_log.INFO)


# ---------------------------------------------------------------------------
# Metric kinds
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic counter (events, bytes, retries)."""

    kind = "counter"
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return self._value


class Gauge:
    """Point-in-time value (queue depth, ratios)."""

    kind = "gauge"
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return self._value


def _percentile(samples, q):
    """q-th percentile (0-100) of an already-sorted sample list; None when
    empty. THE quantile formula — every export path uses this one."""
    if not samples:
        return None
    last = len(samples) - 1
    return samples[max(0, min(int(round(q / 100.0 * last)), last))]


class Histogram:
    """Latency/size distribution: exact count/sum/min/max plus a bounded
    reservoir (Vitter's algorithm R) for p50/p95/p99 — a week-long run
    records billions of steps in O(reservoir) memory."""

    kind = "histogram"
    __slots__ = ("name", "_lock", "_count", "_sum", "_min", "_max",
                 "_reservoir", "_cap")

    def __init__(self, name, reservoir=None):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._cap = int(reservoir if reservoir is not None
                        else getenv("MXNET_TELEMETRY_RESERVOIR"))
        self._reservoir = []

    def record(self, v):
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._reservoir) < self._cap:
                self._reservoir.append(v)
            else:
                j = random.randrange(self._count)
                if j < self._cap:
                    self._reservoir[j] = v

    @property
    def count(self):
        return self._count

    def percentile(self, q):
        """Approximate q-th percentile (0-100) from the reservoir."""
        return self.quantiles(q)[0]

    def quantiles(self, *qs):
        """Several percentiles from ONE sorted reservoir copy (the hot-loop
        spelling: p50+p99 per step must not sort twice). None entries when
        the reservoir is empty (no samples yet, or reservoir size 0)."""
        with self._lock:
            samples = sorted(self._reservoir)
        return tuple(_percentile(samples, q) for q in qs)

    def snapshot(self):
        with self._lock:
            count, total = self._count, self._sum
            samples = sorted(self._reservoir)
        if not count:
            return {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "avg": None, "p50": None, "p95": None, "p99": None}
        return {"count": count, "sum": total,
                "min": self._min, "max": self._max, "avg": total / count,
                "p50": _percentile(samples, 50),
                "p95": _percentile(samples, 95),
                "p99": _percentile(samples, 99)}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def _get_or_create(name, cls):
    m = _registry.get(name)
    if m is not None:
        if not isinstance(m, cls):
            raise TypeError(
                f"telemetry metric {name!r} already registered as {m.kind}")
        return m
    with _registry_lock:
        m = _registry.get(name)
        if m is None:
            m = _registry[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(
                f"telemetry metric {name!r} already registered as {m.kind}")
    return m


def counter(name):
    """Get-or-create the :class:`Counter` named ``name``."""
    return _get_or_create(name, Counter)


def gauge(name):
    """Get-or-create the :class:`Gauge` named ``name``."""
    return _get_or_create(name, Gauge)


def histogram(name):
    """Get-or-create the :class:`Histogram` named ``name``."""
    return _get_or_create(name, Histogram)


def get(name):
    """The metric named ``name``, or None."""
    return _registry.get(name)


def labeled(name, **labels):
    """Compose a metric name carrying Prometheus-style labels:
    ``labeled("qos.admitted", tenant="acme")`` ->
    ``"qos.admitted|tenant=acme"`` (keys sorted for a stable identity).
    Flat views (``dumps_table``, ``snapshot``) show the composed name;
    :func:`prom_text` splits it back into a real label set —
    ``mxnet_qos_admitted{tenant="acme"}`` — so per-tenant series land as
    one metric family, not N name-mangled metrics. Label VALUES have the
    ``|``/``=`` separators sanitized to ``_``; the label-escape path
    handles the rest at render time."""
    parts = [name]
    for k in sorted(labels):
        v = str(labels[k]).replace("|", "_").replace("=", "_")
        parts.append(f"{k}={v}")
    return "|".join(parts)


def enabled():
    return _enabled


def enable(on=True):
    """Turn the registry on (also: ``MXNET_TELEMETRY=1`` at import)."""
    global _enabled
    _enabled = bool(on)
    if _enabled:
        start_log_thread()
    else:
        stop_log_thread()


def disable():
    enable(False)


def reset():
    """Drop every metric (tests; a fresh registry, enabled state kept).
    The log thread stops, and restarts when the registry is on and
    ``MXNET_TELEMETRY_LOG_INTERVAL_S`` asks for one."""
    with _registry_lock:
        _registry.clear()
    stop_log_thread()
    if _enabled:
        start_log_thread()


# ---------------------------------------------------------------------------
# Snapshot / export
# ---------------------------------------------------------------------------


def snapshot():
    """One coherent dict of every metric: {counters, gauges, histograms,
    derived}. ``derived`` carries cross-metric ratios, e.g. the prefetch
    starvation ratio wait/(wait+compute) — >0.5 means the step loop spends
    more time waiting on data than computing (docs/faq/perf.md)."""
    with _registry_lock:
        metrics = list(_registry.values())
    out = {"ts": time.time(), "pid": os.getpid(),
           "counters": {}, "gauges": {}, "histograms": {}, "derived": {}}
    for m in metrics:
        out[m.kind + "s"][m.name] = m.snapshot()
    wait = out["counters"].get("io.prefetch_wait_us_total", 0.0)
    compute = out["counters"].get("io.prefetch_compute_us_total", 0.0)
    if wait + compute > 0:
        out["derived"]["io.starvation_ratio"] = wait / (wait + compute)
    swait = out["counters"].get("io.stage_wait_us_total", 0.0)
    sprep = out["counters"].get("io.stage_prep_us_total", 0.0)
    if swait + sprep > 0:
        # time the consumer blocked on the staging thread over total
        # staging time — near 0 means batches are fully prepared behind
        # device compute, near 1 means staging isn't hiding anything
        # (docs/faq/perf.md "Closing the host gap")
        out["derived"]["io.stage_wait_ratio"] = swait / (swait + sprep)
    step_wall = out["counters"].get("step.wall_us_total", 0.0)
    if step_wall > 0:
        # every host-side input stall a step can see — prefetch wait plus
        # stage wait — over step wall time: the one number that says how
        # much of the run the input pipeline cost (composes PrefetchingIter
        # starvation with DeviceStager waits)
        out["derived"]["io.pipeline_stall_ratio"] = min(
            (wait + swait) / step_wall, 1.0)
    hits = out["counters"].get("compile.cache_hits", 0)
    misses = out["counters"].get("compile.cache_misses", 0)
    if hits + misses > 0:
        # low ratio at steady state = recompile churn (docs/faq/perf.md
        # "Reading compile-cache telemetry")
        out["derived"]["compile.cache_hit_ratio"] = hits / (hits + misses)
    rows = out["counters"].get("serving.batch_rows", 0)
    slots = out["counters"].get("serving.batch_slots", 0)
    if slots > 0:
        # real rows per padded batch slot — low fill means the bucket
        # ladder or flush window is wasting compute on padding
        # (docs/faq/perf.md "Sizing serving buckets")
        out["derived"]["serving.batch_fill_ratio"] = rows / slots
    dtok = out["counters"].get("serving.generation.decode_tokens", 0)
    cap = out["counters"].get("serving.generation.tick_slots", 0)
    if cap > 0:
        # live sessions per slab slot per decode tick — low fill means the
        # KV slab is oversized for the arrival rate (padding compute on
        # dead slots; docs/faq/perf.md "Sizing the KV slab")
        out["derived"]["serving.generation.slot_fill_ratio"] = dtok / cap
    prop = out["counters"].get("serving.generation.spec.proposed", 0)
    if prop > 0:
        # draft quality: accepted proposals over proposed — the lever
        # behind tokens-per-tick (docs/faq/perf.md "Prefix caching and
        # speculative decoding")
        out["derived"]["serving.generation.spec.acceptance_ratio"] = \
            out["counters"].get("serving.generation.spec.accepted", 0) / prop
    vslots = out["counters"].get("serving.generation.spec.verified_slots", 0)
    if vslots > 0:
        # committed tokens per live slot per verify tick: 1.0 is the
        # plain-decode floor, spec_k+1 the ceiling
        out["derived"]["serving.generation.spec.accepted_tokens_per_tick"] = \
            out["counters"].get("serving.generation.spec.committed", 0) \
            / vslots
    ph = out["counters"].get("serving.generation.prefix.hits", 0)
    pm = out["counters"].get("serving.generation.prefix.misses", 0)
    if ph + pm > 0:
        # admissions served by a fork instead of a full prefill — a
        # fleet sharing a system prompt should approach (N-1)/N
        out["derived"]["serving.generation.prefix.hit_ratio"] = \
            ph / (ph + pm)
    segs = out["counters"].get("lazy.segments", 0)
    if segs > 0:
        # fused ops per flushed lazy segment — near 1 means barriers fire
        # per op and capture buys nothing (docs/faq/perf.md "Reading
        # lazy-segment telemetry")
        out["derived"]["lazy.mean_ops_per_segment"] = \
            out["counters"].get("lazy.ops_captured", 0) / segs
    rseg = out["counters"].get("lazy.rewrite.segments", 0)
    if rseg > 0:
        # pre- AND post-rewrite node counts per rewritten segment: post
        # alone would read as "capture got worse" next to
        # mean_ops_per_segment; shrink_ratio is the fraction of replay
        # nodes the rewriter removed (docs/faq/perf.md "Reading rewrite
        # telemetry")
        pre = out["counters"].get("lazy.rewrite.nodes_pre", 0)
        post = out["counters"].get("lazy.rewrite.nodes_post", 0)
        out["derived"]["lazy.rewrite.mean_ops_pre"] = pre / rseg
        out["derived"]["lazy.rewrite.mean_ops_post"] = post / rseg
        if pre > 0:
            out["derived"]["lazy.rewrite.shrink_ratio"] = (pre - post) / pre
    try:
        from . import compile_cache as _cc

        # per-name compile ledger: op-level (op_eager/op_vjp), lazy
        # segments, executors and the serving/generation planes — one
        # accounting language (tools/telemetry_report.py renders it)
        totals = _cc.name_totals()
        if totals:
            out["compile_caches"] = totals
    except Exception:  # noqa: BLE001 — snapshot must never fail
        pass
    try:
        # last computed roofline summary, by reference only (sys.modules:
        # a snapshot must never import — let alone probe — the
        # observatory; tools/telemetry_report.py renders the section)
        obs = sys.modules.get("mxnet_tpu_torch.observatory")
        if obs is not None:
            cached = obs.cached_summary()
            if cached:
                out["observatory"] = cached
    except Exception:  # noqa: BLE001 — snapshot must never fail
        pass
    return out


def dumps(indent=2):
    """JSON snapshot of the registry."""
    return json.dumps(snapshot(), indent=indent)


def dump(path=None):
    """Write :func:`dumps` to ``path`` (default ``MXNET_TELEMETRY_DUMP``)
    through the checkpoint writers' temp-file + fsync + atomic-rename
    sequence — a reader (or a crash) never sees a torn snapshot."""
    from .resilience import durable_replace

    path = path or getenv("MXNET_TELEMETRY_DUMP")
    if not path:
        raise ValueError("no dump path: pass one or set MXNET_TELEMETRY_DUMP")
    payload = dumps()
    tmp = path + ".tmp~"
    with open(tmp, "w") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    durable_replace(tmp, path)
    return path


def trace_counter_events(ts=None):
    """The registry as chrome-trace ``"C"`` (counter) events, for merging
    into ``profiler.dump()`` output: counters/gauges one series each,
    histograms a {p50, p99, count} series — metrics land on the same
    timeline as the host scopes and the device trace."""
    ts = time.time() * 1e6 if ts is None else ts
    pid = os.getpid()
    snap = snapshot()
    events = []

    def emit(name, args):
        events.append({"name": f"telemetry/{name}", "ph": "C",
                       "cat": "telemetry", "pid": pid, "tid": 0,
                       "ts": ts, "args": args})

    for name, v in snap["counters"].items():
        emit(name, {"value": v})
    for name, v in snap["gauges"].items():
        emit(name, {"value": v})
    for name, v in snap["derived"].items():
        emit(name, {"value": v})
    for name, h in snap["histograms"].items():
        if h["count"]:
            emit(name, {"p50": h["p50"], "p99": h["p99"],
                        "count": h["count"]})
    return events


def dumps_table(snap=None, sort_by="total"):
    """Render a snapshot (live registry when ``snap`` is None) in the
    ``profiler.dumps_aggregate`` table format, histograms extended with
    quantile columns — one visual language for both planes
    (`tools/telemetry_report.py` renders dumped files through this)."""
    snap = snapshot() if snap is None else snap
    lines = ["", "Telemetry Statistics:"]

    def section(title, hdr, rows):
        if not rows:
            return
        lines.append("")
        lines.append(title)
        lines.append("=" * len(title))
        lines.append(hdr)
        lines.append("-" * len(hdr))
        lines.extend(rows)

    def val(v):
        return f"{v:>16.1f}" if isinstance(v, float) else f"{v:>16}"

    fmt_cg = f"{'Name':<40}{'Value':>16}"
    section("counters", fmt_cg,
            [f"{n[:39]:<40}{val(v)}" for n, v in sorted(snap["counters"].items())])
    section("gauges", fmt_cg,
            [f"{n[:39]:<40}{val(v)}" for n, v in sorted(snap["gauges"].items())])
    section("derived", fmt_cg,
            [f"{n[:39]:<40}{v:>16.4f}" for n, v in sorted(snap["derived"].items())])

    hdr = (f"{'Name':<40}{'Total Count':>12}{'Time (ms)':>14}"
           f"{'Min (ms)':>12}{'Max (ms)':>12}{'Avg (ms)':>12}"
           f"{'p50 (ms)':>12}{'p95 (ms)':>12}{'p99 (ms)':>12}")
    rows = []
    key_idx = {"count": "count", "total": "sum", "avg": "avg",
               "min": "min", "max": "max"}
    if sort_by not in key_idx:
        raise ValueError(f"sort_by must be one of {sorted(key_idx)}")
    hists = sorted(snap["histograms"].items(),
                   key=lambda kv: kv[1].get(key_idx[sort_by]) or 0,
                   reverse=True)
    for name, h in hists:
        if not h["count"]:
            continue

        def ms(v):
            return f"{v / 1e3:>12.4f}" if v is not None else f"{'-':>12}"

        rows.append(f"{name[:39]:<40}{h['count']:>12}{h['sum'] / 1e3:>14.4f}"
                    f"{ms(h['min'])}{ms(h['max'])}{ms(h['avg'])}"
                    f"{ms(h['p50'])}{ms(h['p95'])}{ms(h['p99'])}")
    section("histograms (us-valued, shown in ms)", hdr, rows)
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Prometheus text export + the /metrics HTTP endpoint
# ---------------------------------------------------------------------------


def _prom_name(name):
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    n = "".join(out)
    return n if n[:1].isalpha() or n[:1] == "_" else "_" + n


def _prom_value(v):
    """A metric value in Prometheus text form, or None when the value is
    not representable (a gauge someone set to a string must be skipped,
    not emitted as an unparseable sample). Non-finite floats use the
    spec spellings ``+Inf`` / ``-Inf`` / ``NaN``."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if not isinstance(v, (int, float)):
        return None
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(v) if isinstance(v, float) else str(v)


def _prom_label(value):
    """A label VALUE escaped per the text exposition format: backslash,
    double-quote and newline are the three characters the parser cannot
    take raw."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_split(name):
    """Split a :func:`labeled` metric name into ``(base, labelstr)`` —
    ``"qos.admitted|class=batch|tenant=acme"`` becomes
    ``("qos.admitted", 'class="batch",tenant="acme"')``. Unlabeled names
    pass through with an empty label string."""
    if "|" not in name:
        return name, ""
    base, _, rest = name.partition("|")
    pairs = []
    for tok in rest.split("|"):
        k, _, v = tok.partition("=")
        pairs.append(f'{_prom_name(k)}="{_prom_label(v)}"')
    return base, ",".join(pairs)


def prom_text(refresh_memory=True):
    """The registry in Prometheus text exposition format (what the HTTP
    ``/metrics`` endpoint serves, scrapeable by any Prometheus-compatible
    collector). Counters/gauges/derived map 1:1 (names prefixed
    ``mxnet_``, dots to underscores); histograms render as summaries
    (p50/p95/p99 quantile series + ``_sum``/``_count``).
    ``refresh_memory`` runs a device-buffer census first so ``memory.*``
    gauges are live, not last-read."""
    if refresh_memory:
        try:
            from . import memory

            memory.update_gauges()
        except Exception:  # noqa: BLE001 — census must not break a scrape
            pass
    snap = snapshot()
    lines = []
    # labeled() series of one base name form ONE metric family: the
    # # TYPE header is emitted once per family, however many label sets
    # report under it (names sort adjacently, so families stay grouped)
    typed = set()

    def emit(name, kind, value):
        v = _prom_value(value)
        if v is None:
            # un-renderable (e.g. a gauge set to a string): a skipped
            # sample keeps the whole exposition parseable
            return
        base, labels = _prom_split(name)
        n = "mxnet_" + _prom_name(base)
        if (n, kind) not in typed:
            typed.add((n, kind))
            lines.append(f"# TYPE {n} {kind}")
        lines.append(f"{n}{{{labels}}} {v}" if labels else f"{n} {v}")

    for name, v in sorted(snap["counters"].items()):
        emit(name, "counter", v)
    for name, v in sorted(snap["gauges"].items()):
        emit(name, "gauge", v)
    for name, v in sorted(snap["derived"].items()):
        emit(name, "gauge", v)
    for name, h in sorted(snap["histograms"].items()):
        base, labels = _prom_split(name)
        n = "mxnet_" + _prom_name(base)
        if (n, "summary") not in typed:
            typed.add((n, "summary"))
            lines.append(f"# TYPE {n} summary")
        if h["count"]:
            for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                qv = _prom_value(h[key])
                if qv is None:
                    # a zero-size reservoir records count/sum but no
                    # quantiles — "None" is not a float the parser takes
                    continue
                lab = (f'{labels},quantile="{_prom_label(q)}"' if labels
                       else f'quantile="{_prom_label(q)}"')
                lines.append(f"{n}{{{lab}}} {qv}")
        suffix = f"{{{labels}}}" if labels else ""
        lines.append(f"{n}_sum{suffix} {_prom_value(h['sum'])}")
        lines.append(f"{n}_count{suffix} {_prom_value(h['count'])}")
    return "\n".join(lines) + "\n"


_http_server = None
_http_thread = None


def start_http_server(port=None, host=None):
    """Start the background observability endpoint (idempotent; opt-in via
    ``MXNET_TELEMETRY_HTTP_PORT`` or an explicit port; binds
    ``MXNET_TELEMETRY_HTTP_HOST``, loopback by default). Serves:

    * ``/metrics`` — :func:`prom_text` (Prometheus scrape format);
    * ``/trace``  — the current chrome-trace buffer (host spans + span
      tracing + telemetry counters, NOT reset by the read) plus the
      flight recorder's worst-step span tree;
    * ``/memory`` — the live device-buffer census
      (:func:`mxnet_tpu_torch.memory.census`) + per-graph-pool memory
      (`memory.executable_stats`);
    * ``/slo`` — the SLO tracker's evaluation report (objectives, burn
      rates, budget state, the autoscale signal);
    * ``/healthz`` / ``/readyz`` — liveness/readiness probe aggregation
      (HTTP 503 when any probe fails — a k8s-shaped contract);
    * ``/events`` — the health event journal (bounded ring of runtime
      events: rejections, evictions, drains, watchdog firings);
    * ``/roofline`` — the observatory's roofline report: measured device
      peaks + per-lane MFU/MBU attribution
      (:func:`mxnet_tpu_torch.observatory.summary`).

    Returns the server (its ``.server_address[1]`` is the bound port —
    pass port 0 for an ephemeral one in tests), or None when off."""
    global _http_server, _http_thread
    if _http_server is not None:
        return _http_server
    if port is None:
        port = int(getenv("MXNET_TELEMETRY_HTTP_PORT"))
        if not port:
            return None
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet: not a user-facing web server
            pass

        def _send(self, body, ctype, code=200):
            data = body.encode() if isinstance(body, str) else body
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            try:
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._send(prom_text(), "text/plain; version=0.0.4")
                elif path == "/trace":
                    from . import profiler, tracing

                    doc = profiler.peek_doc()
                    worst = tracing.flight_recorder.worst()
                    if worst is not None:
                        doc.setdefault("otherData", {})["worst_step"] = worst
                    # the generation analog: the worst scheduler decode
                    # tick's span tree (tracing.tick_recorder)
                    tick = tracing.tick_recorder.worst()
                    if tick is not None:
                        doc.setdefault("otherData", {})["worst_tick"] = tick
                    # compact: a near-cap buffer is hundreds of MB
                    # pretty-printed, and this is a machine-read endpoint
                    self._send(json.dumps(doc), "application/json")
                elif path == "/memory":
                    from . import memory

                    doc = memory.census()
                    doc["executables"] = memory.executable_stats()
                    self._send(json.dumps(doc, indent=2), "application/json")
                elif path == "/slo":
                    from . import health

                    self._send(json.dumps(health.slo_report(), indent=2,
                                          default=repr),
                               "application/json")
                elif path == "/healthz":
                    from . import health

                    ok, probes = health.liveness()
                    body = {"ok": ok, "pid": os.getpid(),
                            "health_enabled": health._enabled,
                            "probes": probes}
                    self._send(json.dumps(body, indent=2),
                               "application/json", 200 if ok else 503)
                elif path == "/readyz":
                    from . import health

                    ok, probes = health.readiness()
                    body = {"ok": ok, "probes": probes}
                    self._send(json.dumps(body, indent=2),
                               "application/json", 200 if ok else 503)
                elif path == "/events":
                    from . import health

                    self._send(json.dumps(health.events(), indent=2,
                                          default=repr),
                               "application/json")
                elif path == "/roofline":
                    from . import observatory

                    # summary() computes attribution for observed lanes —
                    # the first scrape after new compiles pays the lazy
                    # AOT cost pass (like /memory), never the step path
                    self._send(json.dumps(observatory.summary(), indent=2,
                                          default=repr),
                               "application/json")
                else:
                    self.send_error(404, "try /metrics, /trace, /memory, "
                                         "/slo, /healthz, /readyz, "
                                         "/events or /roofline")
            except Exception as e:  # noqa: BLE001 — a scrape must not crash
                try:
                    self.send_error(500, repr(e))
                except Exception:
                    pass

    host = host or getenv("MXNET_TELEMETRY_HTTP_HOST")
    _http_server = ThreadingHTTPServer((host, int(port)), Handler)
    _http_thread = threading.Thread(target=_http_server.serve_forever,
                                    daemon=True,
                                    name="mxnet_tpu_torch.telemetry.http")
    _http_thread.start()
    _logger().info("telemetry HTTP endpoint on %s:%d "
                   "(/metrics, /trace, /memory)", host,
                   _http_server.server_address[1])
    return _http_server


def stop_http_server():
    global _http_server, _http_thread
    if _http_server is not None:
        _http_server.shutdown()
        _http_server.server_close()
        _http_server = None
    if _http_thread is not None:
        _http_thread.join(timeout=1.0)
        _http_thread = None


# ---------------------------------------------------------------------------
# Periodic log summaries
# ---------------------------------------------------------------------------

_log_thread = None
_log_stop = threading.Event()


def start_log_thread(interval=None):
    """Start the summary logger (idempotent). Interval from the arg or
    ``MXNET_TELEMETRY_LOG_INTERVAL_S``; 0/negative means off."""
    global _log_thread
    interval = (float(getenv("MXNET_TELEMETRY_LOG_INTERVAL_S"))
                if interval is None else float(interval))
    if interval <= 0 or (_log_thread is not None and _log_thread.is_alive()):
        return None
    _log_stop.clear()

    def loop():
        while not _log_stop.wait(interval):
            if _enabled and _registry:
                _logger().info("telemetry summary:%s", dumps_table())

    _log_thread = threading.Thread(target=loop, daemon=True,
                                   name="mxnet_tpu_torch.telemetry.log")
    _log_thread.start()
    return _log_thread


def stop_log_thread():
    global _log_thread
    _log_stop.set()
    if _log_thread is not None:
        _log_thread.join(timeout=1.0)
        _log_thread = None


@atexit.register
def _dump_at_exit():
    """``MXNET_TELEMETRY_DUMP`` exit dump — best-effort: a failed telemetry
    write must never turn a clean exit into a crash, but it is logged."""
    path = getenv("MXNET_TELEMETRY_DUMP")
    if not path or not _registry:
        return
    try:
        dump(path)
    except Exception as e:  # noqa: BLE001 — interpreter is dying
        try:
            _logger().error("telemetry exit dump to %s failed: %r", path, e)
        except Exception:
            pass


if _enabled:
    start_log_thread()

if int(getenv("MXNET_TELEMETRY_HTTP_PORT") or 0):
    try:  # opt-in endpoint; a busy port must not break import
        start_http_server()
    except Exception as _e:  # noqa: BLE001
        _logger().error("telemetry HTTP endpoint failed to start: %r", _e)
