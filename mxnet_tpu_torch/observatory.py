"""The performance observatory: roofline attribution against MEASURED peaks.

The port of `mxnet_tpu/observatory.py`. Three moves:

1. **Measured-peak probes** (:func:`peaks`): sustained matmul FLOP/s per
   dtype (``torch.matmul`` chained over an n x n operand, bf16 and fp32
   with TF32 off, as `bench.py:1851-1869` chains its probe), the device's
   memory bandwidth (a device-to-device copy), and collective bandwidth
   (an all-reduce over an initialized `torch.distributed` group of two or
   more ranks; None on one card, as the JAX probe is on one device).
   These are yardstick probes, not kernels of the port. Each is timed
   between CUDA events (best of three). Peaks are measured once and
   persisted under ``MXNET_OBSERVATORY_DIR`` with provenance (backend,
   device name, count, probe sizes, torch version); a provenance mismatch
   re-probes. They run on the device named (default ``cuda``): with no
   card and no explicit ``device="cpu"`` they raise.

2. **Per-program attribution** (:func:`attribution` / :func:`summary`):
   from the cost record each `compile_cache.CompileCache` entry keeps
   (FLOPs counted by ``FlopCounterMode``, bytes accessed under the
   read-once model and the dominant dtype; `compile_cache`'s docstring),
   compute each observed lane's roofline bound (compute, bandwidth or
   comm), its floor time and the achieved MFU / MBU. Published as
   telemetry gauges (``step.mfu``, ``step.mbu``,
   ``serving.generation.tick_mbu``, ``*.host_gap_us``) and at
   ``/roofline``. FlopCounterMode does not see the port's own C++ ops
   (K1-K3) unless each registers a FLOP formula; none of the three
   observed lanes launches one, and a lane that does undercounts.

3. **Lane observations** (:func:`observe`): the instrumented hot paths
   (``Executor.fused_step``, ``Predictor._run``, the generation engine's
   tick) name the program that ran and pass its host wall time and, where
   they run on a card, a pair of CUDA events recorded around the replay.
   Host time there is enqueue time; device time is read from the events
   only in the pull-based :func:`summary`, so no call site waits on the
   card. The off cost is one attribute read a site
   (``observatory._enabled``).

Attribution math (the classic roofline, as in the JAX package):

* ``t_compute = flops / peak_flops(dtype)``
* ``t_memory  = bytes_accessed / peak_bytes_per_s``
* ``t_comm    = collective_bytes / peak_collective_bytes_per_s``
* ``predicted_floor_s = max(of the three)``; its argmax is the bound
* ``mfu = (flops / measured_s) / peak_flops`` and
  ``mbu = (bytes_accessed / measured_s) / peak_bytes_per_s``, where
  ``measured_s`` is the lane's median device time between its events
  (its host wall time where it has none).
"""
from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
import weakref

from . import telemetry
from .base import MXNetError, getenv, register_env

__all__ = ["enabled", "enable", "disable", "reset", "observe", "lanes",
           "host_gap", "peaks", "probe_verdict", "attribute", "attribution",
           "summary",
           "cached_summary", "SCHEMA_VERSION"]

register_env("MXNET_OBSERVATORY", False,
             "enable the roofline observatory: measured-peak probes and "
             "per-program MFU/MBU attribution (off: one attribute read per "
             "instrumented site)")
register_env("MXNET_OBSERVATORY_DIR", "",
             "directory for persisted peak-probe results (JSON per backend, "
             "device name and count, provenance-checked); unset = probe "
             "once per process")
register_env("MXNET_OBSERVATORY_PROBE_N", 0,
             "matmul probe dimension override (NxN); 0 = 8192 on a card, "
             "256 on the CPU")
register_env("MXNET_OBSERVATORY_PROBE_MB", 0,
             "copy-bandwidth probe buffer in MiB; 0 = 1024 on a card "
             "(past the L2 cache), 16 on the CPU")

SCHEMA_VERSION = 1
_EVENT_WINDOW = 32   # CUDA event pairs a lane keeps for its device time

_enabled = bool(getenv("MXNET_OBSERVATORY"))
_lock = threading.Lock()
_lanes = {}           # lane -> {"cache", "key", "wall_s", "count", ...}
_peaks = {}           # device type -> the probe result of this process
_probe_runs = 0       # times the probes actually ran (disk hits do not)
_last_summary = None  # the last summary (telemetry.snapshot embeds it)


def enabled():
    return _enabled


def enable(on=True):
    """Turn the observatory on or off. Enabling never probes: peaks are
    measured at the first :func:`peaks` call."""
    global _enabled
    _enabled = bool(on)
    return _enabled


def disable():
    return enable(False)


def reset(lane=None):
    """Drop observed lane timings (``lane=None``: all of them, and the
    cached summary built from them)."""
    global _last_summary
    with _lock:
        if lane is None:
            _lanes.clear()
            _last_summary = None
        else:
            _lanes.pop(lane, None)


# ---------------------------------------------------------------------------
# lane observations (the hot-path API: no probe, no sync)
# ---------------------------------------------------------------------------

_GAUGE_PREFIX = {"step": "step.", "serving": "serving.",
                 "generation.tick": "serving.generation.tick_"}


def _ewma_update(st, field, value, alpha=0.2):
    cur = st.get(field)
    st[field] = float(value) if cur is None else \
        (1.0 - alpha) * cur + alpha * float(value)
    mn = st.get(field + "_min")
    st[field + "_min"] = float(value) if mn is None else min(mn, float(value))


def observe(lane, cache=None, key=None, wall_s=None, events=None,
            exec_s=None):
    """Record one steady-state sample of ``lane``.

    ``cache`` / ``key`` name the program that ran (the `CompileCache`
    instance, held weakly, or its name); attribution reads its cost later,
    never here. ``wall_s`` is the host wall time of the step or tick.
    ``events`` is a ``(start, end)`` pair of timing CUDA events recorded
    around the replay; :func:`summary` reads their elapsed time.
    ``exec_s`` is a host window around the program alone (dispatch to its
    outputs waited for). Call sites gate on ``observatory._enabled``."""
    if not _enabled:
        return
    with _lock:
        st = _lanes.setdefault(lane, {"count": 0})
        if cache is not None:
            if isinstance(cache, str):
                st["cache"] = cache
                st.pop("_cache_ref", None)
            else:
                st["cache"] = cache.name
                st["_cache_ref"] = weakref.ref(cache)
            st["key"] = key
        if wall_s is not None:
            _ewma_update(st, "wall_s", wall_s)
            # the last walls, matched to the event window's steps
            st.setdefault("_walls", collections.deque(
                maxlen=_EVENT_WINDOW)).append(float(wall_s))
        if exec_s is not None:
            _ewma_update(st, "exec_s", exec_s)
        if events is not None:
            st.setdefault("_events", collections.deque(
                maxlen=_EVENT_WINDOW)).append(events)
        st["count"] += 1


def lanes():
    """Copy of the observed-lane table (private fields stripped)."""
    with _lock:
        return {k: {f: v for f, v in st.items() if not f.startswith("_")}
                for k, st in _lanes.items()}


def _device_seconds(pairs):
    """Median seconds between each pair's events (pairs whose end has not
    been recorded yet are skipped). Waits for the events: pull-side
    only."""
    times = []
    for start, end in list(pairs):
        try:
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        except RuntimeError:   # an event never recorded
            continue
    return _median(times)


def _median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else None


def host_gap(lane):
    """``(median wall, median device, their difference)`` in seconds over
    the last `_EVENT_WINDOW` samples of ``lane``: the same steps' walls
    and CUDA event windows, so the gap compares matched statistics.
    None where the lane has no walls or no events."""
    with _lock:
        st = _lanes.get(lane) or {}
        walls, pairs = list(st.get("_walls") or ()), \
            list(st.get("_events") or ())
    wall, device = _median(walls), _device_seconds(pairs)
    if wall is None or device is None:
        return None
    return wall, device, max(wall - device, 0.0)


# ---------------------------------------------------------------------------
# measured-peak probes
# ---------------------------------------------------------------------------


def _resolve(device):
    """``device`` (default ``cuda``) as a torch.device; a card asked for
    and absent raises: the probes never fall back to the CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("observatory: no CUDA device; pass device='cpu' to "
                         "probe the host")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _provenance(dev):
    import torch

    cuda = dev.type == "cuda"
    n = int(getenv("MXNET_OBSERVATORY_PROBE_N")) or (8192 if cuda else 256)
    mb = int(getenv("MXNET_OBSERVATORY_PROBE_MB")) or (1024 if cuda else 16)
    return {"schema_version": SCHEMA_VERSION,
            "backend": dev.type,
            "device_kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
            "device_count": torch.cuda.device_count() if cuda else 1,
            "probe_n": n, "probe_mb": mb, "torch": torch.__version__}


def _peaks_path(prov):
    d = getenv("MXNET_OBSERVATORY_DIR")
    if not d:
        return None
    slug = "".join(c if c.isalnum() else "-"
                   for c in str(prov["device_kind"]))[:48]
    return os.path.join(
        d, f"peaks_{prov['backend']}_{slug}_{prov['device_count']}.json")


def _min_seconds(fn, dev, reps=3):
    """Best of ``reps`` timings of ``fn()``: between CUDA events on a card,
    by the host clock on the CPU (after one warm-up call)."""
    import torch

    fn()
    best = math.inf
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
        best = min(best, dt)
    return max(best, 1e-9)


def _probe_matmul_flops(n, dtype, dev, chain=8):
    """FLOP/s of ``chain`` matmuls, each consuming the last one's result
    (fp32 with TF32 off)."""
    import torch

    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    a = (torch.randn(n, n, generator=g, device=dev) / n ** 0.5).to(dt)

    def run():
        out = a
        for _ in range(chain):
            out = torch.matmul(a, out)
        return out

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        secs = _min_seconds(run, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return 2.0 * n ** 3 * chain / secs


def _probe_copy_bandwidth(mb, dev):
    """Bytes/s of a device copy: each pass reads and writes the buffer."""
    import torch

    n = max(int(mb), 1) * (1 << 20) // 4
    src = torch.ones(n, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    return 2.0 * n * 4 / _min_seconds(lambda: dst.copy_(src), dev)


def _probe_collective_bandwidth(mb, dev):
    """All-reduce bytes/s per participant over the initialized
    `torch.distributed` group, or None with fewer than two ranks."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    if world < 2:
        return None
    n = max(int(mb), 1) * (1 << 20) // 4
    x = torch.ones(n, dtype=torch.float32, device=dev)
    secs = _min_seconds(lambda: dist.all_reduce(x), dev)
    return 2.0 * (world - 1) / world * n * 4 / secs


def _run_probes(prov, dev):
    global _probe_runs
    _probe_runs += 1
    n, mb = prov["probe_n"], prov["probe_mb"]
    flops = {dtype: _probe_matmul_flops(n, dtype, dev)
             for dtype in ("float32", "bfloat16")}
    return {"provenance": prov, "matmul_flops": flops,
            "hbm_bytes_per_s": _probe_copy_bandwidth(mb, dev),
            "collective_bytes_per_s": _probe_collective_bandwidth(mb, dev),
            "probed_unix": time.time(), "source": "measured"}


def peaks(refresh=False, device=None):
    """The measured peaks of ``device`` (default ``cuda``), probing at the
    first call. Cached in the process and, under ``MXNET_OBSERVATORY_DIR``,
    on disk keyed and checked by provenance; ``refresh=True`` probes
    again."""
    dev = _resolve(device)
    if dev.type in _peaks and not refresh:
        return _peaks[dev.type]
    prov = _provenance(dev)
    path = _peaks_path(prov)
    if path and not refresh:
        try:
            with open(path) as f:
                doc = json.load(f)
            if doc.get("provenance") == prov:
                doc["source"] = "disk"
                _peaks[dev.type] = doc
                return doc
        except (OSError, ValueError):
            pass
    doc = _run_probes(prov, dev)
    if path:
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = path + ".tmp~"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2)
            os.replace(tmp, path)
        except OSError:
            pass
    _peaks[dev.type] = doc
    return doc


def probe_verdict(pk=None):
    """One-line provenance: where the peaks came from and what they are."""
    if pk is None:
        pk = next(iter(_peaks.values()), None)
    if pk is None:
        return "unprobed"
    prov = pk["provenance"]
    return (f"{pk['source']}:{prov['backend']}/{prov['device_kind']}"
            f"x{prov['device_count']}")


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------


def attribute(flops, bytes_accessed, coll_bytes, pk,
              dtype="float32", wall_s=None, exec_s=None):
    """Pure roofline math over one program's counted work (the JAX
    package's, unchanged). Measured fields appear only with ``wall_s``;
    ``exec_s`` (the device-busy part of it) adds the host gap."""
    mf = pk.get("matmul_flops") or {}
    peak_flops = mf.get(dtype) or (max(mf.values()) if mf else None)
    hbm = pk.get("hbm_bytes_per_s")
    cbw = pk.get("collective_bytes_per_s")
    t_compute = (flops / peak_flops) if (flops and peak_flops) else 0.0
    t_memory = (bytes_accessed / hbm) if (bytes_accessed and hbm) else 0.0
    t_comm = (coll_bytes / cbw) if (coll_bytes and cbw) else 0.0
    floor = max(t_compute, t_memory, t_comm)
    if floor <= 0.0:
        bound = "unknown"
    elif floor == t_comm:
        bound = "comm"
    elif floor == t_memory:
        bound = "bandwidth"
    else:
        bound = "compute"
    out = {"flops": flops, "bytes_accessed": bytes_accessed,
           "collective_bytes": coll_bytes,
           "t_compute_s": t_compute, "t_memory_s": t_memory,
           "t_comm_s": t_comm,
           "predicted_floor_s": floor, "roofline_bound": bound,
           "peak_flops": peak_flops, "peak_hbm_bytes_per_s": hbm,
           "peak_collective_bytes_per_s": cbw, "dtype": dtype}
    if wall_s and wall_s > 0:
        out["measured_s"] = wall_s
        if peak_flops and flops:
            out["mfu"] = (flops / wall_s) / peak_flops
        if hbm and bytes_accessed:
            out["mbu"] = (bytes_accessed / wall_s) / hbm
        out["comm_fraction"] = (t_comm / floor) if floor > 0 else 0.0
        if floor > 0:
            out["measured_over_floor"] = wall_s / floor
        if exec_s is not None:
            out["host_gap_us"] = max(wall_s - exec_s, 0.0) * 1e6
    return out


def _find_cache(name, key=None):
    """The live CompileCache called ``name``, preferring the one holding
    ``key`` (names are shared: every engine owns a "generation" cache)."""
    from . import compile_cache

    first = None
    for c in compile_cache.all_caches():
        if c.name == name:
            if key is None or key in c._entries:
                return c
            if first is None:
                first = c
    return first


def attribution(lane, pk=None, device=None):
    """The roofline row of one observed lane, or None when it has no
    observation or no counted program. ``measured_s`` is the lane's median
    device time between its CUDA events, or where it has none (the CPU)
    its host wall time, else its program's host window; with a device
    time and walls, ``host_gap_us`` is the median wall minus the median
    device time over the same window of samples."""
    with _lock:
        st = dict(_lanes.get(lane) or {})
    cache_name, key = st.get("cache"), st.get("key")
    if cache_name is None:
        return None
    ref = st.get("_cache_ref")
    cache = ref() if ref is not None else None
    if cache is None:
        cache = _find_cache(cache_name, key)
    if cache is None:
        return None
    cost = cache.entry_cost(key)
    if not cost:
        return None
    device_s = _device_seconds(st.get("_events") or ())
    wall = st.get("wall_s")
    measured = next((v for v in (device_s, wall, st.get("exec_s"))
                     if v is not None), None)
    # no lane of the port counts its collectives into a program yet: the
    # comm term stays 0 (the dist.* byte counters hold them)
    row = attribute(cost["flops"], cost["bytes_accessed"], 0.0,
                    pk if pk is not None else peaks(device=device),
                    dtype=cache.entry_dtype(key), wall_s=measured)
    if device_s is not None:
        row["device_s"] = device_s
        wall_med = _median(st.get("_walls") or ())
        if wall_med is not None:
            row["wall_s"] = wall
            row["host_gap_us"] = max(wall_med - device_s, 0.0) * 1e6
    row["lane"] = lane
    row["cache"] = cache_name
    row["key"] = repr(key)
    row["samples"] = st.get("count", 0)
    return row


def _publish_gauges(lane, row):
    prefix = _GAUGE_PREFIX.get(lane, lane + ".")
    for field in ("mfu", "mbu", "comm_fraction", "host_gap_us"):
        v = row.get(field)
        if v is not None:
            telemetry.gauge(prefix + field).set(round(float(v), 6))


def summary(refresh_peaks=False, device=None):
    """The full report: measured peaks and one attribution row per
    observed lane, the gauges published as a side effect (the ``/roofline``
    body). ``{"enabled": False}`` when off."""
    global _last_summary
    if not _enabled:
        return {"enabled": False}
    pk = peaks(refresh=refresh_peaks, device=device)
    out = {"enabled": True, "schema_version": SCHEMA_VERSION,
           "probe_verdict": probe_verdict(pk), "peaks": pk, "lanes": {}}
    for lane in list(lanes()):
        try:
            row = attribution(lane, pk)
        except Exception:  # noqa: BLE001 - one broken lane must not
            continue       # take the report down
        if row is None:
            continue
        out["lanes"][lane] = row
        _publish_gauges(lane, row)

    def util(r):
        return r.get("mbu" if r.get("roofline_bound") == "bandwidth"
                     else "mfu") or 0.0

    out["worst"] = sorted(out["lanes"], key=lambda k: util(out["lanes"][k]))
    _last_summary = out
    return out


def cached_summary():
    """The last :func:`summary` (no probe, no event read)."""
    return _last_summary
