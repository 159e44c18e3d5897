"""Profiler: chrome://tracing JSON output with the device trace merged in.

The port of `mxnet_tpu/profiler.py` (parity `python/mxnet/profiler.py`:
set_config, start/stop, dump, dumps, the scoped Task/Frame/Event/Counter/
Marker objects).

Host scopes and per-op dispatch events (`record_op`, which
`ndarray.register.invoke_nd` calls while the profiler runs) are recorded
here as chrome-trace events, as in the JAX package. Where the JAX package
opened `jax.profiler` for the device trace, :func:`start` opens a
`torch.profiler` session (the CPU, and CUDA where a card is present) and
:func:`stop` closes it and keeps its chrome-trace events, their
timestamps moved onto the host events' clock (microseconds since the
epoch). :func:`dump` writes one file: the host events, the device trace
(the kernels by name), the span-tracing events, the telemetry counters
and the health journal.

Only one torch.profiler session can be open in a process, so `start`
raises while another is open; and a session must not be opened or closed
while another thread may replay a CUDA graph (close the engine or hold
its tick lock first).
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time

__all__ = ["set_config", "start", "stop", "dump", "dumps", "pause", "resume",
           "is_running", "device_events",
           "Task", "Frame", "Event", "Counter", "Marker", "scope",
           "record_op", "aggregate_stats", "dumps_aggregate",
           "dropped_events", "peek_json", "peek_doc"]

_config = {"filename": "profile.json", "profile_all": False, "aggregate_stats": False}
_events = []
_dropped = 0  # events discarded once _events hit max_events
_unmirrored = 0  # drops not yet flushed into the telemetry counter
_MAX_EVENTS_DEFAULT = 1 << 20
_lock = threading.Lock()
_running = False
_session = None        # the open torch.profiler session
_device_events = []    # the device trace of the sessions stopped since
                       # the last dump


def set_config(**kwargs):
    """Parity `profiler.py:33`. Recognized: filename, profile_(all|symbolic|
    imperative|memory|api), aggregate_stats, continuous_dump, max_events
    (event-buffer cap; overflow counts into `dropped_events()`)."""
    _config.update(kwargs)


def start(profile_process="worker"):
    """Start recording host events and open a `torch.profiler` session
    over the CPU and, where a card is present, CUDA."""
    global _running, _session
    import torch

    if _session is not None:
        raise RuntimeError("profiler.start: a session is already open")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    session = torch.profiler.profile(activities=acts)
    session.__enter__()
    _session = session
    _running = True


def stop(profile_process="worker"):
    """Stop recording; close the session and keep its device trace for
    the next :func:`dump`."""
    global _running, _session
    _running = False
    session, _session = _session, None
    if session is None:
        return
    session.__exit__(None, None, None)
    events = _session_events(session)
    with _lock:
        _device_events.extend(events)


def _session_events(session):
    """The session's chrome-trace events, their ``ts`` moved onto the
    epoch-microsecond clock of the host events."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        session.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    base = float(doc.get("baseTimeNanoseconds", 0)) / 1e3
    out = []
    for ev in doc.get("traceEvents", []):
        if base and "ts" in ev:
            ev = dict(ev, ts=float(ev["ts"]) + base)
        out.append(ev)
    return out


def device_events():
    """The device trace kept from the sessions stopped since the last
    dump (a copy)."""
    with _lock:
        return list(_device_events)


def pause(profile_process="worker"):
    global _running
    _running = False


def resume(profile_process="worker"):
    global _running
    _running = True


def _emit(name, ph, cat="host", ts=None, args=None, dur=None):
    global _dropped, _unmirrored
    if not _running:
        return
    ev = {"name": name, "ph": ph, "cat": cat, "pid": os.getpid(),
          "tid": threading.get_ident(), "ts": ts if ts is not None else time.time() * 1e6}
    if args:
        ev["args"] = args
    if dur is not None:
        ev["dur"] = dur
    with _lock:
        # bounded buffer: a profiler left running for a long job must not
        # eat the heap — overflow is counted, never silent. Only the
        # count moves here: once the buffer is full the drop path IS the
        # steady state, so it must not take the telemetry registry lock
        # per event — _mirror_drops() flushes the total at capture time
        if len(_events) >= _config.get("max_events", _MAX_EVENTS_DEFAULT):
            _dropped += 1
            _unmirrored += 1
            return
        _events.append(ev)


def is_running():
    return _running


def dropped_events():
    """Events discarded since the last reset because the buffer was full."""
    return _dropped


def record_op(name, dur_us, cat="dispatch"):
    """Record one op invocation of `dur_us` microseconds — the role of the
    engine's ProfileOperator wrap (`threaded_engine.h:353-362`), called by
    the nd dispatch layer when profiling is on. Default category is
    "dispatch": a launch on a card is asynchronous, so the duration is HOST
    dispatch cost, not device execution. The dispatch layer passes cat="operator"
    only when it actually blocked on the result (`profile_all` /
    `profile_sync`), making the label tell the truth about what was
    measured."""
    _emit(name, "X", cat, ts=time.time() * 1e6 - dur_us, dur=dur_us)


def aggregate_stats(events=None):
    """Per-name aggregate over recorded duration events: {category:
    {name: (count, total_ms, min_ms, max_ms)}} — the
    `aggregate_stats.cc` AggregateStats role. ``events`` aggregates a
    caller-captured snapshot (dumps() uses it to capture+reset atomically)
    instead of the live buffer."""
    stats = {}
    if events is None:
        with _lock:
            events = list(_events)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "host")
        ms = ev["dur"] / 1e3
        cnt, tot, mn, mx = stats.setdefault(cat, {}).get(
            ev["name"], (0, 0.0, float("inf"), 0.0))
        stats[cat][ev["name"]] = (cnt + 1, tot + ms, min(mn, ms), max(mx, ms))
    return stats


def dumps_aggregate(sort_by="total", ascending=False, events=None):
    """Render the aggregate per-op summary table — the terminal-readable
    output of the reference's `MXAggregateProfileStatsPrint`
    (`aggregate_stats.cc`). sort_by: total|avg|min|max|count."""
    key_idx = {"count": 0, "total": 1, "min": 2, "max": 3, "avg": 4}
    if sort_by not in key_idx:
        raise ValueError(f"sort_by must be one of {sorted(key_idx)}")
    lines = ["", "Profile Statistics:"]
    hdr = (f"{'Name':<40}{'Total Count':>12}{'Time (ms)':>14}"
           f"{'Min Time (ms)':>16}{'Max Time (ms)':>16}{'Avg Time (ms)':>16}")
    for cat, names in sorted(aggregate_stats(events).items()):
        lines.append("")
        lines.append(cat)
        lines.append("=" * len(cat))
        lines.append(hdr)
        lines.append(f"{'----':<40}{'-----------':>12}{'---------':>14}"
                     f"{'-------------':>16}{'-------------':>16}"
                     f"{'-------------':>16}")
        rows = []
        for name, (cnt, tot, mn, mx) in names.items():
            rows.append((name, cnt, tot, mn, mx, tot / cnt))
        idx = key_idx[sort_by]
        rows.sort(key=lambda r: r[1 + idx] if sort_by != "count" else r[1],
                  reverse=not ascending)
        for name, cnt, tot, mn, mx, avg in rows:
            lines.append(f"{name[:39]:<40}{cnt:>12}{tot:>14.4f}{mn:>16.4f}"
                         f"{mx:>16.4f}{avg:>16.4f}")
    return "\n".join(lines) + "\n"


def _reset_events():
    global _dropped
    _events.clear()
    _device_events.clear()
    _dropped = 0


def _mirror_drops():
    """Flush accumulated drop counts into the monotonic
    ``profiler.dropped_events`` telemetry counter — called at capture
    time (NOT per dropped event) so silent event loss still shows in
    every telemetry dump without the drop path taking the registry lock."""
    global _unmirrored
    with _lock:
        n = _unmirrored
        _unmirrored = 0
    if n:
        try:
            from . import telemetry

            telemetry.counter("profiler.dropped_events").inc(n)
        except Exception:  # noqa: BLE001
            pass


def _capture(reset=False):
    """Snapshot (events, dropped); ``reset`` clears the buffer in the SAME
    critical section, so an event emitted concurrently is either in this
    capture or in the next one — never silently dropped between two lock
    takes. Span-tracing events (`tracing`) and the device trace merge here so one
    trace file carries host scopes, op dispatch AND request/step span
    trees; on reset the tracing buffer is drained with the same
    exactly-once contract."""
    with _lock:
        events = list(_events) + list(_device_events)
        dropped = _dropped
        if reset:
            _reset_events()
    _mirror_drops()
    try:
        from . import tracing

        t_events, t_dropped = tracing.take_events(reset=reset)
        events = events + t_events
        dropped += t_dropped
    except Exception:  # noqa: BLE001 — the merge is additive
        pass
    return events, dropped


def _render_doc(events, dropped):
    """The chrome-trace document (dict) with the telemetry registry's
    counter events merged in (same timeline as the host scopes and the
    device trace) and the dropped-event count in otherData."""
    try:  # telemetry merge is additive — never break a dump
        from . import telemetry

        if telemetry._enabled and (events or _running):
            events = events + telemetry.trace_counter_events()
    except Exception:  # noqa: BLE001
        pass
    try:  # health journal merge: runtime events (evictions, drains,
        # watchdog firings) as chrome-trace instant marks on the same
        # timeline as spans and counters
        from . import health

        if health._enabled:
            events = events + health.trace_instant_events()
    except Exception:  # noqa: BLE001
        pass
    doc = {"traceEvents": events}
    other = {}
    if dropped:
        other["dropped_events"] = dropped
    # dist identity for tools/trace_merge.py: which worker wrote this dump
    wid = os.environ.get("MXNET_PROCESS_ID", os.environ.get("DMLC_WORKER_ID"))
    if wid is not None:
        other["worker"] = wid
    if other:
        doc["otherData"] = other
    return doc


def _render_trace(events, dropped):
    return json.dumps(_render_doc(events, dropped), indent=2)


def _trace_json(reset=False):
    return _render_trace(*_capture(reset))


def peek_doc():
    """The current buffer (host scopes + tracing spans + telemetry
    counters) as a chrome-trace dict WITHOUT consuming it — the telemetry
    HTTP endpoint's /trace read (serialize once, no parse-back)."""
    return _render_doc(*_capture(reset=False))


def peek_json():
    """:func:`peek_doc`, serialized."""
    return json.dumps(peek_doc(), indent=2)


def dumps(reset=False, sort_by="total", ascending=False):
    """Reference `profiler.py:151` dumps: the aggregate per-op table when
    `aggregate_stats=True` was configured, else the chrome-trace JSON."""
    if _config.get("aggregate_stats"):
        with _lock:
            evs = list(_events)
            if reset:
                _reset_events()
        _mirror_drops()
        return dumps_aggregate(sort_by, ascending, events=evs)
    return _trace_json(reset=reset)


def dump(finished=True, profile_process="worker"):
    """Write the chrome-trace JSON to the configured filename (the
    aggregate table is a dumps() view). ``finished=True`` (the default, the
    reference's contract) resets the event buffer after writing, so
    repeated dumps never duplicate events; ``finished=False`` is a
    continuous mid-run dump that keeps accumulating. A failed write puts
    the captured host events back — a bad filename must not destroy the
    trace (retry with a corrected set_config). An open session is closed
    first (its device trace exists only once it is), and a new one opened
    after, so a running profiler keeps running."""
    global _dropped
    if _session is not None:
        stop()
        start()
    fname = _config.get("filename", "profile.json")
    events, dropped = _capture(reset=finished)
    try:
        out = _render_trace(events, dropped)
        with open(fname, "w") as f:
            f.write(out)
    except BaseException:
        if finished:  # restore: the dump failed, the trace is NOT consumed
            with _lock:
                _events[:0] = events
                _dropped += dropped
        raise


class _Scoped:
    _cat = "host"

    def __init__(self, name, **kwargs):
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.time() * 1e6
        return self

    def stop(self):
        if self._t0 is not None:
            _emit(self.name, "X", self._cat, ts=self._t0, dur=time.time() * 1e6 - self._t0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()


class Task(_Scoped):
    _cat = "task"

    def __init__(self, domain=None, name="task"):
        super().__init__(name)


class Frame(_Scoped):
    _cat = "frame"

    def __init__(self, domain=None, name="frame"):
        super().__init__(name)


class Event(_Scoped):
    _cat = "event"


class Counter:
    def __init__(self, domain=None, name="counter", value=0):
        self.name = name
        self.value = value

    def set_value(self, value):
        self.value = value
        _emit(self.name, "C", "counter", args={"value": value})

    def increment(self, delta=1):
        self.set_value(self.value + delta)

    def decrement(self, delta=1):
        self.set_value(self.value - delta)

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self


class Marker:
    def __init__(self, domain=None, name="marker"):
        self.name = name

    def mark(self, scope="process"):
        _emit(self.name, "i", "marker", args={"scope": scope})


def scope(name="<unk>", append_mode=True):
    return Event(name)
