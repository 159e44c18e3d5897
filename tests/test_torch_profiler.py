"""The port's profiler (`mxnet_tpu_torch.profiler`) held to the JAX
package's (`mxnet_tpu.profiler`, after
`tests/python/unittest/test_profiler.py`).

The same op sequence runs through both packages with the profiler on; the
host event plane (per-op dispatch events from `invoke_nd`, the scoped
objects, the aggregate table, dump semantics, the event cap) must agree.
The port's `start` / `stop` also open and close a torch.profiler session,
whose device trace `dump` merges with the telemetry counters, the spans
and the health journal. Tolerance: exact for names, counts, categories
and dump contents; times are not compared.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx
from mxnet_tpu import profiler as jprof
from mxnet_tpu_torch import health, profiler as pprof, telemetry, tracing

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PAIRS = ((jmx, jprof), (pmx, pprof))


def _run_ops(mx):
    with mx.cpu():
        a = mx.nd.array(np.ones((8, 8), np.float32))
        for _ in range(3):
            b = mx.nd.dot(a, a)
        return mx.nd.relu(b)


@pytest.fixture(autouse=True)
def _clean():
    for _, prof in PAIRS:
        prof.dumps(reset=True)
    yield
    for _, prof in PAIRS:
        if getattr(prof, "_session", None) is not None:
            prof.stop()
        prof.set_config(aggregate_stats=False, profile_all=False,
                        max_events=prof._MAX_EVENTS_DEFAULT)
        prof.dumps(reset=True)


def _host(doc, cats=("dispatch", "operator", "task", "event", "counter",
                     "marker")):
    return [(e["name"], e["cat"]) for e in doc["traceEvents"]
            if e.get("cat") in cats]


def test_per_op_events_and_scopes_match(tmp_path):
    got = []
    for mx, prof in PAIRS:
        prof.set_config(filename=str(tmp_path / "p.json"))
        prof.start()
        _run_ops(mx)
        with prof.Task(name="mytask"):
            pass
        with prof.scope("myscope"):
            pass
        c = prof.Counter(name="ctr", value=1)
        c += 2
        prof.Marker(name="mark").mark()
        prof.stop()
        got.append(_host(json.loads(prof.dumps(reset=True))))
    assert got[1] == got[0]
    assert got[1].count(("dot", "dispatch")) == 3


def test_profile_all_labels_operator_time(tmp_path):
    for mx, prof in PAIRS:
        prof.set_config(filename=str(tmp_path / "p.json"), profile_all=True)
        prof.start()
        _run_ops(mx)
        prof.stop()
        doc = json.loads(prof.dumps(reset=True))
        assert {e["cat"] for e in doc["traceEvents"]
                if e["name"] == "dot"} == {"operator"}


def test_aggregate_table_matches(tmp_path):
    tables = []
    for mx, prof in PAIRS:
        prof.set_config(filename=str(tmp_path / "p.json"),
                        aggregate_stats=True)
        prof.start()
        _run_ops(mx)
        prof.stop()
        stats = prof.aggregate_stats()
        tables.append({cat: {n: v[0] for n, v in names.items()}
                       for cat, names in stats.items()})
        assert "Profile Statistics" in prof.dumps(reset=False)
        with pytest.raises(ValueError):
            prof.dumps_aggregate(sort_by="bogus")
        prof.dumps(reset=True)
        assert prof.aggregate_stats() == {}
    assert tables[1] == tables[0]
    assert tables[1]["dispatch"]["dot"] == 3


def test_off_records_nothing_and_dump_semantics(tmp_path):
    """Off: no event. ``dump()`` resets (no duplicate on a second dump),
    ``dump(finished=False)`` keeps accumulating, and a failed write keeps
    the trace, in both packages."""
    for mx, prof in PAIRS:
        _run_ops(mx)
        assert json.loads(prof.dumps())["traceEvents"] == []
        fname = tmp_path / f"{prof.__name__}.json"
        prof.set_config(filename=str(fname))
        prof.start()
        _run_ops(mx)
        prof.dump(finished=False)
        _run_ops(mx)
        prof.stop()
        prof.dump()
        final = json.loads(fname.read_text())["traceEvents"]
        assert sum(e["name"] == "dot" for e in final) == 6
        prof.dump()
        again = json.loads(fname.read_text())["traceEvents"]
        assert not [e for e in again if e["name"] == "dot"]
        prof.start()
        _run_ops(mx)
        prof.stop()
        prof.set_config(filename=str(tmp_path / "missing" / "p.json"))
        with pytest.raises(OSError):
            prof.dump()
        prof.set_config(filename=str(fname))
        prof.dump()
        assert [e for e in json.loads(fname.read_text())["traceEvents"]
                if e["name"] == "dot"]


def test_event_cap_counts_dropped(tmp_path):
    got = []
    for mx, prof in PAIRS:
        prof.set_config(filename=str(tmp_path / "p.json"), max_events=5)
        prof.start()
        _run_ops(mx)
        _run_ops(mx)
        prof.stop()
        dropped = prof.dropped_events()
        doc = json.loads(prof.dumps())
        host = _host(doc)
        got.append((dropped, len(host), doc["otherData"]["dropped_events"]))
        prof.dump()
        assert prof.dropped_events() == 0
    assert got[1] == got[0]


def test_dump_merges_device_trace_counters_spans_and_journal(tmp_path):
    """The port's dump holds the torch.profiler session's events (the
    CPU's aten ops here), the telemetry counters, the spans and the health
    journal, on the host events' clock."""
    prev = (telemetry.enabled(), tracing.enabled(), health.enabled())
    telemetry.enable()
    tracing.enable()
    health.enable()
    try:
        telemetry.counter("unit.marker").inc()
        pprof.set_config(filename=str(tmp_path / "p.json"))
        pprof.start()
        with pytest.raises(RuntimeError):
            pprof.start()                # one session at a time
        with tracing.span("unit.span"):
            _run_ops(pmx)
        health.event("unit_event")
        pprof.stop()
        assert pprof.device_events()
        pprof.dump()
        evs = json.loads((tmp_path / "p.json").read_text())["traceEvents"]
        names = {e.get("name") for e in evs}
        assert "telemetry/unit.marker" in names
        assert "unit.span" in names and "health/unit_event" in names
        assert any(e.get("cat") == "cpu_op" and e["name"] == "aten::mm"
                   for e in evs)
        host = [e["ts"] for e in evs if e.get("cat") == "dispatch"]
        dev = [e["ts"] for e in evs if e.get("cat") == "cpu_op"]
        # both planes on one clock: within a minute of each other
        assert abs(min(dev) - min(host)) < 60e6
        assert pprof.device_events() == []
    finally:
        telemetry.reset()
        tracing.reset()
        health.reset()
        telemetry.enable(prev[0])
        tracing.enable(prev[1])
        health.enable(prev[2])


def test_profiler_off_costs_nothing_subprocess():
    """A fresh interpreter that never starts the profiler: nd traffic
    records no event, opens no torch.profiler session and costs
    `invoke_nd` one attribute read (no host event buffer growth)."""
    code = r"""
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import profiler
with mx.cpu():
    a = mx.nd.array(np.ones((8, 8), np.float32))
    for _ in range(50):
        a = mx.nd.relu(mx.nd.dot(a, a))
assert not profiler.is_running() and profiler._session is None
assert profiler._events == [] and profiler.device_events() == []
assert profiler.dropped_events() == 0
print("PROFILER_OFF_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=dict(os.environ),
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "PROFILER_OFF_OK" in r.stdout
