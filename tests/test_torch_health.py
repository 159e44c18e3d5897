"""The port's health layer (`mxnet_tpu_torch.health`: beacons, the stall
watchdog and its diagnostic bundle, the SLO tracker, the autoscale signal,
the journal and the HTTP endpoints) held to the JAX package's
(`mxnet_tpu.health`, after `tests/python/unittest/test_health.py`).

Beacons run on an injected clock: both modules' ``time`` is replaced by
one fake whose monotonic clock the test advances, so gaps, medians and
stall decisions are exact and nothing sleeps. The SLO trackers take the
same snapshots at the same instants. Tolerance: exact (counts, reports,
schemas); none of these tests reads a real clock for a decision.
"""
import json
import os
import subprocess
import sys
import time as _real_time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mxnet_tpu import health as jh
from mxnet_tpu import telemetry as jtel
from mxnet_tpu_torch import health as ph
from mxnet_tpu_torch import telemetry as ptel
from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig
from mxnet_tpu_torch.serving.generation import (GenerationEngine,
                                                GenerationRouter)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PAIRS = ((jh, jtel), (ph, ptel))


class _Clock:
    """A stand-in for the ``time`` module: the monotonic clock moves only
    when the test says; wall time and sleep pass through."""

    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t

    def time(self):
        return _real_time.time()

    def sleep(self, s):
        _real_time.sleep(s)

    def perf_counter(self):
        return _real_time.perf_counter()


@pytest.fixture(autouse=True)
def _fresh_health(monkeypatch):
    """Both layers and registries enabled over empty state, the monitor
    threads parked (a long watchdog interval, no SLO thread), and the
    state restored after."""
    monkeypatch.setenv("MXNET_HEALTH_WATCHDOG_S", "30")
    monkeypatch.setenv("MXNET_SLO_INTERVAL_S", "0")
    was = [(h.enabled(), t.enabled()) for h, t in PAIRS]
    for h, t in PAIRS:
        h.reset()
        t.reset()
        t.enable()
        h.enable()
    yield
    for (h, t), (wh, wt) in zip(PAIRS, was):
        h.reset()
        t.reset()
        h.enable(wh)
        t.enable(wt)


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for h, _ in PAIRS:
        monkeypatch.setattr(h, "time", c)
    return c


def _counter(tel, name):
    m = tel.get(name)
    return m.value if m is not None else 0


def test_journal_records_and_bounds():
    for h, tel in PAIRS:
        for i in range(600):
            h.event("spam", i=i)
    ends = [(len(h.events()), h.events()[0]["i"], h.events()[-1]["i"],
             _counter(tel, "health.events")) for h, tel in PAIRS]
    assert ends[1] == ends[0] == (512, 88, 599, 600)
    ph.disable()
    try:
        assert ph.event("nope") is None
    finally:
        ph.enable()


def test_beacon_gaps_stall_and_recovery(monkeypatch, tmp_path, clock):
    """Five touches 10 ms apart, then 120 ms of silence past max(3 x
    median, 50 ms): one stall, one bundle, one recovery, then a stall
    again, the same in both packages."""
    monkeypatch.setenv("MXNET_HEALTH_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_HEALTH_STALL_FACTOR", "3")
    monkeypatch.setenv("MXNET_HEALTH_STALL_FLOOR_S", "0.05")
    trails = []
    for h, tel in PAIRS:
        clock.t = 1000.0
        b = h.beacon("t.progress")
        b.arm()
        for _ in range(5):
            clock.t += 0.01
            b.touch()
        trail = [round(b.median_gap(), 9), h.check_beacons()]
        clock.t += 0.12
        trail.append([x.name for x in h.check_beacons()])
        trail.append((b.stalled, b.stall_count,
                      _counter(tel, "health.stalls")))
        trail.append(h.check_beacons())          # one-shot
        path = h.last_bundle()
        doc = json.load(open(path))
        trail.append((doc["reason"], doc["beacon"]["name"], sorted(doc)))
        assert os.path.exists(path + ".stacks.txt")
        assert any("test_torch_health" in "".join(f)
                   for f in doc["threads"].values())
        trail.append(b.touch())                  # recovery
        kinds = [e["kind"] for e in h.events()]
        trail.append(("watchdog_stall" in kinds,
                      "watchdog_recovered" in kinds))
        clock.t += 0.12
        trail.append([x.name for x in h.check_beacons()])
        snap = b.snapshot()
        trail.append(sorted(snap))
        trails.append(trail)
    assert trails[1] == trails[0]
    assert trails[1][2] == ["t.progress"] and trails[1][6] is True


def test_idle_and_rearmed_beacons_never_stall(monkeypatch, clock):
    monkeypatch.setenv("MXNET_HEALTH_STALL_FLOOR_S", "0.05")
    for h, _ in PAIRS:
        b = h.beacon("t.idle")
        b.arm()
        b.touch()
        b.idle()
        clock.t += 10.0
        assert h.check_beacons() == [] and not b.stalled
        b.arm()                                   # new work after idling
        assert h.check_beacons() == [] and b.silence() == 0.0


def test_slo_spec_parsing():
    spec = ("serving.e2e_us:p99<250ms; compile.cache_misses:rate<=0;"
            "step.total_us:p99<8*p50; q.depth:value>=2;x.lat:avg<1.5s;"
            "qos.ttft_us|tenant=acme:p95<40ms")

    def view(objs):
        return [(o.metric, o.stat, o.op, o.threshold, o.rel_stat, o.key)
                for o in objs]

    assert view(ph.parse_spec(spec)) == view(jh.parse_spec(spec))
    assert view(ph.parse_spec("")) == view(jh.parse_spec(""))
    for bad in ("nocolon", "m:p99<<1", "m:p99<abc", "m:weird<1"):
        for h, _ in PAIRS:
            with pytest.raises(ValueError):
                h.parse_spec(bad)


def _lat_snap(tel, lat_values, misses):
    tel.reset()
    hist = tel.histogram("t.lat_us")
    for v in lat_values:
        hist.record(v)
    tel.counter("t.misses").inc(misses)
    return tel.snapshot()


def test_slo_burn_and_exhaustion():
    """The same snapshots at the same instants: the trackers' reports,
    burn rates, exhaustion and gauges are the JAX package's."""
    reports = []
    for h, tel in PAIRS:
        tr = h.SloTracker(objectives=h.parse_spec(
            "t.lat_us:p99<2ms;t.misses:rate<=0"), windows=(1.0, 10.0),
            budget=0.5, grace_s=0.0)
        tr.started_at = 0.0
        out = [tr.evaluate(snap=_lat_snap(tel, [1000.0] * 50, 0),
                           now=1000.0)]
        for now, misses in ((1000.5, 3), (1000.8, 6), (1002.5, 9)):
            out.append(tr.evaluate(
                snap=_lat_snap(tel, [1000.0] * 50 + [9000.0] * 200, misses),
                now=now))
        out.append(tel.gauge("slo.t.lat_us_p99.ok").value)
        out.append(tr.exhausted)
        h._tracker = tr
        out.append(h.readiness())
        out.append(h.budget_ok())
        h._tracker = None
        reports.append(out)
    assert reports[1] == reports[0]
    last = reports[1][3]["objectives"][0]
    assert last["burn_short"] == pytest.approx(2.0) and not last["ok"]


def test_slo_rate_grace():
    reports = []
    for h, tel in PAIRS:
        tr = h.SloTracker(objectives=h.parse_spec("t.misses:rate<=0"),
                          windows=(1.0, 10.0), budget=0.5, grace_s=5.0)
        tr.started_at = 2000.0
        out = [tr.evaluate(snap=_lat_snap(tel, [], 0), now=2000.0),
               tr.evaluate(snap=_lat_snap(tel, [], 3), now=2000.5)]
        tr.grace_s = 0.0
        out.append(tr.evaluate(snap=_lat_snap(tel, [], 6), now=2001.0))
        reports.append(out)
    assert reports[1] == reports[0]
    assert reports[1][1]["in_grace"] and reports[1][1]["objectives"][0]["ok"]
    assert not reports[1][2]["objectives"][0]["ok"]


def test_slo_report_shape():
    keys = []
    for h, _ in PAIRS:
        rep = h.slo_report()
        keys.append((sorted(rep), sorted(rep["objectives"][0])))
        h.disable()
        assert h.slo_report() == {"enabled": False}
        h.enable()
    assert keys[1] == keys[0]


class _FakeEngine:
    def __init__(self, live, queued, slots=4):
        self.live_slots = live
        self.queue_depth = queued
        self.max_slots = slots


def test_autoscale_signal_and_callbacks(monkeypatch):
    monkeypatch.setenv("MXNET_HEALTH_TARGET_FILL", "0.75")
    got = []
    for h, tel in PAIRS:
        calls = []
        h.on_autoscale(lambda desired, info, calls=calls:
                       calls.append((desired, info)))
        out = [h.autoscale_signal([_FakeEngine(2, 0)]),
               tel.gauge("health.desired_engines").value,
               h.autoscale_signal([_FakeEngine(4, 7)]),
               h.autoscale_signal([_FakeEngine(4, 7)]),
               h.autoscale_signal([_FakeEngine(3, 1), _FakeEngine(4, 4)]),
               calls,
               [e["kind"] for e in h.events()].count("autoscale")]
        got.append(out)
    assert got[1] == got[0]
    assert got[1][:5] == [1, 1, 4, 4, 4]


def _lm():
    cfg = TransformerLMConfig(vocab_size=32, d_model=16, n_heads=2, d_ff=32,
                              n_layers=1, max_len=32, dtype="float32")
    torch.manual_seed(0)
    return TransformerLM(cfg, device="cpu")


def test_autoscale_from_registered_fleet_and_fit_beacon():
    """A router registers itself as a fleet; `fit` touches the
    ``fit.step`` beacon once a step."""
    import mxnet_tpu_torch as mx

    lm = _lm()
    engines = [GenerationEngine(lm, max_slots=2, max_len=32, buckets=(8,),
                                start=False) for _ in range(2)]
    router = GenerationRouter(engines)
    assert ph.autoscale_signal() == 1
    assert ph.slo_report()["desired_engines"] == 1
    router.close()
    with mx.cpu():
        x = mx.sym.Variable("data")
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            x, num_hidden=2, name="fc"), name="softmax")
        m = mx.mod.Module(net, context=mx.cpu())
        m.fit(mx.io.NDArrayIter(np.ones((12, 3), np.float32),
                                np.zeros(12, np.float32), batch_size=4),
              num_epoch=1)
    b = ph.beacons()["fit.step"]
    assert b.touches == 3 and not b.active


def test_engine_tick_beacon_and_http_endpoints():
    """The engine's tick beacon moves with its ticks and goes idle; the
    HTTP endpoints on a free localhost port answer as the JAX package's
    do, ``/readyz`` 503 while the beacon is stalled, and ``/memory``
    fails without a card rather than reporting the host."""
    eng = GenerationEngine(_lm(), max_slots=1, max_len=32, buckets=(8,),
                           start=False)
    eng.warm()
    out = eng.generate([1, 2, 3], max_new_tokens=3)
    assert len(out) == 3
    assert eng._beacon.touches >= 2 and not eng._beacon.active
    server = ptel.start_http_server(port=0)
    port = server.server_address[1]
    try:
        def get(path, raw=False):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                    body = r.read().decode()
                    return r.status, body if raw else json.loads(body)
            except urllib.error.HTTPError as e:
                return e.code, None

        code, body = get("/healthz")
        assert code == 200 and body["ok"] and body["health_enabled"]
        code, body = get("/readyz")
        assert code == 200 and body["probes"][eng.health_name]["ok"]
        eng._beacon.stalled = True
        code, _ = get("/readyz")
        assert code == 503
        eng._beacon.stalled = False
        code, body = get("/slo")
        assert code == 200 and body["enabled"] and "objectives" in body
        ph.event("endpoint_marker", x=1)
        code, body = get("/events")
        assert any(e["kind"] == "endpoint_marker" for e in body)
        code, text = get("/metrics", raw=True)
        assert code == 200 and "mxnet_serving_generation_tokens 3" in text
        code, body = get("/trace")
        assert code == 200 and "traceEvents" in body
        code, _ = get("/memory")
        assert code == (200 if torch.cuda.is_available() else 500)
        code, _ = get("/nope")
        assert code == 404
    finally:
        ptel.stop_http_server()
        eng.close()


def test_disabled_zero_overhead_subprocess():
    """A fresh interpreter with ``MXNET_HEALTH`` unset: generation and fit
    traffic start no monitor thread, journal nothing, never touch a
    beacon, and create no ``health.*`` metric."""
    code = r"""
import threading, numpy as np, torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import health, telemetry
from mxnet_tpu_torch.models import TransformerLM, TransformerLMConfig
from mxnet_tpu_torch.serving.generation import GenerationEngine
assert not health.enabled()
cfg = TransformerLMConfig(vocab_size=16, d_model=16, n_heads=2, d_ff=32,
                          n_layers=1, max_len=16, dtype="float32")
eng = GenerationEngine(TransformerLM(cfg, device="cpu"), max_slots=2,
                       max_len=16, buckets=(8,))
assert len(eng.generate([1, 2, 3], max_new_tokens=3)) == 3
eng.close()
assert not any("health" in t.name for t in threading.enumerate())
assert health.events() == []
assert eng._beacon.touches == 0 and not eng._beacon.active
assert "fit.step" not in health.beacons()
assert telemetry.get("health.stalls") is None
assert telemetry.get("health.events") is None
assert health.liveness() == (True, {}) and health.readiness() == (True, {})
print("HEALTH_OFF_OK")
"""
    env = dict(os.environ)
    for k in ("MXNET_HEALTH", "MXNET_TELEMETRY"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "HEALTH_OFF_OK" in r.stdout
