"""The port's telemetry registry (`mxnet_tpu_torch.telemetry`) held to the
JAX package's (`mxnet_tpu.telemetry`, after
`tests/python/unittest/test_telemetry.py`).

Each test drives the same sequence through both registries and compares
what comes out: snapshots, the schema, the Prometheus text, the table,
the dump file, and the ``kvstore.*`` series of one local push and pull.
Tolerance: exact (counts, schemas and text). Histograms here record fewer
samples than their reservoir holds, so their quantiles are exact too.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import telemetry as jtel
from mxnet_tpu_torch import kvstore as pkv
from mxnet_tpu_torch import telemetry as ptel

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def _fresh_registries():
    """Both registries enabled and empty; their state restored after."""
    was = (jtel.enabled(), ptel.enabled())
    for t in (jtel, ptel):
        t.reset()
        t.enable()
    yield
    for t, w in zip((jtel, ptel), was):
        t.reset()
        t.enable(w)


def _drive(tel):
    """One sequence of records: counters, gauges, labeled series,
    histograms, and the inputs of every derived ratio the port feeds."""
    tel.counter("t.requests").inc()
    tel.counter("t.requests").inc(4)
    tel.gauge("t.depth").set(7)
    tel.gauge("t.depth").inc(2)
    tel.gauge("t.depth").dec()
    tel.counter(tel.labeled("qos.admitted", tenant="acme", cls="gold")).inc(3)
    h = tel.histogram("t.lat_us")
    for v in (120.0, 80.0, 1500.0, 95.5, 300.0, 42.0, 999.0):
        h.record(v)
    tel.histogram("t.empty_us")
    for name, v in (("serving.batch_rows", 30), ("serving.batch_slots", 40),
                    ("compile.cache_hits", 9), ("compile.cache_misses", 3),
                    ("serving.generation.decode_tokens", 50),
                    ("serving.generation.tick_slots", 64),
                    ("serving.generation.spec.proposed", 40),
                    ("serving.generation.spec.accepted", 31),
                    ("serving.generation.spec.verified_slots", 10),
                    ("serving.generation.spec.committed", 41),
                    ("serving.generation.prefix.hits", 63),
                    ("serving.generation.prefix.misses", 1),
                    ("step.wall_us_total", 1000)):
        tel.counter(name).inc(v)


def _metrics(snap):
    return {k: snap[k] for k in ("counters", "gauges", "histograms",
                                 "derived")}


def test_snapshot_matches_the_jax_registry():
    _drive(jtel)
    _drive(ptel)
    js, ps = jtel.snapshot(), ptel.snapshot()
    assert _metrics(ps) == _metrics(js)
    assert ps["derived"]["serving.batch_fill_ratio"] == 0.75
    assert ps["histograms"]["t.empty_us"]["p50"] is None
    assert ptel.counter("t.requests") is ptel.get("t.requests")
    with pytest.raises(TypeError):
        ptel.gauge("t.requests")


def test_snapshot_schema_stability():
    """The snapshot keys and the histogram fields are the JAX package's
    (`test_telemetry.py::test_snapshot_schema_stability`), and so are a
    compile ledger row's."""
    from mxnet_tpu.compile_cache import CompileCache as JCache
    from mxnet_tpu_torch.compile_cache import CompileCache as PCache

    for tel, cache_cls in ((jtel, JCache), (ptel, PCache)):
        tel.counter("schema.c").inc(3)
        tel.gauge("schema.g").set(1.5)
        tel.histogram("schema.h").record(123.0)
        tel.histogram("schema.empty")
    jc, pc = JCache("schema_test"), PCache("schema_test")
    jc.get_or_build(("k",), lambda: (lambda: None))
    pc.get_or_build(("k",), lambda: (lambda: None))
    js, ps = jtel.snapshot(), ptel.snapshot()
    assert set(ps) == set(js)
    assert set(ps["histograms"]["schema.h"]) == \
        set(js["histograms"]["schema.h"])
    assert ps["histograms"]["schema.empty"] == \
        js["histograms"]["schema.empty"]
    assert set(ps["compile_caches"]["schema_test"]) == \
        set(js["compile_caches"]["schema_test"])
    for key in ("hits", "misses"):
        assert ps["compile_caches"]["schema_test"][key] == \
            js["compile_caches"]["schema_test"][key]
    json.loads(ptel.dumps())


def test_prom_text_matches_with_escaping():
    """The Prometheus text is the JAX package's, line for line, with
    hostile names, non-finite values, a string gauge (skipped), a
    quantile-less histogram and labeled families."""
    for tel in (jtel, ptel):
        _drive(tel)
        tel.counter('weird"metric\nwith\\stuff').inc(2)
        tel.gauge("g.inf").set(float("inf"))
        tel.gauge("g.nan").set(float("nan"))
        tel.gauge("g.string").set("not-a-number")
        tel.counter(tel.labeled("qos.admitted", tenant='a"b\nc')).inc()
        h = tel.Histogram("h.noquant", reservoir=0)
        with tel._registry_lock:
            tel._registry["h.noquant"] = h
        h.record(5.0)
    text = ptel.prom_text(refresh_memory=False)
    assert text == jtel.prom_text(refresh_memory=False)
    assert "None" not in text and "g_string" not in text
    assert 'tenant="a\\"b\\nc"' in text
    for value in ('a"b', "a\\b", "a\nb"):
        assert ptel._prom_label(value) == jtel._prom_label(value)


def test_dumps_table_matches():
    _drive(jtel)
    snap = jtel.snapshot()
    for sort_by in ("total", "count", "avg", "min", "max"):
        assert ptel.dumps_table(snap, sort_by=sort_by) == \
            jtel.dumps_table(snap, sort_by=sort_by)
    with pytest.raises(ValueError):
        ptel.dumps_table(snap, sort_by="bogus")


def test_atomic_dump(tmp_path):
    """`dump` writes through the temp-file, fsync and rename path and
    leaves no temp file; the file holds the snapshot's metrics."""
    _drive(ptel)
    path = ptel.dump(str(tmp_path / "telemetry.json"))
    doc = json.loads(open(path).read())
    assert not os.path.exists(path + ".tmp~")
    assert _metrics(doc) == _metrics(json.loads(ptel.dumps()))
    with pytest.raises(ValueError):
        ptel.dump("")


def test_kvstore_series_of_a_local_push_and_pull():
    """One local push of two device values and one pull: the same
    ``kvstore.*`` counts and byte totals in both packages."""
    jkv = jmx.kv.create("local")
    jkv.init("w", jmx.nd.ones((8, 4)))
    jkv.push("w", [jmx.nd.ones((8, 4)), jmx.nd.ones((8, 4))])
    jout = jmx.nd.zeros((8, 4))
    jkv.pull("w", out=[jout])
    pkvs = pkv.create("local")
    pkvs.init("w", torch.ones(8, 4))
    pkvs.push("w", [torch.ones(8, 4), torch.ones(8, 4)])
    pout = torch.zeros(8, 4)
    pkvs.pull("w", out=[pout])
    np.testing.assert_array_equal(pout.numpy(), jout.asnumpy())
    js, ps = jtel.snapshot(), ptel.snapshot()
    for name in ("kvstore.push_bytes", "kvstore.pull_bytes"):
        assert ps["counters"][name] == js["counters"][name]
    assert ps["counters"]["kvstore.push_bytes"] == 2 * 8 * 4 * 4
    for name in ("kvstore.push_us", "kvstore.pull_us"):
        assert ps["histograms"][name]["count"] == \
            js["histograms"][name]["count"] == 1


def test_disabled_registry_records_nothing_subprocess(tmp_path):
    """A fresh interpreter with ``MXNET_TELEMETRY`` unset: a checkpoint
    round trip, a kvstore push and pull and a Module fit record no metric
    but the always-on ``compile.*`` series, and start no thread."""
    code = r"""
import threading
import numpy as np, torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kvstore, telemetry
assert not telemetry.enabled()
with mx.cpu():
    mx.nd.save(%r, {"a": mx.nd.ones((2, 2))})
    mx.nd.load(%r)
    kv = kvstore.create("local")
    kv.init("w", torch.ones(4))
    kv.push("w", torch.ones(4))
    kv.pull("w", out=torch.zeros(4))
    x = mx.sym.Variable("data")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(x, num_hidden=2,
                                                     name="fc"), name="softmax")
    m = mx.mod.Module(net, context=mx.cpu())
    X = np.ones((8, 3), np.float32); Y = np.zeros(8, np.float32)
    m.fit(mx.io.NDArrayIter(X, Y, batch_size=4), num_epoch=1)
names = [n for n in telemetry._registry if not n.startswith("compile.")]
assert names == [], names
assert not any("telemetry" in t.name for t in threading.enumerate())
print("TELEMETRY_OFF_OK")
""" % (str(tmp_path / "a.params"), str(tmp_path / "a.params"))
    env = dict(os.environ)
    for k in ("MXNET_TELEMETRY", "MXNET_TELEMETRY_DUMP",
              "MXNET_TELEMETRY_HTTP_PORT"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "TELEMETRY_OFF_OK" in r.stdout
