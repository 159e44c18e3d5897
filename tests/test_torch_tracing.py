"""The port's span tracing (`mxnet_tpu_torch.tracing`) held to the JAX
package's (`mxnet_tpu.tracing`, after
`tests/python/unittest/test_tracing.py`).

The same sequences run through both packages: span nesting, errors,
cross-thread attach, the deterministic trace id, the buffer cap, the
serving span trees on the small MLP Predictor (the worker path, the
caller-runs assist path and a split request) and `fit`'s step trees with
the flight recorder. Tolerance: exact for span names, tree shapes, counts
and ids; durations are only required to be the recorder's maximum.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx
from mxnet_tpu import tracing as jtr
from mxnet_tpu_torch import tracing as ptr

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DIM, CLASSES = 8, 4
REQUEST_STAGES = {"serving.admission", "serving.queue", "serving.execute",
                  "serving.reassembly"}
STEP_PHASES = {"step.data", "step.fwdbwd", "step.update", "step.sync"}


@pytest.fixture
def trc():
    """Tracing on in both packages, buffers and recorders reset before
    and after."""
    prev = (jtr.enabled(), ptr.enabled())
    for t in (jtr, ptr):
        t.enable()
        t.reset()
    yield
    for t, w in zip((jtr, ptr), prev):
        t.reset()
        t.enable(w)


def _spans(tr):
    return [e for e in tr.peek_events() if e.get("ph") == "X"]


def _by_trace(spans):
    out = {}
    for e in spans:
        out.setdefault(e["args"]["trace_id"], []).append(e)
    return out


def _assert_connected(spans):
    """Every parent_id resolves to a span of the same trace: no orphan."""
    for tid, group in _by_trace(spans).items():
        ids = {e["args"]["span_id"] for e in group}
        for e in group:
            p = e["args"].get("parent_id")
            assert p is None or p in ids, f"orphan {e['name']} in {tid}"


def _shape(tree):
    """A span tree's names, nested, without ids or times."""
    return (tree["name"], tuple(_shape(c) for c in tree.get("children", ())))


def test_span_nesting_and_parenting(trc):
    shapes, links = [], []
    for tr in (jtr, ptr):
        with tr.span("root", cat="t") as root:
            with tr.span("child"):
                with tr.span("grandchild"):
                    pass
            with tr.span("sibling"):
                pass
        shapes.append(_shape(root.tree()))
        spans = {e["name"]: e["args"] for e in _spans(tr)}
        links.append({n: (a.get("parent_id") and next(
            m for m, b in spans.items() if b["span_id"] == a["parent_id"]))
            for n, a in spans.items()})
        assert len({a["trace_id"] for a in spans.values()}) == 1
    assert shapes[1] == shapes[0]
    assert links[1] == links[0] == {"root": None, "child": "root",
                                    "grandchild": "child",
                                    "sibling": "root"}


def test_span_error_annotation(trc):
    errors = []
    for tr in (jtr, ptr):
        with pytest.raises(ValueError):
            with tr.span("boom"):
                raise ValueError("nope")
        (ev,) = _spans(tr)
        errors.append(ev["args"]["error"])
    assert errors[1] == errors[0] == repr(ValueError("nope"))


def test_inject_attach_across_thread(trc):
    for tr in (jtr, ptr):
        got = {}

        def far_side(carrier, tr=tr):
            with tr.attach(carrier):
                with tr.span("far") as sp:
                    got["ids"] = (sp.trace_id, sp.parent_id)

        with tr.span("near") as near:
            carrier = tr.inject()
            t = threading.Thread(target=far_side, args=(carrier,))
            t.start()
            t.join()
        assert set(carrier) == {"trace_id", "span_id"}
        assert got["ids"] == (near.trace_id, near.span_id)
        _assert_connected(_spans(tr))


def test_deterministic_trace_id():
    for parts in (("fit", 0, 7), ("fit", 3, 0), ("serve", "a", 1.5)):
        assert ptr.deterministic_trace_id(*parts) == \
            jtr.deterministic_trace_id(*parts)
    assert len(ptr.deterministic_trace_id("fit", 0, 7)) == 16


def test_explicit_trace_id_under_open_span_is_a_true_root(trc):
    det = ptr.deterministic_trace_id("fit", 0, 0)
    with ptr.span("experiment") as outer:
        with ptr.span("step", trace_id=det) as step:
            with ptr.span("step.child") as child:
                pass
    assert step.trace_id == det != outer.trace_id
    assert step.parent_id is None and child.parent_id == step.span_id


def test_buffer_cap_counts_drops(trc, monkeypatch):
    monkeypatch.setenv("MXNET_TRACING_MAX_EVENTS", "4")
    got = []
    for tr in (jtr, ptr):
        for i in range(8):
            with tr.span(f"s{i}"):
                pass
        events, dropped = tr.take_events()
        got.append(([e["name"] for e in events], dropped,
                    tr.dropped_events()))
    assert got[1] == got[0] == (["s0", "s1", "s2", "s3"], 4, 4)


# -- serving ------------------------------------------------------------------


def _mlp(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, num_hidden=CLASSES, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _x(n, seed=0):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, DIM)).astype(np.float32)


def _predictor(mx, buckets):
    """The MLP bound for inference with the same weights in both
    packages."""
    from mxnet_tpu.io.io import DataDesc as JDesc

    desc = JDesc if mx is jmx else pmx.io.DataDesc
    kw = {} if mx is jmx else {"context": pmx.cpu()}
    mod = mx.mod.Module(_mlp(mx), **kw)
    mod.bind([desc("data", (4, DIM))], [desc("softmax_label", (4,))],
             for_training=False)
    rng = np.random.RandomState(7)
    shapes = {"fc1_weight": (16, DIM), "fc1_bias": (16,),
              "fc2_weight": (CLASSES, 16), "fc2_bias": (CLASSES,)}
    ctx = {} if mx is jmx else {"ctx": pmx.cpu()}
    mod.set_params({n: mx.nd.array(rng.uniform(-1, 1, s).astype(np.float32),
                                   **ctx)
                    for n, s in shapes.items()}, {})
    return mod.as_predictor(buckets=buckets)


def _request_traces(tr):
    spans = _spans(tr)
    _assert_connected(spans)
    out = []
    for tid, group in _by_trace(spans).items():
        roots = [e for e in group if e["name"] == "serving.request"]
        if roots:
            assert len(roots) == 1, f"trace {tid} has {len(roots)} roots"
            # the stages a tree holds (how many batches ran it may vary)
            out.append(sorted({e["name"] for e in group}))
    return sorted(out)


def test_serving_request_span_trees_worker_path(trc):
    """Four async submits, computed by the worker: one complete tree a
    request, the same stages in both packages."""
    got = []
    for mx, tr in ((jmx, jtr), (pmx, ptr)):
        with mx.cpu(), mx.serving.DynamicBatcher(
                _predictor(mx, (2, 4, 8)), max_wait_ms=2.0) as b:
            b.warmup()
            tr.reset()
            for f in [b.submit(_x(2, seed=i)) for i in range(4)]:
                f.result(timeout=30)
        traces = _request_traces(tr)
        assert len(traces) == 4
        for names in traces:
            assert REQUEST_STAGES <= set(names)
        got.append(traces)
    assert got[1] == got[0]


def test_serving_span_trees_assist_path_and_no_leakage(trc):
    """Six blocking predicts from six threads (caller-runs assist): six
    traces, each with exactly one root and every stage."""
    for mx, tr in ((jmx, jtr), (pmx, ptr)):
        results = {}
        with mx.cpu(), mx.serving.DynamicBatcher(
                _predictor(mx, (2, 4, 8)), max_wait_ms=1.0) as b:
            b.warmup()
            tr.reset()

            def client(i, b=b, mx=mx):
                with mx.cpu():
                    results[i] = b.predict(_x(2, seed=i), timeout=30)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        assert len(results) == 6
        traces = _request_traces(tr)
        assert len(traces) == 6
        for names in traces:
            assert REQUEST_STAGES <= set(names)


def test_serving_split_request_single_tree(trc):
    """11 rows through a largest bucket of 4: one trace, one root, and the
    same number of execute spans in both packages."""
    execs = []
    for mx, tr in ((jmx, jtr), (pmx, ptr)):
        with mx.cpu(), mx.serving.DynamicBatcher(
                _predictor(mx, (2, 4)), max_wait_ms=1.0) as b:
            b.warmup()
            tr.reset()
            out = b.predict(_x(11, seed=3), timeout=30)
        assert out.shape == (11, CLASSES)
        spans = _spans(tr)
        _assert_connected(spans)
        (root,) = [e for e in spans if e["name"] == "serving.request"]
        execs.append(sum(e["name"] == "serving.execute"
                         for e in _by_trace(spans)[root["args"]["trace_id"]]))
    assert execs[1] == execs[0] >= 3


def test_serving_failure_finishes_span(trc):
    for mx, tr in ((jmx, jtr), (pmx, ptr)):
        with mx.cpu():
            b = mx.serving.DynamicBatcher(_predictor(mx, (2, 4)),
                                          max_wait_ms=1.0)
            b.warmup()
            b.close()
            tr.reset()
            with pytest.raises(mx.serving.ServerClosedError):
                b.submit(_x(2))
        (root,) = [e for e in _spans(tr) if e["name"] == "serving.request"]
        assert "ServerClosedError" in root["args"]["error"]


# -- fit ------------------------------------------------------------------------


def _fit(mx, steps=6, epochs=1, batch=8, callback=None):
    X = np.random.RandomState(3).uniform(
        -1, 1, (steps * batch, 10)).astype(np.float32)
    Y = (np.random.RandomState(4).uniform(0, 1, steps * batch) > 0.5
         ).astype(np.float32)
    x = mx.sym.Variable("data")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(x, num_hidden=2,
                                                     name="fc"),
                               name="softmax")
    with mx.cpu():
        m = mx.mod.Module(net, context=mx.cpu())
        m.fit(mx.io.NDArrayIter(X, Y, batch_size=batch), num_epoch=epochs,
              batch_end_callback=callback,
              optimizer_params=(("learning_rate", 0.1),))
    return m


def test_fit_step_span_trees_and_flight_recorder(trc):
    """Six steps: a tree a step under the deterministic id of (epoch,
    step), the same ids and span names in both packages; the flight
    recorder keeps the slowest step with its four phases and resets on
    read."""
    got = []
    for mx, tr in ((jmx, jtr), (pmx, ptr)):
        _fit(mx, steps=6)
        spans = _spans(tr)
        _assert_connected(spans)
        steps = [e for e in spans if e["name"] == "step"]
        assert len(steps) == 6
        trees = {}
        for root in steps:
            tid = root["args"]["trace_id"]
            assert tid == tr.deterministic_trace_id(
                "fit", root["args"]["epoch"], root["args"]["step"])
            trees[tid] = sorted(e["name"] for e in _by_trace(spans)[tid])
            assert STEP_PHASES <= set(trees[tid])
        worst = tr.flight_recorder.worst()
        assert worst["name"] == "step"
        assert STEP_PHASES <= {c["name"] for c in worst["children"]}
        assert worst["dur"] == pytest.approx(max(e["dur"] for e in steps))
        assert tr.flight_recorder.worst(reset=True) is not None
        assert tr.flight_recorder.worst() is None
        got.append(trees)
    assert got[1] == got[0]


def test_speedometer_surfaces_worst_step(trc, caplog):
    import logging

    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.callback import Speedometer

    prev = telemetry.enabled()
    telemetry.enable()
    try:
        with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.callback"):
            speedo = Speedometer(batch_size=8, frequent=3, auto_reset=False)
            _fit(pmx, steps=6, epochs=2, callback=speedo)
    finally:
        telemetry.reset()
        telemetry.enable(prev)
    assert speedo.worst_step is not None and \
        speedo.worst_step["name"] == "step"
    msgs = [r.getMessage() for r in caplog.records]
    assert any("worst-step" in m for m in msgs)
    assert any("step-p50" in m and "step-p99" in m for m in msgs)


def test_disabled_emits_nothing_and_allocates_nothing():
    """A fresh interpreter with ``MXNET_TRACING`` unset: every entry point
    returns the shared no-op span, serving and fit traffic emit no event,
    and the disabled calls allocate nothing (tracemalloc)."""
    code = r"""
import tracemalloc
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import tracing
assert not tracing.enabled()
s1 = tracing.span("x", cat="y", foo=1)
assert s1 is tracing.span("z")
with s1 as s:
    assert s.set(a=1) is s and s.child("c") is s
    assert s.tree() is None and s.finish() is None
assert tracing.inject() is None and tracing.emit_span("e", 0.0, 1.0) is None
with tracing.attach(None) as ctx:
    assert ctx is None
tracing.flow_start("f"); tracing.flow_end("f")
with mx.cpu():
    x = mx.sym.Variable("data")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(x, num_hidden=2,
                                                     name="fc"), name="softmax")
    m = mx.mod.Module(net, context=mx.cpu())
    X = np.ones((8, 3), np.float32); Y = np.zeros(8, np.float32)
    m.fit(mx.io.NDArrayIter(X, Y, batch_size=4), num_epoch=1)
    pred = m.as_predictor(buckets=(4,))
    with mx.serving.DynamicBatcher(pred) as b:
        b.predict(X[:3])
tracemalloc.start()
for _ in range(1000):
    with tracing.span("hot", cat="t", i=1):
        tracing.emit_span("e", 0.0, 1.0)
snap = tracemalloc.take_snapshot()
tracemalloc.stop()
mine = [s for s in snap.statistics("filename")
        if s.traceback[0].filename.endswith("tracing.py")]
assert mine == [], mine
assert tracing.take_events() == ([], 0)
assert tracing.flight_recorder.worst() is None
print("TRACING_OFF_OK")
"""
    env = dict(os.environ)
    env.pop("MXNET_TRACING", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "TRACING_OFF_OK" in r.stdout
