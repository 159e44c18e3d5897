"""The port's serving stack (`mxnet_tpu_torch.serving`: `Predictor`,
`DynamicBatcher`, `warmup`, the health probes) held to the JAX package's on
the CPU, from the same numpy inputs and weights.

Bounds: `Predictor` outputs against the JAX package's at rtol 1e-5 /
atol 1e-6 for the MLP and 1e-4 for the small ResNet v1 with ``TPU_FUSE``
(the serve phase's (d) bounds). A request coalesced by the batcher runs in
another bucket than the same request alone; torch's CPU GEMM, like cuDNN
on the card, need not give the same bits at two batch sizes (XLA:CPU
does, `test_serving.py:21-24`), so the batcher is held to direct
`predict` at `chip_smoke.SERVE_TOL` (rtol 1e-5 / atol 1e-6) where the JAX
test asks for bit equality. The batcher cases mirror
`tests/python/unittest/test_serving.py:87-585`; the probes
`test_health.py:383`. Everything runs on ``mx.cpu()``.
"""
import errno
import threading
import time

import numpy as np
import pytest

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import health, serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (DeadlineExceededError, DynamicBatcher,
                                     Predictor, QueueFullError,
                                     ServerClosedError)

CPU = mx.cpu()
DIM, CLASSES = cs.SERVE_MLP["dim"], cs.SERVE_MLP["classes"]
MLP_TOL = {"rtol": 1e-5, "atol": 1e-6}
CONV_TOL = {"rtol": 1e-4, "atol": 1e-4}
SIZE = cs.SERVE_SMALL["size"]


def _jax_mlp_params():
    return cs.numpy_params(cs.serve_mlp_module(jmx, jmx.cpu(), seed=7)
                           .get_params())[0]


PARAMS = _jax_mlp_params()


def _module(pkg=mx, params=PARAMS):
    ctx = CPU if pkg is mx else jmx.cpu()
    return cs.serve_mlp_module(pkg, ctx, params=params)


def _predictor(buckets=(2, 4, 8), **kwargs):
    return _module().as_predictor(buckets=buckets, **kwargs)


def _x(n, seed=0):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, DIM)).astype(np.float32)


def _close(a, b, tol=cs.SERVE_TOL):
    np.testing.assert_allclose(a, b, **tol)


@pytest.fixture(scope="module")
def small_prefix(tmp_path_factory):
    """The small ResNet v1, exported by the JAX package (moving stats
    drawn), loaded by both."""
    prefix = str(tmp_path_factory.mktemp("serve") / "small")
    cs.serve_small_export(jmx, prefix)
    return prefix


# ---------------------------------------------------------------------------
# Predictor against the JAX package
# ---------------------------------------------------------------------------


def test_predictor_mlp_matches_jax():
    """`Module.as_predictor` on both packages, 11 rows: chunks of 8 and 3
    (padded to 4) against the JAX package's."""
    got = _predictor().predict(_x(11)).asnumpy()
    want = _module(jmx).as_predictor(buckets=(2, 4, 8)).predict(
        _x(11)).asnumpy()
    assert got.shape == (11, CLASSES)
    _close(got, want, MLP_TOL)


def test_predictor_small_resnet_fused_matches_jax(small_prefix):
    """`Predictor.load` of a checkpoint the JAX package exported folds the
    same 9 chains on both packages, moves every moving stat from aux to
    arg, and serves the same outputs."""
    data = [("data", (1, 3, SIZE, SIZE))]
    pred = Predictor.load(small_prefix, 0, data_shapes=data,
                          buckets=cs.SERVE_SMALL["buckets"], ctx=CPU)
    ref = jmx.serving.Predictor.load(small_prefix, 0, data_shapes=data,
                                     buckets=cs.SERVE_SMALL["buckets"])
    ops = [n.op for n in pred._symbol._nodes() if n.op]
    assert ops.count("_fused_conv_bn_relu") == 9 and "BatchNorm" not in ops
    assert not pred._aux_params and not ref._aux_params
    assert sorted(pred._arg_params) == sorted(ref._arg_params)
    x = np.random.RandomState(2).uniform(
        -1, 1, (6, 3, SIZE, SIZE)).astype(np.float32)  # chunks of 4 and 2
    got = pred.predict(x).asnumpy()
    assert cs.output_std([got]) >= cs.SERVE_MIN_STD  # not a constant
    _close(got, ref.predict(x).asnumpy(), CONV_TOL)


def test_predictor_unfused_opt_out_matches_fused(small_prefix, monkeypatch):
    data = [("data", (1, 3, SIZE, SIZE))]
    fused = Predictor.load(small_prefix, 0, data_shapes=data, buckets=(4,),
                           ctx=CPU)
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "NONE")
    plain = Predictor.load(small_prefix, 0, data_shapes=data, buckets=(4,),
                           ctx=CPU)
    assert "BatchNorm" in [n.op for n in plain._symbol._nodes() if n.op]
    x = np.random.RandomState(3).uniform(
        -1, 1, (4, 3, SIZE, SIZE)).astype(np.float32)
    got = fused.predict(x).asnumpy()
    assert cs.output_std([got]) >= cs.SERVE_MIN_STD
    _close(got, plain.predict(x).asnumpy(), CONV_TOL)


def test_predictor_pads_and_chunks():
    pred = _predictor(buckets=(2, 4))
    X = _x(11, seed=3)
    got = pred.predict(X)                      # chunks 4+4+3 (padded to 4)
    assert got.shape == (11, CLASSES)
    per_row = np.concatenate(
        [pred.predict(X[i:i + 2]).asnumpy() for i in range(0, 10, 2)]
        + [pred.predict(X[10:11]).asnumpy()], axis=0)
    _close(got.asnumpy(), per_row)
    assert pred.stats()["bound"] == [2, 4]


def _bn_module(pkg, ctx):
    with pkg.name.NameManager():
        data = pkg.sym.Variable("data")
        bn = pkg.sym.BatchNorm(pkg.sym.FullyConnected(
            data, num_hidden=8, name="fc1"), name="bn")
        sym = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            bn, num_hidden=CLASSES, name="fc2"), name="softmax")
    mod = pkg.mod.Module(sym, context=ctx)
    mod.bind([("data", (4, DIM))], [("softmax_label", (4,))],
             for_training=False)
    mod.init_params(pkg.init.Xavier())
    return mod


def _missing_weight(pkg, mod):
    arg, aux = mod.get_params()
    arg.pop("fc2_weight")
    return (mod.symbol, arg, aux), {}, "fc2_weight"


def _missing_aux(pkg, mod):
    arg, _ = mod.get_params()
    return (mod.symbol, arg, {}), {}, "aux"


def _wrong_shape(pkg, mod):
    arg, aux = mod.get_params()
    arg["fc2_weight"] = pkg.nd.zeros((CLASSES, 9))
    return (mod.symbol, arg, aux), {"rows": 2}, "fc2_weight"


def _ragged(pkg, mod):
    arg, aux = mod.get_params()
    return (mod.symbol, arg, aux), {"ragged": True}, "ragged"


@pytest.mark.parametrize("case", [_missing_weight, _missing_aux,
                                  _wrong_shape, _ragged])
def test_predictor_errors_match_jax(case):
    """The four validation errors, raised by both packages with the same
    message: a missing weight, a missing aux state, a parameter of the
    wrong shape (at the bind of its first bucket) and a request whose
    data inputs have ragged row counts."""
    for pkg in (mx, jmx):
        ctx = mx.cpu() if pkg is mx else jmx.cpu()
        with ctx:
            (sym, arg, aux), how, match = case(pkg, _bn_module(pkg, ctx))
            err = MXNetError if pkg is mx else jmx.MXNetError
            if "rows" not in how and "ragged" not in how:
                with pytest.raises(err, match=match):
                    pkg.serving.Predictor(sym, arg, aux,
                                          data_shapes=[("data", (1, DIM))],
                                          buckets=(2,))
                continue
            data = [("data", (1, DIM))]
            if "ragged" in how:
                sym = pkg.sym.Group([sym, pkg.sym.Variable("extra") * 2])
                data.append(("extra", (1, 3)))
            pred = pkg.serving.Predictor(sym, arg, aux, data_shapes=data,
                                         buckets=(2,))
            request = ([_x(2), np.zeros((3, 3), np.float32)]
                       if "ragged" in how else _x(2))
            with pytest.raises(err, match=match):
                pred.predict(request)


def test_predictor_request_validation():
    pred = _predictor(buckets=(2, 4))
    with pytest.raises(MXNetError, match="0 rows"):
        pred.predict(np.zeros((0, DIM), np.float32))
    with pytest.raises(MXNetError, match="trailing shape"):
        pred.predict(np.zeros((2, DIM + 1), np.float32))
    with pytest.raises(MXNetError, match="not in ladder"):
        pred.warm_bucket(3)


def test_predictor_needs_a_card_unless_asked_for_the_cpu():
    mod = _module()
    with pytest.raises(MXNetError, match="no CUDA device"):
        Predictor(mod.symbol, *mod.get_params(),
                  data_shapes=[("data", (1, DIM))], ctx=mx.gpu(0))


def test_module_training_does_not_move_predictor():
    """`from_module` copies the weights: the module's arrays are written in
    place by a later init, a live predictor's are not."""
    mod = _module()
    pred = mod.as_predictor(buckets=(2,))
    X = _x(2, seed=9)
    before = pred.predict(X).asnumpy()
    mx.random.seed(123)
    mod.init_params(mx.init.Uniform(1.0), force_init=True)
    np.testing.assert_array_equal(before, pred.predict(X).asnumpy())


def test_warmup_builds_each_bucket_exactly_once():
    pred = _predictor(buckets=(2, 4, 8))
    assert pred.cache.misses == 0
    summary = serving.warmup(pred)
    assert summary["compiles"] == 3 and summary["cache_entries"] == 3
    assert serving.warmup(pred)["compiles"] == 0
    assert pred.cache.misses == 3 and pred._warmed
    with DynamicBatcher(pred, max_wait_ms=1) as srv:
        assert srv.warmup()["compiles"] == 0
        assert serving.warmup(srv)["compiles"] == 0
    with pytest.raises(TypeError):
        serving.warmup(object())


def test_cold_buckets_build_once_under_four_threads():
    """Four threads hitting every bucket of an unwarmed predictor at once
    build one program a bucket (on a card, one capture each: the serve
    phase's check (e))."""
    pred = _predictor(buckets=(2, 4, 8))
    start = threading.Barrier(4)
    outs = []

    def client(k):
        start.wait(timeout=30)
        for b in pred.buckets[k % 3:] + pred.buckets[:k % 3]:
            outs.append(pred.predict(_x(b, seed=b)).shape)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert len(outs) == 12 and pred.cache.misses == len(pred.cache) == 3


def test_swap_weights_writes_in_place_and_counts_versions():
    """A swap writes into the bound tensors every bucket reads (nothing is
    built again) and matches a predictor built on the new weights; a
    repeated version is a no-op; a partial set raises."""
    pred = _predictor(buckets=(2, 4))
    serving.warmup(pred)
    tensors = {k: v._data for k, v in pred._arg_params.items()}
    new = cs.numpy_params(cs.serve_mlp_module(mx, CPU, seed=99)
                          .get_params())[0]
    assert pred.swap_weights(new, {}, version=5) == 5
    assert pred.swap_weights(new, {}, version=5) is None
    assert all(pred._arg_params[k]._data is t for k, t in tensors.items())
    assert pred.cache.misses == 2
    X = _x(3, seed=4)
    want = _module(params=new).as_predictor(buckets=(2, 4)).predict(X)
    np.testing.assert_array_equal(pred.predict(X).asnumpy(), want.asnumpy())
    with pytest.raises(MXNetError, match="missing"):
        pred.swap_weights({"fc1_weight": new["fc1_weight"]})
    assert pred.weights_version == 5


# ---------------------------------------------------------------------------
# DynamicBatcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,buckets", [(3, (2, 4, 8)), (10, (2, 4))])
def test_batcher_roundtrip_and_oversize_gathered(rows, buckets):
    pred = _predictor(buckets=buckets)
    X = _x(rows, seed=11)
    ref = pred.predict(X).asnumpy()
    with DynamicBatcher(pred, max_wait_ms=1) as srv:
        got = srv.predict(X).asnumpy()
    assert got.shape == (rows, CLASSES)
    _close(got, ref)


def test_batcher_concurrent_threads():
    """4 threads x 12 ragged requests each: every caller gets its own rows
    back, and nothing is built after warm-up."""
    pred = _predictor(buckets=(2, 4, 8))
    serving.warmup(pred)
    rng = np.random.RandomState(1)
    payloads = {(t, i): rng.uniform(-1, 1, (1 + (t + i) % 8, DIM))
                .astype(np.float32) for t in range(4) for i in range(12)}
    refs = {k: pred.predict(v).asnumpy() for k, v in payloads.items()}
    got, lock = {}, threading.Lock()
    with DynamicBatcher(pred, max_wait_ms=1) as srv:
        def client(t):
            for i in range(12):
                out = (srv.predict if i % 2 else
                       lambda x: srv.submit(x).result(timeout=30))(
                    payloads[(t, i)]).asnumpy()
                with lock:
                    got[(t, i)] = out

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    assert len(got) == 48 and pred.cache.misses == 3
    for k, ref in refs.items():
        _close(got[k], ref)


class _Gate:
    """Blocks `Predictor._run` until released: a queue piles up behind a
    slow forward."""

    def __init__(self, pred):
        self.event = threading.Event()
        self._orig = pred._run
        pred._run = self._run

    def _run(self, bucket, arrays):
        self.event.wait(10)
        return self._orig(bucket, arrays)


def test_queue_full_fast_reject():
    pred = _predictor(buckets=(1,))            # max_batch 1: no coalescing
    serving.warmup(pred)
    gate = _Gate(pred)
    srv = DynamicBatcher(pred, max_wait_ms=1, max_queue=3)
    queued = []
    try:
        first = srv.submit(_x(1))              # the worker blocks on it
        deadline = time.monotonic() + 5
        with pytest.raises(QueueFullError):
            while time.monotonic() < deadline:
                queued.append(srv.submit(_x(1)))
    finally:
        gate.event.set()
        srv.close()
    assert first.result(timeout=10) is not None
    for f in queued:                           # admitted work was drained
        assert f.result(timeout=10) is not None


def test_deadline_in_queue():
    pred = _predictor(buckets=(1,))
    serving.warmup(pred)
    gate = _Gate(pred)
    srv = DynamicBatcher(pred, max_wait_ms=1)
    try:
        blocked = srv.submit(_x(1))            # occupies the worker
        doomed = srv.submit(_x(1), timeout=0.02)
        time.sleep(0.1)                        # let the deadline pass
    finally:
        gate.event.set()
        srv.close()
    assert blocked.result(timeout=10) is not None
    with pytest.raises(DeadlineExceededError):
        doomed.result(timeout=10)


def test_close_drains_then_rejects():
    pred = _predictor(buckets=(2, 4))
    serving.warmup(pred)
    srv = DynamicBatcher(pred, max_wait_ms=50)  # long window: close flushes
    futs = [srv.submit(_x(2, seed=i)) for i in range(5)]
    srv.close()
    for f in futs:
        assert f.result(timeout=10).shape == (2, CLASSES)
    with pytest.raises(ServerClosedError):
        srv.submit(_x(2))
    srv.close()                                # idempotent


def test_transient_error_retried():
    pred = _predictor(buckets=(2,))
    serving.warmup(pred)
    orig = pred._run
    state = {"failures": 1, "calls": 0}

    def flaky(bucket, arrays):
        state["calls"] += 1
        if state["failures"] > 0:
            state["failures"] -= 1
            raise OSError(errno.EIO, "injected transient executor failure")
        return orig(bucket, arrays)

    pred._run = flaky
    X = _x(2, seed=21)
    ref = orig(2, [mx.nd.array(X, ctx=CPU)])[0].asnumpy()
    with DynamicBatcher(pred, max_wait_ms=1, backoff_s=0.01) as srv:
        got = srv.predict(X).asnumpy()
    assert state["calls"] == 2                 # one failure + one retry
    np.testing.assert_array_equal(got, ref)


def test_no_retry_past_deadline():
    pred = _predictor(buckets=(2,))
    serving.warmup(pred)
    calls = {"n": 0}

    def always_fails(bucket, arrays):
        calls["n"] += 1
        raise OSError(errno.EIO, "injected")

    pred._run = always_fails
    with DynamicBatcher(pred, max_wait_ms=1, retries=5,
                        backoff_s=0.05) as srv:
        fut = srv.submit(_x(2), timeout=0.02)
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=10)
    assert calls["n"] == 1  # the deadline passed during the backoff


def test_overlap_lane_stages_full_flushes(monkeypatch):
    """With ``MXNET_OVERLAP`` on, a full flush queued behind the running
    one is staged between its dispatch and its wait; every request still
    gets its own rows. With it off the lane never stages."""
    for overlap in ("1", "0"):
        monkeypatch.setenv("MXNET_OVERLAP", overlap)
        pred = _predictor(buckets=(2, 4))
        serving.warmup(pred)
        staged = []
        with DynamicBatcher(pred, max_wait_ms=20) as srv:
            orig = srv._stage_next

            def stage():
                prep = orig()
                staged.append(prep is not None)
                return prep

            srv._stage_next = stage
            futs = [srv.submit(_x(4, seed=i)) for i in range(6)]
            outs = [f.result(timeout=10).asnumpy() for f in futs]
        for i, out in enumerate(outs):
            _close(out, pred.predict(_x(4, seed=i)).asnumpy())
        assert any(staged) == (overlap == "1")


# ---------------------------------------------------------------------------
# health probes
# ---------------------------------------------------------------------------


@pytest.fixture
def health_on():
    was = health.enabled()
    health.reset()
    health.enable()
    yield health
    health.reset()
    health.enable(was)


def test_batcher_probes_and_close_deregisters(health_on):
    """`test_health.py:383` on the port."""
    with mx.cpu():
        x = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(x, num_hidden=2, name="fc")
        pred = Predictor(net, {"fc_weight": mx.nd.ones((2, 4)),
                               "fc_bias": mx.nd.zeros(2)},
                         data_shapes=[("data", (1, 4))], buckets=(2, 4))
    assert not pred._warmed
    ok, probes = health.readiness()
    assert not ok and not probes[pred.health_name]["ok"]  # no warm-up
    pred.predict(mx.nd.ones((1, 4), ctx=CPU))  # traffic counts as warmed
    assert health.readiness()[1][pred.health_name]["ok"]
    pred._execs.clear()                        # back to cold
    with DynamicBatcher(pred) as srv:
        name = srv.health_name
        assert srv.healthy()[0] and health.liveness()[1][name]["ok"]
        assert not srv.ready()[0]              # predictor not warmed
        serving.warmup(pred)
        assert srv.ready()[0] and pred._warmed
        ok, probes = health.readiness()
        assert ok and probes[pred.health_name]["ok"] and probes[name]["ok"]
        pred.swap_weights({"fc_weight": np.zeros((2, 4), np.float32),
                           "fc_bias": np.ones(2, np.float32)})
    assert name not in health.readiness()[1]   # close() deregistered
    assert [e["version"] for e in health.events(kind="rollout_swap")] == [1]


def test_journal_filters_and_dead_or_failing_probes(health_on):
    """`health.events(n, kind)` keeps the newest ``n`` of a kind; a probe
    whose owner died drops out at the next read; a probe that raises
    reports not-ok; `unregister` removes both probes of a name."""
    for i in range(3):
        health.event("rollout_swap", version=i)
    health.event("rollout_reject", version=9)
    assert [e["version"] for e in health.events(2, kind="rollout_swap")] \
        == [1, 2]
    assert health.events(1)[0]["kind"] == "rollout_reject"

    class Owner:
        pass

    alive, dead = Owner(), Owner()
    health.register_readiness("t.alive", alive, lambda o: (True, "fine"))
    health.register_readiness("t.dead", dead, lambda o: True)
    health.register_liveness("t.raises", alive, lambda o: 1 / 0)
    del dead
    ok, probes = health.readiness()
    assert ok and probes == {"t.alive": {"ok": True, "detail": "fine"}}
    ok, probes = health.liveness()
    assert not ok and "ZeroDivisionError" in probes["t.raises"]["detail"]
    health.unregister("t.raises")
    health.unregister("t.alive")
    assert health.liveness() == (True, {}) \
        and health.readiness() == (True, {})


def test_probes_off_by_default_are_not_consulted():
    assert not health.enabled()
    pred = _predictor(buckets=(2,))
    assert health.readiness() == (True, {})
    assert not health.event("ignored")
    assert pred.health_name.startswith("serving.predictor.")


# ---------------------------------------------------------------------------
# the slice as a whole: the serve phase's probe on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_serving_probe_runs_on_both_packages(pkg):
    """`chip_smoke.serving_probe` (`bench.py:1132-1302`'s loop) over the
    bench MLP on each package, cut to 6 requests a client: warm-up builds
    one program a bucket and the loops none, the batcher agrees with
    direct `predict`, both swaps serve a fresh predictor's bits and
    `weights_version` ends at 2 (all checked inside the probe)."""
    m = jmx if pkg == "jax" else mx
    ctx = jmx.cpu() if pkg == "jax" else CPU
    pred = cs.serve_mlp_module(m, ctx, params=PARAMS).as_predictor(
        buckets=cs.SERVE_MLP["buckets"])
    weights_b = cs.numpy_params(
        cs.serve_mlp_module(m, ctx, seed=99).get_params())
    line = cs.serving_probe(m, pred, weights_b, per_client=6)
    assert line["requests"] == 24 and line["warmup_captures"] == 4
    assert line["steady_state_captures"] == line["swap_captures"] == 0
    assert 0 < line["fill_ratio"] <= 1
    assert line["weights_version"] == 2
