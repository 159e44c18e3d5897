"""The port's overlap pipeline (``MXNET_OVERLAP``, `io/staging.py`) on the
CPU, held to the JAX package's `tests/python/unittest/test_overlap.py`:

* `fit` under ``MXNET_OVERLAP=1`` (staged feeds, deferred metric reads)
  trains BIT-equal parameters and equal epoch-end metrics to ``=0``, with
  SGD (momentum) and Adam, a short last batch included; and the trained
  parameters agree with the JAX package's `fit` from the same initial
  weights within the 1e-4 of the symbolic tests;
* the parity is not vacuous: the overlap lane is taken and stages every
  batch, each step's slot retired after its own metric read;
* the `DeviceStager` ring refuses work rather than reuse a live slot,
  matches batch identity, drops a slot whose guard fails and raises a
  failed preparation at `take` (the JAX package falls back to lockstep
  there; the port never does so by itself);
* the pad index is built once a bucket and its cache stays bounded;
* the serving batcher's stage-ahead lane is bit-exact against eager
  predictions in both modes, building nothing after warm-up;
* the generation tick's overlap order gives the lockstep order's streams,
  and the JAX engine's;
* a fit with the lock-order recorder on records no inversion or hazard;
* `PrefetchingIter` over `CSVIter` reads a temporary CSV file as the JAX
  package's iterators do.

The JAX package's ZeRO-1 and SPMD modes of the parity matrix have no
counterpart in the port yet (ROADMAP.md queue A, item A.7).
"""
import os
import threading

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import parallel as par
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import TransformerLMConfig as JaxConfig
from mxnet_tpu.serving.generation import GenerationEngine as JaxEngine
from mxnet_tpu_torch import analysis, compile_cache, serving, telemetry
from mxnet_tpu_torch.io import io as io_mod
from mxnet_tpu_torch.io import staging
from mxnet_tpu_torch.io.io import DataDesc
from mxnet_tpu_torch.models import (TransformerLM, TransformerLMConfig,
                                    params_from_jax)
from mxnet_tpu_torch.serving import DynamicBatcher
from mxnet_tpu_torch.serving.generation import GenerationEngine

DIM, CLASSES = 8, 4


class _env:
    """Scoped ``MXNET_OVERLAP`` (and the fused step on), every batch at
    least ``min_bytes`` staged (these tests' batches are small)."""

    def __init__(self, overlap, min_bytes=0):
        self.vals = {"MXNET_OVERLAP": "1" if overlap else "0",
                     "MXNET_FUSED_STEP": "1"}
        self.min_bytes = min_bytes

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.vals}
        os.environ.update(self.vals)
        self.old_min, staging.STAGE_MIN_BYTES = (staging.STAGE_MIN_BYTES,
                                                 self.min_bytes)
        return self

    def __exit__(self, *a):
        staging.STAGE_MIN_BYTES = self.old_min
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _mlp_symbol(sym):
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = sym.Activation(fc1, act_type="relu")
    fc2 = sym.FullyConnected(act, num_hidden=CLASSES, name="fc2")
    return sym.SoftmaxOutput(fc2, name="softmax")


def _init_weights():
    rng = np.random.RandomState(3)
    return {"fc1_weight": rng.normal(0, 0.3, (16, DIM)),
            "fc1_bias": rng.normal(0, 0.1, (16,)),
            "fc2_weight": rng.normal(0, 0.3, (CLASSES, 16)),
            "fc2_bias": rng.normal(0, 0.1, (CLASSES,))}


def _fit(overlap, optimizer="sgd", opt_kw=None, num_epoch=2, batch=8, n=40,
         pkg=mx, min_bytes=0):
    """One fit from fixed initial weights; returns (params, the metric at
    each epoch's last step)."""
    opt_kw = opt_kw or {"learning_rate": 0.1}
    rng = np.random.RandomState(0)
    X = rng.uniform(-1, 1, (n, DIM)).astype(np.float32)
    Y = rng.randint(0, CLASSES, (n,)).astype(np.float32)
    steps = -(-n // batch)
    metric_tail = []

    def on_batch(param):
        if param.nbatch == steps - 1:
            metric_tail.append(param.eval_metric.get_name_value())

    with _env(overlap, min_bytes), pkg.cpu():
        arg = {k: pkg.nd.array(v.astype(np.float32))
               for k, v in _init_weights().items()}
        it = pkg.io.NDArrayIter(X, Y, batch_size=batch, shuffle=False)
        m = pkg.mod.Module(_mlp_symbol(pkg.sym), context=pkg.cpu())
        m.fit(it, num_epoch=num_epoch, optimizer=optimizer,
              optimizer_params=tuple(opt_kw.items()), arg_params=arg,
              batch_end_callback=on_batch)
        arg_p, _ = m.get_params()
        return {k: v.asnumpy() for k, v in arg_p.items()}, metric_tail


@pytest.fixture
def tele():
    prev = telemetry.enabled()
    telemetry.enable()
    yield telemetry
    telemetry.enable(prev)


def _counter(name):
    m = telemetry.get(name)
    return m.value if m is not None else 0


_SGD = ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
_ADAM = ("adam", {"learning_rate": 0.01, "wd": 1e-4})


@pytest.mark.parametrize("optimizer,opt_kw,n", [
    pytest.param(*_SGD, 40, id="fused-sgd"),
    pytest.param(*_ADAM, 40, id="fused-adam"),
    pytest.param(*_SGD, 44, id="fused-sgd-short-last-batch"),
])
def test_fit_overlap_bit_exact_parity(optimizer, opt_kw, n):
    """Trained params BIT-equal and epoch-end metrics equal between the
    overlap and lockstep orders, and within 1e-4 of the JAX package's."""
    w_on, m_on = _fit(True, optimizer, opt_kw, n=n)
    w_off, m_off = _fit(False, optimizer, opt_kw, n=n)
    assert w_on.keys() == w_off.keys()
    for k in w_on:
        assert w_on[k].dtype == w_off[k].dtype, k
        assert np.array_equal(w_on[k], w_off[k]), k
    assert m_on == m_off and len(m_on) == 2
    w_jax, m_jax = _fit(True, optimizer, opt_kw, n=n, pkg=jmx)
    for k in w_on:
        np.testing.assert_allclose(w_on[k], w_jax[k], rtol=1e-4, atol=1e-4)
    for got, want in zip(m_on, m_jax):
        assert [name for name, _ in got] == [name for name, _ in want]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                                   rtol=1e-4, atol=1e-4)


def test_fit_overlap_runs_overlapped(tele):
    """Under ``=1`` the loop takes the deferred lane and consumes staged
    batches, and the derived pipeline ratios come out; under ``=0`` it
    takes no overlap step."""
    steps0 = _counter("overlap.steps")
    staged0 = _counter("overlap.staged_batches")
    _fit(True)
    assert _counter("overlap.steps") > steps0
    assert _counter("overlap.staged_batches") > staged0
    snap = telemetry.snapshot()
    assert 0.0 <= snap["derived"]["io.stage_wait_ratio"] <= 1.0
    assert 0.0 <= snap["derived"]["io.pipeline_stall_ratio"] <= 1.0
    s1 = _counter("overlap.steps")
    _fit(False)
    assert _counter("overlap.steps") == s1


def test_fit_stages_every_step_and_retires_its_own_slot(tele, monkeypatch):
    """Under ``=1`` with the fused step, every step of every epoch (its
    first included) takes a staged feed, the depth-2 ring never refuses
    one, and each retire frees the slot of the step whose metric was just
    read, while the next step's stays in flight."""
    retired = []
    real = staging.DeviceStager.retire

    def spy(self, batch=None):
        in_flight = [s.batch for s in self._slots if s.in_flight]
        ok = real(self, batch)
        retired.append((batch, in_flight, ok))
        return ok

    monkeypatch.setattr(staging.DeviceStager, "retire", spy)
    staged0 = _counter("overlap.staged_batches")
    full0 = _counter("io.stage_ring_full")
    _fit(True, *_SGD, n=40, batch=8, num_epoch=2)        # 5 steps an epoch
    assert _counter("overlap.staged_batches") - staged0 == 10
    assert _counter("io.stage_ring_full") == full0
    assert len(retired) == 10
    for batch, in_flight, ok in retired:
        assert ok and in_flight[0] is batch
    # mid-epoch, the step after the retired one is in flight beside it
    assert sum(len(f) == 2 for _, f, _ in retired) == 8


def test_fit_leaves_small_batches_to_the_lockstep_feed(tele):
    """A batch below `staging.STAGE_MIN_BYTES` is not staged (the
    lockstep feed costs less than the staging thread's hand-off); at the
    threshold it is. The params are the same either way."""
    staged0 = _counter("overlap.staged_batches")
    w_all, _ = _fit(True, *_SGD)
    staged1 = _counter("overlap.staged_batches")
    assert staged1 - staged0 == 10
    batch_bytes = 8 * (DIM + 1) * 4        # data and label, float32
    for floor, staged in ((batch_bytes + 1, 0), (batch_bytes, 10)):
        before = _counter("overlap.staged_batches")
        w, _ = _fit(True, *_SGD, min_bytes=floor)
        assert _counter("overlap.staged_batches") - before == staged
        for k in w_all:
            assert np.array_equal(w_all[k], w[k]), k


def test_pad_index_id_stable_and_bounded():
    """The wrap-around index of a (rows, batch) bucket is built once and
    reused; `pad_arrays` rides it; the cache stays bounded."""
    io_mod._PAD_INDEX_CACHE.clear()
    a = io_mod._pad_index(3, 8)
    assert io_mod._pad_index(3, 8) is a
    np.testing.assert_array_equal(a.numpy(), [0, 1, 2, 0, 1, 2, 0, 1])
    with mx.cpu():
        src = mx.nd.array(np.arange(6, dtype=np.float32).reshape(3, 2))
    (padded,), pad = io_mod.pad_arrays([src], 8)
    assert pad == 5 and padded.shape == (8, 2)
    np.testing.assert_array_equal(padded.asnumpy()[3:5], src.asnumpy()[:2])
    assert io_mod._pad_index(3, 8) is a
    for n in range(1, io_mod._PAD_INDEX_CACHE_MAX + 10):
        io_mod._pad_index(n, n + 1)
    assert len(io_mod._PAD_INDEX_CACHE) <= io_mod._PAD_INDEX_CACHE_MAX


def _prep(tag):
    return lambda put: ({"data": tag}, 0)


def test_stager_refuses_full_ring_never_recycles_in_flight(tele):
    """depth 2: with one slot staged and one in flight the ring REFUSES
    new work; retire frees exactly one."""
    st = staging.DeviceStager(name="test.stager", depth=2)
    try:
        b1, b2, b3 = object(), object(), object()
        full0 = _counter("io.stage_ring_full")
        assert st.stage(b1, _prep("f1")) and st.stage(b2, _prep("f2"))
        assert not st.stage(b3, _prep("f3"))
        assert _counter("io.stage_ring_full") == full0 + 1
        feed, pad = st.take(b1)
        assert feed == {"data": "f1"} and pad == 0
        assert st.occupancy() == (1, 1)
        assert not st.stage(b3, _prep("f3"))          # b1 still in flight
        assert st.retire()
        assert st.occupancy() == (1, 0)
        assert st.stage(b3, _prep("f3"))
        assert st.take(b2) is not None and st.take(b3) is not None
        assert st.retire() and st.retire() and not st.retire()
    finally:
        st.close()


def test_stager_identity_miss_guard_and_error(tele):
    """`take` matches the batch OBJECT; a failed guard drops the slot (a
    lockstep step); a failed preparation raises at `take`."""
    st = staging.DeviceStager(name="test.stager2", depth=2)
    try:
        fb0 = _counter("overlap.fallback_batches")
        b1 = object()
        assert st.stage(b1, _prep("f1"))
        assert st.take(object()) is None              # identity miss
        assert st.take(b1) is not None and st.retire()
        b2 = object()
        assert st.stage(b2, _prep("f2"), guard=lambda: False)
        assert st.take(b2) is None
        assert st.occupancy() == (0, 0)

        def boom(put):
            raise RuntimeError("prep failed")

        b3 = object()
        assert st.stage(b3, boom)
        with pytest.raises(RuntimeError, match="prep failed"):
            st.take(b3)
        assert st.occupancy() == (0, 0)
        assert _counter("overlap.fallback_batches") == fb0 + 1
    finally:
        st.close()


def test_stager_reuses_a_retired_slots_buffers_never_a_live_one(tele):
    """`put` writes into the ring's own buffers, cast to the asked dtype:
    a live slot's buffer is never handed to another slot, and a retired
    slot's is reused by the next one."""
    st = staging.DeviceStager(name="test.stager4", depth=2)

    def prep(val):
        return lambda put: ({"data": put(
            "data", np.full((4, 3), val, np.float64), torch.float32)}, 0)

    try:
        b = [object() for _ in range(4)]
        assert st.stage(b[0], prep(0)) and st.stage(b[1], prep(1))
        t0, t1 = st.take(b[0])[0]["data"], st.take(b[1])[0]["data"]
        assert t0.dtype == torch.float32 and t0.shape == (4, 3)
        assert float(t0[0, 0]) == 0 and float(t1[0, 0]) == 1
        assert t0.data_ptr() != t1.data_ptr()
        assert st.retire(b[0])
        assert st.stage(b[2], prep(2))
        t2 = st.take(b[2])[0]["data"]
        assert t2.data_ptr() == t0.data_ptr()          # b[0]'s set, reused
        assert float(t2[0, 0]) == 2 and float(t1[0, 0]) == 1
        assert st.retire(b[1]) and st.retire(b[2]) and not st.retire(b[3])
    finally:
        st.close()


def test_stager_close_is_terminal():
    st = staging.DeviceStager(name="test.stager3", depth=2)
    st.stage(object(), _prep("x"))
    st.close()
    assert not st.stage(object(), _prep("y"))
    assert st.occupancy() == (0, 0)


def test_batcher_overlap_flush_parity_zero_builds(tele):
    """Concurrent mixed-size requests through the stage-ahead batcher are
    bit-exact against eager predictions, overlap on and off, and build
    nothing after warm-up."""
    with mx.cpu():
        mod = mx.mod.Module(_mlp_symbol(mx.sym), context=mx.cpu())
        mod.bind([DataDesc("data", (4, DIM))],
                 [DataDesc("softmax_label", (4,))], for_training=False)
        mx.random.seed(7)
        mod.init_params(mx.init.Xavier())
        pred = mod.as_predictor(buckets=(2, 4, 8))
        serving.warmup(pred)
        rng = np.random.RandomState(42)
        sizes = [1, 2, 3, 4, 5, 7, 8, 1, 3, 8] * 3
        payloads = [rng.uniform(-1, 1, (s, DIM)).astype(np.float32)
                    for s in sizes]
        refs = [pred.predict(p).asnumpy() for p in payloads]
    for overlap in (True, False):
        with _env(overlap):
            built0 = compile_cache.named_stats("serving")["misses"]
            results = [None] * len(payloads)
            errors = []
            with DynamicBatcher(pred, max_wait_ms=2) as srv:
                def client(t):
                    try:
                        futs = [(i, srv.submit(payloads[i]))
                                for i in range(t, len(payloads), 4)]
                        for i, f in futs:
                            results[i] = f.result(timeout=60).asnumpy()
                    except Exception as e:  # noqa: BLE001
                        errors.append(e)

                threads = [threading.Thread(target=client, args=(t,))
                           for t in range(4)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
            assert not errors, errors
            assert compile_cache.named_stats("serving")["misses"] == built0
            for i, ref in enumerate(refs):
                assert np.array_equal(results[i], ref), i


def test_generation_overlap_token_parity():
    """The launch-then-bookkeep tick gives the lockstep tick's streams and
    the JAX engine's."""
    mesh = par.create_mesh(devices=jax.devices()[:1], dp=1)
    cfg = dict(vocab_size=32, d_model=16, n_heads=2, d_ff=32, n_layers=1,
               max_len=32, dtype="float32")
    jlm = JaxLM(JaxConfig(**cfg), mesh)
    jparams = jlm.init_params(jax.random.PRNGKey(0))
    lm = TransformerLM(TransformerLMConfig(**cfg), device="cpu")
    lm.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu"))
    prompts = [[1, 2, 3, 4], [5, 6], [7, 8, 9]]
    out = {}
    for overlap in (True, False):
        with _env(overlap):
            with GenerationEngine(lm, max_slots=2, max_len=32,
                                  buckets=(8,)) as eng:
                streams = [eng.submit(p, max_new_tokens=8) for p in prompts]
                out[overlap] = [s.result(timeout=300) for s in streams]
    with JaxEngine(jlm, jparams, max_slots=2, max_len=32,
                   buckets=(8,)) as jeng:
        want = [jeng.generate(p, max_new_tokens=8) for p in prompts]
    assert out[True] == out[False] == want


def test_overlap_debug_sync_clean():
    """The lock-order recorder on before any stager exists: an overlapped
    fit records no lock-order inversion and no blocking hazard."""
    was = analysis._enabled
    analysis.enable()
    analysis.reset()
    try:
        w_on, _ = _fit(True)
        assert w_on
        rep = analysis.report()
        assert rep["inversions"] == [], rep["inversions"]
        assert rep["hazards"] == [], rep["hazards"]
    finally:
        analysis.enable(was)
        analysis.reset()


def test_prefetching_csv_iter_matches_jax(tmp_path):
    """`PrefetchingIter` over a `CSVIter` on a temporary file gives the
    JAX package's batches, pads and shapes, epoch after epoch."""
    rng = np.random.RandomState(9)
    data = rng.uniform(-1, 1, (10, 6)).astype(np.float32)
    label = rng.randint(0, 3, (10,)).astype(np.float32)
    dpath, lpath = tmp_path / "data.csv", tmp_path / "label.csv"
    np.savetxt(dpath, data, delimiter=",")
    np.savetxt(lpath, label, delimiter=",")
    epochs = []
    for pkg in (mx, jmx):
        with pkg.cpu():
            from_pkg = pkg.io.io if pkg is jmx else io_mod
            it = from_pkg.PrefetchingIter(from_pkg.CSVIter(
                str(dpath), (2, 3), label_csv=str(lpath), batch_size=4))
            assert [(d.name, d.shape) for d in it.provide_data] == [
                ("data", (4, 2, 3))]
            got = []
            for _ in range(2):
                got.append([(b.data[0].asnumpy(), b.label[0].asnumpy(),
                             b.pad) for b in it])
                it.reset()
            epochs.append(got)
    port, ref = epochs
    assert len(port[0]) == len(ref[0]) == 3
    for pe, re_ in zip(port, ref):
        for (pd, pl, pp), (rd, rl, rp) in zip(pe, re_):
            assert np.array_equal(pd, rd) and np.array_equal(pl, rl)
            assert pp == rp
