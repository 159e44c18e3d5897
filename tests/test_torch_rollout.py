"""The port's weight rollout (`mxnet_tpu_torch.serving.rollout`, the
``publish`` fault point of `resilience`, `model.save_checkpoint`'s publish
hook, `Predictor.swap_weights`) on the CPU, mirroring
`tests/python/unittest/test_rollout.py:122-300` and `:525-556`. The port
has no telemetry yet, so a rejection is read from the health journal's
``rollout_reject`` events and their reasons.

Across the packages: a version published by either package is ingested by
the other's subscriber and swapped into its predictor, which then serves
what a predictor built on those weights serves (bit for bit within a
package; against the other package within the serve tests' rtol 1e-5 /
atol 1e-6).
"""
import os

import numpy as np
import pytest

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import health
from mxnet_tpu_torch import model as mdl
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import fault_scope
from mxnet_tpu_torch.serving import rollout

CPU = mx.cpu()
TOL = {"rtol": 1e-5, "atol": 1e-6}


def _weights(seed, shape=(3, 4)):
    return {"w": np.random.RandomState(seed).uniform(
        -1, 1, shape).astype(np.float32)}


@pytest.fixture
def journal():
    was = health.enabled()
    health.reset()
    health.enable()
    yield lambda: [e["reason"] for e in health.events(kind="rollout_reject")]
    health.reset()
    health.enable(was)


# ---------------------------------------------------------------------------
# publish / subscribe
# ---------------------------------------------------------------------------


def test_publish_subscribe_roundtrip(tmp_path):
    w = _weights(0)
    manifest = rollout.publish(tmp_path, 1, w, aux_params={"m": np.ones(2)},
                               source="test")
    assert manifest is not None and os.path.exists(manifest)
    assert rollout.list_versions(tmp_path) == [1]
    sub = rollout.RolloutSubscriber(tmp_path)
    ws = sub.poll()
    assert ws is not None and ws.version == 1 and sub.version == 1
    np.testing.assert_array_equal(ws.arg_params["w"], w["w"])
    np.testing.assert_array_equal(ws.aux_params["m"], np.ones(2))
    assert ws.refs == 1 and ws.acquire() is ws and not ws.release()
    assert sub.poll() is None          # nothing new


def test_double_publish_idempotent(tmp_path):
    w = _weights(0)
    assert rollout.publish(tmp_path, 1, w) is not None
    assert rollout.publish(tmp_path, 1, _weights(1)) is None   # no-op
    ws = rollout.RolloutSubscriber(tmp_path).poll()
    np.testing.assert_array_equal(ws.arg_params["w"], w["w"])  # first won


def test_retention_keeps_newest(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_ROLLOUT_KEEP", "2")
    for v in range(1, 6):
        rollout.publish(tmp_path, v, _weights(v))
    assert rollout.list_versions(tmp_path) == [4, 5]
    assert sorted(os.listdir(tmp_path)) == [
        "v000004.manifest.json", "v000004.params",
        "v000005.manifest.json", "v000005.params"]


def test_subscriber_takes_newest_of_burst(tmp_path):
    for v in (1, 2, 3):
        rollout.publish(tmp_path, v, _weights(v))
    sub = rollout.RolloutSubscriber(tmp_path)
    assert sub.poll().version == 3
    assert sub.poll() is None  # the superseded versions are handled


# ---------------------------------------------------------------------------
# publish faults -> reject and keep serving
# ---------------------------------------------------------------------------


def test_reject_torn_manifest(tmp_path, journal):
    rollout.publish(tmp_path, 1, _weights(1))
    sub = rollout.RolloutSubscriber(tmp_path)
    assert sub.poll().version == 1
    with fault_scope("point=publish,path=*.manifest.json,truncate=10"):
        rollout.publish(tmp_path, 2, _weights(2))
    assert sub.poll() is None and sub.version == 1
    assert sub.poll() is None          # handled once, not rejected again
    assert journal() == ["torn_manifest"]


def test_reject_corrupt_payload(tmp_path, journal):
    rollout.publish(tmp_path, 1, _weights(1))
    sub = rollout.RolloutSubscriber(tmp_path)
    assert sub.poll().version == 1
    with fault_scope("point=publish,path=*.manifest.json,error=CORRUPT"):
        rollout.publish(tmp_path, 2, _weights(2))
    assert sub.poll() is None and sub.version == 1
    assert journal() == ["corrupt_crc"]
    rollout.publish(tmp_path, 3, _weights(3))  # a good publish still lands
    assert sub.poll().version == 3


def test_reject_stale_version_stamp(tmp_path, journal):
    rollout.publish(tmp_path, 1, _weights(1))
    rollout.publish(tmp_path, 2, _weights(2))
    sub = rollout.RolloutSubscriber(tmp_path)
    assert sub.poll().version == 2
    with fault_scope("point=publish,path=*.manifest.json,error=STALE"):
        rollout.publish(tmp_path, 3, _weights(3))
    assert sub.poll() is None and sub.version == 2
    assert journal() == ["stale_version"]


def test_fault_spec_grammar():
    for bad in ("point=nowhere", "point=open,error=CORRUPT", "path=*",
                "point=publish,nth=x", "point=publish,color=red",
                "point=publish,error=ENOPE"):
        with pytest.raises(MXNetError, match="MXNET_FAULT_SPEC"):
            with fault_scope(bad):
                pass
        assert "MXNET_FAULT_SPEC" not in os.environ


def test_watcher_applies_and_survives_apply_errors(tmp_path):
    rollout.publish(tmp_path, 1, _weights(1))
    seen = []
    w = rollout.RolloutWatcher(tmp_path, seen.append, start=False)
    assert w.poll_once().version == 1 and seen[0].version == 1
    rollout.publish(tmp_path, 2, _weights(2))

    def boom(ws):
        raise RuntimeError("apply failed")

    w._apply = boom
    assert w.poll_once().version == 2          # the ingest happened
    w.close()


def test_watcher_thread_polls(tmp_path):
    seen = []
    with rollout.RolloutWatcher(tmp_path, seen.append, poll_s=0.01) as w:
        rollout.publish(tmp_path, 4, _weights(4))
        for _ in range(500):
            if seen:
                break
            w._stop.wait(0.01)
    assert [ws.version for ws in seen] == [4]
    assert not w._thread.is_alive()


# ---------------------------------------------------------------------------
# Predictor swaps
# ---------------------------------------------------------------------------


def _mlp(pkg, seed):
    ctx = CPU if pkg is mx else jmx.cpu()
    return cs.serve_mlp_module(pkg, ctx, seed=seed)


def _x(rows=4):
    return np.random.RandomState(0).uniform(
        -1, 1, (rows, cs.SERVE_MLP["dim"])).astype(np.float32)


def test_predictor_swap_from_weightset(tmp_path):
    """A published WeightSet swapped in: nothing built again, the bound
    tensors kept, the outputs those of a predictor built on the new
    weights, bit for bit."""
    pred = _mlp(mx, 7).as_predictor(buckets=(2, 4))
    y0 = pred.predict(_x()).asnumpy()
    m2 = _mlp(mx, 11)
    rollout.publish(tmp_path, 5, *cs.numpy_params(m2.get_params()))
    misses = pred.cache.misses
    assert pred.swap_weights(rollout.RolloutSubscriber(tmp_path).poll()) == 5
    y1 = pred.predict(_x()).asnumpy()
    assert pred.cache.misses == misses and not np.allclose(y0, y1)
    np.testing.assert_array_equal(
        y1, m2.as_predictor(buckets=(2, 4)).predict(_x()).asnumpy())


def test_predictor_swap_rejects_bad_shapes():
    pred = _mlp(mx, 7).as_predictor(buckets=(2,))
    arg, aux = cs.numpy_params(_mlp(mx, 8).get_params())
    arg["fc1_weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(MXNetError, match="fc1_weight"):
        pred.swap_weights(arg, aux)
    assert pred.weights_version == 0  # the failed swap committed nothing


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_cross_package_publish_ingest_swap(tmp_path, publisher):
    """A version one package publishes, the other ingests and swaps in; the
    swapped predictor serves what the publisher's own predictor on those
    weights serves."""
    pub, sub = (jmx, mx) if publisher == "jax" else (mx, jmx)
    m_new = _mlp(pub, 11)
    arg, aux = cs.numpy_params(m_new.get_params())
    pub.serving.rollout.publish(str(tmp_path), 3, arg, aux)
    pred = _mlp(sub, 7).as_predictor(buckets=(2, 4))
    ws = sub.serving.rollout.RolloutSubscriber(str(tmp_path)).poll()
    assert ws.version == 3 and sorted(ws.arg_params) == sorted(arg)
    assert pred.swap_weights(ws) == 3
    want = m_new.as_predictor(buckets=(2, 4)).predict(_x()).asnumpy()
    np.testing.assert_allclose(pred.predict(_x()).asnumpy(), want, **TOL)


def test_cross_package_swap_into_fused_predictor(tmp_path):
    """The JAX package publishes a conv net's checkpoint-layout weights
    (BatchNorm stats as aux); the port's ``TPU_FUSE`` predictor moves them
    into its folded arguments and serves what a fresh one does."""
    prefix = str(tmp_path / "small")
    arg, aux = cs.serve_small_export(jmx, prefix)
    size = cs.SERVE_SMALL["size"]
    data = [("data", (1, 3, size, size))]
    pred = mx.serving.Predictor.load(prefix, 0, data_shapes=data,
                                     buckets=(2,), ctx=CPU)
    rng = np.random.RandomState(1)
    arg2 = {k: (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
            for k, v in arg.items()}
    jmx.serving.rollout.publish(str(tmp_path / "rollout"), 1, arg2, aux)
    ws = rollout.RolloutSubscriber(str(tmp_path / "rollout")).poll()
    assert pred.swap_weights(ws) == 1
    x = rng.uniform(-1, 1, (2, 3, size, size)).astype(np.float32)
    fresh = cs.fresh_predictor(mx, pred, *cs.served_layout(pred, arg2, aux))
    got = pred.predict(x).asnumpy()
    assert cs.output_std([got]) >= cs.SERVE_MIN_STD  # not a constant
    np.testing.assert_array_equal(got, fresh.predict(x).asnumpy())


# ---------------------------------------------------------------------------
# train side: save_checkpoint's publish hook
# ---------------------------------------------------------------------------


def test_save_checkpoint_publishes(tmp_path, monkeypatch):
    rd = tmp_path / "rollout"
    monkeypatch.setenv("MXNET_ROLLOUT_DIR", str(rd))
    prefix = str(tmp_path / "ckpt")
    arg = {"w": mx.nd.array(np.arange(4, dtype=np.float32), ctx=CPU)}
    mdl.save_checkpoint(prefix, 2, None, arg, {})
    assert rollout.list_versions(rd) == [2]
    ws = rollout.RolloutSubscriber(rd).poll()
    assert ws.version == 2 and ws.source == str(rd / "v000002.params")
    np.testing.assert_array_equal(ws.arg_params["w"],
                                  np.arange(4, dtype=np.float32))
    mdl.save_checkpoint(prefix, 3, None, arg, {})
    assert rollout.list_versions(rd) == [2, 3]


def test_save_checkpoint_survives_publish_fault(tmp_path, monkeypatch,
                                                journal):
    """A sick rollout directory never stops the training loop."""
    rd = tmp_path / "rollout"
    monkeypatch.setenv("MXNET_ROLLOUT_DIR", str(rd))
    prefix = str(tmp_path / "ckpt")
    arg = {"w": mx.nd.array(np.ones(3, np.float32), ctx=CPU)}
    with fault_scope("point=publish,path=*.manifest.json,error=EIO"):
        mdl.save_checkpoint(prefix, 1, None, arg, {})   # must not raise
    assert [e["version"] for e in
            health.events(kind="rollout_publish_error")] == [1]
    _, a, _ = mdl.load_checkpoint(prefix, 1)
    np.testing.assert_array_equal(a["w"].asnumpy(), np.ones(3, np.float32))
    assert rollout.list_versions(rd) == []
