"""The port's memory census (`mxnet_tpu_torch.memory`) held to the JAX
package's (`mxnet_tpu.memory`, after the census tests of
`tests/python/unittest/test_tracing.py`).

The same registrations go to both packages, and the census categories
must agree: known allocations, shared storages counted once, live
providers and their death, and what `Module.fit` registers (its weights
and its optimizer state). The port's census runs on the device named:
``device="cpu"`` here, and without a card the default (``cuda``) raises.
Tolerance: exact (bytes and buffer counts).
"""
import gc
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as pmx
from mxnet_tpu import memory as jmem
from mxnet_tpu_torch import memory as pmem
from mxnet_tpu_torch import telemetry as ptel
from mxnet_tpu_torch.base import MXNetError

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def _clear():
    jmem.clear()
    pmem.clear()
    yield
    jmem.clear()
    pmem.clear()


def _census(mem):
    kw = {"device": "cpu"} if mem is pmem else {}
    return {c: (v["total"], v["buffers"])
            for c, v in mem.census(**kw)["categories"].items()}


def test_known_allocations():
    keep = []
    for mx, mem in ((jmx, jmem), (pmx, pmem)):
        with mx.cpu():
            w = mx.nd.zeros((128, 32))
            g = mx.nd.zeros((64,))
        mem.track("weights", w)
        mem.track("gradients", [g])
        keep.append((w, g))
    assert _census(pmem) == _census(jmem)
    assert _census(pmem)["weights"] == (128 * 32 * 4, 1)
    assert ptel.get("memory.weights_bytes").value == 128 * 32 * 4
    with pytest.raises(ValueError):
        pmem.track("bogus", keep[1][0])


def test_shared_storages_count_once():
    """Two arrays over one storage count once; so does a view of part of
    it, at the storage's size."""
    from mxnet_tpu.ndarray import NDArray as JND
    from mxnet_tpu_torch.ndarray import NDArray as PND

    with jmx.cpu():
        jw = jmx.nd.ones((32, 32))
    with pmx.cpu():
        pw = pmx.nd.ones((32, 32))
    jmem.track("weights", [jw, JND(jw._data)])
    pmem.track("weights", [pw, PND(pw._data), PND(pw._data[:4])])
    assert _census(pmem)["weights"] == _census(jmem)["weights"] == \
        (32 * 32 * 4, 1)


def test_provider_live_view_and_death():
    class Owner:
        def __init__(self, mx):
            self.mx = mx
            with mx.cpu():
                self.bufs = [mx.nd.zeros((16,))]

    owners = [Owner(jmx), Owner(pmx)]
    for o, mem in zip(owners, (jmem, pmem)):
        mem.register_provider("optimizer_state", o, lambda s: s.bufs)
    assert _census(pmem) == _census(jmem)
    for o in owners:
        with o.mx.cpu():
            o.bufs.append(o.mx.nd.zeros((16,)))
    assert _census(pmem)["optimizer_state"] == \
        _census(jmem)["optimizer_state"] == (2 * 16 * 4, 2)
    del o, owners
    gc.collect()
    assert _census(pmem)["optimizer_state"] == (0, 0)


def test_fit_populates_weight_and_state_census():
    """A fit of one FullyConnected with SGD momentum: the weights and the
    momenta in the census, the same bytes in both packages."""
    X = np.random.RandomState(3).uniform(-1, 1, (32, 10)).astype(np.float32)
    Y = (np.random.RandomState(4).uniform(0, 1, 32) > 0.5).astype(np.float32)
    mods = []
    for mx in (jmx, pmx):
        with mx.cpu():
            x = mx.sym.Variable("data")
            net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
                x, num_hidden=4, name="fc"), name="softmax")
            m = mx.mod.Module(net, context=mx.cpu())
            m.fit(mx.io.NDArrayIter(X, Y, batch_size=8), num_epoch=1,
                  optimizer="sgd", optimizer_params=(("learning_rate", 0.1),
                                                     ("momentum", 0.9)))
        mods.append(m)
    j, p = _census(jmem), _census(pmem)
    for cat in ("weights", "optimizer_state"):
        assert p[cat] == j[cat]
    assert p["weights"][0] == (4 * 10 + 4) * 4
    assert p["optimizer_state"][0] == (4 * 10 + 4) * 4


def test_census_and_capacity_need_the_card_they_name():
    """No card and no explicit CPU request: the census raises instead of
    reporting the host; the CPU has no capacity (headroom unpublished)
    unless ``MXNET_DEVICE_HBM_BYTES`` gives one."""
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError):
            pmem.census()
        with pytest.raises(MXNetError):
            pmem.device_capacity_bytes()
    assert pmem.device_capacity_bytes("cpu") == 0
    assert "headroom_bytes" not in pmem.census(device="cpu")
    rows = pmem.executable_stats(device="cpu")
    assert "allocator" not in rows


def test_headroom_with_a_stated_capacity(monkeypatch):
    monkeypatch.setenv("MXNET_DEVICE_HBM_BYTES", str(1 << 20))
    with pmx.cpu():
        w = pmx.nd.zeros((256,))
    pmem.track("weights", w)
    snap = pmem.census(device="cpu")
    assert snap["capacity_bytes"] == 1 << 20
    assert snap["headroom_bytes"] == (1 << 20) - 1024
    assert ptel.get("memory.headroom_bytes").value == (1 << 20) - 1024


def test_registrations_cost_no_census_subprocess():
    """A fresh interpreter: fit and serving traffic register their views
    but never run a census (no ``memory.*`` gauge exists), and the
    registrations hold no buffer alive."""
    code = r"""
import gc
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import memory, telemetry
with mx.cpu():
    x = mx.sym.Variable("data")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(x, num_hidden=2,
                                                     name="fc"), name="softmax")
    m = mx.mod.Module(net, context=mx.cpu())
    X = np.ones((8, 3), np.float32); Y = np.zeros(8, np.float32)
    m.fit(mx.io.NDArrayIter(X, Y, batch_size=4), num_epoch=1)
    pred = m.as_predictor(buckets=(4,))
    pred.predict(X[:3])
assert not [n for n in telemetry._registry if n.startswith("memory.")]
del m, pred
gc.collect()
cats = memory.census(device="cpu")["categories"]
assert cats["weights"]["total"] == 0, cats
assert cats["optimizer_state"]["total"] == 0, cats
print("MEMORY_OFF_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=dict(os.environ),
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "MEMORY_OFF_OK" in r.stdout
