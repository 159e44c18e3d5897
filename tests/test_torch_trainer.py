"""The port's gluon `Trainer` over a ``dist_sync`` kvstore
(`mxnet_tpu_torch.gluon`) held to the JAX package's on the CPU.

(a) One Dense layer, trained 4 steps by the JAX package's `gluon.Trainer`
    and by the port's, from the same weights and data: SGD and Adam, with and
    without 2-bit compression. Tolerance rtol 2e-4, atol 2e-5, the JAX
    package's own dist Trainer bound (`tests/dist/test_dist_kvstore.py`).
(b) The slice at a small size: a 2-layer fp32 `TransformerLM` (vocab 128,
    d_model 64), its weights drawn with numpy and cross-loaded with
    `params_from_jax`, trained 3 compressed Adam steps by the port's Trainer. The reference is the same step built from
    the JAX package's own parts (its ``dist_sync`` store with the same
    compression, per key push and pull, its Adam updater), fed the port's
    gradients, so a gradient's last-bit rounding cannot flip a code at the
    threshold. Every packed word is equal, and the parameters agree within
    1e-5 (the same fp32 updates, XLA contracting some into fused
    multiply-adds). Separately, the port's gradients of the summed loss are
    held to `jax.grad` of the JAX model's within 1e-4 (fp32, sums in another
    order).
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import gradient_compression as jgc
from mxnet_tpu import parallel as par
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import TransformerLMConfig as JaxConfig
from mxnet_tpu_torch import gradient_compression as tgc
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.kvstore import KVStoreLocal
from mxnet_tpu_torch.models import (TransformerLM, TransformerLMConfig,
                                    params_from_jax, params_to_jax)
from mxnet_tpu_torch.models.convert import jax_name
from mxnet_tpu_torch.parallel import KVStoreDistTPUSync

COMPRESSION = {"type": "2bit", "threshold": 0.5}


@pytest.fixture(autouse=True)
def _one_process(monkeypatch):
    """No coordinator in this process: dist stores are single-process."""
    for name in ("MXNET_COORDINATOR", "DMLC_PS_ROOT_URI"):
        monkeypatch.delenv(name, raising=False)


def _record_words(monkeypatch, cls, words):
    """Record every packed-word array a `GradientCompression` class hands
    out, as uint32 numpy, in call order."""
    real = cls.quantize

    def recorded(self, key, grad):
        packed = real(self, key, grad)
        arr = packed.numpy() if isinstance(packed, torch.Tensor) \
            else np.asarray(packed)
        words.append(arr.view(np.uint32).copy())
        return packed

    monkeypatch.setattr(cls, "quantize", recorded)


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["plain", "2bit"])
@pytest.mark.parametrize("opt,lr", [("sgd", 0.05), ("adam", 0.01)])
def test_dense_layer_trainer_matches_jax(opt, lr, compressed):
    rng = np.random.RandomState(7)
    w0 = rng.rand(3, 4).astype(np.float32)
    xs = rng.rand(4, 8, 4).astype(np.float32)
    ys = rng.rand(4, 8, 3).astype(np.float32)
    comp = COMPRESSION if compressed else None

    net = jgluon.nn.Dense(3, use_bias=False, in_units=4)
    net.initialize()
    net.weight.set_data(mx.nd.array(w0))
    jtrainer = jgluon.Trainer(net.collect_params(), opt,
                              {"learning_rate": lr}, kvstore="dist_sync",
                              compression_params=comp)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    trainer = Trainer([w, w], opt, {"learning_rate": lr},
                      kvstore="dist_sync", compression_params=comp)
    for x, y in zip(xs, ys):
        with jautograd.record():
            jloss = ((net(mx.nd.array(x)) - mx.nd.array(y)) ** 2).sum()
        jloss.backward()
        jtrainer.step(8)
        loss = ((torch.from_numpy(x) @ w.t() - torch.from_numpy(y)) ** 2).sum()
        loss.backward()
        trainer.step(8)
        assert w.grad is None  # stale until the next backward
    assert isinstance(trainer._kvstore, KVStoreDistTPUSync)
    assert not trainer._update_on_kvstore and len(trainer._params) == 1
    np.testing.assert_allclose(w.detach().numpy(), net.weight.data().asnumpy(),
                               rtol=2e-4, atol=2e-5)


def test_trainer_stale_gradient_and_inline_update():
    """A step without a fresh gradient raises, unless ignore_stale_grad;
    one device with a non-dist store updates inline, with no store."""
    w = torch.nn.Parameter(torch.ones(3))
    trainer = Trainer({"w": w}, "sgd", {"learning_rate": 0.5},
                      kvstore="device")
    (w * torch.arange(3.0)).sum().backward()
    trainer.step(1)
    assert trainer._kvstore is None
    np.testing.assert_allclose(w.detach().numpy(), [1.0, 0.5, 0.0])
    with pytest.raises(UserWarning, match="has not been updated"):
        trainer.step(1)
    trainer.step(1, ignore_stale_grad=True)
    np.testing.assert_allclose(w.detach().numpy(), [1.0, 0.5, 0.0])
    assert trainer.learning_rate == 0.5
    trainer.set_learning_rate(0.25)
    assert trainer.learning_rate == 0.25
    with pytest.raises(ValueError):
        Trainer([torch.ones(2)], "sgd")


def test_update_on_local_kvstore_matches_inline_update():
    """With a local store holding the optimizer (update_on_kvstore), the
    pulled weights equal an inline update's."""
    ws = [torch.nn.Parameter(torch.ones(4)) for _ in range(2)]
    trainers = [Trainer([ws[0]], "sgd", {"learning_rate": 0.1},
                        kvstore=KVStoreLocal(), update_on_kvstore=True),
                Trainer([ws[1]], "sgd", {"learning_rate": 0.1},
                        kvstore=None)]
    for w, trainer in zip(ws, trainers):
        for _ in range(2):
            (w * w).sum().backward()
            trainer.step(2)
    assert trainers[0]._update_on_kvstore
    np.testing.assert_array_equal(ws[0].detach().numpy(),
                                  ws[1].detach().numpy())


# d_ff = d_model: fewer distinct shapes, so fewer XLA compiles on the JAX side
SMALL = dict(vocab_size=128, d_model=64, n_heads=4, d_ff=64, n_layers=2,
             max_len=16, dtype="float32")
B, L = 2, 16


def test_small_transformer_compressed_dist_training_matches_jax(monkeypatch):
    mesh = par.create_mesh(devices=jax.devices()[:1], dp=1)
    jlm = JaxLM(JaxConfig(**SMALL), mesh)
    tlm = TransformerLM(TransformerLMConfig(**SMALL), device="cpu")
    # the JAX model's initialisation rule, drawn with numpy: scales one,
    # biases zero, matrices normal / sqrt(fan_in)
    rng = np.random.RandomState(2)
    np_params = {}
    for name, p in sorted(tlm.named_parameters()):
        if name.endswith("_scale"):
            arr = np.ones(p.shape, np.float32)
        elif name.endswith(("_bias", ".b1", ".b2")):
            arr = np.zeros(p.shape, np.float32)
        else:
            arr = (rng.standard_normal(p.shape)
                   / np.sqrt(p.shape[0])).astype(np.float32)
        np_params[jax_name(name)] = arr
    tlm.load_state_dict(params_from_jax(np_params, device="cpu"))
    toks = rng.randint(0, SMALL["vocab_size"], (B, L)).astype(np.int32)
    tgts = rng.randint(0, SMALL["vocab_size"], (B, L)).astype(np.int32)
    tt, tg = (torch.from_numpy(a).long() for a in (toks, tgts))

    port_words, ref_words = [], []
    _record_words(monkeypatch, tgc.GradientCompression, port_words)
    _record_words(monkeypatch, jgc.GradientCompression, ref_words)
    params = dict(tlm.named_parameters())
    names = sorted(params)  # the Trainer's key order
    trainer = Trainer(params, "adam", {"learning_rate": 1e-3},
                      kvstore="dist_sync", compression_params=COMPRESSION)

    jkv = mx.kv.create("dist_sync")
    jkv.set_gradient_compression(COMPRESSION)
    jupd = mx.optimizer.get_updater(mx.optimizer.create(
        "adam", learning_rate=1e-3, rescale_grad=1.0 / (B * L)))
    jw = [mx.nd.array(np_params[jax_name(n)]) for n in names]
    for i, w in enumerate(jw):
        jkv.init(i, w)
    with mesh:
        jgrad = jax.jit(jax.grad(
            lambda p: jlm.loss(p, toks, tgts) * (B * L)))

    for step in range(3):
        with mesh:
            want_grads = jgrad(params_to_jax(tlm))
        (tlm.loss(tt, tg) * (B * L)).backward()
        grads = {n: p.grad.numpy().copy() for n, p in params.items()}
        for n in names:
            np.testing.assert_allclose(
                grads[n], np.asarray(want_grads[jax_name(n)]), rtol=1e-4,
                atol=1e-4, err_msg=f"step {step} grad {n}")
        trainer.step(B * L)
        for i, n in enumerate(names):
            jkv.push(i, mx.nd.array(grads[n]))
            g = mx.nd.zeros(grads[n].shape)
            jkv.pull(i, out=g)
            jupd(i, g, jw[i])

    assert len(port_words) == len(ref_words) == 3 * len(names)
    fired = 0
    for k, (got, want) in enumerate(zip(port_words, ref_words)):
        np.testing.assert_array_equal(got, want, err_msg=names[k % len(names)])
        fired += int(np.count_nonzero(got))
    assert fired > 0  # some codes fired: the run trained something
    for n, w in zip(names, jw):
        np.testing.assert_allclose(params[n].detach().numpy(), w.asnumpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=n)
