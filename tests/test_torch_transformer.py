"""The port's TransformerLM (`mxnet_tpu_torch.models`) held to the JAX
package's (`mxnet_tpu.models.transformer`) on the CPU, at a small size:
vocab 64, d_model 32, 4 heads, d_ff 64, 2 layers, L=16, fp32.

Both sides start from the same weights: the JAX model's `init_params`,
carried over by `params_from_jax`. The JAX side runs once with its Pallas
attention kernel in interpret mode and once on its default blockwise path.
Tolerances, fp32 throughout:
- logits and loss 1e-5: the two sides differ only in the order of fp32 sums
  (matmul blocking, softmax and LayerNorm reductions), a few ulp per layer;
- after 3 Adam steps, losses 1e-5 and parameters 1e-5: each update is
  lr * m_hat / (sqrt(v_hat) + eps), at most lr = 1e-3 in size, and a
  gradient's relative error of a few ulp moves it by far less than that.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import parallel as par
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import TransformerLMConfig as JaxConfig
from mxnet_tpu.ops import pallas_attention
from mxnet_tpu_torch import resolve_device
from mxnet_tpu_torch.models import (TransformerLM, TransformerLMConfig,
                                    params_from_jax, params_to_jax)
from mxnet_tpu_torch.models.convert import jax_name, port_name

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
             max_len=16, dtype="float32")
B, L = 2, 16
REPO = Path(__file__).resolve().parents[1]

ATTENTION_MODES = {
    "pallas_interpret": {"MXNET_PALLAS_ATTENTION": "1",
                         "MXNET_PALLAS_INTERPRET": "1"},
    "blockwise": {},
}


@pytest.fixture
def jax_attention_mode(request, monkeypatch):
    """Set the JAX package's attention switches for one mode, and check
    after the test that its Pallas kernel was traced in that mode only."""
    monkeypatch.delenv("MXNET_PALLAS_ATTENTION", raising=False)
    monkeypatch.delenv("MXNET_PALLAS_INTERPRET", raising=False)
    for key, val in ATTENTION_MODES[request.param].items():
        monkeypatch.setenv(key, val)
    traced = []
    real = pallas_attention._pallas_forward

    def counted(*args, **kwargs):
        traced.append(args[-1])  # the interpret flag
        return real(*args, **kwargs)

    monkeypatch.setattr(pallas_attention, "_pallas_forward", counted)
    yield request.param
    if request.param == "pallas_interpret":
        assert traced and all(traced)
    else:
        assert not traced


def _models():
    mesh = par.create_mesh(devices=jax.devices()[:1], dp=1)
    jlm = JaxLM(JaxConfig(**SMALL), mesh)
    jparams = jlm.init_params(jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    tlm = TransformerLM(TransformerLMConfig(**SMALL), device="cpu")
    tlm.load_state_dict(params_from_jax(np_params, device="cpu"))
    return mesh, jlm, jparams, tlm


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, SMALL["vocab_size"], (B, L)).astype(np.int32)
    tgts = rng.randint(0, SMALL["vocab_size"], (B, L)).astype(np.int32)
    return toks, tgts


@pytest.mark.parametrize("jax_attention_mode", list(ATTENTION_MODES),
                         indirect=True)
def test_forward_and_loss_match_jax(jax_attention_mode):
    mesh, jlm, jparams, tlm = _models()
    toks, tgts = _batch()
    with mesh:
        want_logits = np.asarray(jax.jit(jlm.forward)(jparams, toks))
        want_loss = float(jax.jit(jlm.loss)(jparams, toks, tgts))
    with torch.no_grad():
        tt = torch.from_numpy(toks).long()
        logits = tlm(tt)
        loss = float(tlm.loss(tt, torch.from_numpy(tgts).long()))
    assert logits.shape == (B, L, SMALL["vocab_size"])
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("jax_attention_mode", list(ATTENTION_MODES),
                         indirect=True)
def test_three_adam_steps_match_jax(jax_attention_mode):
    mesh, jlm, jparams, tlm = _models()
    toks, tgts = _batch(seed=1)
    jstep, jinit = jlm.make_train_step(lr=1e-3)
    jstate = jinit(jparams)
    step, init_opt = tlm.make_train_step(lr=1e-3)
    state = init_opt()
    tt, tg = (torch.from_numpy(x).long() for x in (toks, tgts))
    with mesh:
        jtoks, jtgts = jlm.shard_tokens(toks), jlm.shard_tokens(tgts)
        for i in range(3):
            jparams, jstate, jloss = jstep(jparams, jstate, jtoks, jtgts,
                                           jnp.asarray(i))
            loss = step(state, tt, tg, i)
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                       atol=1e-5, err_msg=f"step {i}")
    got = params_to_jax(tlm)
    assert set(got) == set(jparams)
    for name, want in jparams.items():
        np.testing.assert_allclose(got[name], np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_bf16_forward_tracks_jax():
    """The compute dtype the card runs: both sides round every matmul and
    LayerNorm output to bf16, at places that differ, so logits agree to a
    few bf16 ulp of their size (~0.5 here), not bit for bit."""
    cfg = dict(SMALL, dtype="bfloat16")
    mesh = par.create_mesh(devices=jax.devices()[:1], dp=1)
    jlm = JaxLM(JaxConfig(**cfg), mesh)
    jparams = jlm.init_params(jax.random.PRNGKey(0))
    tlm = TransformerLM(TransformerLMConfig(**cfg), device="cpu")
    tlm.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu"))
    toks, _ = _batch()
    with mesh:
        want = np.asarray(jax.jit(jlm.forward)(jparams, toks), np.float32)
    with torch.no_grad():
        got = tlm(torch.from_numpy(toks).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_through_the_port(dtype):
    jlm = JaxLM(JaxConfig(**dict(SMALL, dtype=dtype)),
                par.create_mesh(devices=jax.devices()[:1], dp=1))
    np_params = {k: np.asarray(v)
                 for k, v in jlm.init_params(jax.random.PRNGKey(3)).items()}
    state = params_from_jax(np_params, device="cpu")
    assert {port_name(k) for k in np_params} == set(state)
    assert state["layers.1.wqkv"].shape == (32, 96)
    assert all(t.dtype == getattr(torch, dtype) for t in state.values())
    tlm = TransformerLM(TransformerLMConfig(**dict(SMALL, dtype=dtype)),
                        device="cpu")
    tlm.load_state_dict(state)
    back = params_to_jax(tlm)
    assert set(back) == set(np_params)
    for name, arr in np_params.items():
        np.testing.assert_array_equal(back[name], arr.astype(np.float32),
                                      err_msg=name)


@pytest.mark.parametrize("jax_key,port_key", [
    ("l0.wqkv", "layers.0.wqkv"), ("l11.ln2_bias", "layers.11.ln2_bias"),
    ("embed", "embed"), ("ln_f_scale", "ln_f_scale"),
    ("pos_embed", "pos_embed")])
def test_parameter_names_map_both_ways(jax_key, port_key):
    assert port_name(jax_key) == port_key
    assert jax_name(port_key) == jax_key


def test_params_from_jax_dtype_cast():
    state = params_from_jax({"embed": np.ones((4, 2), np.float32)},
                            device="cpu", dtype=torch.bfloat16)
    assert state["embed"].dtype == torch.bfloat16


def test_init_params_follows_the_jax_rule():
    tlm = TransformerLM(TransformerLMConfig(**SMALL), device="cpu",
                        generator=torch.Generator().manual_seed(1))
    sd = tlm.state_dict()
    assert torch.equal(sd["layers.0.ln1_scale"], torch.ones(32))
    assert torch.equal(sd["layers.1.b1"], torch.zeros(64))
    assert torch.equal(sd["ln_f_bias"], torch.zeros(32))
    # normal / sqrt(fan_in): std ~ 1/sqrt(32) for a [32, 2048*...] matrix
    w1 = sd["layers.0.w1"]
    assert abs(float(w1.std()) * np.sqrt(32) - 1) < 0.1
    again = TransformerLM(TransformerLMConfig(**SMALL), device="cpu",
                          generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in
               zip(sd.values(), again.state_dict().values()))


def test_no_device_without_cuda_raises(monkeypatch):
    """With no card, an entry point given no device refuses to run rather
    than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(TransformerLMConfig(**SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"embed": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_moe_config_is_refused():
    with pytest.raises(NotImplementedError):
        TransformerLM(TransformerLMConfig(**dict(SMALL, moe_experts=2)),
                      device="cpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "mxnet_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 5
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "mxnet_tpu"), (path, mod)
