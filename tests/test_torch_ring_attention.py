"""The port's ring attention held to the JAX package's on the CPU: the
ring-hop partials (`mxnet_tpu_torch.ops.flash_attention.flash_block_partials`
against `mxnet_tpu.ops.pallas_attention.flash_block_partials` in interpret
mode and the plain `_block_attn`), their gradients, `ring_self_attention`
over four `sp` positions, and `TransformerLM` with ``sp = 4``.

On a CPU tensor the port computes the plain versions; the JAX side runs on
four virtual host devices (`tests/conftest.py`). Tolerances are the JAX
package's own: partials 1e-5 (`test_pallas_attention.py`), hop gradients
rtol 1e-4 / atol 1e-5 (`test_ring_hop_partials_and_gradients`), the ring
2e-5 forward and 2e-4 gradients, bf16 within 0.05 of dense fp32
(`test_parallel.py`). The transformer's logits, loss and gradients agree to
1e-4 (fp32 on both sides, sums in other orders over two layers); the port's
``sp = 4`` logits agree with its own ``sp = 1`` logits to 1e-5. The CUDA
kernel itself is held to the plain version on the card by `chip_smoke.py`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import parallel as jpar
from mxnet_tpu.models import TransformerLM as JaxLM
from mxnet_tpu.models import TransformerLMConfig as JaxConfig
from mxnet_tpu.ops.pallas_attention import HAVE_PALLAS
from mxnet_tpu.ops.pallas_attention import block_partials_pallas
from mxnet_tpu.ops.pallas_attention import \
    flash_block_partials as jax_partials
from mxnet_tpu.parallel.ring_attention import _block_attn as jax_block_attn
from mxnet_tpu.parallel.ring_attention import \
    ring_self_attention as jax_ring
from mxnet_tpu_torch.models import (TransformerLM, TransformerLMConfig,
                                    params_from_jax, params_to_jax)
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.parallel import (create_mesh, ring_self_attention,
                                      ring_shift)
from mxnet_tpu_torch.parallel.ring_attention import _block_attn

pallas = pytest.mark.skipif(not HAVE_PALLAS, reason="pallas unavailable")

B, H, D = 2, 2, 16
SMALL = dict(vocab_size=64, d_model=32, n_heads=2, d_ff=64, n_layers=2,
             max_len=16, dtype="float32")


@pytest.fixture(autouse=True)
def _jax_ring_on_its_plain_hop(monkeypatch):
    """The JAX ring's hop follows MXNET_PALLAS_ATTENTION; on the CPU
    backend, unset, it is the plain `_block_attn`."""
    monkeypatch.delenv("MXNET_PALLAS_ATTENTION", raising=False)
    monkeypatch.delenv("MXNET_PALLAS_INTERPRET", raising=False)


def _arrays(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def _causal(lq, lk, q0=0, k0=0):
    """The ring's causal bias of one hop: [1, 1, Lq, Lk], 0 or -1e30."""
    keep = (q0 + np.arange(lq))[:, None] >= (k0 + np.arange(lk))[None, :]
    return np.where(keep, 0.0, -1e30).astype(np.float32)[None, None]


def _bias(case, lq, lk):
    if case == "none":
        return None
    if case == "causal_diagonal":
        return _causal(lq, lk)
    if case == "fully_masked":  # a K/V block wholly in the query's future
        return _causal(lq, lk, q0=0, k0=lk)
    return _arrays((1, 1, lq, lk), seed=7)[0]  # random additive bias


@pallas
@pytest.mark.parametrize("case,lq,lk", [
    ("none", 32, 32), ("causal_diagonal", 32, 32), ("fully_masked", 32, 32),
    ("random", 32, 32), ("none", 32, 48)],
    ids=["none", "causal_diagonal", "fully_masked", "random",
         "ragged_32x48"])
def test_partials_match_jax(case, lq, lk):
    q, k, v = _arrays((B, lq, H, D), (B, lk, H, D), (B, lk, H, D))
    bias = _bias(case, lq, lk)
    scale = 1.0 / np.sqrt(D)
    got = fa.flash_block_partials(_t(q), _t(k), _t(v),
                                  None if bias is None else _t(bias), scale)
    assert got[0].shape == (B, lq, H, D) and got[0].dtype == torch.float32
    assert got[1].shape == got[2].shape == (B, H, lq, 1)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    want_kernel = jax_partials(jq, jk, jv, bias=jb, scale=scale, block_q=16,
                               block_k=16, interpret=True)
    want_ref = jax_block_attn(jq, jk, jv, jb, scale)
    for want in (want_kernel, want_ref):
        for name, g, w in zip("oml", got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    if case == "fully_masked":
        # every key weighs exp(0) = 1: the ring's combine drops the hop
        np.testing.assert_array_equal(got[2].numpy(), lk)


@pallas
def test_partials_reject_per_head_bias():
    q, k, v = _arrays((B, 32, H, D), (B, 32, H, D), (B, 32, H, D))
    per_head = np.zeros((B, H, 32, 32), np.float32)
    with pytest.raises(ValueError, match="broadcastable"):
        fa.flash_block_partials(_t(q), _t(k), _t(v), _t(per_head))
    with pytest.raises(ValueError):
        jax_partials(*map(jnp.asarray, (q, k, v)),
                     bias=jnp.asarray(per_head), interpret=True)


@pallas
@pytest.mark.parametrize("uses", ["normalized", "all_outputs"])
def test_block_partials_gradients_match_jax(uses):
    """The autograd.Function's backward recomputes through `_block_attn`,
    as the JAX custom_vjp does, taking the cotangents of o, m and l."""
    L = 32
    q, k, v = _arrays(*[(B, L, H, D)] * 3, seed=1)
    bias = _causal(L, L)
    scale = 1.0 / np.sqrt(D)

    def loss(o, m, l, perm):
        out = ((o / perm(l)) ** 2).sum()
        if uses == "all_outputs":
            out = out + (0.1 * m).sum() + (0.01 * l).sum()
        return out

    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    got = loss(*fa.block_partials(tq, tk, tv, _t(bias), scale),
               lambda x: x.permute(0, 2, 1, 3))
    got.backward()

    def jax_loss(q_, k_, v_):
        return loss(*block_partials_pallas(q_, k_, v_, jnp.asarray(bias),
                                           scale, block_q=16, block_k=16,
                                           interpret=True),
                    lambda x: jnp.transpose(x, (0, 2, 1, 3)))

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(float(got.detach()),
                               float(jax_loss(jq, jk, jv)),
                               rtol=1e-5)
    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_cpu_tensors_take_the_plain_versions_not_the_kernels():
    q, k, v = (_t(x) for x in _arrays(*[(B, 16, H, 8)] * 3))
    before = (fa.flash_block_partials_kernel.launches,
              fa.flash_attention_fwd_kernel.launches)
    mesh = create_mesh(devices=["cpu"] * 4, sp=4)
    ring_self_attention(q, k, v, mesh=mesh, causal=True)
    ring_self_attention(q, k, v, causal=True)
    got = fa.flash_block_partials(q, k, v, None, 0.5)
    assert (fa.flash_block_partials_kernel.launches,
            fa.flash_attention_fwd_kernel.launches) == before
    for g, w in zip(got, _block_attn(q, k, v, None, 0.5)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_block_partials_kernel(q, k, v, None, 0.5)


def test_ring_shift_moves_each_shard_to_the_next_position():
    shards = [torch.full((2,), float(i)) for i in range(4)]
    for shift in (1, 3):
        out = ring_shift(shards, shift=shift)
        assert [int(t[0]) for t in out] == [(r - shift) % 4 for r in range(4)]
        # positions that share a device hand the tensor over without a copy
        assert all(o.data_ptr() == shards[(r - shift) % 4].data_ptr()
                   for r, o in enumerate(out))


def _jax_sp_mesh():
    return jpar.create_mesh(devices=jax.devices()[:4], dp=1, sp=4)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_self_attention_matches_jax(causal):
    q, k, v = _arrays(*[(B, 16, H, 8)] * 3)
    mesh = create_mesh(devices=["cpu"] * 4, dp=1, sp=4)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = ring_self_attention(tq, tk, tv, mesh=mesh, causal=causal)
    (out ** 2).sum().backward()

    jmesh = _jax_sp_mesh()

    def jax_loss(q_, k_, v_):
        return (jax_ring(q_, k_, v_, mesh=jmesh, causal=causal) ** 2).sum()

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jax_ring(jq, jk, jv, mesh=jmesh, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    grads = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   err_msg=name)


def test_ring_self_attention_bf16_keeps_its_dtype():
    q, k, v = _arrays(*[(B, 16, H, 8)] * 3)
    mesh = create_mesh(devices=["cpu"] * 4, sp=4)
    out = ring_self_attention(*(_t(x, torch.bfloat16) for x in (q, k, v)),
                              mesh=mesh, causal=True)
    assert out.dtype == torch.bfloat16
    dense = fa.reference_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(out.float().numpy(), dense.numpy(), atol=0.05)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_self_attention_without_sp_matches_jax(causal, monkeypatch):
    """No mesh: one hop over the whole sequence, as the JAX function's
    n == 1 branch computes it, through `block_partials` (the kernel on a
    CUDA tensor, the plain version here)."""
    monkeypatch.delenv("MXNET_MESH_SHAPE", raising=False)
    q, k, v = _arrays(*[(B, 16, H, 8)] * 3, seed=3)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = ring_self_attention(tq, tk, tv, causal=causal)
    (out ** 2).sum().backward()

    def jax_loss(q_, k_, v_):
        return (jax_ring(q_, k_, v_, causal=causal) ** 2).sum()

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jax_ring(jq, jk, jv, causal=causal)),
                               atol=2e-5)
    grads = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   err_msg=name)


def test_ring_self_attention_raises_on_other_devices():
    q, k, v = (torch.empty(B, 16, H, 8, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="unsupported device"):
        ring_self_attention(q, k, v, causal=True)


def _models():
    """The JAX model on a 4-position sp mesh and the port's on one of four
    CPU positions, from the JAX model's parameters."""
    jmesh = _jax_sp_mesh()
    jlm = JaxLM(JaxConfig(**SMALL), jmesh)
    jparams = jlm.init_params(jax.random.PRNGKey(0))
    state = params_from_jax({n: np.asarray(p) for n, p in jparams.items()},
                            device="cpu")
    tlm = TransformerLM(TransformerLMConfig(**SMALL), device="cpu",
                        mesh=create_mesh(devices=["cpu"] * 4, dp=1, sp=4))
    tlm.load_state_dict(state)  # the same parameters as without a mesh
    return jmesh, jlm, jparams, tlm


def _batch(seq=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, SMALL["vocab_size"], (2, seq)).astype(np.int32)
            for _ in range(2)]


def test_transformer_sp4_logits_match_jax_and_sp1():
    jmesh, jlm, jparams, tlm = _models()
    toks, _ = _batch()
    with jmesh:
        want = np.asarray(jax.jit(jlm.forward)(jparams, toks))
    plain = TransformerLM(TransformerLMConfig(**SMALL), device="cpu")
    plain.load_state_dict(tlm.state_dict())
    with torch.no_grad():
        tt = torch.from_numpy(toks).long()
        got, got_sp1 = tlm(tt), plain(tt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), got_sp1.numpy(), rtol=0,
                               atol=1e-5)


def test_transformer_sp4_loss_and_gradients_match_jax():
    jmesh, jlm, jparams, tlm = _models()
    toks, tgts = _batch(seed=1)
    with jmesh:
        jloss, jgrads = jax.jit(jax.value_and_grad(jlm.loss))(jparams, toks,
                                                              tgts)
    loss = tlm.loss(*(torch.from_numpy(x).long() for x in (toks, tgts)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0,
                               atol=1e-4)
    got = params_to_jax({n: p.grad for n, p in tlm.named_parameters()})
    assert set(got) == set(jgrads)
    for name, want in jgrads.items():
        np.testing.assert_allclose(got[name], np.asarray(want), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_sequence_not_divisible_by_sp_raises():
    _, _, _, tlm = _models()
    toks, _ = _batch(seq=14)
    with pytest.raises(ValueError, match="not divisible"):
        tlm(torch.from_numpy(toks).long())


def test_mesh_axes_of_later_slices_raise():
    with pytest.raises(NotImplementedError, match="later slice"):
        create_mesh(devices=["cpu"] * 4, tp=2, sp=2)
