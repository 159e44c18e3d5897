"""The port's flash attention (`mxnet_tpu_torch.ops.flash_attention`) held to
the JAX package's (`mxnet_tpu.ops.pallas_attention`) on the CPU.

On a CPU tensor the port computes its plain version; the JAX side runs the
Pallas kernel in interpret mode and its plain reference. The tolerances are
those of the JAX package's own kernel tests
(`tests/python/unittest/test_pallas_attention.py`): 1e-5 in fp32, 2e-2 in
bf16 (both sides round their output to bf16, in different places), 1e-4 for
gradients. The CUDA kernel itself is held to the plain version on the card by
`chip_smoke.py`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas_attention import HAVE_PALLAS
from mxnet_tpu.ops.pallas_attention import flash_attention as jax_flash
from mxnet_tpu.ops.pallas_attention import reference_attention as jax_ref
from mxnet_tpu_torch.ops import flash_attention as fa_mod
from mxnet_tpu_torch.ops.flash_attention import (flash_attention,
                                                 reference_attention)

pallas = pytest.mark.skipif(not HAVE_PALLAS, reason="pallas unavailable")


def _qkv(b=2, l=64, h=4, d=32, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, l, h, d).astype(np.float32) for _ in range(3)]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


@pallas
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("blocks", [(64, 64), (32, 16)], ids=["one_k_block",
                                                              "many_k_blocks"])
def test_flash_attention_matches_jax_fp32(causal, blocks):
    q, k, v = _qkv()
    out = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert out.dtype == torch.float32 and out.shape == q.shape
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_kernel = jax_flash(jq, jk, jv, causal=causal, block_q=blocks[0],
                            block_k=blocks[1], interpret=True)
    want_ref = jax_ref(jq, jk, jv, causal=causal)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pallas
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_matches_jax_bf16(causal):
    q, k, v = _qkv()
    out = flash_attention(*(_t(x, torch.bfloat16) for x in (q, k, v)),
                          causal=causal)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = jax_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                     interpret=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pallas
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_gradients_match_jax(causal):
    """The autograd.Function's backward recomputes through the plain
    version, as the JAX custom_vjp recomputes through its reference."""
    q, k, v = _qkv(l=32)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    (flash_attention(tq, tk, tv, causal=causal) ** 2).sum().backward()

    def loss(q_, k_, v_):
        return (jax_flash(q_, k_, v_, causal=causal, block_q=16, block_k=16,
                          interpret=True) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


def test_plain_version_matches_jax_reference_ragged_lengths():
    """The kernel masks the ragged edge of L itself, so the port takes any
    length; the plain version is the function it must compute there."""
    q, _, _ = _qkv(l=24, seed=1)
    _, k, v = _qkv(l=40, seed=2)
    out = reference_attention(_t(q), _t(k), _t(v), causal=False)
    want = jax_ref(*map(jnp.asarray, (q, k, v)), causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_causal_rejects_unequal_lengths():
    q, _, _ = _qkv(l=16)
    _, k, v = _qkv(l=32)
    with pytest.raises(ValueError, match="causal requires lq == lk"):
        flash_attention(_t(q), _t(k), _t(v), causal=True)


def test_cpu_tensor_takes_the_plain_version_not_the_kernel():
    q, k, v = _qkv(l=16)
    before = fa_mod.flash_attention_fwd_kernel.launches
    out = flash_attention(_t(q), _t(k), _t(v), causal=True)
    assert fa_mod.flash_attention_fwd_kernel.launches == before
    np.testing.assert_array_equal(
        out.numpy(), reference_attention(_t(q), _t(k), _t(v), True).numpy())


@pytest.mark.parametrize("case,reason", [
    ("cpu_tensor", "CUDA device"), ("fp16", "float32 or bfloat16"),
    ("head_dim_48", "head dim 48"), ("rank3", r"\[B, L, H, D\]"),
    ("d_stride", "contiguous"), ("shape_mismatch", "disagree")])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(case, reason):
    """The wrapper's checks raise before any build or launch."""
    q, k, v = (_t(x) for x in _qkv(l=16))
    if case == "fp16":
        q, k, v = (x.half() for x in (q, k, v))
    elif case == "head_dim_48":
        q, k, v = (x.repeat(1, 1, 1, 2)[..., :48] for x in (q, k, v))
    elif case == "rank3":
        q, k, v = (x[0] for x in (q, k, v))
    elif case == "d_stride":
        q = q.repeat_interleave(2, dim=-1)[..., ::2]
    elif case == "shape_mismatch":
        k = k[:, :, :2]
    if case != "cpu_tensor":
        # present the tensors as if on a card, so the checks after the
        # device check run; nothing reaches the kernel
        q, k, v = (_OnCard(t) for t in (q, k, v))
    with pytest.raises(ValueError, match=reason):
        fa_mod._check_kernel_args(q, k, v)


class _OnCard:
    """A CPU tensor that reports a CUDA device, for the wrapper's checks."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)
