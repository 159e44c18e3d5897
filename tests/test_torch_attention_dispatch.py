"""How the port's attention kernels are chosen and what they take, on the
CPU: the wrappers' pure launch plan (`launch_plan`), and the plain versions
held to the JAX package at the bf16 head dims of the tensor-core kernel.

`launch_plan` picks each kernel's variant by dtype (bf16: the wgmma kernel
fed by TMA; fp32: the FMA kernel) and refuses bf16 operands that TMA cannot
read in place: a base address, or a B, L or H stride, that is not a multiple
of 16 bytes. Its inputs are numbers, so the rule is checked here without a
card; the kernels themselves are held to the plain versions on the card by
`chip_smoke.py`. The plain-version comparisons use the JAX package's bf16
kernel-test bound, 2e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas_attention import reference_attention as jax_ref
from mxnet_tpu.parallel.ring_attention import _block_attn as jax_block_attn
from mxnet_tpu_torch.ops import flash_attention as fa_mod
from mxnet_tpu_torch.ops.flash_attention import (bias_pitch,
                                                 flash_block_partials,
                                                 launch_plan, launch_strides,
                                                 reference_attention)

WRAPPERS = ["flash_attention kernel", "flash_block_partials kernel"]


def _operands(tensors, offset=0):
    """(name, shape, strides, byte address) of q, k and v, as a wrapper
    hands them to `launch_plan`."""
    return [(name, tuple(t.shape), t.stride(), t.data_ptr() + offset)
            for name, t in zip("qkv", tensors)]


def _split_views(b, l, h, d, dtype=torch.bfloat16):
    """q, k and v as the transformer makes them: views of one
    [B, L, 3*H*D] projection."""
    qkv = torch.zeros(b, l, 3 * h * d, dtype=dtype)
    return [t.view(b, l, h, d) for t in qkv.split(h * d, dim=-1)]


@pytest.mark.parametrize("what", WRAPPERS)
@pytest.mark.parametrize("dtype,variant", [
    (torch.bfloat16, "wgmma"), (torch.float32, "fma")],
    ids=["bf16_tensor_cores", "fp32_fma"])
def test_variant_is_chosen_by_dtype(what, dtype, variant):
    ops = _operands(_split_views(2, 16, 2, 64, dtype))
    assert launch_plan(dtype, ops, what)[0] == variant


@pytest.mark.parametrize("what", WRAPPERS)
def test_other_dtypes_have_no_variant(what):
    ops = _operands(_split_views(1, 8, 1, 32, torch.float16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        launch_plan(torch.float16, ops, what)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_transformer_split_views_qualify(d):
    b, l, h = 2, 24, 3
    _, strides = launch_plan(torch.bfloat16, _operands(_split_views(b, l, h,
                                                                    d)))
    # read in place: the projection's strides, nothing copied
    assert strides == [(l * 3 * h * d, 3 * h * d, d)] * 3


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_shards_qualify(sp):
    """The ring's shards: each position's block of L, a view at an offset
    of the same projection."""
    q, k, v = _split_views(2, 32, 2, 64)
    for pos in range(sp):
        shards = [t.chunk(sp, dim=1)[pos] for t in (q, k, v)]
        variant, strides = launch_plan(torch.bfloat16, _operands(shards))
        assert variant == "wgmma"
        assert strides == [(32 * 3 * 2 * 64, 3 * 2 * 64, 64)] * 3


@pytest.mark.parametrize("what", WRAPPERS)
@pytest.mark.parametrize("case,reason", [
    ("odd_h_stride", "H stride of 66 bytes"),
    ("odd_l_stride", "L stride of 200 bytes"),
    ("odd_b_stride", "B stride of 1800 bytes"),
    ("misaligned_base", "base address"),
    ("strided_head_dim", "contiguous")])
def test_operands_tma_cannot_read_raise(what, case, reason):
    """Numbers only: shape (B, L, H, D), element strides, byte address."""
    shape, strides, address = (2, 9, 3, 32), (9 * 96, 96, 32, 1), 4096
    if case == "odd_h_stride":
        strides = (9 * 104, 104, 33, 1)
    elif case == "odd_l_stride":
        strides = (9 * 104, 100, 32, 1)
    elif case == "odd_b_stride":
        strides = (900, 96, 32, 1)
    elif case == "misaligned_base":
        address = 4096 + 8
    elif case == "strided_head_dim":
        strides = (9 * 192, 192, 64, 2)
    ops = [("q", shape, (9 * 96, 96, 32, 1), 4096), ("k", shape, strides,
                                                     address)]
    with pytest.raises(ValueError, match=f"{what}: k's .*{reason}"):
        launch_plan(torch.bfloat16, ops, what)
    # the FMA kernel reads through plain pointers: it takes the same fp32
    # operands wherever the head-dim axis is contiguous
    if case != "strided_head_dim":
        assert launch_plan(torch.float32, ops, what)[0] == "fma"


def test_size_one_axes_take_nested_strides():
    """A size-1 axis's stride is never used: it is replaced by the stride a
    nested layout would give it, which TMA accepts."""
    shape, strides = (1, 5, 1, 64), (3, 64, 7, 1)
    assert launch_strides(shape, strides) == (320, 64, 64)
    launch_plan(torch.bfloat16, [("q", shape, strides, 0)])


@pytest.mark.parametrize("lk,fma,wgmma", [(512, 512, 512), (300, 300, 300),
                                          (71, 71, 72), (70, 70, 72)])
def test_bias_rows_are_pitched_for_tma(lk, fma, wgmma):
    """K2's fp32 bias: the FMA kernel reads it contiguous; the tensor-core
    kernel's TMA needs rows a multiple of 16 bytes apart, so
    `flash_block_partials` pads them to `bias_pitch` on the card."""
    assert bias_pitch(lk, "fma") == fma
    assert bias_pitch(lk, "wgmma") == wgmma


class _OnCard:
    """A CPU tensor that reports a CUDA device, for the wrapper's checks."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize("case,lk,refused_for", [
    ("rows_padded_to_8", 6, "fp32"),      # the bf16 pitch, not fp32's
    ("rows_6_apart", 6, "bf16"),          # fp32's, not bf16's
    ("base_4_bytes_off", 8, "bf16"),      # no TMA from there
    ("transposed", 8, "both")])
def test_kernel_wrapper_checks_the_bias_layout(case, lk, refused_for):
    """The K2 wrapper takes the bias only in the layout its variant reads:
    rows `bias_pitch` apart, and a 16-byte aligned base for TMA."""
    flat = torch.zeros(8 * 8 + 1)
    bias = {"rows_padded_to_8": lambda: flat[:64].view(8, 8)[:, :lk],
            "rows_6_apart": lambda: flat[:48].view(8, lk),
            "base_4_bytes_off": lambda: flat[1:65].view(8, lk),
            "transposed": lambda: flat[:64].view(8, 8).t()}[case]()
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        q = _OnCard(torch.zeros(1, 8, 2, 32, dtype=dtype))
        if refused_for in (name, "both"):
            with pytest.raises(ValueError, match="bias must be"):
                fa_mod._check_bias(_OnCard(bias), q, lk, "K2")
        else:
            assert fa_mod._check_bias(_OnCard(bias), q, lk, "K2") == \
                bias.stride(0)


@pytest.mark.parametrize("d,causal", [(32, True), (128, False)],
                         ids=["d32_causal", "d128_full"])
def test_plain_attention_matches_jax_bf16_ragged(d, causal):
    rng = np.random.RandomState(d + causal)
    q, k, v = (rng.randn(1, 37, 2, d).astype(np.float32) for _ in range(3))
    out = reference_attention(*(torch.from_numpy(x).bfloat16()
                                for x in (q, k, v)), causal=causal)
    # one compiled call rather than op-by-op dispatch, for CPU time
    want = jax.jit(jax_ref, static_argnames="causal")(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        causal=causal)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("d", [32, 128])
def test_plain_partials_match_jax_bf16_ragged(d):
    rng = np.random.RandomState(d)
    q = rng.randn(1, 20, 2, d).astype(np.float32)
    k, v = (rng.randn(1, 37, 2, d).astype(np.float32) for _ in range(2))
    bias = rng.randn(1, 1, 20, 37).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    got = flash_block_partials(*(torch.from_numpy(x).bfloat16()
                                 for x in (q, k, v)),
                               torch.from_numpy(bias), scale)
    want = jax.jit(jax_block_attn, static_argnums=4)(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(bias), scale)
    o, m, l = (g.float().numpy() for g in got)
    wo, wm, wl = (np.asarray(w.astype(jnp.float32)) for w in want)
    # m and l are fp32 statistics of the same bf16 scores
    np.testing.assert_allclose(m, wm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, wl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o / l.transpose(0, 2, 1, 3),
                               wo / wl.transpose(0, 2, 1, 3),
                               rtol=2e-2, atol=2e-2)
