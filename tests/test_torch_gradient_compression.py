"""The port's 2-bit gradient compression (`mxnet_tpu_torch.gradient_compression`)
held to the JAX package's (`mxnet_tpu.gradient_compression`) on the CPU.

On a CPU tensor the port runs its plain version; the JAX side runs its XLA
`quantize_2bit` and its Pallas `quantize_2bit_pallas` in interpret mode, as
its own test does (`tests/python/unittest/test_gradient_compression.py`).
Packed words are bit-exact: the port keeps them as int32 with the same bits,
compared as uint32. Residuals are held within 1e-7, the JAX package's own
kernel-test bound (both sides do the same fp32 add and subtract, so they
agree exactly in practice). The CUDA kernel is held to the plain version,
bit for bit, on the card by `chip_smoke.py`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.gradient_compression import dequantize_2bit as jax_dequantize
from mxnet_tpu.gradient_compression import quantize_2bit as jax_quantize
from mxnet_tpu.gradient_compression import quantize_2bit_pallas
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gradient_compression import (GradientCompression,
                                                  compressed_size,
                                                  dequantize_2bit,
                                                  quantize_2bit,
                                                  quantize_2bit_kernel)

SHAPES = [(2, 3), (16,), (7, 11), (130,), (100,), (33, 65), (2048,), (4097,)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# jit: one interpret-mode trace per shape instead of one per call
_pallas = jax.jit(quantize_2bit_pallas, static_argnums=2)


def _words(packed):
    """The port's int32 words as the JAX package's uint32 words."""
    assert packed.dtype == torch.int32
    return packed.numpy().view(np.uint32)


def _same_grad(g32, dtype):
    """One gradient for both sides: rounded to ``dtype`` by torch, then
    handed to JAX exactly (every bf16 value is an fp32 value)."""
    tdt, jdt = DTYPES[dtype]
    gt = torch.from_numpy(g32).to(tdt)
    return gt, jnp.asarray(gt.float().numpy()).astype(jdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_matches_jax_and_pallas(shape, dtype):
    """Four chained steps, each side carrying its own residual."""
    rng = np.random.RandomState(0)
    res = torch.zeros(shape)
    res_x = res_p = jnp.zeros(shape, jnp.float32)
    for _ in range(4):
        gt, gj = _same_grad(rng.uniform(-1, 1, shape).astype(np.float32),
                            dtype)
        packed, res = quantize_2bit(gt, res, 0.5)
        want_x, res_x = jax_quantize(gj, res_x, 0.5)
        want_p, res_p = _pallas(gj, res_p, 0.5)
        assert packed.shape == (compressed_size(int(np.prod(shape))),)
        np.testing.assert_array_equal(_words(packed), np.asarray(want_x))
        np.testing.assert_array_equal(_words(packed), np.asarray(want_p))
        assert res.shape == shape and res.dtype == torch.float32
        np.testing.assert_allclose(res.numpy(), np.asarray(res_x), rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(res.numpy(), np.asarray(res_p), rtol=0,
                                   atol=1e-7)


@pytest.mark.parametrize("threshold", [0.1, 0.7])
def test_fp32_threshold_and_nan_match_jax(threshold):
    """Thresholds that fp32 does not hold (0.1 rounds up, 0.7 down), values
    at and beside the fp32 threshold, NaN and infinities: the same codes and
    residuals as jnp, which compares against the fp32-rounded threshold."""
    t32 = np.float32(threshold)
    near = [t32, np.nextafter(t32, np.float32(0)),
            np.nextafter(t32, np.float32(1))]
    g = np.array(near + [-x for x in near]
                 + [np.nan, np.inf, -np.inf, 0.0, 0.25, -0.9, 3.0],
                 np.float32)
    res0 = np.linspace(-0.05, 0.05, g.size).astype(np.float32)
    res0[:6] = 0  # keep the values at the threshold exactly there
    packed, res = quantize_2bit(torch.from_numpy(g), torch.from_numpy(res0),
                                threshold)
    want, want_res = jax_quantize(jnp.asarray(g), jnp.asarray(res0),
                                  threshold)
    np.testing.assert_array_equal(_words(packed), np.asarray(want))
    # bit-equal, NaN in the same place (it stays in the residual, code 0)
    np.testing.assert_array_equal(res.numpy(), np.asarray(want_res))
    codes = (_words(packed)[0] >> (2 * np.arange(16, dtype=np.uint32))) & 3
    assert codes[0] == 3 and codes[6] == 0  # r = t32 fires, NaN does not


def test_dequantize_matches_jax():
    rng = np.random.RandomState(1)
    shape = (33, 65)
    words = rng.randint(0, 2**32, size=compressed_size(33 * 65),
                        dtype=np.uint64).astype(np.uint32)
    packed = torch.from_numpy(words.view(np.int32).copy())
    for dtype in DTYPES:
        tdt, jdt = DTYPES[dtype]
        got = dequantize_2bit(packed, shape, 0.5, tdt)
        want = jax_dequantize(jnp.asarray(words), shape, 0.5, jdt)
        assert got.shape == shape and got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    # a leading axis of workers is kept
    two = dequantize_2bit(torch.stack([packed, packed]), shape, 0.5)
    assert two.shape == (2,) + shape
    np.testing.assert_array_equal(two[1].numpy(), two[0].numpy())


def test_residual_ladder():
    """The port of the JAX package's `test_residual_semantics` (the
    reference's check_compr_residual ladder)."""
    t = 0.5
    shape = (2, 3)
    res = torch.zeros(shape)
    for step, want in [(0.4, 0.0), (t - 0.4, t), (0.2, 0.0), (t - 0.2, t)]:
        p, res = quantize_2bit(torch.full(shape, step), res, t)
        assert torch.all(dequantize_2bit(p, shape, t) == want)
    assert torch.allclose(res, torch.zeros(shape))


def test_negative_and_mixed():
    t = 1.0
    grad = torch.tensor([-2.5, -1.0, -0.5, 0.0, 0.5, 1.0, 2.5, 0.99])
    p, res = quantize_2bit(grad, torch.zeros(8), t)
    np.testing.assert_allclose(dequantize_2bit(p, (8,), t).numpy(),
                               [-1, -1, 0, 0, 0, 1, 1, 0])
    np.testing.assert_allclose(res.numpy(),
                               [-1.5, 0, -0.5, 0, 0.5, 0, 1.5, 0.99],
                               rtol=1e-7)


def test_param_validation():
    gc = GradientCompression()
    with pytest.raises(MXNetError):
        gc.set_params({"type": "1bit"})
    with pytest.raises(MXNetError):
        gc.set_params({"type": "2bit", "threshold": 0})
    with pytest.raises(MXNetError):
        gc.set_params({"type": "2bit", "bogus": 1})
    assert not gc.active
    gc.set_params({"type": "2bit", "threshold": 0.25})
    assert gc.active and gc.threshold == 0.25


def test_compressed_size():
    assert compressed_size(16) == 1
    assert compressed_size(17) == 2
    assert compressed_size(1) == 1
    assert compressed_size(32) == 2


def test_gradient_compression_quantize_on_cpu():
    """The live quantiser runs the plain version on a CPU tensor, keeps one
    residual per key and starts a new one when the key's shape changes."""
    gc = GradientCompression()
    gc.set_params({"type": "2bit", "threshold": 0.5})
    g = torch.full((4,), 0.3)
    assert torch.all(gc.dequantize(gc.quantize("a", g), (4,)) == 0)
    assert torch.all(gc.dequantize(gc.quantize("a", g), (4,)) == 0.5)
    assert torch.all(gc.dequantize(gc.quantize("b", g), (4,)) == 0)
    assert torch.all(gc.dequantize(gc.quantize("a", torch.full((2, 2), 0.3)),
                                   (2, 2)) == 0)


def test_kernel_refuses_what_it_does_not_take():
    """The CUDA kernel's wrapper raises on CPU tensors (it never falls back
    to the plain version), and the live quantiser raises on a device that is
    neither CUDA nor the CPU."""
    with pytest.raises(ValueError, match="CUDA"):
        quantize_2bit_kernel(torch.zeros(16), torch.zeros(16), 0.5)
    assert quantize_2bit_kernel.launches == 0
    gc = GradientCompression()
    gc.set_params({"type": "2bit"})
    with pytest.raises(ValueError, match="unsupported device"):
        gc.quantize("a", torch.zeros(16, device="meta"))
