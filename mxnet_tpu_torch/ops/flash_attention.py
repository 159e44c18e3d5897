"""Fused flash-attention forward: the port of `mxnet_tpu/ops/pallas_attention.py`
(`reference_attention`, `_fwd_kernel`, `_make_fa`, `flash_attention`).

`flash_attention` takes [B, L, H, D] tensors, the transformer's layout. On a
CUDA tensor it launches the hand-written kernel `csrc/flash_attention_fwd.cu`
or raises; on a CPU tensor it computes the plain version,
`reference_attention`. The backward recomputes through `reference_attention`,
as the JAX package's `custom_vjp` does: the TPU kernel has no backward kernel
and neither has the port.

The kernel reads q, k and v through their strides (the last axis must be
contiguous), so the strided views that split the transformer's fused QKV
projection go to it without a copy. Unlike the Pallas kernel it masks the
ragged edge of L itself, so it takes any length; like it, it refuses causal
attention between sequences of different lengths.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd_kernel",
           "reference_attention"]

_NEG_INF = -1e30
_KERNEL = "flash_attention_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def reference_attention(q, k, v, causal=False, scale=None):
    """Plain exact attention with an fp32 softmax over [B, L, H, D] tensors:
    the numerics contract the kernel reproduces, and the backward."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(lk - lq)
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _check_kernel_args(q, k, v):
    """Raise ValueError for inputs the kernel does not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel: q, k and v must lie on one "
                         f"CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention kernel: q, k and v must all be "
                         f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention kernel: expected [B, L, H, D] "
                         "tensors")
    b, lq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} not in "
                         f"{_HEAD_DIMS}")
    if min(b, lq, h, k.shape[1]) == 0:
        raise ValueError("flash_attention kernel: empty input")
    if b * h > 65535:
        raise ValueError(f"flash_attention kernel: B*H = {b * h} exceeds the "
                         "grid limit 65535")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: the head-dim axis must be "
                         "contiguous")


def _kernel_lib():
    lib = _build.library(_KERNEL)
    fn = lib.mxtt_flash_attention_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
        lib.mxtt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd_kernel(q, k, v, causal, scale):
    """Launch the CUDA kernel on q, k, v [B, L, H, D] (fp32 or bf16, on one
    card) and return the attention output [B, Lq, H, D] in q's dtype. Counts
    each launch in `flash_attention_fwd_kernel.launches`."""
    _check_kernel_args(q, k, v)
    b, lq, h, d = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, lq, k.shape[1], d, strides,
            float(scale), int(bool(causal)), stream)
    if err != 0:
        msg = lib.mxtt_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg}")
    flash_attention_fwd_kernel.launches += 1
    return out


flash_attention_fwd_kernel.launches = 0


def _forward(q, k, v, causal, scale):
    if q.device.type == "cuda":
        return flash_attention_fwd_kernel(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal, scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """Fused forward; the backward recomputes through `reference_attention`
    (the JAX package's `_make_fa` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _forward(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = reference_attention(*inputs, causal=ctx.causal,
                                      scale=ctx.scale)
            grads = torch.autograd.grad(out, inputs, grad_out)
        return (*grads, None, None)


def flash_attention(q, k, v, causal=False, scale=None):
    """Attention over [B, L, H, D] tensors: the kernel on a CUDA tensor, the
    plain version on a CPU tensor, differentiable through the plain version.

    Raises ValueError for causal attention with lq != lk: the kernel's mask
    assumes aligned self-attention positions."""
    lq, lk = q.shape[1], k.shape[1]
    if causal and lq != lk:
        raise ValueError(
            f"flash_attention: causal requires lq == lk, got ({lq}, {lk})")
    scale = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    return _FlashAttention.apply(q, k, v, bool(causal), scale)
