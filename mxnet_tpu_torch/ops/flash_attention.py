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

Each kernel has two variants, chosen by dtype in `launch_plan`: bf16 runs
on the tensor cores (wgmma products on tiles that TMA loads, from
`csrc/attention_sm90.cuh`), fp32 on the FMA pipes. TMA reads the [B, L, H, D]
views through tensor maps, which need 16-byte aligned base addresses and B,
L and H strides (`check_tma_operand`); the wrappers raise ValueError on other
bf16 inputs rather than copy them.

`flash_block_partials` is one hop of ring attention (`_partial_kernel`,
`flash_block_partials`, `_make_partials_vjp` and `block_partials_pallas` of
the JAX module): the unnormalized partials `(o, m, l)` of one query block
against one K/V block under an additive (Lq, Lk) bias. On a CUDA tensor it
launches `csrc/flash_block_partials.cu` or raises; on a CPU tensor it
computes the plain version, the ring's `_block_attn`. `block_partials` makes
it differentiable, recomputing through `_block_attn` as the JAX `custom_vjp`
does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["bias_pitch", "block_partials", "check_tma_operand",
           "flash_attention", "flash_attention_fwd_kernel",
           "flash_block_partials", "flash_block_partials_kernel",
           "kernel_variant", "launch_plan", "launch_strides",
           "reference_attention"]

_NEG_INF = -1e30
_KERNEL = "flash_attention_fwd"
_PARTIALS_KERNEL = "flash_block_partials"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_VARIANTS = {torch.bfloat16: "wgmma", torch.float32: "fma"}
_TMA_ALIGN = 16  # bytes: TMA's granule for base addresses and strides


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


def _check_kernel_args(q, k, v, what="flash_attention kernel"):
    """Raise ValueError for inputs the kernel `what` does not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{what}: q, k and v must lie on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k and v must all be float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: expected [B, L, H, D] tensors")
    b, lq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {_HEAD_DIMS}")
    if min(b, lq, h, k.shape[1]) == 0:
        raise ValueError(f"{what}: empty input")
    if b * h > 65535:
        raise ValueError(f"{what}: B*H = {b * h} exceeds the grid limit "
                         "65535")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{what}: the head-dim axis must be contiguous")


def kernel_variant(dtype):
    """The variant a kernel wrapper launches for inputs of `dtype`: "wgmma",
    the tensor-core kernel, for bfloat16; "fma", the fp32 FMA kernel, for
    float32. Raises ValueError for any other dtype."""
    try:
        return _VARIANTS[dtype]
    except KeyError:
        raise ValueError(f"no attention kernel for {dtype}: float32 or "
                         "bfloat16 only") from None


def launch_strides(shape, strides):
    """The (B, L, H) element strides a kernel is given for a [B, L, H, D]
    tensor: its own, except that an axis of size 1 (whose stride is never
    multiplied by a nonzero index) takes the stride a nested layout would
    give it, so that a tensor map accepts it."""
    _, _, _, d = shape
    out, inner = [], d  # the extent of the axes inside, in elements
    for size, stride in zip(reversed(shape[:3]), reversed(strides[:3])):
        stride = inner if size == 1 else stride
        out.append(stride)
        inner = size * stride
    h, l, b = out
    return b, l, h


def check_tma_operand(name, shape, strides, address, itemsize=2,
                      what="attention kernel"):
    """Raise ValueError unless the tensor-core kernel's TMA can read the
    [B, L, H, D] operand `name` in place: its D axis contiguous, its base
    `address` (bytes) and the byte strides of its B, L and H axes (after
    `launch_strides`) multiples of 16."""
    if strides[3] != 1:
        raise ValueError(f"{what}: {name}'s head-dim axis must be contiguous")
    if address % _TMA_ALIGN:
        raise ValueError(f"{what}: {name}'s base address {address:#x} is not "
                         f"a multiple of {_TMA_ALIGN} bytes")
    for axis, stride in zip("BLH", launch_strides(shape, strides)):
        if (stride * itemsize) % _TMA_ALIGN:
            raise ValueError(
                f"{what}: {name}'s {axis} stride of {stride * itemsize} bytes "
                f"is not a multiple of {_TMA_ALIGN}")


def launch_plan(dtype, operands, what="attention kernel"):
    """A kernel wrapper's launch, from numbers alone: the variant for
    `dtype` (`kernel_variant`) and the launch strides (`launch_strides`) of
    each of `operands`, a sequence of (name, shape, strides, byte address)
    of the [B, L, H, D] inputs q, k and v. Raises ValueError where the
    variant cannot read an operand in place: for "wgmma", where
    `check_tma_operand` refuses it."""
    variant = kernel_variant(dtype)
    if variant == "wgmma":
        for name, shape, strides, address in operands:
            check_tma_operand(name, shape, strides, address, dtype.itemsize,
                              what)
    return variant, [launch_strides(shape, strides)
                     for _, shape, strides, _ in operands]


def _launch_strides(q, k, v, out, what, extra=()):
    """The 12 (B, L, H) element strides of q, k, v and out for a launch,
    after `launch_plan`'s checks, followed by `extra`."""
    _, strides = launch_plan(q.dtype, [
        (name, tuple(t.shape), t.stride(), t.data_ptr())
        for name, t in (("q", q), ("k", k), ("v", v))], what)
    strides.append(launch_strides(out.shape, out.stride()))
    flat = [x for st in strides for x in st] + list(extra)
    return (ctypes.c_longlong * len(flat))(*flat)


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
    card; the variant of `kernel_variant`) and return the attention output
    [B, Lq, H, D] in q's dtype. Counts each launch, of either variant, in
    `flash_attention_fwd_kernel.launches`."""
    what = "flash_attention kernel"
    _check_kernel_args(q, k, v, what)
    b, lq, h, d = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = _launch_strides(q, k, v, out, what)
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


# ---------------------------------------------------------------------------
# One ring hop: the unnormalized partials of one query block against one K/V
# block (`_partial_kernel` of the JAX module), for `parallel.ring_attention`.
# ---------------------------------------------------------------------------


def _partials_lib():
    lib = _build.library(_PARTIALS_KERNEL)
    fn = lib.mxtt_flash_block_partials
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.mxtt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def bias_pitch(lk, variant):
    """The row pitch, in elements, with which a kernel variant reads an
    (Lq, Lk) fp32 bias: Lk for "fma"; for "wgmma", whose TMA needs 16-byte
    row strides, Lk rounded up to a multiple of 4."""
    return lk if variant == "fma" else -(-lk // 4) * 4


def _check_bias(bias, q, lk, what):
    """Raise ValueError unless `bias` (or None) is an (Lq, Lk) fp32 tensor
    on q's device in the layout q's variant reads: rows `bias_pitch`
    elements apart and, for TMA, a 16-byte aligned base. Returns the
    pitch."""
    lq = q.shape[1]
    variant = kernel_variant(q.dtype)
    pitch = bias_pitch(lk, variant)
    if bias is not None and not (
            bias.device == q.device and bias.dtype == torch.float32
            and tuple(bias.shape) == (lq, lk)
            and bias.stride() == (pitch, 1)
            and (variant == "fma" or bias.data_ptr() % _TMA_ALIGN == 0)):
        raise ValueError(f"{what}: bias must be a ({lq}, {lk}) float32 "
                         f"tensor on {q.device} with rows {pitch} elements "
                         f"apart (16-byte aligned for {variant}), got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device} "
                         f"with strides {bias.stride()}")
    return pitch


def flash_block_partials_kernel(q, k, v, bias, scale):
    """Launch the CUDA kernel on q [B, Lq, H, D], k, v [B, Lk, H, D] (fp32 or
    bf16, on one card; the variant of `kernel_variant`) and `bias`, an
    (Lq, Lk) fp32 tensor on the same card whose rows lie `bias_pitch`
    elements apart (16-byte aligned for bf16), or None. Returns `(o, m, l)`:
    o [B, Lq, H, D] in q's dtype, unnormalized; m and l [B, H, Lq, 1] fp32.
    Counts each launch, of either variant, in
    `flash_block_partials_kernel.launches`."""
    what = "flash_block_partials kernel"
    _check_kernel_args(q, k, v, what)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    pitch = _check_bias(bias, q, lk, what)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, lq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, lq, 1), dtype=torch.float32, device=q.device)
    strides = _launch_strides(q, k, v, o, what, extra=(pitch,))
    lib = _partials_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtt_flash_block_partials(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), _DTYPE_CODES[q.dtype], b, h, lq, lk,
            d, strides, float(scale), stream)
    if err != 0:
        msg = lib.mxtt_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_block_partials kernel launch failed: {msg}")
    flash_block_partials_kernel.launches += 1
    return o, m, l


flash_block_partials_kernel.launches = 0


def flash_block_partials(q, k, v, bias=None, scale=None):
    """The partials `(o, m, l)` of `_block_attn`: o = exp(s - m) @ v,
    UNNORMALIZED, [B, Lq, H, D] in q's dtype; m the row max and l the row
    sum-exp of s = q k^T * scale + bias, [B, H, Lq, 1] fp32. `bias` is one
    additive (Lq, Lk) mask shared by every batch row and head (any shape of
    Lq * Lk elements, such as the ring's [1, 1, Lq, Lk]); another size raises
    ValueError. The kernel on a CUDA tensor, the plain version on a CPU
    tensor. The bias is handed on as a contiguous fp32 (Lq, Lk) array, with
    its rows padded to `bias_pitch` for the bf16 kernel when Lk is not a
    multiple of 4 (the padding is never read)."""
    lq, lk = q.shape[1], k.shape[1]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        if bias.numel() != lq * lk:
            # one (Lq, Lk) mask for every batch row and head: collapsing a
            # per-head bias would be wrong
            raise ValueError(
                f"flash_block_partials: bias shape {tuple(bias.shape)} is "
                f"not a broadcastable ({lq}, {lk}) mask")
        bias = bias.to(device=q.device, dtype=torch.float32).reshape(lq, lk)
        pitch = (bias_pitch(lk, kernel_variant(q.dtype))
                 if q.device.type == "cuda" else lk)
        if pitch != lk:
            padded = torch.zeros((lq, pitch), dtype=torch.float32,
                                 device=q.device)
            bias = padded[:, :lk].copy_(bias)
        else:
            bias = bias.contiguous()
    if q.device.type == "cuda":
        return flash_block_partials_kernel(q, k, v, bias, scale)
    if q.device.type == "cpu":
        from ..parallel.ring_attention import _block_attn

        return _block_attn(q, k, v, bias, scale)
    raise ValueError(f"flash_block_partials: unsupported device {q.device}")


class _BlockPartials(torch.autograd.Function):
    """Forward `flash_block_partials`; the backward recomputes through the
    plain `_block_attn` and gives the bias no gradient (the JAX package's
    `_make_partials_vjp` custom_vjp). An output that receives no gradient
    (the ring's `m`, which only shifts) is left out of the recompute's
    backward, as XLA drops the work of a zero cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        ctx.set_materialize_grads(False)
        return flash_block_partials(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, *cotangents):
        from ..parallel.ring_attention import _block_attn

        q, k, v, bias = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            outs = _block_attn(*inputs, bias, ctx.scale)
            pairs = [(o, g) for o, g in zip(outs, cotangents)
                     if g is not None]
            grads = torch.autograd.grad([o for o, _ in pairs], inputs,
                                        [g for _, g in pairs],
                                        allow_unused=True)
        return (*grads, None, None)


def block_partials(q, k, v, bias, scale):
    """Ring-hop entry point: `_block_attn`'s contract with the kernel forward
    (on a CUDA tensor) and an exact recomputed backward. `bias` may be
    None."""
    return _BlockPartials.apply(q, k, v, bias, float(scale))
