"""2-bit gradient compression with an error-feedback residual: the port of
`mxnet_tpu/gradient_compression.py`.

    r = residual + grad
    r >=  threshold: code 11, residual = r - threshold
    r <= -threshold: code 10, residual = r + threshold
    else:            code 00, residual = r (the value is dropped, kept in
                     the residual)

Sixteen 2-bit codes pack into one 32-bit word, LSB-first (code j of a word
at bits 2j and 2j+1), the JAX package's wire format. torch's ``uint32`` has
few operations, so the port keeps packed words in an ``int32`` tensor with
the same bits; ``.numpy().view(np.uint32)`` gives the JAX package's words.

`quantize_2bit` is the plain version, in torch ops. `quantize_2bit_kernel`
launches the hand-written kernel `ops/csrc/quantize_2bit.cu` (K3, the port
of the Pallas `quantize_2bit_pallas`) on CUDA tensors. The live quantiser,
`GradientCompression.quantize`, launches the kernel on a CUDA tensor, runs
the plain version on a CPU tensor, and raises on any other device.
`dequantize_2bit` is torch ops on either device: it is XLA in the JAX
package, with no Pallas kernel.

The threshold is compared and subtracted in fp32, rounded from the Python
float as jnp rounds a weak-typed scalar, in both versions.
"""
from __future__ import annotations

import ctypes

import torch

from .base import MXNetError
from .ops import _build

__all__ = ["GradientCompression", "compressed_size", "quantize_2bit",
           "quantize_2bit_kernel", "dequantize_2bit"]

_VALS_PER_WORD = 16  # 32 bits / 2 bits per value
_KERNEL = "quantize_2bit"
_GRAD_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def compressed_size(n):
    """Number of 32-bit words for n values."""
    return (n + _VALS_PER_WORD - 1) // _VALS_PER_WORD


def _shifts(device):
    return torch.arange(_VALS_PER_WORD, dtype=torch.int64, device=device) * 2


def quantize_2bit(grad, residual, threshold):
    """Error-feedback 2-bit quantization in plain torch ops.

    ``grad`` is any float tensor, ``residual`` an fp32 tensor of the same
    number of values. Returns ``(packed int32[ceil(n/16)], new_residual)``;
    ``new_residual`` has the residual's shape, and neither input is
    changed."""
    # a fill, not a host-to-device copy (which would wait for the stream)
    t = torch.full((), float(threshold), dtype=torch.float32,
                   device=residual.device)
    r = residual + grad.reshape(residual.shape).to(residual.dtype)
    pos = r >= t
    neg = r <= -t
    new_residual = torch.where(pos, r - t, torch.where(neg, r + t, r))
    codes = torch.where(pos, 3, torch.where(neg, 2, 0)).reshape(-1).long()
    pad = (-codes.numel()) % _VALS_PER_WORD
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    words = (codes.view(-1, _VALS_PER_WORD) << _shifts(codes.device)).sum(1)
    # the words lie in [0, 2**32): fold the upper half onto int32's negatives
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32), new_residual


def dequantize_2bit(packed, shape, threshold, dtype=torch.float32):
    """Inverse map of packed int32 words: code 11 -> +threshold, 10 ->
    -threshold, else 0, as a tensor of ``shape`` in ``dtype`` on the words'
    device. A leading axis of ``packed`` beyond the words (e.g. one row per
    worker) is kept: [W, words] gives [W, *shape]."""
    n = 1
    for s in shape:
        n *= int(s)
    lead = tuple(packed.shape[:-1])
    shifts = _shifts(packed.device).to(torch.int32)
    # on int32 words >> is arithmetic, so a word with its top bit set shifts
    # in ones from the left; the & 3 keeps only the two bits of code j, which
    # the sign extension never reaches
    codes = (packed.unsqueeze(-1) >> shifts) & 3
    codes = codes.reshape(*lead, -1)[..., :n]
    # fills with the threshold rounded to dtype; no host-to-device copy
    out = torch.zeros(codes.shape, dtype=dtype, device=packed.device)
    out.masked_fill_(codes == 3, float(threshold))
    out.masked_fill_(codes == 2, -float(threshold))
    return out.reshape(*lead, *shape)


def _check_kernel_args(grad, residual):
    """Raise ValueError for inputs the kernel does not take."""
    if not grad.is_cuda or residual.device != grad.device:
        raise ValueError("quantize_2bit kernel: grad and residual must lie "
                         f"on one CUDA device, got {grad.device}, "
                         f"{residual.device}")
    if grad.dtype not in _GRAD_DTYPE_CODES:
        raise ValueError("quantize_2bit kernel: grad must be float32 or "
                         f"bfloat16, got {grad.dtype}")
    if residual.dtype != torch.float32:
        raise ValueError("quantize_2bit kernel: residual must be float32, "
                         f"got {residual.dtype}")
    if residual.shape != grad.shape:
        raise ValueError("quantize_2bit kernel: residual shape "
                         f"{tuple(residual.shape)} differs from grad shape "
                         f"{tuple(grad.shape)}")
    if not (grad.is_contiguous() and residual.is_contiguous()):
        raise ValueError("quantize_2bit kernel: grad and residual must be "
                         "contiguous")
    if grad.numel() == 0:
        raise ValueError("quantize_2bit kernel: empty input")


def _kernel_lib():
    lib = _build.library(_KERNEL)
    fn = lib.mxtt_quantize_2bit
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, ctypes.c_longlong,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.mxtt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def quantize_2bit_kernel(grad, residual, threshold):
    """Launch the CUDA kernel: quantize ``grad`` (fp32 or bf16, contiguous,
    on one card) against ``residual`` (fp32, same shape), updating the
    residual in place. Returns ``(packed int32[ceil(n/16)], residual)``.
    Counts each launch in `quantize_2bit_kernel.launches`."""
    _check_kernel_args(grad, residual)
    n = grad.numel()
    packed = torch.empty(compressed_size(n), dtype=torch.int32,
                         device=grad.device)
    lib = _kernel_lib()
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        err = lib.mxtt_quantize_2bit(
            grad.data_ptr(), _GRAD_DTYPE_CODES[grad.dtype],
            residual.data_ptr(), packed.data_ptr(), n, float(threshold),
            stream)
    if err != 0:
        msg = lib.mxtt_cuda_error_string(err).decode()
        raise RuntimeError(f"quantize_2bit kernel launch failed: {msg}")
    quantize_2bit_kernel.launches += 1
    return packed, residual


quantize_2bit_kernel.launches = 0


class GradientCompression:
    """Per-store compression state: the type, the threshold and one fp32
    error-feedback residual per key (one per worker, as the reference keeps
    a residual per compressed key on each worker)."""

    def __init__(self):
        self.type = None
        self.threshold = 0.5
        self._residuals = {}

    def set_params(self, compression_params):
        params = dict(compression_params)
        ctype = params.pop("type", None)
        threshold = float(params.pop("threshold", 0.5))
        if params:
            raise MXNetError(
                f"unknown gradient compression params {sorted(params)}")
        if ctype != "2bit":
            raise MXNetError(f"Unknown type for gradient compression {ctype}")
        if threshold <= 0:
            raise MXNetError("threshold must be greater than 0")
        self.type = "2bit"
        self.threshold = threshold

    @property
    def active(self):
        return self.type == "2bit"

    def quantize(self, key, grad):
        """Quantize ``grad`` for ``key``, folding in and updating the key's
        residual (a new zero residual when the shape changed). Returns the
        packed int32 words. The kernel on a CUDA tensor, the plain version on
        a CPU tensor; any other device raises ValueError."""
        res = self._residuals.get(key)
        if res is None or res.shape != grad.shape:
            res = torch.zeros(grad.shape, dtype=torch.float32,
                              device=grad.device)
        if grad.device.type == "cuda":
            packed, res = quantize_2bit_kernel(grad, res, self.threshold)
        elif grad.device.type == "cpu":
            packed, res = quantize_2bit(grad, res, self.threshold)
        else:
            raise ValueError(
                f"GradientCompression.quantize: unsupported device "
                f"{grad.device}")
        self._residuals[key] = res
        return packed

    def dequantize(self, packed, shape, dtype=torch.float32):
        return dequantize_2bit(packed, tuple(shape), self.threshold, dtype)
