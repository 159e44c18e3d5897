"""The port's error type, dtype tables and environment knobs: the
counterpart of `mxnet_tpu/base.py`, cut to what the port raises and reads,
and the nested-list helpers of `mxnet_tpu/util.py`."""
from __future__ import annotations

import os
import threading

import numpy as _np
import torch

__all__ = ["MXNetError", "register_env", "getenv", "np_dtype", "torch_dtype",
           "dtype_name", "numeric_types", "integer_types", "flatten_nested",
           "unflatten_nested"]


class MXNetError(RuntimeError):
    """Default error raised by the port (the name of the reference's
    ``mxnet.base.MXNetError``, kept so user code catches the same type on
    either package)."""


numeric_types = (float, int, _np.generic)
integer_types = (int, _np.integer)

# The type flags of the reference's binary array format (`mxnet_tpu/base.py`
# _DTYPE_NP_TO_MX), kept so `nd.save` files cross-load between the packages.
# bfloat16 has no flag: `nd.save` writes it as float32.
_DTYPE_NP_TO_MX = {
    None: -1,
    _np.float32: 0,
    _np.float64: 1,
    _np.float16: 2,
    _np.uint8: 3,
    _np.int32: 4,
    _np.int8: 5,
    _np.int64: 6,
    _np.bool_: 7,
}
_DTYPE_MX_TO_NP = {v: k for k, v in _DTYPE_NP_TO_MX.items()}

_NP_TO_TORCH = {
    _np.dtype(_np.float32): torch.float32,
    _np.dtype(_np.float64): torch.float64,
    _np.dtype(_np.float16): torch.float16,
    _np.dtype(_np.uint8): torch.uint8,
    _np.dtype(_np.int8): torch.int8,
    _np.dtype(_np.int16): torch.int16,
    _np.dtype(_np.int32): torch.int32,
    _np.dtype(_np.int64): torch.int64,
    _np.dtype(_np.bool_): torch.bool,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def np_dtype(dtype):
    """Canonicalize a dtype-ish value (None for float32, a name, a numpy or
    a torch dtype) to a numpy dtype. bfloat16, which numpy lacks, stays
    ``torch.bfloat16``. Unlike the JAX package, 64-bit types stay 64-bit:
    torch has them without a mode switch."""
    if dtype is None:
        return _np.dtype(_np.float32)
    if isinstance(dtype, torch.dtype):
        return dtype if dtype == torch.bfloat16 else _TORCH_TO_NP[dtype]
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    return _np.dtype(dtype)


def dtype_name(dtype):
    """A dtype's name: ``"float32"``, ..., ``"bfloat16"``."""
    dt = np_dtype(dtype)
    return "bfloat16" if dt == torch.bfloat16 else dt.name


def torch_dtype(dtype):
    """The torch dtype of a dtype-ish value (None for float32)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = np_dtype(dtype)
    return dt if isinstance(dt, torch.dtype) else _NP_TO_TORCH[dt]


_env_lock = threading.Lock()
_env_registry = {}


def register_env(name, default, doc=""):
    """Declare an ``MXNET_*`` knob with its default; returns the name."""
    with _env_lock:
        _env_registry[name] = (default, doc)
    return name


def getenv(name, default=None):
    """The knob's value from the environment, parsed to the type of its
    default (a bool knob is false for "0", "false", "False" and ""), or the
    default when unset. `default` overrides the registered one."""
    if default is None and name in _env_registry:
        default = _env_registry[name][0]
    val = os.environ.get(name)
    if val is None:
        return default
    if isinstance(default, bool):
        return val not in ("0", "false", "False", "")
    if isinstance(default, int):
        return int(val)
    if isinstance(default, float):
        return float(val)
    return val


def flatten_nested(x, leaf_cls):
    """A nested list or tuple of ``leaf_cls`` instances as (flat list,
    structure); the structure is None for a bare leaf and a list of
    (child structure, child leaf count) otherwise. The control-flow
    frontends of `ndarray` and `symbol` share it."""
    if isinstance(x, leaf_cls):
        return [x], None
    if x is None:
        return [], ()
    flat, struct = [], []
    for item in x:
        f, s = flatten_nested(item, leaf_cls)
        flat.extend(f)
        struct.append((s, len(f)))
    return flat, struct


def unflatten_nested(flat, struct):
    """The inverse of `flatten_nested`."""
    if struct is None:
        return flat[0]
    out, i = [], 0
    for s, n in struct:
        out.append(unflatten_nested(flat[i:i + n], s))
        i += n
    return out
