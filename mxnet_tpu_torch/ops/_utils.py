"""Shared helpers for op implementations: the port's own copy of
`mxnet_tpu/ops/_utils.py`."""
from __future__ import annotations

import numpy as np
import torch


def normalize_axis(axis, ndim):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(normalize_axis(a, ndim) for a in axis)
    axis = int(axis)
    if axis < 0:
        axis += ndim
    if not 0 <= axis < max(ndim, 1):
        raise ValueError(f"axis {axis} out of range for ndim {ndim}")
    return axis


def reduce_axes(axis, ndim, exclude=False):
    """MXNet reduce-axis semantics: None → all; exclude=True inverts the set
    (reference `src/operator/tensor/broadcast_reduce_op.h` ReduceAxesParam)."""
    if axis is None or (isinstance(axis, (tuple, list)) and len(axis) == 0):
        return tuple(range(ndim)) if not exclude else ()
    if isinstance(axis, int):
        axis = (axis,)
    axes = tuple(sorted(a % ndim for a in axis))
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _parse_tuple(v, n, cast, scalars):
    """Shared parser for MXNet tuple params: scalar | sequence | str
    '(a, b)'; broadcasts a scalar/length-1 value to length n."""
    if v is None:
        return None
    if isinstance(v, str):
        v = v.strip()
        if v.startswith("(") or v.startswith("["):
            v = v[1:-1]
        v = tuple(cast(x) for x in v.replace(",", " ").split() if x)
    elif isinstance(v, scalars):
        v = (cast(v),) if n is None else (cast(v),) * n
    else:
        v = tuple(cast(x) for x in v)
    if n is not None and len(v) == 1:
        v = v * n
    return v


def as_tuple(v, n=None, name="param"):
    """Parse MXNet-style Shape params: int | tuple | str '(1, 2)'."""
    return _parse_tuple(v, n, int, (int, np.integer))


def as_float_tuple(v, n=None):
    """Parse MXNet-style float-tuple params: float | tuple | str '(0.1, 0.2)'."""
    return _parse_tuple(v, n, float, (int, float, np.integer, np.floating))


def parse_bool(v):
    if isinstance(v, str):
        return v not in ("0", "false", "False", "")
    return bool(v)


def safe_acc_dtype(dtype):
    """Accumulate low-precision reductions in fp32 (MXNET_SAFE_ACCUMULATION)."""
    if dtype in (torch.float16, torch.bfloat16):
        return torch.float32
    return None


def is_none(v):
    """An attr left unset: None or the string the Symbol/JSON path writes."""
    return v is None or v == "None"
