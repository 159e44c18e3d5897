"""gluon utilities: the port of `mxnet_tpu/gluon/utils.py` (parity
`python/mxnet/gluon/utils.py`): batch splitting and global-norm clipping.
"""
from __future__ import annotations

import warnings

import numpy as _np

from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``; the last one
    takes the remainder unless ``even_split``, which requires none."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}. Use a batch size "
            f"that's multiple of {num_slice} or set even_split=False to "
            "allow uneven partitioning of data.")
    if num_slice == 1:
        return [data]
    step = size // num_slice
    return [nd.slice_axis(data, axis=batch_axis, begin=i * step,
                          end=(i + 1) * step
                          if even_split or i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` along ``batch_axis`` and put slice i on context i."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [i.as_in_context(ctx) for i, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` so that the 2-norm of all of them together is at
    most ``max_norm``; returns that norm before scaling."""
    if not arrays:
        raise ValueError("clip_global_norm needs at least one array")
    ctx = arrays[0].context
    total_norm = nd.sqrt(nd.add_n(*[
        (arr.reshape((-1,)) ** 2).sum().as_in_context(ctx)
        for arr in arrays]))
    norm = total_norm.asscalar()
    if check_isfinite and not _np.isfinite(norm):
        warnings.warn(UserWarning("nan or inf is detected. Clipping results "
                                  "will be undefined."), stacklevel=2)
    scale = max_norm / (norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return norm

