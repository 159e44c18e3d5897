"""Indexing, gather and scatter ops: the port of `mxnet_tpu/ops/indexing.py`
(`indexing_op.cc`: take, Embedding, one_hot, gather_nd, scatter_nd, pick;
`control_flow_op.cc` where; `boolean_mask.cc`; `ravel.cc`; the sequence
ops).

Embedding with ``sparse_grad=True`` and `_contrib_SparseEmbedding` give a
row-sparse weight gradient when called imperatively under recording
(`_embedding_sparse_vjp`, the JAX package's row-sparse pullback): torch's
sparse COO gradient of the gather, the (indices, rows) of the lookups, so
a 1,000,001-row table's gradient costs O(batch), not O(table). Inside a
hybridized block's function they give a dense one, as in the JAX package
(and a captured CUDA graph cannot hold the ``unique`` that deduplicates
rows: its output size is read on the host)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from ._utils import as_tuple, parse_bool, reduce_axes
from .registry import register
from .shape_ops import read_key


def _clip_index(indices, n):
    return torch.clamp(indices.long(), 0, n - 1)


@register("take")
def _take(a, indices, axis=0, mode="clip", **kw):
    axis = int(axis) % a.dim()
    n = a.shape[axis]
    idx = torch.remainder(indices.long(), n) if mode == "wrap" \
        else _clip_index(indices, n)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + tuple(indices.shape)
                       + a.shape[axis + 1:])


def _embedding_sparse_vjp(data, weight, sparse_grad=False, **kw):
    """Embedding whose weight gradient is a sparse COO tensor of the
    looked-up rows (indices clipped to [0, N-1] as the forward clips them),
    or None when ``sparse_grad`` is off."""
    if not parse_bool(sparse_grad):
        return None
    return F.embedding(_clip_index(data, weight.shape[0]), weight,
                       sparse=True)


@register("Embedding", sparse_vjp=_embedding_sparse_vjp)
def _embedding(data, weight, input_dim=None, output_dim=None,
               dtype="float32", sparse_grad=False, **kw):
    """One gather of weight rows (`indexing_op.cc` Embedding)."""
    return F.embedding(_clip_index(data, weight.shape[0]), weight)


@register("_contrib_SparseEmbedding", aliases=["contrib_SparseEmbedding"],
          sparse_vjp=lambda data, weight, **kw: _embedding_sparse_vjp(
              data, weight, sparse_grad=True))
def _sparse_embedding(data, weight, input_dim=None, output_dim=None,
                      dtype="float32", deterministic=False, **kw):
    """Embedding whose weight gradient is always row-sparse (the contrib
    precursor of ``sparse_grad``); the same gather."""
    return F.embedding(_clip_index(data, weight.shape[0]), weight)


@register("one_hot")
def _one_hot(indices, depth=0, on_value=1.0, off_value=0.0, dtype="float32",
             **kw):
    depth = int(depth)
    idx = indices.long()
    # an index outside [0, depth) gives an all-off row, as jax.nn.one_hot
    oh = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device))
    oh = oh.to(torch_dtype(dtype))
    return oh * (float(on_value) - float(off_value)) + float(off_value)


@register("pick", aliases=["choose_element_0index"])
def _pick(data, index, axis=-1, keepdims=False, mode="clip", **kw):
    """data's entries at `index` along `axis`. Indices are clipped in
    either mode, as the JAX package does."""
    axis = int(axis) % data.dim()
    idx = _clip_index(index, data.shape[axis]).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if parse_bool(keepdims) else out.squeeze(axis)


@register("batch_take")
def _batch_take(a, indices, **kw):
    off = torch.arange(a.shape[0], device=a.device) * a.shape[1]
    return torch.take(a, indices.long() + off)


@register("gather_nd")
def _gather_nd(data, indices, **kw):
    return data[tuple(indices.long())]


@register("scatter_nd")
def _scatter_nd(data, indices, shape=None, **kw):
    out = torch.zeros(as_tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(indices.long()), data, accumulate=True)


@register("_scatter_set_nd")
def _scatter_set_nd(data, indices, shape=None, **kw):
    out = torch.zeros(as_tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(indices.long()), data)


@register("where")
def _where(condition, x, y, **kw):
    return torch.where(condition.bool(), x, y)


@register("_contrib_boolean_mask", aliases=["contrib_boolean_mask"])
def _boolean_mask(data, index, axis=0, **kw):
    """The slices of data along `axis` whose index is nonzero; the output's
    extent depends on the values (`boolean_mask.cc`)."""
    keep = torch.nonzero(index.reshape(-1).bool()).reshape(-1)
    return torch.index_select(data, int(axis), keep)


@register("ravel_multi_index", aliases=["_ravel_multi_index"])
def _ravel_multi_index(data, shape=None, **kw):
    """Row-major flat indices (`tensor/ravel.cc`) in int32 arithmetic, as
    the JAX package's."""
    shape = as_tuple(shape)
    out = torch.zeros(data.shape[1:], dtype=torch.int32, device=data.device)
    stride = 1
    for i in range(len(shape) - 1, -1, -1):
        out = out + data[i].to(torch.int32) * stride
        stride *= shape[i]
    return out


@register("unravel_index", aliases=["_unravel_index"])
def _unravel_index(data, shape=None, **kw):
    """Flat → multi indices, in int32 arithmetic."""
    shape = as_tuple(shape)
    idx = data.to(torch.int32)
    strides, stride = [], 1
    for s in reversed(shape):
        strides.append(stride)
        stride *= s
    strides.reverse()
    outs = [torch.div(idx, strides[i], rounding_mode="floor") % s
            for i, s in enumerate(shape)]
    return torch.stack(outs, dim=0).to(torch.int32)


@register("_contrib_index_copy")
def _index_copy(old, idx, new, **kw):
    return old.index_copy(0, idx.long(), new)


@register("_contrib_index_array")
def _index_array(data, axes=None, **kw):
    axes = as_tuple(axes) or tuple(range(data.dim()))
    grids = torch.meshgrid(*[torch.arange(data.shape[a], device=data.device)
                             for a in axes], indexing="ij")
    return torch.stack(grids, dim=-1).to(torch.int32)


def _steps_mask(data, sequence_length, axis):
    """(seq, batch) mask for axis 0, (batch, seq) for axis 1, broadcast over
    the trailing dims: step < length."""
    steps = torch.arange(data.shape[axis], device=data.device)
    lens = sequence_length.to(steps.dtype)
    mask = steps[:, None] < lens[None, :] if axis == 0 \
        else steps[None, :] < lens[:, None]
    return mask.reshape(mask.shape + (1,) * (data.dim() - 2))


@register("SequenceMask")
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0, **kw):
    if not parse_bool(use_sequence_length) or sequence_length is None:
        return data
    mask = _steps_mask(data, sequence_length, int(axis))
    return torch.where(mask, data,
                       torch.full((), float(value), dtype=data.dtype,
                                  device=data.device))


@register("SequenceLast")
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0, **kw):
    axis = int(axis)
    if not parse_bool(use_sequence_length) or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    idx = sequence_length.long() - 1
    d = torch.movedim(data, 0, 1) if axis == 0 else data  # (batch, seq, ...)
    idx = idx.reshape((-1,) + (1,) * (d.dim() - 1)).expand(
        (d.shape[0], 1) + d.shape[2:])
    return torch.gather(d, 1, idx).squeeze(1)


@register("SequenceReverse")
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0, **kw):
    if not parse_bool(use_sequence_length) or sequence_length is None:
        return torch.flip(data, dims=(int(axis),))
    seq = data.shape[0]  # (seq, batch, ...) layout
    steps = torch.arange(seq, device=data.device)[:, None]
    lens = sequence_length.long()[None, :]
    idx = torch.where(steps < lens, lens - 1 - steps, steps)
    idx = idx.reshape(idx.shape + (1,) * (data.dim() - 2)).expand(data.shape)
    return torch.gather(data, 0, idx)


@register("cast_storage")
def _cast_storage_op(data, stype="default", **kw):
    """`cast_storage` at the dense level: the identity on values. The
    imperative frontend (`nd.cast_storage`) builds the sparse types; graphs
    that hold the op run it dense, the reference's fallback."""
    return data


@register("_sparse_retain", aliases=["sparse_retain"])
def _sparse_retain_op(data, indices, **kw):
    """Dense rendering of `sparse_retain`: zero every row NOT in indices."""
    keep = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    keep[indices.reshape(-1).long()] = True
    return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)), data,
                       torch.zeros((), dtype=data.dtype, device=data.device))


@register("_square_sum", aliases=["square_sum"])
def _square_sum_op(data, axis=None, keepdims=False, **kw):
    """sum(x^2) along axis (`tensor/square_sum.cc`), dense."""
    return torch.sum(torch.square(data), dim=reduce_axes(axis, data.dim()),
                     keepdim=parse_bool(keepdims))


@register("_ag_getitem")
def _ag_getitem(x, key=((),), **kw):
    """``x[key]``: the op behind `NDArray.__getitem__`, so that a read under
    `autograd.record` is a node of the graph (the key rides wrapped in a
    1-tuple attr)."""
    return read_key(x, key[0])
