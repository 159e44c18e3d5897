"""Reductions, ordering and norms: the port of `mxnet_tpu/ops/reduce.py`
(`broadcast_reduce_op_value.cc`, `ordering_op.cc`). Half inputs accumulate
sums, means and products in fp32; every reduction returns its input's
dtype, as the JAX package's do (a mean of int32 truncates to int32)."""
from __future__ import annotations

import torch

from ..base import torch_dtype
from ._utils import as_tuple, is_none, parse_bool, reduce_axes, \
    safe_acc_dtype
from .registry import register


def _over_axes(fn, x, axes, keepdim):
    """fn over several axes, one at a time for the torch reductions that
    take one ``dim`` (prod): the highest axis first, so the lower ones keep
    their numbers."""
    for a in sorted(axes, reverse=True):
        x = fn(x, dim=a, keepdim=keepdim)
    return x


def _reduce(name):
    def impl(x, axis=None, keepdims=False, exclude=False, **kw):
        axes = reduce_axes(as_tuple(axis) if not isinstance(axis, int)
                           else axis, x.dim(), parse_bool(exclude))
        if axes == () and x.dim() > 0:
            return x
        keep = parse_bool(keepdims)
        dtype = x.dtype
        acc = safe_acc_dtype(dtype)
        if acc is not None and name in ("sum", "mean", "prod"):
            x = x.to(acc)
        elif name == "mean" and not x.is_floating_point():
            x = x.to(torch.float32)
        elif name in ("max", "min") and dtype == torch.bool:
            x = x.to(torch.uint8)
        if name == "sum":
            out = torch.sum(x, dim=axes, keepdim=keep)
        elif name == "mean":
            out = torch.mean(x, dim=axes, keepdim=keep)
        elif name == "nansum":
            out = torch.nansum(x, dim=axes, keepdim=keep)
        elif name == "max":
            out = torch.amax(x, dim=axes, keepdim=keep)
        elif name == "min":
            out = torch.amin(x, dim=axes, keepdim=keep)
        else:
            if name == "nanprod":
                x = torch.where(torch.isnan(x), torch.ones_like(x), x)
            out = _over_axes(torch.prod, x, axes, keep)
        return out.to(dtype)

    return impl


register("sum", aliases=["sum_axis"])(_reduce("sum"))
register("mean")(_reduce("mean"))
register("prod")(_reduce("prod"))
register("nansum")(_reduce("nansum"))
register("nanprod")(_reduce("nanprod"))
register("max", aliases=["max_axis"])(_reduce("max"))
register("min", aliases=["min_axis"])(_reduce("min"))


@register("norm")
def _norm(x, ord=2, axis=None, keepdims=False, **kw):
    ord = int(ord)
    axes = as_tuple(axis)
    acc = safe_acc_dtype(x.dtype)
    xx = x.to(acc) if acc else x
    keep = parse_bool(keepdims)
    if ord == 1:
        out = torch.sum(torch.abs(xx), dim=axes, keepdim=keep)
    else:
        out = torch.sqrt(torch.sum(xx * xx, dim=axes, keepdim=keep))
    return out.to(x.dtype)


def _arg_reduce(fn):
    def impl(x, axis=None, keepdims=False, **kw):
        if is_none(axis):
            out = fn(x.reshape(-1), dim=0).to(torch.float32)
            return out.reshape((1,) * x.dim()) if parse_bool(keepdims) \
                else out
        return fn(x, dim=int(axis), keepdim=parse_bool(keepdims)).to(
            torch.float32)

    return impl


register("argmax")(_arg_reduce(torch.argmax))
register("argmin")(_arg_reduce(torch.argmin))


@register("argmax_channel")
def _argmax_channel(x, **kw):
    return torch.argmax(x, dim=1).to(torch.float32)


@register("topk", num_outputs=lambda attrs: 2 if attrs.get(
    "ret_typ", "indices") == "both" else 1)
def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32", **kw):
    if is_none(axis):
        x, axis = x.reshape(-1), 0
    axis = int(axis) % x.dim()
    k = int(k)
    if k <= 0:
        k = x.shape[axis]
    idx = torch.argsort(x if parse_bool(is_ascend) else -x, dim=axis,
                        stable=True).narrow(axis, 0, k)
    vals = torch.gather(x, axis, idx)
    idxf = idx.to(torch_dtype(dtype))
    if ret_typ == "indices":
        return idxf
    if ret_typ == "value":
        return vals
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter(axis, idx, 1)
    return vals, idxf  # both


@register("sort")
def _sort(x, axis=-1, is_ascend=True, **kw):
    if is_none(axis):
        x, axis = x.reshape(-1), 0
    out = torch.sort(x, dim=int(axis)).values
    if not parse_bool(is_ascend):
        out = torch.flip(out, dims=(int(axis),))
    return out


@register("argsort")
def _argsort(x, axis=-1, is_ascend=True, dtype="float32", **kw):
    if is_none(axis):
        x, axis = x.reshape(-1), 0
    out = torch.argsort(x if parse_bool(is_ascend) else -x, dim=int(axis),
                        stable=True)
    return out.to(torch_dtype(dtype))


@register("cumsum")
def _cumsum(x, axis=None, dtype=None, **kw):
    out_dtype = torch.int32 if x.dtype == torch.bool else x.dtype
    if dtype is not None:
        out_dtype = torch_dtype(dtype)
    if axis is None:
        return torch.cumsum(x.reshape(-1), dim=0).to(out_dtype)
    return torch.cumsum(x, dim=int(axis)).to(out_dtype)


@register("_histogram", num_outputs=2)
def _histogram(x, bins=10, range=None, **kw):
    """Counts of x over `bins` equal bins of `range` (default: x's min and
    max), the last bin closed, values outside dropped; and the bin edges
    (jnp.histogram's contract)."""
    bins = int(bins)
    xf = x.reshape(-1).to(torch.float32)
    lo, hi = (xf.min(), xf.max()) if range is None else (
        torch.tensor(float(range[0]), device=x.device),
        torch.tensor(float(range[1]), device=x.device))
    edges = torch.linspace(0, 1, bins + 1, device=x.device) * (hi - lo) + lo
    inside = (xf >= lo) & (xf <= hi)
    idx = torch.bucketize(xf, edges, right=True) - 1
    idx = torch.clamp(idx, 0, bins - 1)[inside]
    counts = torch.bincount(idx, minlength=bins).to(torch.float32)
    return counts, edges.to(x.dtype)


@register("L2Normalization")
def _l2norm(x, eps=1e-10, mode="instance", **kw):
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, x.dim()))
    else:
        raise ValueError(mode)
    n = torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True)
                   + float(eps))
    return x / n
