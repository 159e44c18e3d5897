"""Creation ops (no tensor inputs): the port of `mxnet_tpu/ops/init_ops.py`
(`init_op.cc`). The frontend passes ``device``, the torch device of the
context the array is asked for."""
from __future__ import annotations

import torch

from ..base import torch_dtype
from ._utils import as_tuple, is_none, parse_bool
from .registry import register


@register("_zeros", aliases=["zeros"])
def _zeros(shape=(), dtype="float32", ctx=None, device=None, **kw):
    return torch.zeros(as_tuple(shape) or (), dtype=torch_dtype(dtype),
                       device=device)


@register("_ones", aliases=["ones"])
def _ones(shape=(), dtype="float32", ctx=None, device=None, **kw):
    return torch.ones(as_tuple(shape) or (), dtype=torch_dtype(dtype),
                      device=device)


@register("_full", aliases=["full"])
def _full(shape=(), value=0.0, dtype="float32", ctx=None, device=None, **kw):
    return torch.full(as_tuple(shape) or (), float(value),
                      dtype=torch_dtype(dtype), device=device)


@register("_eye", aliases=["eye"])
def _eye(N=1, M=0, k=0, dtype="float32", ctx=None, device=None, **kw):
    n, m, k = int(N), int(M) or int(N), int(k)
    rows = torch.arange(n, device=device)[:, None]
    cols = torch.arange(m, device=device)[None, :]
    return (cols - rows == k).to(torch_dtype(dtype))


@register("_arange", aliases=["arange"])
def _arange(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            dtype="float32", ctx=None, device=None, **kw):
    if is_none(stop):
        start, stop = 0.0, start
    out = torch.arange(float(start), float(stop), float(step),
                       dtype=torch_dtype(dtype), device=device)
    if int(repeat) > 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register("_linspace", aliases=["linspace"])
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32",
              ctx=None, device=None, **kw):
    num = int(num)
    if parse_bool(endpoint):
        return torch.linspace(float(start), float(stop), num,
                              dtype=torch_dtype(dtype), device=device)
    step = (float(stop) - float(start)) / num
    return (torch.arange(num, device=device) * step + float(start)).to(
        torch_dtype(dtype))


@register("full_like")
def _full_like(x, fill_value=0.0, **kw):
    return torch.full_like(x, float(fill_value))
