"""Broadcasting binary ops and explicit broadcast shape ops: the port of
`mxnet_tpu/ops/broadcast.py` (`elemwise_binary_broadcast_op_basic.cc`,
`broadcast_reduce_op_value.cc`). torch broadcasting is MXNet's numpy-style
broadcasting."""
from __future__ import annotations

import torch

from ._utils import as_tuple
from .registry import register

_BROADCAST = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.true_divide,
    "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_hypot": torch.hypot,
    "broadcast_plus": torch.add,
    "broadcast_minus": torch.sub,
}

for _name, _f in _BROADCAST.items():
    register(_name)((lambda f: lambda a, b, **kw: f(a, b))(_f))


def _bcmp(f):
    def impl(a, b, **kw):
        return f(a, b).to(torch.promote_types(a.dtype, b.dtype))

    return impl


register("broadcast_equal")(_bcmp(torch.eq))
register("broadcast_not_equal")(_bcmp(torch.ne))
register("broadcast_greater")(_bcmp(torch.gt))
register("broadcast_greater_equal")(_bcmp(torch.ge))
register("broadcast_lesser")(_bcmp(torch.lt))
register("broadcast_lesser_equal")(_bcmp(torch.le))
register("broadcast_logical_and")(_bcmp(torch.logical_and))
register("broadcast_logical_or")(_bcmp(torch.logical_or))
register("broadcast_logical_xor")(_bcmp(torch.logical_xor))


@register("broadcast_to")
def _broadcast_to(x, shape=None, **kw):
    shape = as_tuple(shape)
    # MXNet: 0 in the target shape keeps the input dim
    tgt = tuple(s if s != 0 else x.shape[i] for i, s in enumerate(shape))
    return torch.broadcast_to(x, tgt)


@register("broadcast_axis", aliases=["broadcast_axes"])
def _broadcast_axis(x, axis=(), size=(), **kw):
    tgt = list(x.shape)
    for a, s in zip(as_tuple(axis) or (), as_tuple(size) or ()):
        tgt[a % x.dim()] = s
    return torch.broadcast_to(x, tuple(tgt))


@register("broadcast_like")
def _broadcast_like(x, like, lhs_axes=None, rhs_axes=None, **kw):
    lhs_axes, rhs_axes = as_tuple(lhs_axes), as_tuple(rhs_axes)
    if lhs_axes is None:
        return torch.broadcast_to(x, like.shape)
    tgt = list(x.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        tgt[la % x.dim()] = like.shape[ra % like.dim()]
    return torch.broadcast_to(x, tuple(tgt))
