"""Fused optimizer-update ops, the SGD family: the port of part of
`mxnet_tpu/ops/optimizer_ops.py` (`optimizer_op.cc` sgd_update,
sgd_mom_update, mp_sgd_update, mp_sgd_mom_update and the aggregated
multi_sgd_update, multi_sgd_mom_update, multi_mp_sgd_update,
multi_mp_sgd_mom_update).

Each op returns ``(new_weight, new_state...)``; callers pass ``out=weight``,
and the frontend copies the states into their arrays in place
(``mutate_aux``). The math is fp32 whatever the weight's dtype. A
``multi_*`` op takes its weights' inputs interleaved (weight, grad, state
... for each) with one learning rate and weight decay each (``lrs``,
``wds``), and returns the new weights, then the new states. Not ported yet
(ROADMAP.md queue A, item A.4): NAG and the other optimizers' ops.
"""
from __future__ import annotations

import torch

from ._utils import as_float_tuple, is_none
from .registry import register


def _f32(t):
    return t if t.dtype == torch.float32 else t.float()


def _as(t, dtype):
    return t if t.dtype == dtype else t.to(dtype)


def _rescale(grad, rescale_grad, clip_gradient, wd=0.0, weight=None):
    """grad * rescale_grad, clipped to ±clip_gradient when that is
    positive, then + wd * weight: the reference's order. Each step is one
    kernel, and none is launched for a factor of 1 (the ops are called once
    per parameter a step, so their launches are the host's cost)."""
    g = _f32(grad)
    if float(rescale_grad) != 1.0:
        g = g * float(rescale_grad)
    if not is_none(clip_gradient) and float(clip_gradient) > 0:
        c = float(clip_gradient)
        g = torch.clamp(g, -c, c)
    if wd and weight is not None:
        g = torch.add(g, _f32(weight), alpha=float(wd))
    return g


def _momentum(mom, g, lr, momentum):
    """momentum * mom - lr * g, in fp32."""
    return torch.add(_f32(mom) * float(momentum), g, alpha=-float(lr))


@register("sgd_update", num_outputs=1)
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True, **kw):
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight)
    return _as(torch.add(_f32(weight), g, alpha=-float(lr)), weight.dtype)


@register("sgd_mom_update", num_outputs=2, mutate_aux=(2,))
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                    **kw):
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = _momentum(mom, g, lr, momentum)
    return _as(_f32(weight) + new_mom, weight.dtype), _as(new_mom, mom.dtype)


@register("mp_sgd_update", num_outputs=2, mutate_aux=(2,))
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True, **kw):
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight32)
    new_w32 = torch.add(weight32, g, alpha=-float(lr))
    return _as(new_w32, weight.dtype), new_w32


@register("mp_sgd_mom_update", num_outputs=3, mutate_aux=(2, 3))
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True, **kw):
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight32)
    new_mom = _momentum(mom, g, lr, momentum)
    new_w32 = weight32 + new_mom
    return _as(new_w32, weight.dtype), new_mom, new_w32


def _per_weight(v, n):
    """A scalar-or-sequence attr as n floats (a Symbol/JSON path writes a
    tuple as a string)."""
    return list(as_float_tuple(v, n))


def _n_weights(attrs):
    return int(attrs.get("num_weights", 1))


@register("multi_sgd_update", num_outputs=_n_weights)
def _multi_sgd_update(*data, lrs=0.01, wds=0.0, rescale_grad=1.0,
                      clip_gradient=-1.0, num_weights=1, **kw):
    n = int(num_weights)
    lrs, wds = _per_weight(lrs, n), _per_weight(wds, n)
    return tuple(_sgd_update(data[2 * i], data[2 * i + 1], lr=lrs[i],
                             wd=wds[i], rescale_grad=rescale_grad,
                             clip_gradient=clip_gradient) for i in range(n))


@register("multi_sgd_mom_update",
          num_outputs=lambda attrs: 2 * _n_weights(attrs),
          mutate_aux=lambda attrs: tuple(
              3 * i + 2 for i in range(_n_weights(attrs))))
def _multi_sgd_mom_update(*data, lrs=0.01, wds=0.0, momentum=0.0,
                          rescale_grad=1.0, clip_gradient=-1.0,
                          num_weights=1, **kw):
    n = int(num_weights)
    lrs, wds = _per_weight(lrs, n), _per_weight(wds, n)
    outs = [_sgd_mom_update(*data[3 * i:3 * i + 3], lr=lrs[i],
                            momentum=momentum, wd=wds[i],
                            rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient) for i in range(n)]
    return tuple(o[0] for o in outs) + tuple(o[1] for o in outs)


@register("multi_mp_sgd_update",
          num_outputs=lambda attrs: 2 * _n_weights(attrs),
          mutate_aux=lambda attrs: tuple(
              3 * i + 2 for i in range(_n_weights(attrs))))
def _multi_mp_sgd_update(*data, lrs=0.01, wds=0.0, rescale_grad=1.0,
                         clip_gradient=-1.0, num_weights=1, **kw):
    n = int(num_weights)
    lrs, wds = _per_weight(lrs, n), _per_weight(wds, n)
    outs = [_mp_sgd_update(*data[3 * i:3 * i + 3], lr=lrs[i], wd=wds[i],
                           rescale_grad=rescale_grad,
                           clip_gradient=clip_gradient) for i in range(n)]
    return tuple(o[0] for o in outs) + tuple(o[1] for o in outs)


@register("multi_mp_sgd_mom_update",
          num_outputs=lambda attrs: 3 * _n_weights(attrs),
          mutate_aux=lambda attrs: tuple(
              4 * i + o for i in range(_n_weights(attrs)) for o in (2, 3)))
def _multi_mp_sgd_mom_update(*data, lrs=0.01, wds=0.0, momentum=0.0,
                             rescale_grad=1.0, clip_gradient=-1.0,
                             num_weights=1, **kw):
    n = int(num_weights)
    lrs, wds = _per_weight(lrs, n), _per_weight(wds, n)
    outs = [_mp_sgd_mom_update(*data[4 * i:4 * i + 4], lr=lrs[i],
                               momentum=momentum, wd=wds[i],
                               rescale_grad=rescale_grad,
                               clip_gradient=clip_gradient)
            for i in range(n)]
    return tuple(o[0] for o in outs) + tuple(x for o in outs for x in o[1:])
