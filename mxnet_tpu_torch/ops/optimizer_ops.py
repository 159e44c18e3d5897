"""Fused optimizer-update ops: the port of `mxnet_tpu/ops/optimizer_ops.py`
(`optimizer_op.cc`: the SGD family and its aggregated ``multi_*`` ops,
nag_mom_update, adam_update, ftml_update, rmsprop_update,
rmspropalex_update, ftrl_update, signsgd_update, signum_update,
``_sparse_adagrad_update``; `contrib/adamw.cc`: the four AdamW ops;
`contrib/optimizer_op.cc`: ``_contrib_group_adagrad_update``).

Each op returns ``(new_weight, new_state...)``; callers pass ``out=weight``,
and the frontend copies the states into their arrays in place
(``mutate_aux``). The math is fp32 whatever the weight's dtype. A
``multi_*`` op takes its weights' inputs interleaved (weight, grad, state
... for each) with one learning rate and weight decay each (``lrs``,
``wds``), and returns the new weights, then the new states. The ops take
dense gradients: a row-sparse one reaches them densified, and the lazy
rows-only SGD and Adam updates of a row-sparse gradient are `optimizer.py`'s
(`_sparse_sgd_update`, `_sparse_adam_update`). With a zero row the AdaGrad
ops move nothing, as the reference's rows-only one.
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


def _clip(g, clip_gradient):
    if not is_none(clip_gradient) and float(clip_gradient) > 0:
        c = float(clip_gradient)
        g = torch.clamp(g, -c, c)
    return g


def _clip_weights(w, clip_weights):
    if not is_none(clip_weights) and float(clip_weights) > 0:
        cw = float(clip_weights)
        w = torch.clamp(w, -cw, cw)
    return w


@register("nag_mom_update", num_outputs=2, mutate_aux=(2,))
def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, **kw):
    """Nesterov momentum: m = momentum * m + g; w -= lr * (g + momentum *
    m)."""
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = _f32(mom) * float(momentum) + g
    new_w = _f32(weight) - float(lr) * (g + float(momentum) * new_mom)
    return _as(new_w, weight.dtype), _as(new_mom, mom.dtype)


@register("mp_nag_mom_update", num_outputs=3, mutate_aux=(2, 3))
def _mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, **kw):
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight32)
    new_mom = float(momentum) * mom + g
    new_w32 = weight32 - float(lr) * (g + float(momentum) * new_mom)
    return _as(new_w32, weight.dtype), new_mom, new_w32


@register("adam_update", num_outputs=3, mutate_aux=(2, 3))
def _adam_update(weight, grad, mean, var, lr=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True, **kw):
    """Adam's step without bias correction (the optimizer folds it into
    ``lr``): m, v moved by beta1, beta2; w -= lr * m / (sqrt(v) +
    epsilon)."""
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight)
    b1, b2 = float(beta1), float(beta2)
    new_mean = b1 * _f32(mean) + (1 - b1) * g
    new_var = b2 * _f32(var) + (1 - b2) * torch.square(g)
    new_w = _f32(weight) - float(lr) * new_mean / (
        torch.sqrt(new_var) + float(epsilon))
    return (_as(new_w, weight.dtype), _as(new_mean, mean.dtype),
            _as(new_var, var.dtype))


@register("ftml_update", num_outputs=4, mutate_aux=(2, 3, 4))
def _ftml_update(weight, grad, d, v, z, lr=0.01, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0, t=1,
                 **kw):
    """Follow the moving leader at step ``t`` (`optimizer_op.cc`
    FTMLUpdate)."""
    g = _rescale(grad, rescale_grad, clip_grad, wd, weight)
    b1, b2, eps, t = float(beta1), float(beta2), float(epsilon), int(t)
    new_v = b2 * v + (1 - b2) * torch.square(g)
    d_t = (1 - b1 ** t) / float(lr) * (torch.sqrt(new_v / (1 - b2 ** t))
                                       + eps)
    sigma = d_t - b1 * d
    new_z = b1 * z + (1 - b1) * g - sigma * _f32(weight)
    new_w = -new_z / d_t
    return _as(new_w, weight.dtype), d_t, new_v, new_z


@register("rmsprop_update", num_outputs=2, mutate_aux=(2,))
def _rmsprop_update(weight, grad, n, lr=0.01, gamma1=0.95, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0, **kw):
    """RMSProp (Tieleman and Hinton): n = gamma1 n + (1 - gamma1) g^2;
    w -= lr g / sqrt(n + epsilon)."""
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight)
    g1 = float(gamma1)
    new_n = g1 * n + (1 - g1) * torch.square(g)
    new_w = _f32(weight) - float(lr) * g / torch.sqrt(new_n + float(epsilon))
    return _as(_clip_weights(new_w, clip_weights), weight.dtype), new_n


@register("rmspropalex_update", num_outputs=4, mutate_aux=(2, 3, 4))
def _rmspropalex_update(weight, grad, n, g, delta, lr=0.01, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0, **kw):
    """Centered RMSProp (Graves 2013)."""
    gr = _rescale(grad, rescale_grad, clip_gradient, wd, weight)
    g1, g2 = float(gamma1), float(gamma2)
    new_n = g1 * n + (1 - g1) * torch.square(gr)
    new_g = g1 * g + (1 - g1) * gr
    new_delta = g2 * delta - float(lr) * gr / torch.sqrt(
        new_n - torch.square(new_g) + float(epsilon))
    new_w = _clip_weights(_f32(weight) + new_delta, clip_weights)
    return _as(new_w, weight.dtype), new_n, new_g, new_delta


@register("ftrl_update", num_outputs=3, mutate_aux=(2, 3))
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0, **kw):
    """FTRL-proximal: the weight is 0 where |z| <= lamda1."""
    g = _rescale(grad, rescale_grad, clip_gradient)
    w = _f32(weight)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / float(lr)
    new_z = z + g - sigma * w
    l1, b, wd = float(lamda1), float(beta), float(wd)
    new_w = torch.where(
        torch.abs(new_z) > l1,
        -(new_z - torch.sign(new_z) * l1) / (
            (b + torch.sqrt(new_n)) / float(lr) + wd),
        torch.zeros((), dtype=torch.float32, device=w.device))
    return _as(new_w, weight.dtype), new_z, new_n


@register("signsgd_update", num_outputs=1)
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, **kw):
    """w -= lr * (sign(g) + wd * w)."""
    g = _rescale(grad, rescale_grad, clip_gradient)
    w = _f32(weight)
    return _as(w - float(lr) * (torch.sign(g) + float(wd) * w), weight.dtype)


@register("signum_update", num_outputs=2, mutate_aux=(2,))
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0, **kw):
    """Signum: m = momentum m - (1 - momentum) g; w = (1 - lr wd_lh) w +
    lr sign(m)."""
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = float(momentum) * mom - (1 - float(momentum)) * g
    new_w = (1 - float(lr) * float(wd_lh)) * _f32(weight) + \
        float(lr) * torch.sign(new_mom)
    return _as(new_w, weight.dtype), new_mom


def _adamw(w32, grad, mean, var, scale, lr, beta1, beta2, epsilon, wd, eta,
           clip_gradient):
    """AdamW's arithmetic (`contrib/adamw.cc`): the decay decoupled from
    the moments, the whole step times ``eta``."""
    g = _clip(_f32(grad) * scale, clip_gradient)
    b1, b2 = float(beta1), float(beta2)
    new_mean = b1 * mean + (1 - b1) * g
    new_var = b2 * var + (1 - b2) * torch.square(g)
    new_w = w32 - float(eta) * (float(lr) * new_mean / (
        torch.sqrt(new_var) + float(epsilon)) + float(wd) * w32)
    return new_w, new_mean, new_var


def _scale_attr(rescale_grad_t, rescale_grad):
    return float(rescale_grad) if rescale_grad_t is None else rescale_grad_t


@register("_contrib_adamw_update", aliases=["contrib_adamw_update"],
          num_outputs=3, mutate_aux=(2, 3))
def _adamw_update(weight, grad, mean, var, rescale_grad_t=None, lr=0.01,
                  beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                  rescale_grad=1.0, clip_gradient=-1.0, **kw):
    new_w, new_mean, new_var = _adamw(
        _f32(weight), grad, mean, var,
        _scale_attr(rescale_grad_t, rescale_grad), lr, beta1, beta2,
        epsilon, wd, eta, clip_gradient)
    return _as(new_w, weight.dtype), new_mean, new_var


@register("_contrib_mp_adamw_update", num_outputs=4, mutate_aux=(2, 3, 4))
def _mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad_t=None,
                     lr=0.01, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                     eta=1.0, rescale_grad=1.0, clip_gradient=-1.0, **kw):
    new_w32, new_mean, new_var = _adamw(
        weight32, grad, mean, var, _scale_attr(rescale_grad_t, rescale_grad),
        lr, beta1, beta2, epsilon, wd, eta, clip_gradient)
    return _as(new_w32, weight.dtype), new_mean, new_var, new_w32


# AdamW with the rescale as a tensor input (dynamic loss scaling,
# `contrib/adamw.cc:53,98`): a scale that is NaN, infinite or 0 skips the
# step, chosen on the device with no host synchronization.

def _finite_scale(rescale_grad):
    rs = rescale_grad.reshape(()).to(torch.float32)
    return rs, torch.isfinite(rs) & (rs != 0)


@register("_adamw_update", num_outputs=3, mutate_aux=(2, 3))
def _adamw_update_t(weight, grad, mean, var, rescale_grad, lr=0.01,
                    beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                    clip_gradient=-1.0, **kw):
    rs, ok = _finite_scale(rescale_grad)
    w = _f32(weight)
    new_w, new_mean, new_var = _adamw(w, grad, mean, var, rs, lr, beta1,
                                      beta2, epsilon, wd, eta, clip_gradient)
    return (_as(torch.where(ok, new_w, w), weight.dtype),
            torch.where(ok, new_mean, mean), torch.where(ok, new_var, var))


@register("_mp_adamw_update", num_outputs=4, mutate_aux=(2, 3, 4))
def _mp_adamw_update_t(weight, grad, mean, var, weight32, rescale_grad,
                       lr=0.01, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                       eta=1.0, clip_gradient=-1.0, **kw):
    rs, ok = _finite_scale(rescale_grad)
    new_w32, new_mean, new_var = _adamw(weight32, grad, mean, var, rs, lr,
                                        beta1, beta2, epsilon, wd, eta,
                                        clip_gradient)
    new_w32 = torch.where(ok, new_w32, weight32)
    return (_as(new_w32, weight.dtype), torch.where(ok, new_mean, mean),
            torch.where(ok, new_var, var), new_w32)


@register("_sparse_adagrad_update", num_outputs=2, mutate_aux=(2,))
def _sparse_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7,
                           wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                           **kw):
    """AdaGrad (`optimizer_op.cc:840`): history += g^2; w -= lr g /
    sqrt(history + epsilon)."""
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight)
    new_hist = _f32(history) + torch.square(g)
    new_w = _f32(weight) - float(lr) * g / torch.sqrt(
        new_hist + float(epsilon))
    return _as(new_w, weight.dtype), _as(new_hist, history.dtype)


@register("_contrib_group_adagrad_update",
          aliases=["contrib_group_adagrad_update"], num_outputs=2,
          mutate_aux=(2,))
def _group_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-5,
                          rescale_grad=1.0, clip_gradient=-1.0, **kw):
    """AdaGrad with one accumulator a row (`contrib/optimizer_op.cc:53`):
    history += mean of g^2 over each row."""
    g = _rescale(grad, rescale_grad, clip_gradient)
    axes = tuple(range(1, g.dim()))
    g2 = torch.mean(torch.square(g), dim=axes, keepdim=True) if axes \
        else torch.square(g)
    new_hist = _f32(history) + g2.reshape(history.shape)
    new_w = _f32(weight) - float(lr) * g / torch.sqrt(
        new_hist.reshape(g2.shape) + float(epsilon))
    return _as(new_w, weight.dtype), _as(new_hist, history.dtype)
