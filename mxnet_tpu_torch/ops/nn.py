"""Neural-network ops, the ResNet set: the port of part of
`mxnet_tpu/ops/nn.py` (`src/operator/nn/`: fully_connected, convolution,
pooling, activation, softmax, batch_norm, layer_norm, dropout;
`softmax_output.cc`).

Layout is NCHW, as at the reference's API. Convolution and FullyConnected
call cuDNN and cuBLAS through `torch.nn.functional`, as the JAX package
calls XLA's convolution and dot; on the card both accumulate half inputs in
fp32. BatchNorm computes in fp32 for half inputs and returns its new moving
stats as extra outputs, which the frontend writes back in place
(``mutate_aux``). Not ported yet (ROADMAP.md queue A): Deconvolution,
UpSampling, LRN, LeakyReLU, InstanceNorm, `_contrib_SyncBatchNorm`, the
regression outputs, MakeLoss, BilinearSampler, GridGenerator,
IdentityAttachKLSparseReg and SoftmaxActivation.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from ._utils import as_tuple, is_none, parse_bool
from .registry import register


@register("FullyConnected")
def _fully_connected(data, weight, *maybe_bias, num_hidden=None,
                     no_bias=False, flatten=True, **kw):
    """y = x W^T + b (`fully_connected.cc`); the weight is (num_hidden,
    in_units), `torch.nn.Linear`'s layout. ``flatten`` folds every axis
    after the first into the input units."""
    if parse_bool(flatten) and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    bias = maybe_bias[0] if maybe_bias and not parse_bool(no_bias) else None
    return F.linear(data, weight, bias)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution")
def _convolution(data, weight, *maybe_bias, kernel=None, stride=None,
                 dilate=None, pad=None, num_filter=None, num_group=1,
                 no_bias=False, layout=None, workspace=1024, cudnn_tune=None,
                 cudnn_off=False, **kw):
    kernel = as_tuple(kernel)
    nd = len(kernel)
    stride = as_tuple(stride, nd) or (1,) * nd
    dilate = as_tuple(dilate, nd) or (1,) * nd
    pad = as_tuple(pad, nd) or (0,) * nd
    bias = maybe_bias[0] if maybe_bias and not parse_bool(no_bias) else None
    return _CONV[nd](data, weight, bias, stride, pad, dilate, int(num_group))


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling")
def _pooling(data, kernel=None, pool_type="max", global_pool=False,
             stride=None, pad=None, pooling_convention="valid",
             cudnn_off=False, p_value=2, count_include_pad=True, **kw):
    """Max, avg, sum and lp pooling (`pooling.cc`). The input is padded
    explicitly, by ``pad`` on the left and, with ``pooling_convention=
    "full"``, on the right by as much as the last partial window needs
    (the JAX package's rule, `nn.py:206-213`, which is not torch's
    ``ceil_mode`` at every shape); then pooled with no padding of torch's.
    With ``count_include_pad`` an average divides by the window size, else
    by the count of input elements in the window."""
    nd = data.dim() - 2
    axes = tuple(range(2, data.dim()))
    if parse_bool(global_pool):
        if pool_type == "max":
            return torch.amax(data, dim=axes, keepdim=True)
        if pool_type == "sum":
            return torch.sum(data, dim=axes, keepdim=True)
        if pool_type == "avg":
            return torch.mean(data, dim=axes, keepdim=True)
        if pool_type == "lp":
            p = float(p_value)
            return torch.sum(torch.abs(data) ** p, dim=axes,
                             keepdim=True) ** (1.0 / p)
        raise ValueError(f"unknown pool_type {pool_type}")
    kernel = as_tuple(kernel, nd)
    stride = as_tuple(stride, nd) or (1,) * nd
    pad = as_tuple(pad, nd) or (0,) * nd
    pads = []
    for i in range(nd):
        hi = pad[i]
        if pooling_convention == "full":
            in_sz = data.shape[2 + i]
            out_sz = max(0, math.ceil(
                (in_sz + 2 * pad[i] - kernel[i]) / stride[i])) + 1
            hi = max((out_sz - 1) * stride[i] + kernel[i] - in_sz - pad[i],
                     pad[i])
        pads.append((pad[i], hi))
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    padded = any(flat)

    def pad_with(x, value):
        return F.pad(x, flat, value=value) if padded else x

    if pool_type == "max":
        fill = -math.inf if data.is_floating_point() \
            else torch.iinfo(data.dtype).min
        return _MAX_POOL[nd](pad_with(data, fill), kernel, stride)
    if pool_type in ("avg", "sum"):
        avg = _AVG_POOL[nd](pad_with(data, 0.0), kernel, stride)
        if pool_type == "sum":
            return avg * math.prod(kernel)
        if parse_bool(count_include_pad) or not padded:
            return avg
        ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                          device=data.device)
        return avg / _AVG_POOL[nd](pad_with(ones, 0.0), kernel, stride)
    if pool_type == "lp":
        p = float(p_value)
        s = _AVG_POOL[nd](pad_with(torch.abs(data) ** p, 0.0), kernel,
                          stride) * math.prod(kernel)
        return s ** (1.0 / p)
    raise ValueError(f"unknown pool_type {pool_type}")


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}


@register("Activation")
def _activation(data, act_type="relu", **kw):
    return _ACTIVATIONS[act_type](data)


def _softmax_like(fn, data, axis, temperature, dtype):
    x = data if is_none(temperature) else data / float(temperature)
    out = fn(x.to(torch.float32), dim=int(axis)).to(data.dtype)
    return out if is_none(dtype) else out.to(torch_dtype(dtype))


@register("softmax")
def _softmax(data, axis=-1, temperature=None, dtype=None, use_length=False,
             length=None, **kw):
    """softmax in fp32, cast back to the input's dtype (or ``dtype``)."""
    return _softmax_like(torch.softmax, data, axis, temperature, dtype)


@register("log_softmax")
def _log_softmax(data, axis=-1, temperature=None, dtype=None, **kw):
    return _softmax_like(torch.log_softmax, data, axis, temperature, dtype)


@register("softmin")
def _softmin(data, axis=-1, temperature=None, dtype=None, **kw):
    return _softmax(-data, axis=axis, temperature=temperature, dtype=dtype)


@register("softmax_cross_entropy")
def _softmax_cross_entropy(data, label, **kw):
    logp = torch.log_softmax(data.to(torch.float32), dim=-1)
    picked = torch.gather(logp, -1, label.long()[:, None])
    return (-torch.sum(picked)).to(data.dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """Forward softmax; backward the loss layer's (p - onehot)·grad_scale,
    whatever the head gradient (`softmax_output.cc`)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, multi_output,
                use_ignore, normalization):
        axis = 1 if multi_output else -1
        p = torch.softmax(data, dim=axis)
        ctx.save_for_backward(p, label)
        ctx.attrs = (grad_scale, ignore_label, axis, use_ignore,
                     normalization)
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        grad_scale, ignore_label, axis, use_ignore, normalization = ctx.attrs
        lab = label.long()
        classes = [1] * p.dim()
        classes[axis] = p.shape[axis]
        # a label outside the classes (ignore_label -1) has no one
        onehot = lab.unsqueeze(axis) == torch.arange(
            p.shape[axis], device=p.device).reshape(classes)
        grad = p - onehot.to(p.dtype)
        keep = (lab != ignore_label).to(p.dtype)
        if use_ignore:
            grad = grad * keep.unsqueeze(axis)
        if normalization == "batch" or (normalization == "valid"
                                        and not use_ignore):
            grad = grad / p.shape[0]
        elif normalization == "valid":
            grad = grad / torch.clamp(keep.sum(), min=1.0)
        grad = (grad * grad_scale).to(p.dtype)
        return grad, torch.zeros_like(label), None, None, None, None, None


@register("SoftmaxOutput", aliases=["Softmax"])
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0, **kw):
    return _SoftmaxOutput.apply(
        data, label, float(grad_scale), int(float(ignore_label)),
        parse_bool(multi_output), parse_bool(use_ignore), normalization)


@register("BatchNorm", aliases=["BatchNorm_v1"], needs_mode=True,
          num_outputs=3, mutate_aux=(3, 4))
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False, _train=False,
                **kw):
    """Returns (out, new_moving_mean, new_moving_var) (`batch_norm.cc`).

    Training normalizes by the batch's mean and biased variance and moves
    the stats MXNet's way, new = momentum * old + (1 - momentum) * batch,
    computed outside the graph; otherwise (or with ``use_global_stats``)
    it normalizes by the moving stats, which stay. ``fix_gamma`` uses a
    gamma of ones and gives gamma a zero gradient. `torch.batch_norm`'s
    own running-stat update (unbiased variance, momentum 1 - m) is never
    used."""
    axis = int(axis) % data.dim()
    if axis != 1:
        data = torch.movedim(data, axis, 1)
    eps, momentum = float(eps), float(momentum)
    gamma = gamma.to(torch.float32)
    beta = beta.to(torch.float32)
    if parse_bool(fix_gamma):
        # ones, but still a function of gamma with a zero gradient
        gamma = gamma * 0 + 1 if gamma.requires_grad \
            else torch.ones_like(gamma)
    rm, rv = moving_mean.to(torch.float32), moving_var.to(torch.float32)
    if parse_bool(_train) and not parse_bool(use_global_stats):
        # half inputs with fp32 gamma/beta run torch's mixed-type kernels,
        # which compute in fp32
        out, mean, invstd = torch.ops.aten.native_batch_norm(
            data, gamma, beta, None, None, True, 0.0, eps)
        with torch.no_grad():
            # m * old + (1 - m) * batch, one kernel each
            new_mean = torch.lerp(mean.to(torch.float32), rm, momentum).to(
                moving_mean.dtype)
            new_var = torch.lerp(invstd.to(torch.float32) ** -2 - eps, rv,
                                 momentum).to(moving_var.dtype)
    else:
        out = torch.batch_norm(data, gamma, beta, rm, rv, False, 0.0, eps,
                               torch.backends.cudnn.enabled)
        new_mean, new_var = moving_mean, moving_var
    if axis != 1:
        out = torch.movedim(out, 1, axis)
    return out, new_mean, new_var


@register("LayerNorm")
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False,
                **kw):
    axis = int(axis) % data.dim()
    xf = data.to(torch.float32)
    var, mean = torch.var_mean(xf, dim=axis, keepdim=True, correction=0)
    out = (xf - mean) * torch.rsqrt(var + float(eps))
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    out = out * gamma.to(torch.float32).reshape(shape) \
        + beta.to(torch.float32).reshape(shape)
    return out.to(data.dtype)


@register("Dropout", needs_rng=True, needs_mode=True)
def _dropout(gen, data, p=0.5, mode="training", axes=(), cudnn_off=False,
             _train=False, **kw):
    """Inverted dropout (`dropout.cc`): in training (or ``mode="always"``)
    each element, or each slice along ``axes``, is kept with probability
    1 - p and scaled by 1 / (1 - p); otherwise the identity. The mask is
    drawn from the generator of the data's device."""
    p = float(p)
    if (not parse_bool(_train) and mode != "always") or p == 0.0:
        return data
    axes = as_tuple(axes) or ()
    mshape = tuple(1 if i in axes else s for i, s in enumerate(data.shape))
    keep = 1.0 - p
    mask = torch.empty(mshape, device=data.device).bernoulli_(
        keep, generator=gen).bool()
    return torch.where(mask, data / keep,
                       torch.zeros((), dtype=data.dtype, device=data.device))
