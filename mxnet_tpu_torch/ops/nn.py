"""Neural-network ops: the port of `mxnet_tpu/ops/nn.py`
(`src/operator/nn/`: fully_connected, convolution, deconvolution, pooling,
activation, leaky_relu, softmax, softmax_activation, batch_norm,
layer_norm, dropout, upsampling, lrn; `instance_norm.cc`,
`softmax_output.cc`, `regression_output.cc`, `make_loss.cc`,
`bilinear_sampler.cc`, `grid_generator.cc`,
`identity_attach_KL_sparse_reg.cc`).

Layout is NCHW, as at the reference's API. Convolution and FullyConnected
call cuDNN and cuBLAS through `torch.nn.functional`, as the JAX package
calls XLA's convolution and dot; on the card both accumulate half inputs in
fp32. BatchNorm computes in fp32 for half inputs and returns its new moving
stats as extra outputs, which the frontend writes back in place
(``mutate_aux``). Deconvolution calls `conv_transpose` (its weight is
``(in, out / groups, *kernel)``, the reference's layout), and the output
layers (SoftmaxOutput, the regression outputs) carry the reference's
loss-layer gradients, whatever the head gradient. Every name of the JAX
file is ported.
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


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution")
def _deconvolution(data, weight, *maybe_bias, kernel=None, stride=None,
                   dilate=None, pad=None, adj=None, target_shape=None,
                   num_filter=None, num_group=1, no_bias=True, layout=None,
                   workspace=1024, cudnn_tune=None, cudnn_off=False, **kw):
    """The transposed convolution (`deconvolution.cc`): the gradient of
    Convolution with respect to its data. ``adj`` pads the output's far
    edge (`output_padding`); ``target_shape`` is taken and, as in the JAX
    package, not applied."""
    kernel = as_tuple(kernel)
    nd = len(kernel)
    stride = as_tuple(stride, nd) or (1,) * nd
    dilate = as_tuple(dilate, nd) or (1,) * nd
    pad = as_tuple(pad, nd) or (0,) * nd
    adj = as_tuple(adj, nd) or (0,) * nd
    bias = maybe_bias[0] if maybe_bias and not parse_bool(no_bias) else None
    return _CONV_T[nd](data, weight, bias, stride, pad, adj, int(num_group),
                       dilate)


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


@register("UpSampling")
def _upsampling(*args, scale=1, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", workspace=512,
                **kw):
    """Nearest: each pixel repeated ``scale`` times along H and W, further
    inputs scaled to the first one's output and concatenated on the
    channels. Bilinear: ``args`` are (data, weight), a depthwise
    Deconvolution with the weight's kernel and stride ``scale``."""
    data = args[0]
    s = int(scale)
    if sample_type == "nearest":
        def up(x, f):
            return x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)

        out = up(data, s)
        if len(args) > 1 and multi_input_mode == "concat":
            out = torch.cat([out] + [up(a, data.shape[2] * s // a.shape[2])
                                     for a in args[1:]], dim=1)
        return out
    weight = args[1]
    k = weight.shape[-1]
    pad = (k - s) // 2 if (k - s) % 2 == 0 else (k - s + 1) // 2
    return _deconvolution(data, weight, kernel=(k, k), stride=(s, s),
                          pad=(pad, pad), num_group=data.shape[1],
                          no_bias=True)


@register("LRN")
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **kw):
    """Local response normalization across channels (`lrn.cc`):
    x / (knorm + alpha / nsize * sum of x^2 over nsize channels)^beta."""
    n = int(nsize)
    half = n // 2
    sq = F.pad(torch.square(data), (0, 0, 0, 0, half, half))
    win = sum(sq[:, i:i + data.shape[1]] for i in range(n))
    return data / torch.pow(float(knorm) + float(alpha) / n * win,
                            float(beta))


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


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU", needs_rng=True, needs_mode=True)
def _leaky_relu(gen, data, *maybe_gamma, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334, _train=False, **kw):
    """The LeakyReLU family (`leaky_relu.cc`): leaky, prelu (``gamma`` per
    channel), elu, selu, gelu (the erf form) and rrelu, whose negative
    slope is drawn from U(lower_bound, upper_bound) in training and is
    their mean otherwise."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, float(slope) * data)
    if act_type == "prelu":
        gamma = maybe_gamma[0]
        if gamma.dim() == 1 and data.dim() > 1:
            gamma = gamma.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(data >= 0, data, gamma * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, float(slope) * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(
            data >= 0, data, _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "rrelu":
        lo, hi = float(lower_bound), float(upper_bound)
        if parse_bool(_train):
            r = torch.empty(data.shape, dtype=torch.float32,
                            device=data.device).uniform_(lo, hi,
                                                         generator=gen)
            return torch.where(data >= 0, data, r.to(data.dtype) * data)
        return torch.where(data >= 0, data, (lo + hi) / 2.0 * data)
    raise ValueError(f"unknown act_type {act_type}")


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


@register("SoftmaxActivation")
def _softmax_activation(data, mode="instance", **kw):
    """softmax over the channels (axis 1) with ``mode="channel"``, else
    over everything but the batch axis."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


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
    # half data keeps fp32 statistics; fp32 and fp64 data their own type
    stat = torch.float32 if data.dtype in (torch.float16, torch.bfloat16) \
        else data.dtype
    gamma = gamma.to(stat)
    beta = beta.to(stat)
    if parse_bool(fix_gamma):
        # ones, but still a function of gamma with a zero gradient
        gamma = gamma * 0 + 1 if gamma.requires_grad \
            else torch.ones_like(gamma)
    rm, rv = moving_mean.to(stat), moving_var.to(stat)
    if parse_bool(_train) and not parse_bool(use_global_stats):
        # half inputs with fp32 gamma/beta run torch's mixed-type kernels,
        # which compute in fp32
        out, mean, invstd = torch.ops.aten.native_batch_norm(
            data, gamma, beta, None, None, True, 0.0, eps)
        with torch.no_grad():
            # m * old + (1 - m) * batch, one kernel each
            new_mean = torch.lerp(mean.to(stat), rm, momentum).to(
                moving_mean.dtype)
            new_var = torch.lerp(invstd.to(stat) ** -2 - eps, rv,
                                 momentum).to(moving_var.dtype)
    else:
        out = torch.batch_norm(data, gamma, beta, rm, rv, False, 0.0, eps,
                               torch.backends.cudnn.enabled)
        new_mean, new_var = moving_mean, moving_var
    if axis != 1:
        out = torch.movedim(out, 1, axis)
    return out, new_mean, new_var


@register("_contrib_SyncBatchNorm", needs_mode=True, num_outputs=3,
          mutate_aux=(3, 4))
def _sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                     momentum=0.9, fix_gamma=True, use_global_stats=False,
                     output_mean_var=False, ndev=1, key=None, _train=False,
                     **kw):
    """BatchNorm over the channel axis of one process's batch, as the JAX
    op is on one device; the reduction across cards waits for the
    multi-card port (ROADMAP.md queue A, item A.9)."""
    return _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                       momentum=momentum, fix_gamma=fix_gamma,
                       use_global_stats=use_global_stats, axis=1,
                       _train=_train)


@register("InstanceNorm")
def _instance_norm(data, gamma, beta, eps=1e-3, **kw):
    """Each sample's each channel normalized over its spatial axes, in
    fp32 for half inputs (`instance_norm.cc`)."""
    xf = data.to(torch.float32)
    var, mean = torch.var_mean(xf, dim=tuple(range(2, data.dim())),
                               keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    out = (xf - mean) * torch.rsqrt(var + float(eps))
    out = out * gamma.to(torch.float32).reshape(shape) \
        + beta.to(torch.float32).reshape(shape)
    return out.to(data.dtype)


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


# -- output layers: the forward's value, the reference's gradient ----------

class _RegressionOutput(torch.autograd.Function):
    """Forward ``fwd(data)``; backward ``residual(out, label) *
    grad_scale`` whatever the head gradient, and no gradient for the
    label (`regression_output-inl.h`)."""

    @staticmethod
    def forward(ctx, data, label, fwd, residual, grad_scale):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.residual, ctx.grad_scale = residual, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad = ctx.residual(out, label.reshape(out.shape)) * ctx.grad_scale
        return (grad.to(out.dtype), torch.zeros_like(label), None, None,
                None)


def _identity(x):
    return x


def _difference(p, label):
    return p - label


def _sign_of_difference(p, label):
    return torch.sign(p - label)


@register("LinearRegressionOutput")
def _linear_regression_output(data, label, grad_scale=1.0, **kw):
    return _RegressionOutput.apply(data, label, _identity, _difference,
                                   float(grad_scale))


@register("MAERegressionOutput")
def _mae_regression_output(data, label, grad_scale=1.0, **kw):
    return _RegressionOutput.apply(data, label, _identity,
                                   _sign_of_difference, float(grad_scale))


@register("LogisticRegressionOutput")
def _logistic_regression_output(data, label, grad_scale=1.0, **kw):
    return _RegressionOutput.apply(data, label, torch.sigmoid, _difference,
                                   float(grad_scale))


@register("MakeLoss")
def _make_loss_op(data, grad_scale=1.0, valid_thresh=0.0,
                  normalization="null", **kw):
    """The identity, as the JAX op is: the head gradient passes through."""
    return data


# -- sampling grids ---------------------------------------------------------

@register("BilinearSampler")
def _bilinear_sampler(data, grid, cudnn_off=False, **kw):
    """``data`` (N, C, H, W) sampled at ``grid`` (N, 2, Ho, Wo), whose
    (x, y) in [-1, 1] map to the corner pixels' centres (0 .. W - 1):
    bilinear over the four neighbours, and zero where the point lies
    outside the image, as the JAX op computes."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = (gx - x0)[:, None], (gy - y0)[:, None]
    flat = data.reshape(n, c, h * w)

    def sample(xi, yi):
        idx = (torch.clamp(yi, 0, h - 1).long() * w
               + torch.clamp(xi, 0, w - 1).long())
        return torch.gather(flat, 2, idx.reshape(n, 1, -1).expand(
            n, c, -1)).reshape(n, c, *idx.shape[1:])

    out = (sample(x0, y0) * (1 - wx) * (1 - wy)
           + sample(x0 + 1, y0) * wx * (1 - wy)
           + sample(x0, y0 + 1) * (1 - wx) * wy
           + sample(x0 + 1, y0 + 1) * wx * wy)
    inside = ((gx >= 0) & (gx <= w - 1) & (gy >= 0) & (gy <= h - 1))[:, None]
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype,
                                                device=out.device)).to(
        data.dtype)


@register("GridGenerator")
def _grid_generator(data, transform_type="affine", target_shape=(0, 0),
                    **kw):
    """A sampling grid of ``target_shape`` in [-1, 1] (endpoints
    included): the affine map ``data`` (N, 6) of the target grid, or
    (``warp``) the grid plus the flow ``data`` (N, 2, H, W)."""
    th, tw = as_tuple(target_shape)
    ys = torch.linspace(-1.0, 1.0, th, device=data.device)
    xs = torch.linspace(-1.0, 1.0, tw, device=data.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    if transform_type == "affine":
        base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                            torch.ones_like(gx).reshape(-1)])
        out = torch.einsum("nij,jk->nik", data.reshape(-1, 2, 3),
                           base.to(data.dtype))
        return out.reshape(-1, 2, th, tw)
    return data + torch.stack([gx, gy])[None].to(data.dtype)


@register("IdentityAttachKLSparseReg")
def _identity_kl(data, sparseness_target=0.1, penalty=0.001, momentum=0.9,
                 **kw):
    """The identity, as the JAX op is (no sparseness penalty)."""
    return data
