"""Vision ops that train beside the nn ops: the port of part of
`mxnet_tpu/ops/vision.py` (`roi_pooling.cc` ROIPooling,
`spatial_transformer.cc` SpatialTransformer, `correlation.cc`
Correlation, `svm_output.cc` SVMOutput). Each is written with dense
gathers and masked reductions over static shapes, as the JAX package's
are. The other names of that file (ROIAlign, the box and multibox ops,
deformable convolution, adaptive pooling, fft, count_sketch and the
index ops) are ROADMAP.md queue A, item A.4's second half.
"""
from __future__ import annotations

import math

import torch

from ._utils import as_tuple, parse_bool
from .registry import register


def _bilinear_gather(data, ys, xs):
    """``data`` (N, C, H, W) at fractional points ``ys``, ``xs`` (N, ...)
    with the reference's boundary rule (`roi_align.cc:166-180`): a point
    outside [-1, H] x [-1, W] gives zero; one inside is clamped to the
    border. Returns (N, C, ...)."""
    n, c, h, w = data.shape
    valid = (ys >= -1.0) & (ys <= h) & (xs >= -1.0) & (xs <= w)
    y = torch.clamp(ys, 0.0, h - 1.0)
    x = torch.clamp(xs, 0.0, w - 1.0)
    y0, x0 = torch.floor(y).long(), torch.floor(x).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    ly, lx = (y - y0)[:, None], (x - x0)[:, None]
    flat = data.reshape(n, c, h * w)

    def at(yi, xi):
        idx = (yi * w + xi).reshape(n, 1, -1).expand(n, c, -1)
        return torch.gather(flat, 2, idx).reshape(n, c, *ys.shape[1:])

    val = ((1 - ly) * (1 - lx) * at(y0, x0) + (1 - ly) * lx * at(y0, x1)
           + ly * (1 - lx) * at(y1, x0) + ly * lx * at(y1, x1))
    return torch.where(valid[:, None], val, torch.zeros(
        (), dtype=val.dtype, device=val.device))


def _round_half_away(v):
    """C++ ``std::round``: halves away from zero (torch.round is
    half-to-even)."""
    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)


@register("ROIPooling")
def _roi_pooling(data, rois, pooled_size=None, spatial_scale=1.0, **kw):
    """Max pooling over each ROI's quantized bins (`roi_pooling.cc:251`);
    ``rois`` (R, 5) are (batch index, x1, y1, x2, y2) in input pixels
    times ``spatial_scale``. An empty bin gives 0."""
    ph, pw = as_tuple(pooled_size)
    scale = float(spatial_scale)
    _, _, h, w = data.shape
    bidx = rois[:, 0].long()
    r32 = rois.to(torch.float32)
    x1, y1, x2, y2 = (_round_half_away(r32[:, i] * scale).long()
                      for i in (1, 2, 3, 4))
    rh = torch.clamp(y2 - y1 + 1, min=1)
    rw = torch.clamp(x2 - x1 + 1, min=1)

    def bounds(start, extent, p):
        i = torch.arange(p, device=data.device)[None, :]
        ext = extent[:, None].to(torch.float32)
        lo = start[:, None] + torch.floor(i * ext / p).long()
        hi = start[:, None] + torch.ceil((i + 1) * ext / p).long()
        return lo, hi

    hs, he = bounds(y1, rh, ph)                              # (R, ph)
    ws, we = bounds(x1, rw, pw)                              # (R, pw)
    hh = torch.arange(h, device=data.device)
    mask_h = (hh >= torch.clamp(hs, 0, h)[..., None]) & \
        (hh < torch.clamp(he, 0, h)[..., None])              # (R, ph, H)
    ww = torch.arange(w, device=data.device)
    mask_w = (ww >= torch.clamp(ws, 0, w)[..., None]) & \
        (ww < torch.clamp(we, 0, w)[..., None])              # (R, pw, W)
    imgs = data[bidx]                                        # (R, C, H, W)
    neg = torch.full((), -math.inf, dtype=data.dtype, device=data.device)
    m1 = torch.where(mask_h[:, None, :, :, None], imgs[:, :, None], neg)
    m1 = torch.amax(m1, dim=3)                               # (R, C, ph, W)
    m2 = torch.where(mask_w[:, None, None], m1[:, :, :, None], neg)
    out = torch.amax(m2, dim=4)                              # (R, C, ph, pw)
    return torch.where(torch.isfinite(out), out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


@register("SpatialTransformer")
def _spatial_transformer(data, loc, target_shape=None,
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=None, **kw):
    """The spatial transformer (`spatial_transformer.cc:170`): the affine
    map ``loc`` (N, 6) of a ``target_shape`` grid in [-1, 1] (endpoints
    included, fp32), then bilinear sampling of ``data`` there."""
    th, tw = as_tuple(target_shape)
    n, _, h, w = data.shape
    theta = loc.to(torch.float32).reshape(n, 2, 3)
    dev = data.device
    xs = -1.0 + torch.arange(tw, dtype=torch.float32, device=dev) \
        * 2.0 / max(tw - 1, 1)
    ys = -1.0 + torch.arange(th, dtype=torch.float32, device=dev) \
        * 2.0 / max(th - 1, 1)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")           # (th, tw)
    grid = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, th * tw)
    src = torch.einsum("nij,jp->nip", theta, grid)           # (N, 2, th*tw)
    sx = ((src[:, 0] + 1.0) * (w - 1.0) / 2.0).reshape(n, th, tw)
    sy = ((src[:, 1] + 1.0) * (h - 1.0) / 2.0).reshape(n, th, tw)
    return _bilinear_gather(data, sy, sx).to(data.dtype)


@register("Correlation")
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True, **kw):
    """FlowNet's correlation (`correlation.cc:163`): for each displacement
    of the neighbourhood grid, the product (or with ``is_multiply`` off
    the absolute difference) of the two maps summed over a kernel window
    and the channels, over kernel_size^2 * C."""
    ks, md = int(kernel_size), int(max_displacement)
    s1, s2, p = int(stride1), int(stride2), int(pad_size)
    mult = parse_bool(is_multiply)
    _, c, h, w = data1.shape
    kr = (ks - 1) // 2
    border = md + kr
    ph_, pw_ = h + 2 * p, w + 2 * p
    top_h = int(math.ceil(float(ph_ - 2 * border) / s1))
    top_w = int(math.ceil(float(pw_ - 2 * border) / s1))
    ngr = md // s2
    pads = (p, p, p, p)
    d1 = torch.nn.functional.pad(data1, pads)
    d2 = torch.nn.functional.pad(data2, pads)
    norm = float(ks * ks * c)
    dev = data1.device
    cy = border + torch.arange(top_h, device=dev) * s1
    cx = border + torch.arange(top_w, device=dev) * s1
    zero = torch.zeros((), dtype=d2.dtype, device=dev)
    outs = []
    for dy in range(-ngr, ngr + 1):
        for dx in range(-ngr, ngr + 1):
            oy, ox = dy * s2, dx * s2
            acc = 0.0
            for uy in range(-kr, kr + 1):
                for ux in range(-kr, kr + 1):
                    a = d1[:, :, (cy + uy)[:, None], (cx + ux)[None, :]]
                    by = (cy + oy + uy)[:, None]
                    bx = (cx + ox + ux)[None, :]
                    b = d2[:, :, torch.clamp(by, 0, ph_ - 1),
                           torch.clamp(bx, 0, pw_ - 1)]
                    inside = (by >= 0) & (by < ph_) & (bx >= 0) & (bx < pw_)
                    b = torch.where(inside[None, None], b, zero)
                    acc = acc + (a * b if mult else torch.abs(a - b))
            outs.append(acc.sum(dim=1) / norm)
    return torch.stack(outs, dim=1)


class _SVMOutput(torch.autograd.Function):
    """Forward the identity; backward the one-vs-all hinge gradient
    (`svm_output.cc:89`), whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.attrs = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.attrs
        k = data.shape[1]
        onehot = label.long()[:, None] == torch.arange(k, device=data.device)
        sign = torch.where(onehot, 1.0, -1.0).to(data.dtype)
        viol = sign * data < margin
        if use_linear:
            grad = -reg * sign
        else:
            grad = -2.0 * reg * sign * (margin - sign * data)
        grad = torch.where(viol, grad, torch.zeros((), dtype=data.dtype,
                                                   device=data.device))
        return grad.to(data.dtype), torch.zeros_like(label), None, None, None


@register("SVMOutput")
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False, **kw):
    """The SVM output layer: the identity forward, the hinge (L1 with
    ``use_linear``, else squared) gradient times
    ``regularization_coefficient``."""
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(parse_bool(use_linear)))
