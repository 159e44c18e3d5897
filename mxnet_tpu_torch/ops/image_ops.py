"""Image ops: the port of `mxnet_tpu/ops/image_ops.py` (parity
`src/operator/image/image_random.cc`, `resize.cc`, `crop.cc`, and the
OpenCV host ops of `src/io/image_io.cc`).

The ``_image_*`` ops take (H, W, C) or (N, H, W, C) images and run on the
array's device; the random ones are ``needs_rng`` and draw from the
generator of that device (`mxnet_tpu_torch.random`), every draw a device
tensor, so a captured graph draws anew at each replay. The four ``_cv*``
ops are host ops, as in the JAX package (``eager_only``) and the
reference: their work is codec work on the CPU, whatever the array's
device. `_cvcopyMakeBorder` needs no codec; `_cvimdecode`, `_cvimread`
and `_cvimresize` need PIL, imported when they run, and raise a named
`ImportError` without it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ._utils import as_float_tuple, as_tuple, parse_bool
from .registry import register


def _hw_axes(data):
    return (data.ndim - 3, data.ndim - 2)  # (H, W) of HWC / NHWC


@register("_image_to_tensor", aliases=["image_to_tensor"])
def _to_tensor(data, **kw):
    """HWC uint8 in [0, 255] -> CHW float32 in [0, 1] (NHWC -> NCHW)."""
    x = data.to(torch.float32) / 255.0
    if data.ndim == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


@register("_image_normalize", aliases=["image_normalize"])
def _normalize(data, mean=(0.0,), std=(1.0,), **kw):
    """(data - mean) / std over the channel axis of CHW / NCHW input."""
    mean = torch.tensor(as_float_tuple(mean), dtype=torch.float32,
                        device=data.device).reshape(-1, 1, 1)
    std = torch.tensor(as_float_tuple(std), dtype=torch.float32,
                       device=data.device).reshape(-1, 1, 1)
    return ((data.to(torch.float32) - mean) / std).to(data.dtype)


@register("_image_flip_left_right", aliases=["image_flip_left_right"])
def _flip_lr(data, **kw):
    return torch.flip(data, (_hw_axes(data)[1],))


@register("_image_flip_top_bottom", aliases=["image_flip_top_bottom"])
def _flip_tb(data, **kw):
    return torch.flip(data, (_hw_axes(data)[0],))


def _coin(gen, data):
    """A fair coin as a 0-d bool tensor on the data's device."""
    return torch.rand((), generator=gen, device=data.device) < 0.5


@register("_image_random_flip_left_right",
          aliases=["image_random_flip_left_right"], needs_rng=True)
def _random_flip_lr(gen, data, **kw):
    return torch.where(_coin(gen, data), _flip_lr(data), data)


@register("_image_random_flip_top_bottom",
          aliases=["image_random_flip_top_bottom"], needs_rng=True)
def _random_flip_tb(gen, data, **kw):
    return torch.where(_coin(gen, data), _flip_tb(data), data)


def _uniform(gen, data, lo, hi):
    """One U(lo, hi) draw as a 0-d float32 tensor on the data's device."""
    return torch.empty((), dtype=torch.float32, device=data.device).uniform_(
        float(lo), float(hi), generator=gen)


def _blend(img, other, alpha):
    out = alpha * img.to(torch.float32) + (1.0 - alpha) * other
    return out.to(img.dtype)


_LUMA = (0.299, 0.587, 0.114)  # ITU-R BT.601, image_random.cc RGB2Gray


def _gray(img):
    w = torch.tensor(_LUMA, dtype=torch.float32, device=img.device)
    return (img.to(torch.float32) * w).sum(dim=-1, keepdim=True)


@register("_image_random_brightness", aliases=["image_random_brightness"],
          needs_rng=True)
def _random_brightness(gen, data, min_factor=0.0, max_factor=1.0, **kw):
    alpha = _uniform(gen, data, min_factor, max_factor)
    return _blend(data, 0.0, alpha)


@register("_image_random_contrast", aliases=["image_random_contrast"],
          needs_rng=True)
def _random_contrast(gen, data, min_factor=0.0, max_factor=1.0, **kw):
    alpha = _uniform(gen, data, min_factor, max_factor)
    # each image's own gray mean: HWC reduces to a scalar, NHWC to (N,1,1,1)
    dims = tuple(range(data.ndim - 3, data.ndim))
    mean = _gray(data).mean(dim=dims, keepdim=True)
    return _blend(data, mean, alpha)


@register("_image_random_saturation", aliases=["image_random_saturation"],
          needs_rng=True)
def _random_saturation(gen, data, min_factor=0.0, max_factor=1.0, **kw):
    alpha = _uniform(gen, data, min_factor, max_factor)
    return _blend(data, _gray(data), alpha)


_TYIQ = np.array([[0.299, 0.587, 0.114],
                  [0.596, -0.274, -0.321],
                  [0.211, -0.523, 0.311]])
# the exact inverse (not the published 3-decimal one), so that a zero
# rotation is the identity
_ITYIQ = np.linalg.inv(_TYIQ)


@register("_image_random_hue", aliases=["image_random_hue"], needs_rng=True)
def _random_hue(gen, data, min_factor=0.0, max_factor=1.0, **kw):
    """A hue rotation by U(min, max) x pi in YIQ space (the linear form
    of the reference's HSV cycle, image_random.cc RandomHue)."""
    theta = _uniform(gen, data, min_factor, max_factor) * math.pi
    cos, sin = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(cos), torch.zeros_like(cos)
    rot = torch.stack([torch.stack([one, zero, zero]),
                       torch.stack([zero, cos, -sin]),
                       torch.stack([zero, sin, cos])])
    dev = data.device
    m = torch.tensor(_ITYIQ, dtype=torch.float32, device=dev) @ rot @ \
        torch.tensor(_TYIQ, dtype=torch.float32, device=dev)
    return (data.to(torch.float32) @ m.T).to(data.dtype)


@register("_image_random_color_jitter",
          aliases=["image_random_color_jitter"], needs_rng=True)
def _random_color_jitter(gen, data, brightness=0.0, contrast=0.0,
                         saturation=0.0, hue=0.0, **kw):
    x = data
    if float(brightness) > 0:
        x = _random_brightness(gen, x, 1 - float(brightness),
                               1 + float(brightness))
    if float(contrast) > 0:
        x = _random_contrast(gen, x, 1 - float(contrast), 1 + float(contrast))
    if float(saturation) > 0:
        x = _random_saturation(gen, x, 1 - float(saturation),
                               1 + float(saturation))
    if float(hue) > 0:
        x = _random_hue(gen, x, -float(hue), float(hue))
    return x


# ImageNet's PCA lighting (the AlexNet recipe the reference hardcodes)
_EIG_VAL = (55.46, 4.794, 1.148)
_EIG_VEC = ((-0.5675, 0.7192, 0.4009),
            (-0.5808, -0.0045, -0.8140),
            (-0.5836, -0.6948, 0.4203))


def _lighting(data, alpha):
    dev = data.device
    delta = torch.tensor(_EIG_VEC, dtype=torch.float32, device=dev) @ \
        (alpha * torch.tensor(_EIG_VAL, dtype=torch.float32, device=dev))
    return (data.to(torch.float32) + delta).to(data.dtype)


@register("_image_adjust_lighting", aliases=["image_adjust_lighting"])
def _adjust_lighting(data, alpha=(0.0, 0.0, 0.0), **kw):
    alpha = torch.tensor(as_float_tuple(alpha, 3), dtype=torch.float32,
                         device=data.device)
    return _lighting(data, alpha)


@register("_image_random_lighting", aliases=["image_random_lighting"],
          needs_rng=True)
def _random_lighting(gen, data, alpha_std=0.05, **kw):
    alpha = torch.empty(3, dtype=torch.float32, device=data.device).normal_(
        generator=gen) * float(alpha_std)
    return _lighting(data, alpha)


@register("_image_resize", aliases=["image_resize"])
def _resize(data, size=(), keep_ratio=False, interp=1, **kw):
    """Bilinear (``interp=1``) or nearest (0) resize of HWC / NHWC images
    to ``size`` (w, h) (resize.cc); a single ``size`` with ``keep_ratio``
    is the short side. The JAX package's `jax.image.resize`: half-pixel
    centres, and when shrinking a triangle filter widened by the scale
    (torch's ``antialias``); nearest picks floor((i + 0.5) x in / out).
    Integer images are rounded, not truncated."""
    size = as_tuple(size)
    ih, iw = (data.shape[0], data.shape[1]) if data.ndim == 3 \
        else (data.shape[1], data.shape[2])
    if len(size) == 1:
        if parse_bool(keep_ratio):
            if ih < iw:
                size = (int(round(iw * size[0] / ih)), size[0])
            else:
                size = (size[0], int(round(ih * size[0] / iw)))
        else:
            size = (size[0], size[0])
    w, h = size
    x = data.to(torch.float32)
    x = (x.permute(2, 0, 1)[None] if data.ndim == 3
         else x.permute(0, 3, 1, 2))
    if (h, w) != (ih, iw):
        if int(interp) == 0:
            x = F.interpolate(x, size=(h, w), mode="nearest-exact")
        else:
            x = F.interpolate(x, size=(h, w), mode="bilinear",
                              align_corners=False, antialias=True)
    out = x[0].permute(1, 2, 0) if data.ndim == 3 else x.permute(0, 2, 3, 1)
    if not data.is_floating_point():
        out = torch.round(out)  # OpenCV's rounding, not truncation
    return out.to(data.dtype)


@register("_image_crop", aliases=["image_crop"])
def _crop(data, x=0, y=0, width=1, height=1, **kw):
    """The (x, y, width, height) window of HWC / NHWC images (crop.cc); a
    window outside the image raises, as in the reference."""
    x, y, width, height = int(x), int(y), int(width), int(height)
    h, w = (data.shape[0], data.shape[1]) if data.ndim == 3 \
        else (data.shape[1], data.shape[2])
    if x < 0 or y < 0 or width < 1 or height < 1 or \
            x + width > w or y + height > h:
        raise MXNetError(
            f"_image_crop: window (x={x}, y={y}, w={width}, h={height}) "
            f"out of bounds for image {h}x{w}")
    if data.ndim == 3:
        return data[y:y + height, x:x + width, :]
    return data[:, y:y + height, x:x + width, :]


def _pil(op):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{op} needs PIL (the image codec), which is not "
                          "installed") from e
    return Image


def _decode(op, buf, flag, to_rgb):
    import io

    img = _pil(op).open(io.BytesIO(bytes(bytearray(
        np.asarray(buf, dtype=np.uint8)))))
    if int(flag) == 0:
        arr = np.asarray(img.convert("L"))[:, :, None]
    else:
        arr = np.asarray(img.convert("RGB"))
        if not parse_bool(to_rgb):
            arr = arr[:, :, ::-1]
    return torch.from_numpy(arr.copy())


@register("_cvimdecode", aliases=["cvimdecode"])
def _cvimdecode(buf, flag=1, to_rgb=True, **kw):
    """Decode an encoded image (a 1-D uint8 array) to an HWC uint8 array
    (`image_io.cc` ``_cvimdecode``), on the host; the result goes to the
    buffer's device."""
    return _decode("_cvimdecode", buf.cpu().numpy(), flag,
                   to_rgb).to(buf.device)


@register("_cvimread", aliases=["cvimread"])
def _cvimread(filename=None, flag=1, to_rgb=True, device=None, **kw):
    """Read and decode an image file (`image_io.cc` ``_cvimread``)."""
    with open(str(filename), "rb") as f:
        buf = np.frombuffer(f.read(), dtype=np.uint8)
    return _decode("_cvimread", buf, flag, to_rgb).to(device or "cpu")


@register("_cvimresize", aliases=["cvimresize"])
def _cvimresize(src, w=None, h=None, interp=1, **kw):
    """Resize an HWC uint8 image with PIL's filter for ``interp``
    (`image_io.cc` ``_cvimresize``), on the host."""
    Image = _pil("_cvimresize")
    arr = src.cpu().numpy().astype(np.uint8)
    squeeze = arr.shape[-1] == 1
    img = Image.fromarray(arr[:, :, 0] if squeeze else arr)
    resample = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
                3: Image.LANCZOS, 4: Image.LANCZOS}.get(int(interp),
                                                        Image.BILINEAR)
    out = np.asarray(img.resize((int(w), int(h)), resample))
    if squeeze:
        out = out[:, :, None]
    return torch.from_numpy(out.copy()).to(src.device)


def _border_index(n, before, after, mode):
    """Source indices of a padded axis of length n: edge (1) or reflect
    without the edge repeated (2), numpy's "edge" and "reflect"."""
    i = torch.arange(-before, n + after)
    if mode == 1 or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


@register("_cvcopyMakeBorder", aliases=["cvcopyMakeBorder"])
def _cvcopy_make_border(src, top=0, bot=0, left=0, right=0, type=0,
                        value=0.0, **kw):
    """Pad an HWC image (`image_io.cc` ``_cvcopyMakeBorder``): ``type`` 0
    fills with ``value`` (cv2.BORDER_CONSTANT), 1 repeats the edge, 2
    reflects."""
    top, bot, left, right, t = (int(top), int(bot), int(left), int(right),
                                int(type))
    h, w = src.shape[0], src.shape[1]
    if t in (1, 2):
        rows = _border_index(h, top, bot, t).to(src.device)
        cols = _border_index(w, left, right, t).to(src.device)
        return src[rows][:, cols]
    out = torch.full((h + top + bot, w + left + right) + tuple(src.shape[2:]),
                     float(np.asarray(value, np.float64)), dtype=src.dtype,
                     device=src.device)
    out[top:top + h, left:left + w] = src
    return out
