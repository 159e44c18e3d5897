"""Vision transforms: the port of
`mxnet_tpu/gluon/data/vision/transforms.py` (parity
`python/mxnet/gluon/data/vision/transforms.py`).

Blocks, so that they compose with `nn.Sequential`. They take the HWC
uint8 (or float) images that the datasets give and keep the reference's
conventions: `ToTensor` makes CHW float32 in [0, 1], `Normalize` works on
CHW. Every result is a CPU NDArray: a transform runs once a sample, in a
`DataLoader` worker or the loading thread, and only the batch goes to the
card. The random transforms draw from Python's `random` (`RandomLighting`
from numpy's global stream), as the JAX package's do.
"""
from __future__ import annotations

import random as _random

import numpy as _np

from ....image import image as _img
from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting", "RandomGray", "CropResize"]

_host = _img._host


class Compose(Sequential):
    """The transforms in order."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    """A cast to ``dtype``."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return x.astype(self._dtype)


class ToTensor(Block):
    """HWC uint8 in [0, 255] -> CHW float32 in [0, 1] (NHWC -> NCHW)."""

    def forward(self, x):
        arr = x.asnumpy().astype("float32") / 255.0
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)
        return _host(arr)


class Normalize(Block):
    """(x - mean) / std on CHW float, ``mean`` and ``std`` a channel."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, "float32")
        self._std = _np.asarray(std, "float32")

    def forward(self, x):
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return _host((x.asnumpy() - mean) / std)


class Resize(Block):
    """A resize to ``size`` (an int: square, or the short side with
    ``keep_ratio``; else (w, h))."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        if isinstance(self._size, int):
            if self._keep:
                return _img.resize_short(x, self._size, self._interpolation)
            return _img.imresize(x, self._size, self._size,
                                 self._interpolation)
        return _img.imresize(x, self._size[0], self._size[1],
                             self._interpolation)


class CenterCrop(Block):
    """The centred window of ``size`` (scaled down to fit, resized
    back)."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._interpolation = interpolation

    def forward(self, x):
        return _img.center_crop(x, self._size, self._interpolation)[0]


class RandomResizedCrop(Block):
    """The Inception crop: a window of random area share (``scale``) and
    aspect (``ratio``), resized to ``size``."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        return _img.random_size_crop(x, self._size, self._scale, self._ratio,
                                     self._interpolation)[0]


class CropResize(Block):
    """The (x0, y0, width, height) window, resized to ``size`` if
    given."""

    def __init__(self, x0, y0, width, height, size=None, interpolation=1):
        super().__init__()
        self._args = (x0, y0, width, height)
        self._size = size
        self._interpolation = interpolation

    def forward(self, x):
        out = _img.fixed_crop(x, *self._args)
        if self._size:
            out = _img.imresize(out, self._size[0], self._size[1],
                                self._interpolation)
        return out


class RandomFlipLeftRight(Block):
    """A left-right flip with probability ``p``."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _random.random() < self._p:
            return _host(x.asnumpy()[:, ::-1].copy(), str(x.dtype))
        return x


class RandomFlipTopBottom(Block):
    """A top-bottom flip with probability ``p``."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _random.random() < self._p:
            return _host(x.asnumpy()[::-1].copy(), str(x.dtype))
        return x


class _JitterBlock(Block):
    _aug_cls = None

    def __init__(self, amount):
        super().__init__()
        self._aug = self._aug_cls(amount)

    def forward(self, x):
        return self._aug(x)


class RandomBrightness(_JitterBlock):
    """`image.BrightnessJitterAug`."""
    _aug_cls = _img.BrightnessJitterAug


class RandomContrast(_JitterBlock):
    """`image.ContrastJitterAug`."""
    _aug_cls = _img.ContrastJitterAug


class RandomSaturation(_JitterBlock):
    """`image.SaturationJitterAug`."""
    _aug_cls = _img.SaturationJitterAug


class RandomHue(_JitterBlock):
    """`image.HueJitterAug`."""
    _aug_cls = _img.HueJitterAug


class RandomColorJitter(Block):
    """Brightness, contrast and saturation jitter in a random order, then
    the hue's."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._aug = _img.ColorJitterAug(brightness, contrast, saturation)
        self._hue = _img.HueJitterAug(hue) if hue else None

    def forward(self, x):
        x = self._aug(x)
        if self._hue:
            x = self._hue(x)
        return x


class RandomLighting(Block):
    """AlexNet's PCA lighting noise of standard deviation ``alpha``."""

    def __init__(self, alpha):
        super().__init__()
        self._aug = _img.LightingAug(alpha, _img._EIGVAL, _img._EIGVEC)

    def forward(self, x):
        return self._aug(x)


class RandomGray(Block):
    """The image made gray with probability ``p``."""

    def __init__(self, p=0.5):
        super().__init__()
        self._aug = _img.RandomGrayAug(p)

    def forward(self, x):
        return self._aug(x)
