"""The image pipeline: the port of `mxnet_tpu/image/image.py` (parity
`python/mxnet/image/image.py`: `imdecode`, `imresize`, the crops, the
augmenters, `CreateAugmenter`, `ImageIter`) and the reference's decode
threads and prefetcher (`src/io/iter_image_recordio_2.cc`,
`iter_prefetcher.h`) as `ImageIter`'s thread pool and `ImageRecordIter`.

Decode and augmentation are host work, as in the reference (OpenCV on the
host): every array here is a CPU NDArray of HWC images, and a batch goes
to the card once, where the consumer puts it. Decoding needs PIL, imported
only where an image is decoded, encoded or resized with an interpolation
other than 1; ``interp=1`` is the JAX package's own align-corners
bilinear (`_bilinear_resize_np`), in numpy. The random augmenters draw
from Python's `random` (and `LightingAug` from numpy's global stream), as
the JAX package's do, so seeded runs augment alike in both.
"""
from __future__ import annotations

import io as _io
import os
import random as _random

import numpy as _np

from .. import ndarray as nd
from .. import recordio
from ..context import cpu
from ..io.io import DataBatch, DataDesc, DataIter

__all__ = ["imdecode", "imread", "imresize", "scale_down", "resize_short",
           "fixed_crop", "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "Augmenter", "SequentialAug", "RandomOrderAug",
           "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "RandomSizedCropAug", "CenterCropAug", "HorizontalFlipAug",
           "CastAug", "ColorNormalizeAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "RandomGrayAug",
           "CreateAugmenter", "ImageIter", "ImageRecordIter"]


def _host(arr, dtype=None):
    """A CPU NDArray of a numpy array (cast as `nd.array` casts unless
    ``dtype`` is given)."""
    return nd.array(arr, ctx=cpu(), dtype=dtype)


def _numpy(src):
    return src.asnumpy() if isinstance(src, nd.NDArray) else _np.asarray(src)


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """An encoded image (bytes or a uint8 NDArray) decoded to an HWC uint8
    CPU NDArray: RGB (BGR with ``to_rgb=False``), or one gray channel with
    ``flag=0``."""
    from PIL import Image

    if isinstance(buf, nd.NDArray):
        buf = bytes(buf.asnumpy().astype("uint8"))
    img = Image.open(_io.BytesIO(buf))
    if flag == 0:
        arr = _np.asarray(img.convert("L"))[:, :, None]
    else:
        arr = _np.asarray(img.convert("RGB"))
        if not to_rgb:
            arr = arr[:, :, ::-1]
    return _host(arr.astype("uint8"), "uint8")


def imread(filename, flag=1, to_rgb=True):
    """`imdecode` of a file's bytes."""
    from ..resilience import open_checked

    with open_checked(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def _bilinear_resize_np(arr, h, w):
    """Align-corners bilinear resize of an HWC uint8 array to (h, w),
    rounded half up: the JAX package's arithmetic (that of its native
    decode workers), so ``interp=1`` gives the same bytes in both."""
    sh, sw = arr.shape[:2]
    if (sh, sw) == (h, w):
        return arr.copy()
    ry = (sh - 1) / (h - 1) if h > 1 else 0.0
    rx = (sw - 1) / (w - 1) if w > 1 else 0.0
    fy = _np.arange(h, dtype=_np.float32) * _np.float32(ry)
    fx = _np.arange(w, dtype=_np.float32) * _np.float32(rx)
    y0 = fy.astype(_np.int32)
    x0 = fx.astype(_np.int32)
    y1 = _np.minimum(y0 + 1, sh - 1)
    x1 = _np.minimum(x0 + 1, sw - 1)
    wy = (fy - y0)[:, None, None].astype(_np.float32)
    wx = (fx - x0)[None, :, None].astype(_np.float32)
    a = arr.astype(_np.float32)
    top = a[y0][:, x0] + (a[y0][:, x1] - a[y0][:, x0]) * wx
    bot = a[y1][:, x0] + (a[y1][:, x1] - a[y1][:, x0]) * wx
    return (top + (bot - top) * wy + 0.5).astype(arr.dtype)


def imresize(src, w, h, interp=1):
    """An HWC image resized to (h, w): ``interp=1`` the align-corners
    bilinear of `_bilinear_resize_np`, the other codes PIL's filters
    (0 nearest, 2 bicubic, 3 and 4 Lanczos)."""
    arr = _numpy(src)
    if int(interp) == 1:
        return _host(_bilinear_resize_np(arr.astype("uint8"), h, w)
                     .astype(arr.dtype.name), arr.dtype.name)
    from PIL import Image

    squeeze = arr.shape[-1] == 1
    img = Image.fromarray(arr[:, :, 0] if squeeze else arr.astype("uint8"))
    resample = {0: Image.NEAREST, 2: Image.BICUBIC, 3: Image.LANCZOS,
                4: Image.LANCZOS}.get(interp, Image.BILINEAR)
    out = _np.asarray(img.resize((w, h), resample))
    if squeeze:
        out = out[:, :, None]
    return _host(out.astype(arr.dtype.name), arr.dtype.name)


def scale_down(src_size, size):
    """``size`` (w, h) scaled down to fit in ``src_size``, keeping its
    aspect."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """The image resized so that its short side is ``size``."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp=interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """The (x0, y0, w, h) window, resized to ``size`` (w, h) if given."""
    out = _numpy(src)[y0:y0 + h, x0:x0 + w]
    out_nd = _host(out, str(out.dtype))
    if size is not None and (w, h) != size:
        out_nd = imresize(out_nd, *size, interp=interp)
    return out_nd


def random_crop(src, size, interp=2):
    """A window of ``size`` (scaled down to fit) at a random place:
    (crop, (x0, y0, w, h))."""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = _random.randint(0, w - new_w)
    y0 = _random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """The centred window of ``size`` (scaled down to fit)."""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    """A window of random area share (``area``) and aspect (``ratio``, log
    uniform), resized to ``size``: the Inception crop; the centre crop
    after 10 misses."""
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _random.uniform(area[0], area[1]) * src_area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        new_ratio = _np.exp(_random.uniform(*log_ratio))
        new_w = int(round(_np.sqrt(target_area * new_ratio)))
        new_h = int(round(_np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = _random.randint(0, w - new_w)
            y0 = _random.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """(src - mean) / std, as float."""
    arr = src.asnumpy().astype("float32") if isinstance(src, nd.NDArray) \
        else src
    arr = arr - _np.asarray(mean)
    if std is not None:
        arr = arr / _np.asarray(std)
    return _host(arr)


_GRAY = _np.array([[[0.299, 0.587, 0.114]]], "float32")


class Augmenter:
    """An image augmenter: ``aug(src) -> image``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, nd.NDArray):
                kwargs[k] = v.asnumpy().tolist()
            elif isinstance(v, _np.ndarray):
                kwargs[k] = v.tolist()

    def dumps(self):
        """The augmenter as JSON text: [class name, its arguments]."""
        import json

        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    """The augmenters ``ts`` in order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    """The augmenters ``ts`` in a random order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        _random.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    """`resize_short` to ``size``."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """`imresize` to ``size`` (w, h)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, *self.size, interp=self.interp)


class RandomCropAug(Augmenter):
    """`random_crop` to ``size``."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    """`random_size_crop` to ``size``."""

    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    """`center_crop` to ``size``."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    """A left-right flip with probability ``p``."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _random.random() < self.p:
            return _host(src.asnumpy()[:, ::-1].copy(), str(src.dtype))
        return src


class CastAug(Augmenter):
    """A cast to ``typ``."""

    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return _host(src.asnumpy().astype(self.typ), self.typ)


class ColorNormalizeAug(Augmenter):
    """`color_normalize` by ``mean`` and ``std``."""

    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = _np.asarray(mean) if mean is not None else None
        self.std = _np.asarray(std) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    """Pixels scaled by 1 + U(-brightness, brightness)."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _random.uniform(-self.brightness, self.brightness)
        return _host(src.asnumpy().astype("float32") * alpha)


class ContrastJitterAug(Augmenter):
    """A blend with the image's mean gray by 1 + U(-contrast, contrast)."""

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _random.uniform(-self.contrast, self.contrast)
        arr = src.asnumpy().astype("float32")
        gray = (arr * _GRAY).sum(axis=2, keepdims=True)
        mean = gray.mean() * (1.0 - alpha)
        return _host(arr * alpha + mean)


class SaturationJitterAug(Augmenter):
    """A blend with each pixel's gray by 1 + U(-saturation, saturation)."""

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _random.uniform(-self.saturation, self.saturation)
        arr = src.asnumpy().astype("float32")
        gray = (arr * _GRAY).sum(axis=2, keepdims=True) * (1.0 - alpha)
        return _host(arr * alpha + gray)


class HueJitterAug(Augmenter):
    """A hue rotation by U(-hue, hue) x pi in YIQ space."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = _np.array([[0.299, 0.587, 0.114],
                               [0.596, -0.274, -0.321],
                               [0.211, -0.523, 0.311]], "float32")
        self.ityiq = _np.array([[1.0, 0.956, 0.621],
                                [1.0, -0.272, -0.647],
                                [1.0, -1.107, 1.705]], "float32")

    def __call__(self, src):
        alpha = _random.uniform(-self.hue, self.hue)
        u, w = _np.cos(alpha * _np.pi), _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                       "float32")
        t = self.ityiq @ bt @ self.tyiq
        return _host(src.asnumpy().astype("float32") @ t.T)


class ColorJitterAug(RandomOrderAug):
    """Brightness, contrast and saturation jitter in a random order."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """AlexNet's PCA lighting noise: alphas N(0, alphastd) from numpy's
    global stream."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval, "float32")
        self.eigvec = _np.asarray(eigvec, "float32")

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd, size=(3,)).astype(
            "float32")
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return _host(src.asnumpy().astype("float32") + rgb)


class RandomGrayAug(Augmenter):
    """The image made gray with probability ``p``."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _random.random() < self.p:
            arr = src.asnumpy().astype("float32")
            gray = (arr * _GRAY).sum(axis=2, keepdims=True)
            return _host(_np.broadcast_to(gray, arr.shape).copy())
        return src


# ImageNet's PCA lighting (the AlexNet recipe the reference hardcodes)
_EIGVAL = _np.array([55.46, 4.794, 1.148])
_EIGVEC = _np.array([[-0.5675, 0.7192, 0.4009],
                     [-0.5808, -0.0045, -0.814],
                     [-0.5836, -0.6948, 0.4203]])


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """The standard augmenter list for ``data_shape`` (C, H, W)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise, _EIGVAL, _EIGVEC))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if isinstance(mean, (tuple, list)):
        mean = _np.asarray(mean)
    if isinstance(std, (tuple, list)):
        std = _np.asarray(std)
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


_AUG_ARGS = ("resize", "rand_crop", "rand_resize", "rand_mirror", "mean",
             "std", "brightness", "contrast", "saturation", "hue",
             "pca_noise", "rand_gray", "inter_method")


class ImageIter(DataIter):
    """Image batches from a RecordIO file (``path_imgrec``, random access
    through its ``.idx``), an image list file (``path_imglist``, lines of
    ``index\\tlabel...\\tpath``) or a list of (label, path) (``imglist``),
    decoded and augmented by a pool of ``num_threads`` threads. Batches are
    CPU NDArrays of CHW float32 images; a short last batch is padded with
    its first image (``last_batch_handle="pad"``) or dropped
    (``"discard"``)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 last_batch_handle="pad", num_threads=4, **kwargs):
        super().__init__(batch_size)
        assert path_imgrec or path_imglist or isinstance(imglist, list)
        assert dtype in ("int32", "float32", "int64", "float64"), dtype
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self.label_width = label_width
        self.shuffle = shuffle
        self.dtype = dtype
        self._num_threads = max(1, int(num_threads))
        self._pool = None

        self.imgrec = None
        self.imglist = None
        self.seq = None
        self.path_root = path_root
        if path_imgrec:
            idx_path = path_imgidx or \
                (os.path.splitext(path_imgrec)[0] + ".idx")
            if os.path.exists(idx_path):
                self.imgrec = recordio.MXIndexedRecordIO(idx_path,
                                                         path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                assert not shuffle, "shuffle needs a .idx file"
        elif path_imglist:
            self.imglist = {}
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    label = _np.array(parts[1:-1], dtype=dtype)
                    self.imglist[int(parts[0])] = (label, parts[-1])
            self.seq = sorted(self.imglist.keys())
        else:
            self.imglist = {}
            for i, (label, fname) in enumerate(imglist):
                self.imglist[i] = (_np.array(label, ndmin=1, dtype=dtype),
                                   fname)
            self.seq = list(self.imglist.keys())

        if num_parts > 1 and self.seq is not None:
            assert part_index < num_parts
            n_per = len(self.seq) // num_parts
            self.seq = self.seq[part_index * n_per:(part_index + 1) * n_per]

        if aug_list is None:
            self.auglist = CreateAugmenter(
                data_shape, **{k: v for k, v in kwargs.items()
                               if k in _AUG_ARGS})
        else:
            self.auglist = aug_list

        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc(label_name,
                                       (batch_size, label_width)
                                       if label_width > 1
                                       else (batch_size,))]
        self.last_batch_handle = last_batch_handle
        self.cur = 0
        self.reset()

    def reset(self):
        if self.shuffle and self.seq is not None:
            _random.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        """(label, the encoded image's bytes) of the next sample."""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                header, img = recordio.unpack(self.imgrec.read_idx(idx))
                return header.label, img
            label, fname = self.imglist[idx]
            path = os.path.join(self.path_root, fname) if self.path_root \
                else fname
            with open(path, "rb") as f:
                return label, f.read()
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def _decode_augment(self, label, raw):
        img = imdecode(raw)
        for aug in self.auglist:
            img = aug(img)
        arr = img.asnumpy()
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)  # HWC -> CHW
        return label, arr.astype("float32")

    def next(self):
        samples = []
        pad = 0
        try:
            for _ in range(self.batch_size):
                samples.append(self.next_sample())
        except StopIteration:
            if not samples:
                raise
            if self.last_batch_handle == "discard":
                raise StopIteration
            pad = self.batch_size - len(samples)

        if self._num_threads > 1 and len(samples) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    self._num_threads, thread_name_prefix="ImageIter")
            decoded = list(self._pool.map(
                lambda s: self._decode_augment(*s), samples))
        else:
            decoded = [self._decode_augment(*s) for s in samples]

        while len(decoded) < self.batch_size:  # pad with the first image
            decoded.append(decoded[0])

        data = _np.stack([d for _, d in decoded])
        labels = _np.stack([_np.array(lb, ndmin=1) for lb, _ in decoded])
        if self.label_width == 1:
            labels = labels[:, 0]
        return DataBatch(data=[_host(data)], label=[_host(labels)], pad=pad)


def ImageRecordIter(path_imgrec, data_shape, batch_size, label_width=1,
                    shuffle=False, aug_list=None, preprocess_threads=4,
                    prefetch_buffer=2, **kwargs):
    """An `ImageIter` over a RecordIO file behind a `PrefetchingIter` of
    ``prefetch_buffer`` batches: the reference's registered
    ``ImageRecordIter`` (its decode threads and prefetcher)."""
    from ..io.io import PrefetchingIter

    base = ImageIter(batch_size, data_shape, label_width=label_width,
                     path_imgrec=path_imgrec, shuffle=shuffle,
                     aug_list=aug_list, num_threads=preprocess_threads,
                     **kwargs)
    return PrefetchingIter(base, prefetch_depth=prefetch_buffer)
