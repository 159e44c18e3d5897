"""The port's vision transforms (`gluon.data.vision.transforms`) held to
the JAX package's on the CPU: each of the 17 transforms on the same HWC
images (numpy, from a seed), the random ones after seeding Python's
`random` and numpy's global stream alike in both packages (the streams
both draw from). Outputs agree at rtol 1e-6 / atol 1e-4 (float32 from the
same numpy arithmetic; uint8 exactly) and are CPU arrays. The gluon-cv
ImageNet training chain runs through `DataLoader` in each worker mode; in
worker processes, with its deterministic steps only, since each process
draws from its own stream.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.data.vision import transforms as jT
from mxnet_tpu_torch.gluon.data.vision import transforms as tT

CPU = mx.cpu()
MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]

TRANSFORMS = {
    "Cast": lambda T: T.Cast("float16"),
    "ToTensor": lambda T: T.ToTensor(),
    "Normalize": lambda T: T.Compose([T.ToTensor(), T.Normalize(MEAN, STD)]),
    "Resize": lambda T: T.Resize(13),
    "Resize_keep_ratio": lambda T: T.Resize(13, keep_ratio=True),
    "Resize_wh": lambda T: T.Resize((17, 9), interpolation=2),
    "CenterCrop": lambda T: T.CenterCrop(12),
    "RandomResizedCrop": lambda T: T.RandomResizedCrop(16),
    "CropResize": lambda T: T.CropResize(2, 3, 10, 8, size=(6, 5)),
    "RandomFlipLeftRight": lambda T: T.RandomFlipLeftRight(),
    "RandomFlipTopBottom": lambda T: T.RandomFlipTopBottom(),
    "RandomBrightness": lambda T: T.RandomBrightness(0.4),
    "RandomContrast": lambda T: T.RandomContrast(0.4),
    "RandomSaturation": lambda T: T.RandomSaturation(0.4),
    "RandomHue": lambda T: T.RandomHue(0.2),
    "RandomColorJitter": lambda T: T.RandomColorJitter(0.4, 0.4, 0.4, 0.1),
    "RandomLighting": lambda T: T.RandomLighting(0.1),
    "RandomGray": lambda T: T.RandomGray(0.5),
}


def images(n=4, h=21, w=27):
    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for _ in range(n)]


def run(T, nd, make, imgs, seed=0, **ctx):
    random.seed(seed)
    np.random.seed(seed)
    t = make(T)
    out = []
    for a in imgs:
        y = t(nd.array(a, dtype="uint8", **ctx))
        if ctx:
            assert y.context == CPU
        out.append(y.asnumpy())
    return out


def test_every_transform_is_covered():
    assert set(tT.__all__) == set(jT.__all__)
    named = {k.split("_")[0] for k in TRANSFORMS} | {"Compose"}
    assert named == set(jT.__all__)


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_jax(name):
    imgs = images()
    got = run(tT, mx.nd, TRANSFORMS[name], imgs, ctx=CPU)
    want = run(jT, jmx.nd, TRANSFORMS[name], imgs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-4)


def chain(T, train=True):
    """gluon-cv's ImageNet transforms (scripts/classification/imagenet/
    train_imagenet.py), at 16 x 16."""
    steps = [T.RandomResizedCrop(16), T.RandomFlipLeftRight(),
             T.RandomColorJitter(0.4, 0.4, 0.4), T.RandomLighting(0.1)] \
        if train else [T.Resize(18, keep_ratio=True), T.CenterCrop(16)]
    return T.Compose(steps + [T.ToTensor(), T.Normalize(MEAN, STD)])


def loader_batches(pkg, nd, train, imgs, labels, ctx, **kw):
    ds = pkg.gluon.data.ArrayDataset(
        pkg.gluon.data.SimpleDataset([nd.array(a, dtype="uint8", **ctx)
                                      for a in imgs]), labels)
    ds = ds.transform_first(chain(pkg.gluon.data.vision.transforms, train))
    random.seed(1)
    np.random.seed(1)
    return [(x.asnumpy(), y.asnumpy()) for x, y in pkg.gluon.data.DataLoader(
        ds, batch_size=3, last_batch="keep", **kw)]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_imagenet_chain_through_the_loader(train):
    imgs = images(n=7, h=24, w=30)
    labels = np.arange(7, dtype=np.int32)
    want = loader_batches(jmx, jmx.nd, train, imgs, labels, {})
    modes = [{}, {"num_workers": 2}] if train else \
        [{}, {"num_workers": 2}, {"num_workers": 2, "thread_pool": False}]
    for mode in modes:
        if train and mode:
            mode = dict(mode, num_workers=1)  # one thread: one stream order
        got = loader_batches(mx, mx.nd, train, imgs, labels, {"ctx": CPU},
                             **mode)
        assert len(got) == len(want) == 3
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.shape == wx.shape and gx.dtype == np.float32
            np.testing.assert_allclose(gx, wx, rtol=1e-6, atol=1e-4)
            np.testing.assert_array_equal(gy, wy)
