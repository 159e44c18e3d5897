"""The port's image pipeline (`mxnet_tpu_torch/image/`, the vision datasets
of `gluon.data.vision`) held to the JAX package's on the CPU, from images
made with numpy from a seed. Every comparison is exact (uint8 pixels, or
float32 from the same numpy arithmetic): the crops; `imresize` at
``interp=1`` (the JAX package's own align-corners bilinear) and through
PIL; every augmenter under one seed of Python's `random` and numpy's
global stream; `ImageIter` over a ``.rec`` and over an image list;
`ImageRecordIter`; `ImageFolderDataset` and `ImageRecordDataset` through
`DataLoader`; MNIST and CIFAR10 from files the test writes. Records hold
PNG images, which both packages decode with PIL.
"""
import gzip
import os
import pickle
import random
import struct
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import image as jimg
from mxnet_tpu import recordio as jrec
from mxnet_tpu.gluon.data import vision as jvision
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data import vision as tvision

CPU = mx.cpu()


def image(seed=0, h=23, w=31, c=3):
    return np.random.RandomState(seed).randint(
        0, 256, (h, w, c)).astype(np.uint8)


def both(fn, seed=0):
    """fn(package's image module, nd) run on the port, then on the JAX
    package, each after seeding Python's and numpy's streams alike."""
    out = []
    for mod, nd in ((timg, mx.nd), (jimg, jmx.nd)):
        random.seed(seed)
        np.random.seed(seed)
        out.append(fn(mod, nd))
    return out


def host(x):
    """An image module result as numpy; a port array must be on the CPU."""
    if isinstance(x, tuple):
        return tuple(host(v) for v in x)
    if isinstance(x, mx.nd.NDArray):
        assert x.context == CPU
    return x.asnumpy() if hasattr(x, "asnumpy") else x


def assert_equal(a, b):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            assert_equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def src(nd, seed=0, **kw):
    return nd.array(image(seed, **kw), dtype="uint8",
                    **({"ctx": CPU} if nd is mx.nd else {}))


@pytest.mark.parametrize("call", [
    lambda m, s: m.imresize(s, 17, 9, interp=1),
    lambda m, s: m.imresize(s, 40, 30, interp=1),
    lambda m, s: m.imresize(s, 17, 9, interp=2),
    lambda m, s: m.imresize(s, 17, 9, interp=0),
    lambda m, s: m.resize_short(s, 12),
    lambda m, s: m.fixed_crop(s, 3, 4, 10, 8),
    lambda m, s: m.fixed_crop(s, 3, 4, 10, 8, size=(6, 5), interp=1),
    lambda m, s: m.center_crop(s, (12, 10)),
    lambda m, s: m.center_crop(s, (40, 10), interp=1),
    lambda m, s: m.random_crop(s, (12, 10)),
    lambda m, s: m.random_size_crop(s, (16, 16), 0.3, (0.75, 1.33), 1),
    lambda m, s: m.random_size_crop(s, (16, 16), (0.08, 1.0), (3, 4), 2),
    lambda m, s: m.color_normalize(s.astype("float32"),
                                   np.array([100.0, 110.0, 120.0]),
                                   np.array([50.0, 60.0, 70.0])),
], ids=["bilinear_down", "bilinear_up", "bicubic", "nearest", "short",
        "fixed", "fixed_resized", "center", "center_scaled_down", "random",
        "random_size", "random_size_fallback", "normalize"])
def test_resize_and_crops(call):
    got, want = both(lambda m, nd: host(call(m, src(nd))), seed=4)
    assert_equal(got, want)


def test_scale_down_and_bilinear_arithmetic():
    assert timg.scale_down((20, 10), (30, 30)) == \
        jimg.scale_down((20, 10), (30, 30))
    a = image(1)
    assert_equal(timg.image._bilinear_resize_np(a, 7, 9),
                 jimg.image._bilinear_resize_np(a, 7, 9))


def _augmenters(m):
    eigval = np.array([55.46, 4.794, 1.148])
    eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.814],
                       [-0.5836, -0.6948, 0.4203]])
    return [m.ResizeAug(14, 1), m.ForceResizeAug((20, 12), 2),
            m.RandomCropAug((12, 10), 1),
            m.RandomSizedCropAug((16, 16), (0.1, 1.0), (0.5, 2.0), 1),
            m.CenterCropAug((12, 10), 2), m.HorizontalFlipAug(0.5),
            m.CastAug(), m.ColorNormalizeAug([120.0, 115.0, 100.0],
                                             [60.0, 55.0, 50.0]),
            m.BrightnessJitterAug(0.4), m.ContrastJitterAug(0.4),
            m.SaturationJitterAug(0.4), m.HueJitterAug(0.3),
            m.ColorJitterAug(0.4, 0.3, 0.2),
            m.LightingAug(0.1, eigval, eigvec), m.RandomGrayAug(0.5),
            m.SequentialAug([m.CastAug(), m.BrightnessJitterAug(0.2)]),
            m.RandomOrderAug([m.BrightnessJitterAug(0.2),
                              m.ContrastJitterAug(0.2)])]


def test_every_augmenter_under_one_seed():
    def run(m, nd):
        out = []
        for aug in _augmenters(m):
            for k in range(3):
                s = src(nd, seed=k)
                if isinstance(aug, (m.BrightnessJitterAug,
                                    m.ContrastJitterAug,
                                    m.SaturationJitterAug, m.HueJitterAug,
                                    m.ColorJitterAug, m.LightingAug,
                                    m.RandomGrayAug, m.RandomOrderAug)):
                    s = s.astype("float32")
                out.append((aug.dumps(), host(aug(s))))
        return out

    got, want = both(run, seed=11)
    assert [g[0] for g in got] == [w[0] for w in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-4, err_msg=name)


def test_create_augmenter():
    kw = dict(resize=20, rand_crop=True, rand_resize=True, rand_mirror=True,
              mean=True, std=True, brightness=0.3, contrast=0.3,
              saturation=0.3, hue=0.1, pca_noise=0.1, rand_gray=0.2,
              inter_method=1)

    def run(m, nd):
        augs = m.CreateAugmenter((3, 16, 16), **kw)
        s = src(nd, seed=2)
        for aug in augs:
            s = aug(s)
        return [a.dumps() for a in augs], host(s)

    (gd, g), (wd, w) = both(run, seed=8)
    assert gd == wd
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-3)


def png(rgb):
    """The PNG bytes of an RGB image."""
    return jrec.unpack(jrec.pack_img(jrec.IRHeader(0, 0, 0, 0),
                                     rgb[:, :, ::-1], img_fmt=".png"))[1]


def write_rec(folder, n=10, size=(20, 26)):
    """A .rec/.idx of n PNG records, labels i % 4, written by the JAX
    package (the port reads it)."""
    rec, idx = os.path.join(folder, "img.rec"), os.path.join(folder,
                                                              "img.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        bgr = image(i, *size)[:, :, ::-1]
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i % 4), i, 0),
                                     bgr, img_fmt=".png"))
    w.close()
    return rec


def batches(it, n=None):
    out = []
    for k, b in enumerate(it):
        if n is not None and k >= n:
            break
        out.append((host(b.data[0]), host(b.label[0]), b.pad))
    return out


def assert_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[2] == w[2]
        assert_equal(g[0], w[0])
        assert_equal(g[1], w[1])


def test_image_iter_from_rec_and_list(tmp_path):
    rec = write_rec(str(tmp_path))
    kw = dict(batch_size=4, data_shape=(3, 16, 16), path_imgrec=rec,
              resize=18, mean=True, std=True, inter_method=1)
    got, want = both(lambda m, nd: batches(m.ImageIter(num_threads=3,
                                                       **kw)))
    assert_batches(got, want)
    assert got[-1][2] == 2  # 10 images: the last batch pads 2
    rand = dict(kw, shuffle=True, rand_crop=True, rand_mirror=True)
    got, want = both(lambda m, nd: batches(m.ImageIter(num_threads=1,
                                                       **rand)), seed=3)
    assert_batches(got, want)

    folder = tmp_path / "list"
    folder.mkdir()
    lines = []
    for i in range(6):
        name = f"im{i}.png"
        (folder / name).write_bytes(png(image(20 + i, 18, 22)))
        lines.append(f"{i}\t{i % 3}\t{i * 0.5}\t{name}")
    lst = tmp_path / "list.lst"
    lst.write_text("\n".join(lines) + "\n")
    kw = dict(batch_size=4, data_shape=(3, 14, 14), path_imglist=str(lst),
              path_root=str(folder), label_width=2,
              last_batch_handle="discard")
    got, want = both(lambda m, nd: batches(m.ImageIter(**kw)))
    assert_batches(got, want)
    assert len(got) == 1 and got[0][1].shape == (4, 2)


def test_image_record_iter(tmp_path):
    rec = write_rec(str(tmp_path), n=12)
    kw = dict(path_imgrec=rec, data_shape=(3, 16, 16), batch_size=5,
              preprocess_threads=2, resize=17, inter_method=1)
    got, want = both(lambda m, nd: batches(m.ImageRecordIter(**kw)))
    assert_batches(got, want)
    assert [b[2] for b in got] == [0, 0, 3]


def test_datasets_of_images_through_the_loader(tmp_path):
    rec = write_rec(str(tmp_path), n=6, size=(12, 12))
    root = tmp_path / "folder"
    for cls in ("cat", "dog"):
        (root / cls).mkdir(parents=True)
        for i in range(3):
            (root / cls / f"{i}.png").write_bytes(
                png(image(40 + i + (cls == "dog"), 12, 12)))
    (root / "notes.txt").write_text("not a class")

    def run(pkg, vision):
        out = []
        for ds in (vision.ImageRecordDataset(rec),
                   vision.ImageFolderDataset(str(root)),
                   vision.ImageRecordDataset(rec, flag=0)):
            loader = pkg.DataLoader(ds, batch_size=4)
            out.append([(host(x), host(y)) for x, y in loader])
        return out, vision.ImageFolderDataset(str(root)).synsets

    (got, gs), (want, ws) = run(tdata, tvision), run(jmx.gluon.data,
                                                     jvision)
    assert gs == ws == ["cat", "dog"]
    for g, w in zip(got, want):
        for (gx, gy), (wx, wy) in zip(g, w):
            assert_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def write_idx(path, arr):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">I", 0x800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def test_mnist_and_cifar10_from_files(tmp_path):
    rng = np.random.RandomState(0)
    mn = tmp_path / "mnist"
    mn.mkdir()
    write_idx(str(mn / "train-images-idx3-ubyte.gz"),
              rng.randint(0, 256, (5, 28, 28)))
    write_idx(str(mn / "train-labels-idx1-ubyte"), rng.randint(0, 10, 5))
    cf = tmp_path / "cifar" / "cifar-10-batches-py"
    cf.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cf / name, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (2, 3072)).astype(
                np.uint8), "labels": list(rng.randint(0, 10, 2))}, f)
    for name, root, n in (("MNIST", str(mn), 5),
                          ("CIFAR10", str(tmp_path / "cifar"), 10)):
        got = getattr(tvision, name)(root=root)
        want = getattr(jvision, name)(root=root)
        assert len(got) == len(want) == n
        for i in range(n):
            assert_equal(host(got[i][0]), host(want[i][0]))
            assert got[i][1] == want[i][1]
        tf = getattr(tvision, name)(root=root, train=True,
                                    transform=lambda x, y: (x.shape, y + 1))
        assert tf[1] == (got[1][0].shape, got[1][1] + 1)
    test = tvision.CIFAR10(root=str(tmp_path / "cifar"), train=False)
    assert len(test) == 2 and test[0][0].shape == (32, 32, 3)
    with pytest.raises(mx.MXNetError, match="t10k-images-idx3-ubyte"):
        tvision.MNIST(root=str(mn), train=False)
    with pytest.raises(mx.MXNetError, match="cifar-100-python"):
        tvision.CIFAR100(root=str(tmp_path / "none"))


def test_bilinear_resize_needs_no_codec(monkeypatch):
    """``interp=1`` is numpy alone: it runs with PIL missing, where decode
    and the codec ops raise a named ImportError."""
    a = image(5)
    want = host(timg.imresize(mx.nd.array(a, ctx=CPU, dtype="uint8"), 9, 7))
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = host(timg.imresize(mx.nd.array(a, ctx=CPU, dtype="uint8"), 9, 7))
    assert_equal(got, want)
    with pytest.raises(ImportError):
        timg.imdecode(b"\x89PNG")
    with pytest.raises(ImportError, match="_cvimresize needs PIL"):
        mx.nd.op._cvimresize(mx.nd.array(a, ctx=CPU, dtype="uint8"), w=3,
                             h=3)


def test_record_fed_step_matches_jax(tmp_path):
    """`chip_smoke.vision_record_step`, the vision phase's record-fed step
    at its small size, on both packages: raw-pixel records (written by the
    port), `RecordFileDataset` through gluon-cv's ImageNet transforms and
    `DataLoader`, one SGD step of the gluon phase's small ResNet from the
    JAX package's weights. Batch, loss, output and weights within rtol
    1e-4 / atol 1e-5."""
    import chip_smoke as cs
    from mxnet_tpu_torch import recordio as trec

    cfg = cs.VISION_SMALL_RECORDS
    rec, labels = cs.vision_records(trec, str(tmp_path), cfg["n"],
                                    cfg["image"], cfg["classes"], seed=1)
    # a frame header (8 B), an IRHeader (24 B) and the pixels a record
    assert os.path.getsize(rec) == cfg["n"] * (32 + np.prod(cfg["image"]))
    params = str(tmp_path / "small_resnet.params")
    jmx.random.seed(0)
    net = cs.gluon_small_net(jmx)()
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.zeros((1, 3, cfg["crop"], cfg["crop"])))
    net.save_parameters(params)
    jmx.nd.load(params)  # the JAX package writes its files asynchronously
    want = cs.vision_record_step(jmx, jmx.cpu(), rec, params)
    got = cs.vision_record_step(mx, CPU, rec, params)
    assert got["batch"].shape == (cfg["batch"], 3, cfg["crop"], cfg["crop"])
    assert set(got["label"]) <= set(labels.astype(np.float32))
    cs.vision_compare("record-fed step", got, want, cs.ND_SMALL_TOL)
