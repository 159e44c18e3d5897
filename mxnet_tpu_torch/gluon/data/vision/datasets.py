"""Vision datasets from local files: the port of
`mxnet_tpu/gluon/data/vision/datasets.py` (parity
`python/mxnet/gluon/data/vision/datasets.py`): MNIST and FashionMNIST
(idx files), CIFAR10 and CIFAR100 (the python pickle batches or their
``.tar.gz``), `ImageRecordDataset` (a ``.rec`` of packed images) and
`ImageFolderDataset` (``root/class/image``).

Nothing is downloaded: a missing file raises with the path where it
belongs, as in the JAX package. Images are HWC uint8 CPU NDArrays.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as _np

from .... import ndarray as nd
from ....base import MXNetError
from ....context import cpu
from .. import dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(dataset.Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        if not os.path.isdir(self._root):
            os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return _np.frombuffer(f.read(), dtype=_np.uint8).reshape(dims)


class MNIST(_DownloadedDataset):
    """MNIST from its idx files (``train-images-idx3-ubyte[.gz]`` and the
    others) under ``root``: 28 x 28 x 1 uint8 images, int32 labels."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _find(self, base):
        for cand in (base, base + ".gz"):
            p = os.path.join(self._root, cand)
            if os.path.exists(p):
                return p
        raise MXNetError(
            f"{base}[.gz] not found under {self._root}; nothing is "
            f"downloaded: place the raw idx files there")

    def _get_data(self):
        imgs, labels = self._train_files if self._train else self._test_files
        data = _read_idx(self._find(imgs))
        label = _read_idx(self._find(labels))
        self._data = nd.array(data[..., None].astype("uint8"), ctx=cpu(),
                              dtype="uint8")
        self._label = label.astype("int32")


class FashionMNIST(MNIST):
    """FashionMNIST, in MNIST's file format."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root=root, train=train, transform=transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from the python pickle batches under ``root``
    (``cifar-10-batches-py/`` or ``cifar-10-python.tar.gz``): 32 x 32 x 3
    uint8 images, int32 labels."""

    _batch_dir = "cifar-10-batches-py"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _load_batches(self, names):
        d = os.path.join(self._root, self._batch_dir)
        if not os.path.isdir(d):
            tar = os.path.join(self._root, "cifar-10-python.tar.gz")
            if os.path.exists(tar):
                with tarfile.open(tar) as t:
                    t.extractall(self._root)
            else:
                raise MXNetError(
                    f"{self._batch_dir}/ not found under {self._root}; "
                    f"nothing is downloaded: place the CIFAR python batches "
                    f"there")
        data, labels = [], []
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                batch = pickle.load(f, encoding="latin1")
            data.append(batch["data"])
            labels.extend(batch.get("labels", batch.get("fine_labels")))
        data = _np.concatenate(data).reshape(-1, 3, 32, 32).transpose(
            0, 2, 3, 1)
        return data.astype("uint8"), _np.asarray(labels, dtype="int32")

    def _get_data(self):
        names = [f"data_batch_{i}" for i in range(1, 6)] if self._train \
            else ["test_batch"]
        data, label = self._load_batches(names)
        self._data = nd.array(data, ctx=cpu(), dtype="uint8")
        self._label = label


class CIFAR100(CIFAR10):
    """CIFAR100 (``cifar-100-python/``), its fine labels."""

    _batch_dir = "cifar-100-python"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=True, train=True, transform=None):
        self._fine = fine_label
        super().__init__(root=root, train=train, transform=transform)

    def _get_data(self):
        data, label = self._load_batches(["train"] if self._train
                                         else ["test"])
        self._data = nd.array(data, ctx=cpu(), dtype="uint8")
        self._label = label


class ImageRecordDataset(dataset.RecordFileDataset):
    """(image, label) of each record of a ``.rec`` of packed images,
    decoded with `image.imdecode` (``flag`` 0: gray)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import recordio
        from ....image import imdecode

        header, img = recordio.unpack(super().__getitem__(idx))
        image = imdecode(img, self._flag)
        if self._transform is not None:
            return self._transform(image, header.label)
        return image, header.label


class ImageFolderDataset(dataset.Dataset):
    """(image, label) of each image under ``root/<class>/``, the classes
    (``synsets``) in sorted order."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".bmp"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from ....image import imread

        img = imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
