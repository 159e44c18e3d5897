"""gluon.data datasets: the port of `mxnet_tpu/gluon/data/dataset.py`
(parity `python/mxnet/gluon/data/dataset.py`)."""
from __future__ import annotations

import os

from ... import recordio
from ...ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Items addressable by integer index."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        """The items for which ``fn(item)`` is true."""
        return _FilteredDataset(self, fn)

    def take(self, count):
        """The first ``count`` items (all of them for None)."""
        if count is None or count > len(self):
            count = len(self)
        return _TakenDataset(self, count)

    def sample(self, sampler):
        """The items at the indices ``sampler`` yields."""
        if not isinstance(sampler, (list, tuple)) and \
                not hasattr(sampler, "__iter__"):
            raise TypeError(f"Invalid sampler type: {type(sampler)}.")
        return _SampledDataset(self, list(iter(sampler)))

    def transform(self, fn, lazy=True):
        """Each item through ``fn`` (a tuple item spread over its
        arguments), at each read with ``lazy``, else once, now."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """The first element of each item through ``fn``."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """A dataset over any indexable sequence."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _FilteredDataset(Dataset):
    def __init__(self, dataset, fn):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]
        self._dataset = dataset

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]


class _TakenDataset(Dataset):
    def __init__(self, dataset, count):
        self._dataset = dataset
        self._count = count

    def __len__(self):
        return self._count

    def __getitem__(self, idx):
        if idx >= self._count:
            raise IndexError("Index out of range")
        return self._dataset[idx]


class _SampledDataset(Dataset):
    def __init__(self, dataset, indices):
        self._dataset = dataset
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]


class ArrayDataset(Dataset):
    """Several array-likes of one length; an item is the tuple of their
    items at an index (the item itself for one array). A 1-D NDArray is
    read as numpy, so its items are numbers."""

    def __init__(self, *args):
        assert len(args) > 0, "Needs at least 1 arrays"
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                f"All arrays must have the same length; 0-th has " \
                f"{self._length} while {i}-th has {len(data)}."
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The records of a RecordIO ``.rec`` file, as bytes, through the
    ``.idx`` index beside it."""

    def __init__(self, filename):
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(self.idx_file,
                                                  self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
