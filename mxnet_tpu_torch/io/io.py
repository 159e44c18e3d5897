"""Data iterators: the port of `mxnet_tpu/io/io.py` (parity
`python/mxnet/io/io.py`): `DataDesc`, `DataBatch`, `DataIter`,
`NDArrayIter` and `ResizeIter`.

Batches are cut from host numpy arrays and become NDArrays on the current
context, one copy to the device a batch. `NDArrayIter`'s shuffle draws
from numpy's global stream, as the JAX package's does, so a seeded run
shuffles alike in both packages.

Not ported yet: `PrefetchingIter` and `CSVIter`, which wait for the staging
ring (ROADMAP.md queue A, item A.3); both raise NotImplementedError.
"""
from __future__ import annotations

import collections

import numpy as _np

from ..base import MXNetError

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "pad_arrays"]


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape"])):
    """The name, shape, dtype and layout of one input stream."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype},{self.layout}]"

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")

    @staticmethod
    def get_list(shapes, types=None):
        types = dict(types) if types else {}
        return [DataDesc(n, s, types.get(n, _np.float32)) for n, s in shapes]


class DataBatch:
    """One batch: lists of data and label NDArrays, and how many of its
    rows are padding."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            raise TypeError("Data must be list of NDArrays")
        if label is not None and not isinstance(label, (list, tuple)):
            raise TypeError("Label must be list of NDArrays")
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        dshapes = [d.shape for d in self.data] if self.data else []
        lshapes = [l.shape for l in self.label] if self.label else []
        return (f"{type(self).__name__}: data shapes: {dshapes} label "
                f"shapes: {lshapes}")


def pad_arrays(arrays, batch_size):
    """Pad each array in ``arrays`` along axis 0 up to ``batch_size`` by
    recycling its rows from the start (wrapping around when the batch is
    shorter than the pad); returns ``(padded_list, pad)`` (parity
    `mxnet_tpu/io/io.py` `pad_arrays`). A short last batch padded up to
    the bound batch size reuses the step already captured for that shape;
    `Module` slices ``pad`` rows back off its outputs and metrics. The
    padded rows do train, as `NDArrayIter`'s ``last_batch_handle='pad'``
    rows do."""
    import torch

    from ..ndarray import NDArray

    out, pad = [], 0
    for a in arrays:
        n = a.shape[0]
        if n >= batch_size:
            out.append(a)
            continue
        if n == 0:
            raise MXNetError("pad_arrays: cannot pad an empty batch "
                             "(no rows to recycle)")
        pad = batch_size - n
        data = a._data if isinstance(a, NDArray) else torch.as_tensor(a)
        idx = torch.as_tensor(_np.concatenate(
            [_np.arange(n), _np.arange(pad) % n]), device=data.device)
        out.append(NDArray(data.index_select(0, idx)))
    return out, pad


class DataIter:
    """The iterator base: `next` builds a `DataBatch` from `getdata`,
    `getlabel`, `getpad` and `getindex`."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Array, list or dict input as a list of (name, numpy array)."""
    from ..ndarray import NDArray

    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise ValueError(f"{default_name} must be non-empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, list or dict")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else _np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Batches of in-memory arrays (data and label as an array, a list or a
    dict), optionally shuffled each epoch, with the last short batch
    padded from the front (``"pad"``), dropped (``"discard"``) or carried
    into the next epoch (``"roll_over"``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        for k, v in self.data + self.label:
            if v.shape[0] != self.num_data:
                raise ValueError(
                    f"{k} has {v.shape[0]} rows, expected {self.num_data}")
        if last_batch_handle == "discard" and self.num_data < batch_size:
            raise MXNetError("not enough data for even one batch")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.idx = _np.arange(self.num_data)
        self.cursor = -batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            self.cursor = self.cursor - self.num_data - self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrays):
        from ..ndarray import array as nd_array

        start = self.cursor
        end = min(start + self.batch_size, self.num_data)
        out = []
        for _, v in arrays:
            if start >= 0:
                # unshuffled, a slice view: the copy to the device is the
                # only copy
                chunk = v[start:end] if not self.shuffle \
                    else v[self.idx[start:end]]
            else:  # a batch carried over by roll_over
                chunk = v[self.idx[start:]]
                if end > 0:
                    chunk = _np.concatenate([chunk, v[self.idx[:end]]])
            if chunk.shape[0] < self.batch_size:  # pad from the front
                pad = self.batch_size - chunk.shape[0]
                chunk = _np.concatenate([chunk, v[self.idx[:pad]]])
            out.append(nd_array(chunk))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """Another iterator cut or stretched to ``size`` batches an epoch."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Not ported yet: waits for the staging ring."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PrefetchingIter waits for the port's staging ring (ROADMAP.md "
            "queue A, item A.3)")


class CSVIter(DataIter):
    """Not ported yet: waits for the staging ring."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "CSVIter waits for the port's staging ring (ROADMAP.md queue A, "
            "item A.3)")
