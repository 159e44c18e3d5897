"""Data iterators: the port of `mxnet_tpu/io/io.py` (parity
`python/mxnet/io/io.py`): `DataDesc`, `DataBatch`, `DataIter`,
`NDArrayIter`, `ResizeIter`, `PrefetchingIter`, `CSVIter` and
`LibSVMIter`.

Batches are cut from host numpy arrays and become NDArrays on the current
context, one copy to the device a batch (from pinned memory, not waiting
for the card). `NDArrayIter`'s shuffle draws
from numpy's global stream, as the JAX package's does, so a seeded run
shuffles alike in both packages. `PrefetchingIter` fetches batches on a
background thread (the JAX package's thread path; its native-engine path
has no counterpart here), with the ``prefetch`` fault point and the
``io.prefetch_*`` telemetry; `CSVIter` and `LibSVMIter` read a local file
once and batch it in memory.
"""
from __future__ import annotations

import collections
import logging
import queue as _queue
import threading
import time as _time

import numpy as _np

from .. import telemetry, tracing
from ..base import MXNetError, getenv, register_env

register_env("MXNET_PREFETCH_JOIN_TIMEOUT", 5.0,
             "seconds to wait for a prefetch thread at reset")

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


# (rows, batch_size, device) -> the index that maps a short batch onto its
# padded bucket (row i < n keeps data[i], row n + j recycles data[j % n]),
# built once a bucket; an LRU keeps the cache bounded under shape churn
_PAD_INDEX_CACHE = collections.OrderedDict()
_PAD_INDEX_CACHE_MAX = 64


def _pad_index(n, batch_size, device="cpu"):
    """The cached wrap-around gather index that pads ``n`` rows up to
    ``batch_size`` on ``device``: the same key returns the SAME tensor."""
    import torch

    key = (int(n), int(batch_size), str(torch.device(device)))
    idx = _PAD_INDEX_CACHE.get(key)
    if idx is None:
        pad = batch_size - n
        idx = torch.as_tensor(_np.concatenate(
            [_np.arange(n), _np.arange(pad) % n]), device=device)
        _PAD_INDEX_CACHE[key] = idx
        while len(_PAD_INDEX_CACHE) > _PAD_INDEX_CACHE_MAX:
            _PAD_INDEX_CACHE.popitem(last=False)
    else:
        _PAD_INDEX_CACHE.move_to_end(key)
    return idx


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
        out.append(NDArray(data.index_select(
            0, _pad_index(n, batch_size, data.device))))
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


def _batch_dtype(source):
    """The dtype of the batches cut from ``source``: `nd.array`'s, which
    makes float64 float32 and int64 int32, as the JAX package does. A
    module binds its inputs at this dtype."""
    return {_np.dtype(_np.float64): _np.dtype(_np.float32),
            _np.dtype(_np.int64): _np.dtype(_np.int32)}.get(
                source.dtype, source.dtype)


def _batch_array(chunk, host=False):
    """``chunk`` as an NDArray on the current context (``host``: on the
    CPU), cast as `nd.array` casts. On a card the values pass through
    pinned memory and are copied without blocking (stream-ordered before
    anything that reads them), so fetching the next batch does not wait
    for the step the card runs."""
    import torch

    from ..context import cpu, current_context
    from ..ndarray import NDArray
    from ..ndarray import array as nd_array

    if host:
        return nd_array(chunk, ctx=cpu())
    device = current_context().torch_device
    if device.type != "cuda":
        return nd_array(chunk)
    host = nd_array(chunk, ctx=cpu())._data
    return NDArray(host.pin_memory().to(device, non_blocking=True))


class NDArrayIter(DataIter):
    """Batches of in-memory arrays (data and label as an array, a list or a
    dict), optionally shuffled each epoch, with the last short batch
    padded from the front (``"pad"``), dropped (``"discard"``) or carried
    into the next epoch (``"roll_over"``). Batches land on the current
    context; with ``host_batches`` set they stay on the CPU, for a
    consumer that copies them to its device itself (`Module.fit`'s staged
    feed, on its staging thread)."""

    host_batches = False

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
        return [DataDesc(k, (self.batch_size,) + v.shape[1:],
                         _batch_dtype(v)) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:],
                         _batch_dtype(v)) for k, v in self.label]

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
            out.append(_batch_array(chunk, self.host_batches))
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
    """Background prefetch over one or more iterators (the role of the
    reference's `PrefetcherIter`): a thread fetches up to
    ``prefetch_depth`` combined batches ahead while the trainer consumes.
    The fetches make their arrays on the context that was current where
    the iterator was built (or last reset). A fetch error is raised to
    the consumer; a thread that dies without
    delivering raises MXNetError instead of wedging the loop. `reset`
    stops the epoch's thread (waiting ``MXNET_PREFETCH_JOIN_TIMEOUT``) and
    starts the next; a wedged thread is left to the new one, which waits
    it out before it resets the sources. With telemetry on, the wait and
    the consumer's compute between batches count into
    ``io.prefetch_wait_us`` / ``io.prefetch_wait_us_total`` /
    ``io.prefetch_compute_us_total`` (their ratio is the starvation
    ratio)."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._depth = prefetch_depth
        self._queue = None
        self._thread = None
        self._name = (f"PrefetchingIter#{id(self):x}"
                      f"({','.join(type(i).__name__ for i in iters)})")
        self._handoff = None
        self._t_consumed = None     # end of the previous next() (telemetry)
        self._start()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
                     for d in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r.get(d.name, d.name), d.shape, d.dtype)
                     for d in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def _fetch_one(self):
        """One combined batch (on the thread): a DataBatch, None at the
        end, or the exception a source raised."""
        try:
            batches = []
            try:
                for it in self.iters:
                    batches.append(it.next())
            except StopIteration:
                return None
            data = sum([b.data for b in batches], [])
            label = sum([(b.label or []) for b in batches], [])
            return DataBatch(data=data, label=label, pad=batches[0].pad,
                             index=batches[0].index)
        except Exception as e:  # noqa: BLE001 - raised to the consumer
            return e

    def _start(self):
        from ..context import current_context

        self._queue = _queue.Queue(maxsize=max(1, self._depth))
        self._stop = threading.Event()
        # the current context is per thread: the fetches make their
        # arrays on the consumer's
        ctx = current_context()

        # q and stop are bound per epoch: a thread wedged across a reset
        # keeps talking to ITS queue and ITS (set) stop event. `prev` is a
        # predecessor that outlived its join timeout: the new thread waits
        # it out and only then resets the sources
        def worker(q=self._queue, stop=self._stop, prev=self._handoff):
            from .. import resilience

            if prev is not None:
                prev.join()
                for it in self.iters:
                    it.reset()
            while not stop.is_set():
                try:
                    resilience.inject("prefetch", self._name)
                except resilience.ThreadKilled:
                    return  # a simulated silent thread death
                with tracing.span("io.prefetch_fetch", cat="io"), ctx:
                    item = self._fetch_one()
                q.put(item)
                if item is None or isinstance(item, Exception):
                    return

        self._handoff = None
        self._thread = threading.Thread(target=worker, daemon=True,
                                        name=self._name)
        self._thread.start()

    def reset(self):
        self._stop.set()
        # the gap between epochs is not step compute
        self._t_consumed = None
        try:
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass
        stale = None
        if self._thread is not None:
            timeout = float(getenv("MXNET_PREFETCH_JOIN_TIMEOUT"))
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                # a wedged fetch cannot be killed from Python: leave the
                # daemon thread, never silently
                logging.getLogger(__name__).warning(
                    "%s: prefetch thread still alive %.1fs after reset(); "
                    "the new epoch waits until it exits (the source "
                    "iterator may be wedged)", self._name, timeout)
                stale = self._thread
        self._handoff = stale
        if stale is None:
            for it in self.iters:
                it.reset()
        self._start()

    def next(self):
        if telemetry._enabled:
            t0 = _time.perf_counter()
            if self._t_consumed is not None:
                telemetry.counter("io.prefetch_compute_us_total").inc(
                    (t0 - self._t_consumed) * 1e6)
            item = self._get_item()
            wait_us = (_time.perf_counter() - t0) * 1e6
            telemetry.histogram("io.prefetch_wait_us").record(wait_us)
            telemetry.counter("io.prefetch_wait_us_total").inc(wait_us)
            self._t_consumed = _time.perf_counter()
        else:
            item = self._get_item()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def _get_item(self):
        """A blocking queue read that cannot hang on a dead producer."""
        while True:
            try:
                return self._queue.get(timeout=0.1)
            except _queue.Empty:
                if self._thread.is_alive():
                    continue
                try:
                    # the final put may have raced the liveness check
                    return self._queue.get_nowait()
                except _queue.Empty:
                    raise MXNetError(
                        f"{self._name}: prefetch thread died without "
                        "delivering a batch") from None

    def iter_next(self):
        try:
            self._next_batch = self.next()
            return True
        except StopIteration:
            return False


class CSVIter(NDArrayIter):
    """CSV file iterator (reference `iter_csv.cc`): loads a local CSV file
    once and batches it in memory; ``round_batch`` pads the last batch,
    else it is discarded."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32", **kwargs):
        data = _np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=dtype,
                                ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[:-1])
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="pad" if round_batch else "discard",
                         label_name="label")


class LibSVMIter(NDArrayIter):
    """LibSVM-format iterator (reference `iter_libsvm.cc:200`), dense-backed
    as in the JAX package: each line ``label index:value ...`` parses to a
    dense feature vector of ``data_shape``."""

    def __init__(self, data_libsvm, data_shape, label_shape=None,
                 batch_size=1, **kwargs):
        dim = int(_np.prod(data_shape))
        rows, labels = [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                vec = _np.zeros(dim, dtype=_np.float32)
                for tok in parts[1:]:
                    i, _, v = tok.partition(":")
                    vec[int(i)] = float(v)
                rows.append(vec)
        data = _np.stack(rows).reshape((-1,) + tuple(data_shape))
        super().__init__(data, _np.asarray(labels, dtype=_np.float32),
                         batch_size=batch_size, label_name="label")
