"""gluon.data.DataLoader: the port of `mxnet_tpu/gluon/data/dataloader.py`
(parity `python/mxnet/gluon/data/dataloader.py`): batches from a
`Dataset` through a sampler, ``batchify_fn`` and workers.

Batches are CPU arrays. The caller moves each to the card once
(``batch.as_in_context(mx.gpu(0))``); with ``pin_memory`` (and a card) a
batch is page-locked, so that copy does not block the host. The workers
page-lock it (a worker process's batch, in a pin thread of the parent),
so the thread that iterates only takes finished batches. Three worker
paths:

* ``num_workers=0``: the calling thread reads and batches;
* ``thread_pool=True`` (the default with workers): a thread pool, as in
  the JAX package;
* ``thread_pool=False``: worker processes. They are forked from
  multiprocessing's fork server, a fresh interpreter that imports the
  port and never touches CUDA, so no worker is a fork of a parent whose
  CUDA context is live; each gets the dataset once, at its start, and
  returns numpy batches through the pool's pipe. The JAX package ships
  them through a shared-memory arena of its native runtime; the port has
  no native runtime, so the pipe carries them.

An epoch's workers stop when its iterator is exhausted or dropped. The
fork server and multiprocessing's resource tracker outlive the epochs;
`shutdown_worker_processes` stops them.
"""
from __future__ import annotations

import contextlib
import gc
import multiprocessing
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ... import ndarray as nd
from ...context import cpu
from ...ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "shutdown_worker_processes"]

# the longest an ending epoch waits for the batches its worker processes
# are sending before it stops them
_DRAIN_S = 60.0


def default_batchify_fn(data):
    """Stack a list of items into a batch: NDArrays with `nd.stack`,
    tuples element by element, anything else through numpy (as CPU
    arrays)."""
    if isinstance(data[0], NDArray):
        return nd.stack(*data)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    data = np.asarray(data)
    return nd.array(data, ctx=cpu(), dtype=data.dtype)


def _as_numpy_batchify(data):
    """A worker process's batchify: numpy, which pickles with no torch
    storage to share."""
    if isinstance(data[0], tuple):
        return [_as_numpy_batchify(i) for i in zip(*data)]
    if isinstance(data[0], NDArray):
        return np.stack([d.asnumpy() for d in data])
    return np.asarray(data)


class _WorkerFn:
    """Read and batchify one index batch (the thread pool's task, then as
    CPU NDArrays page-locked with ``pin_memory``; a worker process's, left
    as it is)."""

    def __init__(self, dataset, batchify_fn, pin_memory=None):
        self._dataset = dataset
        self._batchify_fn = batchify_fn
        self._pin_memory = pin_memory

    def __call__(self, indices):
        batch = self._batchify_fn([self._dataset[i] for i in indices])
        if self._pin_memory is None:
            return batch
        return _to_nd(batch, self._pin_memory)


_worker_fn = None  # a worker process's `_WorkerFn`, set at its start


def _worker_init(dataset, batchify_fn):
    global _worker_fn
    torch.set_num_threads(1)  # one core a worker: the pool is the spread
    _worker_fn = _WorkerFn(dataset, batchify_fn)


def _worker_task(indices):
    return _worker_fn(indices)


def _received(result, pin_memory, stopped):
    """A worker process's batch, once it arrives, as CPU NDArrays
    (page-locked with ``pin_memory``): the pin thread's task. Gives up
    when the epoch has ``stopped``, and holds no reference to the epoch,
    so that a dropped epoch is collected."""
    while True:
        try:
            batch = result.get(0.1)
            break
        except multiprocessing.TimeoutError:
            if stopped.is_set():
                raise RuntimeError("the epoch's workers stopped") from None
    return _to_nd(batch, pin_memory, owned=True)


def _process_context():
    """multiprocessing's fork-server context, its server preloading the
    port so that each worker starts as a cheap fork of a process that
    has never initialised CUDA."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["mxnet_tpu_torch"])
    return ctx


def shutdown_worker_processes():
    """Stop the fork server that worker processes are forked from and
    multiprocessing's resource tracker: both outlive the epochs, and a
    program that must leave no process behind calls this after its last
    epoch. A later epoch with worker processes starts them again."""
    from multiprocessing import forkserver, resource_tracker

    gc.collect()  # the dropped pools' semaphores unlink themselves first
    for server in (forkserver._forkserver, resource_tracker._resource_tracker):
        with contextlib.suppress(Exception):
            server._stop()


def _to_nd(batch, pin_memory=False, owned=False):
    """A batch (nested lists of NDArrays or numpy arrays) as CPU NDArrays,
    page-locked with ``pin_memory`` where a card exists. An ``owned`` numpy
    batch (a worker process's, unpickled here) is wrapped, not copied."""
    if isinstance(batch, (list, tuple)):
        return [_to_nd(b, pin_memory, owned) for b in batch]
    if not isinstance(batch, NDArray):
        batch = NDArray(torch.from_numpy(np.ascontiguousarray(batch))) \
            if owned else nd.array(batch, ctx=cpu(), dtype=batch.dtype)
    if pin_memory and torch.cuda.is_available() and \
            not batch._data.is_cuda and not batch._data.is_pinned():
        batch = NDArray(batch._data.pin_memory())
    return batch


class DataLoader:
    """Mini-batches of ``dataset``.

    ``batch_size`` with ``shuffle`` or a ``sampler``, and ``last_batch``
    ("keep", "discard" or "rollover"), or a ``batch_sampler``;
    ``batchify_fn`` (default `default_batchify_fn`); ``num_workers``
    threads or (``thread_pool=False``) processes, ``prefetch`` batches in
    flight (default twice the workers); ``pin_memory``."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._thread_pool = thread_pool

        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")

        self._batch_sampler = batch_sampler
        self._num_workers = num_workers if num_workers >= 0 else 0
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * self._num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn

    def __iter__(self):
        if self._num_workers == 0:
            def same_process_iter():
                for batch in self._batch_sampler:
                    yield _to_nd(self._batchify_fn(
                        [self._dataset[idx] for idx in batch]),
                        self._pin_memory)
            return same_process_iter()
        return _MultiWorkerIter(self)

    def __len__(self):
        return len(self._batch_sampler)


class _MultiWorkerIter:
    """One epoch over a worker pool, ``prefetch`` batches ahead."""

    def __init__(self, loader):
        self._loader = loader
        bf = loader._batchify_fn
        self._stopped = threading.Event()
        self._pin = None
        if loader._thread_pool:
            self._pool = ThreadPoolExecutor(
                max_workers=loader._num_workers,
                thread_name_prefix="DataLoader")
            fn = _WorkerFn(loader._dataset, bf, loader._pin_memory)
            self._submit = lambda idx: self._pool.submit(fn, idx)
        else:
            np_bf = _as_numpy_batchify if bf is default_batchify_fn else bf
            self._pool = _process_context().Pool(
                loader._num_workers, initializer=_worker_init,
                initargs=(loader._dataset, np_bf))
            # one thread takes the workers' batches in order and wraps
            # (and page-locks) them, as torch's pin thread does
            self._pin = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="DataLoaderPin")
            pin, stopped = loader._pin_memory, self._stopped

            def submit(idx):
                result = self._pool.apply_async(_worker_task, (idx,))
                self._sent = [r for r in self._sent if not r.ready()]
                self._sent.append(result)
                return self._pin.submit(_received, result, pin, stopped)

            self._sent = []
            self._submit = submit
        self._batch_iter = iter(loader._batch_sampler)
        self._pending = []
        for _ in range(max(1, loader._prefetch)):
            self._push_next()

    def _push_next(self):
        indices = next(self._batch_iter, None)
        if indices is not None:
            self._pending.append(self._submit(indices))

    def __next__(self):
        if not self._pending:
            self._shutdown()
            raise StopIteration
        fut = self._pending.pop(0)
        self._push_next()
        return fut.result()

    def __iter__(self):
        return self

    def close(self):
        """Stop the epoch's workers now (an abandoned epoch stops them
        when it is dropped)."""
        self._shutdown()

    def _shutdown(self):
        self._pending = []
        self._stopped.set()
        if isinstance(self._pool, ThreadPoolExecutor):
            self._pool.shutdown(wait=False, cancel_futures=True)
        else:
            self._pin.shutdown(wait=False, cancel_futures=True)
            # a worker stopped while it sends a batch leaves the pool's
            # result thread waiting for the rest, and terminate() waiting
            # on that thread: the batches in flight arrive first
            deadline = time.monotonic() + _DRAIN_S
            for result in self._sent:
                result.wait(max(0.0, deadline - time.monotonic()))
            self._sent = []
            self._pool.terminate()
            self._pool.join()

    def __del__(self):
        try:
            self._shutdown()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
