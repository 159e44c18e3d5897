"""KVStore: key-value synchronization of gradients and parameters, the port
of `mxnet_tpu/kvstore.py`.

Values are torch tensors where the JAX package has NDArrays; a list of
tensors stands for one key's per-device values. `create` maps ``local`` and
``device`` to `KVStoreLocal` (one process) and ``dist_sync`` /
``dist_device_sync`` / ``dist_tpu_sync`` to `parallel.dist.KVStoreDistTPUSync`
(a `torch.distributed` process group). `row_sparse_pull` hands back only
the requested rows. Not ported: the flat-bucket primitives of gradient
bucketing (`allreduce_flat`, `reduce_scatter_flat`), the fused-step hooks
and the save/load of optimizer states.

With telemetry on, push and pull record ``kvstore.push_bytes`` /
``kvstore.pull_bytes`` (the dense bytes of the values pushed and of the
arrays pulled into; for a row-sparse value the bytes of its stored rows
and indices, where the JAX package counts its dense size) and the host
latency histograms ``kvstore.push_us`` / ``kvstore.pull_us`` (enqueue time
on a card).
"""
from __future__ import annotations

import time
import zlib

import torch

from . import optimizer as opt
from . import telemetry
from .base import MXNetError
from .gradient_compression import GradientCompression

__all__ = ["KVStoreBase", "KVStoreLocal", "create"]


class KVStoreBase:
    """The interface every store shares: gradient compression, an optional
    updater (the optimizer run "on the store"), rank and worker count."""

    def __init__(self):
        self._updater = None
        self._gc = GradientCompression()

    @property
    def type(self):
        raise NotImplementedError

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def set_gradient_compression(self, compression_params):
        """2-bit gradient compression with an error-feedback residual: later
        pushes are quantized to {-threshold, 0, +threshold}; init bypasses
        it."""
        self._gc.set_params(compression_params)

    def set_optimizer(self, optimizer):
        """Register an optimizer, so that a push updates the stored value."""
        self._set_updater(opt.get_updater(optimizer))

    def _set_updater(self, updater):
        self._updater = updater

    def barrier(self):
        pass


def _nbytes(values):
    """Dense bytes of a tensor or a list of them; the stored bytes of a
    row-sparse value."""
    if isinstance(values, (list, tuple)):
        return sum(_nbytes(v) for v in values)
    if not isinstance(values, torch.Tensor):
        return sum(_nbytes(t) for t in values._components().values())
    return int(values.numel()) * values.element_size()


def _group_sum(values):
    """Sum one key's per-device values onto the first value's device, as a
    new tensor."""
    out = values[0].detach().clone()
    for v in values[1:]:
        out += v.detach().to(out.device)
    return out


class KVStoreLocal(KVStoreBase):
    """Single-process store: a push sums one key's values across devices."""

    def __init__(self, device=False):
        super().__init__()
        self._device = device
        self._store = {}  # key -> tensor, the authoritative value

    @property
    def type(self):
        return "device" if self._device else "local"

    @staticmethod
    def _normalize(key, value):
        """[(key, [tensor, ...]), ...] from one key and value or aligned
        lists; a value may be a list of per-device tensors."""
        if isinstance(key, (str, int)):
            key, value = [key], [value]
        if len(key) != len(value):
            raise MXNetError(
                f"grouped call: {len(key)} keys but {len(value)} values")
        return [(k, [v] if isinstance(v, torch.Tensor) else list(v))
                for k, v in zip(key, value)]

    def init(self, key, value):
        """Initialize key-value pairs."""
        for k, vals in self._normalize(key, value):
            if k in self._store:
                raise MXNetError(f"key {k} already initialized")
            self._store[k] = vals[0].detach().clone()

    @torch.no_grad()
    def push(self, key, value, priority=0):
        """Sum values across devices, compress the sum when compression is
        on, then either apply the updater to the stored value or store the
        sum."""
        tele = telemetry._enabled
        t0 = time.perf_counter() if tele else 0.0
        for k, vals in self._normalize(key, value):
            if tele:
                telemetry.counter("kvstore.push_bytes").inc(_nbytes(vals))
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized (call init first)")
            merged = _group_sum(vals)
            if self._gc.active:
                packed = self._gc.quantize(k, merged)
                merged = self._gc.dequantize(packed, merged.shape,
                                             merged.dtype)
            stored = self._store[k]
            merged = merged.to(stored.device)
            if self._updater is not None:
                self._updater(_key_index(k), merged, stored)
            else:
                self._store[k] = merged
        if tele:
            telemetry.histogram("kvstore.push_us").record(
                (time.perf_counter() - t0) * 1e6)

    @torch.no_grad()
    def pull(self, key, out=None, priority=0):
        """Copy the stored values into the ``out`` tensors, in their dtype."""
        if out is None:
            raise MXNetError("pull needs out")
        tele = telemetry._enabled
        t0 = time.perf_counter() if tele else 0.0
        for k, outs in self._normalize(key, out):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized (call init first)")
            if tele:
                telemetry.counter("kvstore.pull_bytes").inc(_nbytes(outs))
            for o in outs:
                o.copy_(self._store[k])
        if tele:
            telemetry.histogram("kvstore.pull_us").record(
                (time.perf_counter() - t0) * 1e6)

    def pushpull(self, key, value, out=None, priority=0):
        """Push, then pull into ``out`` (into ``value`` when out is None)."""
        self.push(key, value, priority)
        self.pull(key, out if out is not None else value, priority)

    @torch.no_grad()
    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` (the reference's
        PullRowSparseImpl, `kvstore_dist.h:271`): a row_sparse ``out`` gets
        the deduplicated requested rows as its components, a dense one
        (NDArray or tensor) the full shape with those rows filled and the
        others zero. One out, or a list with one row_ids each or one for
        all."""
        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull needs out and row_ids")
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        rids = list(row_ids) if isinstance(row_ids, (list, tuple)) \
            else [row_ids] * len(outs)
        keys = [key] * len(outs) if isinstance(key, (str, int)) else key
        from .ndarray import sparse

        for k, o, rid in zip(keys, outs, rids):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized (call init first)")
            src = self._store[k]
            sparse.fill_rows(o, src, sparse.unique_rows(rid, src.device))


def _str_key_int(k):
    """A deterministic int for a string key (the updater's state index),
    stable across processes, as the JAX package's."""
    return zlib.crc32(str(k).encode("utf-8")) & 0x7FFFFFFF


def _key_index(k):
    """The updater's state index of a key, the same in every store type."""
    return k if isinstance(k, int) else _str_key_int(k)


def create(name="local", device=None):
    """Create a KVStore by type name. ``device`` places a dist store's
    process group: NCCL for a CUDA device (the default), gloo for the CPU.
    ``dist_async`` is refused, as in the JAX package."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name = name.lower()
    if name in ("local", "local_update_cpu", "local_allreduce_cpu"):
        return KVStoreLocal(device=False)
    if name in ("device", "local_allreduce_device", "nccl"):
        return KVStoreLocal(device=True)
    if name.startswith("dist"):
        if "async" in name:
            raise MXNetError("dist_async is not supported: synchronous "
                             "collectives replace parameter servers. Use "
                             "dist_sync / dist_tpu_sync.")
        from .parallel.dist import KVStoreDistTPUSync

        return KVStoreDistTPUSync(device=device)
    raise MXNetError(f"unknown kvstore type {name}")
