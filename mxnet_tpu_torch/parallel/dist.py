"""The process group and the ``dist_sync`` KVStore: the port of
`mxnet_tpu/parallel/dist.py` over `torch.distributed`.

Every worker process joins one process group: NCCL when the store's device
is a CUDA card, gloo on the CPU. There are no server processes; a push is a
collective that every worker makes with the same keys in the same order, and
the optimizer runs on every worker on the summed gradient.

* Dense push: the keys of one push call are grouped by dtype into one flat
  bucket each, and each bucket is summed over the workers by one
  `all_reduce` (the JAX package also caps a bucket's size; the port's
  trainer pushes one key at a time).
  16-bit keys ride a bf16 wire (`MXNET_KVSTORE_FP32_WIRE=1` keeps fp32).
* 2-bit compressed push: each worker quantizes each key with its own
  error-feedback residual (`GradientCompression.quantize`, the K3 kernel on
  a card), the packed words of the call ride one `all_gather`, and every
  worker dequantizes all workers' words and sums them in fp32.
* Row-sparse push (a `RowSparseNDArray` value): only the occupied rows
  travel. Each worker's (indices, rows) are padded to the largest worker's
  row count (one all-gather of the counts) and all-gathered; the pieces
  stay unmerged until a pull, `pull_sparse_grad` or `row_sparse_pull`
  merges them (sorted unique rows, summed) and, with an updater, applies
  the lazy update to the stored rows (reference `EncodeRowSparseKey`,
  `kvstore_dist.h:676`). One worker keeps its pieces where they are.

With telemetry on, every collective records ``dist.<name>_calls``,
``dist.<name>_bytes`` (this process's contribution: the flat bucket of an
all_reduce, the packed uint32 words of a compressed all_gather) and the
host latency ``dist.<name>_us``, which is enqueue time (NCCL runs on the
card's stream, as the JAX package's dispatch was asynchronous); pushes
count ``dist.push_collectives``, and push and pull the
``kvstore.push_bytes`` / ``kvstore.pull_bytes`` dense sizes.

Not ported: `allreduce_flat`, `reduce_scatter_flat`, the fused-step sync
and the elastic lease.
"""
from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist

from .. import analysis, telemetry
from ..base import MXNetError
from ..context import resolve_device
from ..gradient_compression import compressed_size
from ..kvstore import KVStoreBase, _group_sum, _key_index, _nbytes
from ..ndarray import sparse

__all__ = ["init_process_group", "KVStoreDistTPUSync"]

def _env_coordinator():
    if os.environ.get("MXNET_COORDINATOR"):
        return os.environ["MXNET_COORDINATOR"]
    uri = os.environ.get("DMLC_PS_ROOT_URI")
    if not uri:
        return None
    port = os.environ.get("DMLC_PS_ROOT_PORT", "9091")
    return f"{uri}:{port}"


def init_process_group(coordinator=None, num_processes=None, process_id=None,
                       device=None):
    """Join the process group from the arguments or the environment; a no-op
    when this process already has a group or there is no coordinator (one
    process). Returns True when a group exists afterwards.

    The environment names are the JAX package's: `MXNET_COORDINATOR`
    (``host:port``) or `DMLC_PS_ROOT_URI` / `DMLC_PS_ROOT_PORT`;
    `MXNET_NUM_PROCESSES` or `DMLC_NUM_WORKER`; `MXNET_PROCESS_ID` or
    `DMLC_WORKER_ID`. `MXNET_INIT_TIMEOUT_S` bounds the rendezvous. The
    backend is NCCL for a CUDA ``device`` (the default) and gloo for the
    CPU."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or _env_coordinator()
    if coordinator is None:
        return False
    dev = resolve_device(device)
    if num_processes is None:
        num_processes = int(os.environ.get(
            "MXNET_NUM_PROCESSES", os.environ.get("DMLC_NUM_WORKER", "1")))
    if process_id is None:
        process_id = int(os.environ.get(
            "MXNET_PROCESS_ID", os.environ.get("DMLC_WORKER_ID", "0")))
    kwargs = {}
    timeout_s = int(os.environ.get("MXNET_INIT_TIMEOUT_S", "0"))
    if timeout_s:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        kwargs.update(backend="nccl", device_id=dev)
    elif dev.type == "cpu":
        kwargs["backend"] = "gloo"
    else:
        raise MXNetError(f"no process-group backend for device {dev}")
    try:
        dist.init_process_group(init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                **kwargs)
    except Exception as e:
        raise MXNetError(
            f"process group rendezvous failed: coordinator={coordinator} "
            f"rank={process_id}/{num_processes} ({e!r}). Check that the "
            f"coordinator host:port is reachable, that all {num_processes} "
            "workers launched, and that every rank is claimed once "
            "(MXNET_PROCESS_ID / DMLC_WORKER_ID).") from e
    return True


def _collective_telemetry(name, buf, t0):
    """One collective: its bytes (this process's contribution) and the
    host time to issue it."""
    telemetry.counter(f"dist.{name}_calls").inc()
    telemetry.counter(f"dist.{name}_bytes").inc(_nbytes(buf))
    telemetry.histogram(f"dist.{name}_us").record(
        (time.perf_counter() - t0) * 1e6)


def _wire_dtype(dtype, fp32_wire):
    """16-bit keys ship over a bf16 wire (fp32's exponent range in half the
    bytes); `MXNET_KVSTORE_FP32_WIRE=1` gives them an exact fp32 wire."""
    if dtype in (torch.float16, torch.bfloat16):
        return torch.float32 if fp32_wire else torch.bfloat16
    return dtype


class KVStoreDistTPUSync(KVStoreBase):
    """``create('dist_sync')`` / ``'dist_tpu_sync'`` / ``'dist'``, with the
    JAX package's class name: push sums every worker's gradient (through
    one collective per bucket), pull hands the sum back, or the value the
    updater made of it.

    Without a coordinator the store is single-process and its collectives
    are the identity, as in the JAX package."""

    def __init__(self, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self._grouped = init_process_group(device=self.device)
        self._store = {}    # key -> tensor
        self._pending = {}  # key -> summed dense gradient
        self._pending_rsp = {}  # key -> [(indices, rows), ...] unmerged

    # -- identity -----------------------------------------------------------

    @property
    def type(self):
        return "dist_tpu_sync"

    @property
    def rank(self):
        return dist.get_rank() if self._grouped else 0

    @property
    def num_workers(self):
        return dist.get_world_size() if self._grouped else 1

    def barrier(self):
        if self._grouped:
            if analysis._enabled:
                analysis.check_blocking("collective.barrier")
            t0 = time.monotonic()
            dist.barrier()
            if telemetry._enabled:
                # the time this rank waited at the sync point
                telemetry.histogram("dist.barrier_wait_us").record(
                    (time.monotonic() - t0) * 1e6)

    # -- data plane -----------------------------------------------------------

    @staticmethod
    def _key_list(key, value):
        if isinstance(key, (list, tuple)):
            if len(key) != len(value):
                raise MXNetError(
                    f"grouped call: {len(key)} keys but {len(value)} values")
            return list(key), list(value)
        return [key], [value]

    def init(self, key, value):
        """Set initial values (never compressed)."""
        keys, vals = self._key_list(key, value)
        for k, v in zip(keys, vals):
            if k in self._store:
                raise MXNetError(f"key {k} already initialized")
            self._store[k] = v.detach().to(self.device, copy=True)

    @torch.no_grad()
    def push(self, key, value, priority=0):
        """Sum gradients over all workers into the pending buffer; a list
        value is first summed over its devices."""
        tele = telemetry._enabled
        t0 = time.perf_counter() if tele else 0.0
        keys, vals = self._key_list(key, value)
        if tele:
            telemetry.counter("kvstore.push_bytes").inc(_nbytes(vals))
        arrs, dense_keys = [], []
        for k, v in zip(keys, vals):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized (call init first)")
            if not isinstance(v, (list, tuple, torch.Tensor)):
                self._push_row_sparse(k, v)
                continue
            dense_keys.append(k)
            if isinstance(v, (list, tuple)):
                v = _group_sum(v)
            arrs.append(v.detach().to(self.device))
        if dense_keys and self._gc.active:
            self._push_dense_compressed(dense_keys, arrs)
        elif dense_keys:
            self._push_dense(dense_keys, arrs)
        if tele:
            telemetry.histogram("kvstore.push_us").record(
                (time.perf_counter() - t0) * 1e6)

    def _add_pending(self, k, p):
        pend = self._pending.get(k)
        self._pending[k] = p if pend is None else pend + p

    def _push_dense(self, keys, arrs):
        """Flatten and concatenate the keys of each dtype into one bucket,
        sum each bucket over the workers with one all_reduce on its wire
        dtype, and split it back per key."""
        buckets = {}
        for k, a in zip(keys, arrs):
            buckets.setdefault(a.dtype, []).append((k, a))
        fp32_wire = os.environ.get("MXNET_KVSTORE_FP32_WIRE", "0") == "1"
        for bucket in buckets.values():
            wire = _wire_dtype(bucket[0][1].dtype, fp32_wire)
            flat = torch.cat([a.reshape(-1).to(wire) for _, a in bucket])
            tele = telemetry._enabled
            if tele:
                telemetry.counter("dist.push_collectives").inc()
            if self._grouped:
                t0 = time.perf_counter() if tele else 0.0
                dist.all_reduce(flat, op=dist.ReduceOp.SUM)
                if tele:
                    _collective_telemetry("allreduce", flat, t0)
            off = 0
            for k, a in bucket:
                part = flat[off:off + a.numel()].view(a.shape)
                self._add_pending(k, part.to(a.dtype))
                off += a.numel()

    def _all_gather(self, t):
        """Every worker's ``t`` (same shape on each), stacked."""
        tele = telemetry._enabled
        t0 = time.perf_counter() if tele else 0.0
        out = torch.empty((dist.get_world_size(),) + tuple(t.shape),
                          dtype=t.dtype, device=t.device)
        dist.all_gather(list(out.unbind(0)), t)
        if tele:
            _collective_telemetry("allgather", t, t0)
        return out

    def _push_row_sparse(self, k, v):
        """Queue a row-sparse gradient's pieces: this worker's alone, or
        every worker's through all-gathers padded to the largest row
        count (indices -1 in the padding)."""
        aux = v._components()
        idx = aux["indices"].to(self.device, torch.int32)
        rows = aux["data"].to(self.device)
        pieces = self._pending_rsp.setdefault(k, [])
        if telemetry._enabled:
            telemetry.counter("dist.push_collectives").inc()
        if self.num_workers == 1:
            if idx.numel():
                pieces.append((idx, rows))
            return
        count = torch.tensor([idx.shape[0]], dtype=torch.int64,
                             device=self.device)
        cap = int(self._all_gather(count).max())
        if cap == 0:
            return
        pad_idx = torch.full((cap,), -1, dtype=torch.int32,
                             device=self.device)
        pad_idx[:idx.shape[0]] = idx
        pad_rows = rows.new_zeros((cap,) + tuple(rows.shape[1:]))
        pad_rows[:idx.shape[0]] = rows
        all_idx = self._all_gather(pad_idx).reshape(-1)
        all_rows = self._all_gather(pad_rows).reshape(
            (-1,) + tuple(rows.shape[1:]))
        valid = torch.nonzero(all_idx >= 0).reshape(-1)
        pieces.append((all_idx.index_select(0, valid),
                       all_rows.index_select(0, valid)))

    def _merged_rsp(self, k):
        """The pending pieces of ``k`` merged: (sorted unique rows, their
        sums), or None when no worker pushed a row."""
        from ..autograd import dedup_rows

        pieces = self._pending_rsp.pop(k)
        if not pieces:
            return None
        return dedup_rows(torch.cat([p[0] for p in pieces]),
                          torch.cat([p[1] for p in pieces]))

    def _push_dense_compressed(self, keys, arrs):
        """Quantize each key with its residual, all-gather the packed words
        of all keys at once, then dequantize every worker's words and sum
        them over the workers in fp32, cast to each gradient's dtype."""
        packs = [self._gc.quantize(k, a) for k, a in zip(keys, arrs)]
        bucket = packs[0] if len(packs) == 1 else torch.cat(packs)
        tele = telemetry._enabled
        if tele:
            telemetry.counter("dist.push_collectives").inc()
        if self._grouped:
            t0 = time.perf_counter() if tele else 0.0
            gathered = torch.empty((dist.get_world_size(), bucket.numel()),
                                   dtype=bucket.dtype, device=bucket.device)
            dist.all_gather(list(gathered.unbind(0)), bucket)
            if tele:
                _collective_telemetry("allgather", bucket, t0)
        else:
            gathered = bucket.unsqueeze(0)
        off = 0
        for k, a in zip(keys, arrs):
            words = compressed_size(a.numel())
            per_worker = self._gc.dequantize(gathered[:, off:off + words],
                                             a.shape, torch.float32)
            self._add_pending(k, per_worker.sum(0).to(a.dtype))
            off += words

    @torch.no_grad()
    def pull(self, key, out=None, priority=0):
        """Apply the pending sum of each key (through the updater when one
        is set) and copy the stored value into the ``out`` tensors."""
        if out is None:
            raise MXNetError("pull needs out")
        tele = telemetry._enabled
        t0 = time.perf_counter() if tele else 0.0
        keys, outs = self._key_list(key, out)
        for k, o in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized (call init first)")
            self._apply_pending(k)
            targets = o if isinstance(o, (list, tuple)) else [o]
            if tele:
                telemetry.counter("kvstore.pull_bytes").inc(_nbytes(targets))
            for t in targets:
                t.copy_(self._store[k])
        if tele:
            telemetry.histogram("kvstore.pull_us").record(
                (time.perf_counter() - t0) * 1e6)

    def _apply_pending(self, k):
        if k in self._pending_rsp:
            self._apply_pending_rsp(k)
            return
        pend = self._pending.pop(k, None)
        if pend is None:
            return
        if self._updater is not None:
            self._updater(_key_index(k), pend, self._store[k])
        else:
            self._store[k] = pend.to(self._store[k].dtype)

    def _apply_pending_rsp(self, k):
        """A merged row-sparse sum: the updater's lazy update of the stored
        rows, or without an updater the stored value becomes the sum
        (every other row zero, `kvstore_dist_server.h` ApplyUpdates)."""
        merged = self._merged_rsp(k)
        stored = self._store[k]
        if merged is None:
            if self._updater is None:
                self._store[k] = torch.zeros_like(stored)
            return
        uniq, summed = merged
        if self._updater is not None:
            self._updater(_key_index(k), sparse.RowSparseNDArray(
                summed.to(stored.dtype), uniq, tuple(stored.shape)), stored)
        else:
            dense = torch.zeros_like(stored)
            dense[uniq.long()] = summed.to(stored.dtype)
            self._store[k] = dense

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        self.pull(key, out if out is not None else value, priority)

    def pull_sparse_grad(self, key):
        """The merged pending row-sparse sum of ``key`` as (sorted unique
        rows, summed rows), neither applied to the stored value nor
        densified: the Trainer's merge-then-update-locally flow."""
        merged = self._merged_rsp(key) if key in self._pending_rsp else None
        if merged is None:
            val = self._store[key]
            return (torch.zeros(0, dtype=torch.int32, device=val.device),
                    val.new_zeros((0,) + tuple(val.shape[1:])))
        return merged

    @torch.no_grad()
    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` (reference `PullRowSparseImpl`,
        `kvstore_dist.h:271`), after applying what is pending: a row_sparse
        ``out`` gets just (indices, rows), a dense one the full shape with
        the deduplicated requested rows filled and the others zero."""
        keys, outs = self._key_list(key, out)
        rids = row_ids if isinstance(row_ids, (list, tuple)) \
            else [row_ids] * len(keys)
        for k, o, r in zip(keys, outs, rids):
            self._apply_pending(k)
            val = self._store[k]
            ridx = sparse.unique_rows(r, val.device)
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                sparse.fill_rows(t, val, ridx)

