"""Predictor: a trained symbol bound for thread-safe, bucketed inference.
The port of `mxnet_tpu/serving/predictor.py`.

`BaseModule.predict` is a training-loop convenience: one caller, one bound
batch shape. The Predictor serves a concurrent, ragged request stream:

* **bucket-ladder executors**: one ``grad_req="null"`` executor per
  batch-size bucket (``MXNET_SERVING_BUCKETS``), every request padded up to
  the smallest bucket that fits (`io.pad_arrays`, rows sliced back off the
  outputs). On a card each bucket's forward is ONE CUDA graph, captured at
  its first call (`symbol/executor.py` `_Inference`), so steady traffic
  replays exactly ``len(buckets)`` graphs however ragged the sizes;
* **one named cache**: every bucket's program lives in ONE
  `CompileCache("serving")` (each bucket executor's ``_cache`` points at
  it), so warm-up pins the exact capture count and steady state can assert
  zero new misses;
* **serving fusion**: `load` and `from_module` apply the subgraph backend
  of ``MXNET_SUBGRAPH_BACKEND`` (default ``TPU_FUSE``: Convolution ->
  BatchNorm (-> ReLU) folded into `_fused_conv_bn_relu`).

The weights are SHARED by the bucket executors (the same tensors are bound
into each), so N buckets cost N graphs but one copy of the parameters.
The graphs share one memory pool too: their replays never overlap (the
lock below) and each replay's outputs are copied before the next.
Inference never writes them; `swap_weights` writes new values INTO them,
in place, so every captured graph serves the new weights with nothing
captured again.

Execution is serialized on one lock: the card runs one forward at a time,
and serving concurrency comes from batching (`DynamicBatcher`). A graph
replay writes its outputs into fixed buffers, so the forward copies them
while the lock is held and `_run_dispatch` records an event behind the
copies, which `_run_wait` waits on outside the lock.

cuDNN chooses its convolution algorithm per batch size, so one row served
in two buckets need not be bit-equal on the card, as it is on XLA:CPU;
the serve phase of `chip_smoke.py` records the largest difference.

Observability, each plane gated on its module's ``_enabled``:
``serving.pad`` / ``serving.forward`` spans, the ``serving.compute_us``
histogram (dispatch to the outputs' event), ``serving.weight_swaps``, the
observatory's ``serving`` lane (the bucket's program, with CUDA events
around its replay on a card), and the bound parameters (``weights``) and
each batch in flight (``serving_batches``) in the memory census. Not
ported yet (ROADMAP.md queue A, item A.7): the SPMD serving bind.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from .. import memory, observatory, telemetry, tracing
from .. import ndarray as nd
from ..base import MXNetError, getenv, register_env
from ..compile_cache import CompileCache
from ..io.io import DataDesc, pad_arrays

__all__ = ["Predictor", "bucket_ladder"]

register_env("MXNET_SERVING_BUCKETS", "1,2,4,8,16,32",
             "serving batch-size bucket ladder (comma-separated ints): "
             "every request or coalesced batch pads up to the smallest "
             "bucket that fits, so steady traffic reuses len(buckets) "
             "programs")
register_env("MXNET_SUBGRAPH_BACKEND", "TPU_FUSE",
             "subgraph rewrite backend applied by Predictor.load and "
             "Predictor.from_module (conv+bn(+relu) folding for "
             "inference); NONE or 0 opts out. A training bind applies it "
             "only when the variable is set")


def _serving_fused(symbol, arg_params, aux_params):
    """Apply the serving-side subgraph backend (default ``TPU_FUSE``,
    opt-out ``MXNET_SUBGRAPH_BACKEND=NONE``) to a checkpointed symbol and
    move the parameters across the rewrite: BatchNorm's moving statistics
    are aux states of the original graph but plain arguments of the folded
    `_fused_conv_bn_relu` node, so they move from ``aux_params`` to
    ``arg_params``. Returns (symbol, arg_params, aux_params), unchanged
    when the backend is off, unregistered or matches nothing."""
    backend = os.environ.get("MXNET_SUBGRAPH_BACKEND", "TPU_FUSE")
    if not backend or backend in ("NONE", "none", "0"):
        return symbol, arg_params, aux_params
    from ..symbol.subgraph import build_subgraph, list_subgraph_backends

    if backend not in list_subgraph_backends():
        return symbol, arg_params, aux_params
    fused = build_subgraph(symbol, backend)
    fused_args = set(fused.list_arguments())
    arg_params = dict(arg_params or {})
    aux_params = dict(aux_params or {})
    for name in list(aux_params):
        if name in fused_args and name not in arg_params:
            arg_params[name] = aux_params.pop(name)
    return fused, arg_params, aux_params


def bucket_ladder(buckets=None, env_var="MXNET_SERVING_BUCKETS"):
    """Normalize a bucket spec (None -> the `env_var` knob, a
    comma-separated string, or any int iterable) into an ascending,
    deduplicated tuple of positive sizes. `env_var` names the knob in error
    messages; the generation engine's prefill ladder parses through here
    too."""
    if buckets is None:
        buckets = getenv(env_var)
        if buckets is None:
            raise MXNetError(f"no buckets given and {env_var} is not set")
    if isinstance(buckets, str):
        try:
            buckets = [int(tok) for tok in buckets.replace(" ", "").split(",")
                       if tok]
        except ValueError:
            raise MXNetError(
                f"{env_var} must be comma-separated ints, got {buckets!r}")
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] < 1:
        raise MXNetError(f"serving buckets must be positive ints, got {out}")
    return out


class Predictor:
    """A ``(symbol, params)`` checkpoint bound for concurrent inference.

    Parameters
    ----------
    symbol : Symbol
        The inference graph. Loss heads are fine: ``SoftmaxOutput`` emits
        probabilities at inference and its label input is bound to zeros
        (any argument ending in ``label`` with no value in ``arg_params``
        is treated so; any other unbound argument raises, catching a
        checkpoint that is missing a weight).
    arg_params / aux_params : dict[str, NDArray or numpy array]
        Trained parameters, e.g. from ``model.load_checkpoint``.
    data_shapes : list of (name, shape) or DataDesc
        The data inputs; the leading (batch) dimension is a placeholder,
        the bucket ladder gives the real ones.
    buckets : str | iterable of int | None
        Bucket ladder override (default ``MXNET_SERVING_BUCKETS``).
    ctx : Context
        Where the predictor runs: default the current context, ``gpu(0)``
        unless a ``with mx.cpu():`` says otherwise; without a card that
        raises.
    retry_on : tuple of exception types
        What the batcher treats as a transient executor failure
        (`resilience.retry_call` semantics; the deadline always wins).
    """

    def __init__(self, symbol, arg_params, aux_params=None, data_shapes=None,
                 label_shapes=None, buckets=None, ctx=None,
                 retry_on=(OSError,)):
        from ..context import current_context
        from .health import attach_predictor

        if data_shapes is None:
            raise MXNetError(
                "Predictor needs data_shapes=[(name, shape), ...]: the "
                "batch dim is a placeholder, trailing dims bind the graph")
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else current_context()
        self._device = self._ctx.torch_device  # raises without a card
        self._data_descs = [d if isinstance(d, DataDesc) else DataDesc(*d)
                            for d in data_shapes]
        self._data_names = [d.name for d in self._data_descs]
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self.retry_on = tuple(retry_on)

        unknown = [n for n in self._data_names if n not in self._arg_names]
        if unknown:
            raise MXNetError(f"data inputs {unknown} are not arguments of "
                             f"the symbol ({self._arg_names})")

        def as_nd(v):
            return (v.as_in_context(self._ctx) if isinstance(v, nd.NDArray)
                    else nd.array(v, ctx=self._ctx))

        self._arg_params = {n: as_nd(v) for n, v in (arg_params or {}).items()
                            if n in self._arg_names
                            and n not in self._data_names}
        self._aux_params = {n: as_nd(v) for n, v in (aux_params or {}).items()
                            if n in self._aux_names}
        missing_aux = [n for n in self._aux_names if n not in self._aux_params]
        if missing_aux:
            # as loud as a missing weight: zeros would make BatchNorm
            # normalize with mean 0 / var 0 and serve garbage silently
            raise MXNetError(
                f"auxiliary states {missing_aux} have no value in "
                "aux_params: pass the checkpoint's aux_params (serving "
                "them as zeros would silently corrupt inference, e.g. "
                "BatchNorm moving statistics)")

        # label-style inputs, bound to zeros of shape (bucket,) + trail.
        # Explicit label_shapes win; otherwise only label-named leftovers
        # qualify: any OTHER unbound argument is a missing weight
        self._label_trails = {}
        for desc in (label_shapes or []):
            d = desc if isinstance(desc, DataDesc) else DataDesc(*desc)
            self._label_trails[d.name] = tuple(d.shape[1:])
        missing = [n for n in self._arg_names
                   if n not in self._data_names
                   and n not in self._arg_params
                   and n not in self._label_trails]
        for n in list(missing):
            if n.endswith("label"):
                self._label_trails[n] = ()
                missing.remove(n)
        if missing:
            raise MXNetError(
                f"arguments {missing} have no value in arg_params and are "
                "not data inputs; pass them in arg_params (weights) or "
                "label_shapes (dummy label inputs)")

        self._buckets = bucket_ladder(buckets)
        self._cache = CompileCache("serving")
        self._pool = (torch.cuda.graph_pool_handle()
                      if self._device.type == "cuda" else None)
        self._execs = {}
        self._lock = threading.RLock()
        self._weights_version = 0     # bumped by swap_weights
        # readiness: serving.warmup sets it (health probe)
        self._warmed = False
        self.health_name = attach_predictor(self)
        # the census dedups by storage, so buckets sharing them count once
        memory.track("weights", list(self._arg_params.values())
                     + list(self._aux_params.values()))

    # -- construction conveniences ------------------------------------------

    @classmethod
    def load(cls, prefix, epoch=None, data_shapes=None, **kwargs):
        """Bind the newest (or the given) ``prefix`` checkpoint for
        serving, with `model.load_checkpoint`'s semantics (an unreadable
        newest epoch falls back to an older one when ``epoch`` is None).
        A checkpoint of either package loads."""
        from ..model import load_checkpoint

        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        if symbol is None:
            raise MXNetError(f"no symbol json found for prefix {prefix!r} "
                             "(need prefix-symbol.json to serve)")
        symbol, arg_params, aux_params = _serving_fused(
            symbol, arg_params, aux_params)
        return cls(symbol, arg_params, aux_params,
                   data_shapes=data_shapes, **kwargs)

    @classmethod
    def from_module(cls, module, buckets=None, **kwargs):
        """Wrap a bound, initialized `Module`, on the module's context
        unless ``ctx`` says otherwise. The Predictor takes COPIES of the
        current parameters (`get_params`), so training the module further
        never changes a live server."""
        if not (module.binded and module.params_initialized):
            raise MXNetError("from_module needs a bound module with "
                             "initialized parameters")
        arg_params, aux_params = module.get_params()
        kwargs.setdefault("label_shapes",
                          getattr(module, "_label_shapes", None))
        kwargs.setdefault("ctx", module._context[0])
        symbol, arg_params, aux_params = _serving_fused(
            module.symbol, arg_params, aux_params)
        return cls(symbol, arg_params, aux_params,
                   data_shapes=module.data_shapes, buckets=buckets, **kwargs)

    # -- properties ----------------------------------------------------------

    @property
    def buckets(self):
        return self._buckets

    @property
    def max_batch(self):
        return self._buckets[-1]

    @property
    def data_names(self):
        return list(self._data_names)

    @property
    def output_names(self):
        return list(self._output_names)

    @property
    def cache(self):
        """The shared ``"serving"`` `CompileCache`: ``.misses`` is the
        exact number of programs built (on a card, graphs captured) so
        far."""
        return self._cache

    def bucket_for(self, rows):
        """Smallest bucket >= ``rows``, or None (the caller chunks by
        :attr:`max_batch`)."""
        for b in self._buckets:
            if b >= rows:
                return b
        return None

    # -- binding -------------------------------------------------------------

    def _bind_bucket(self, bucket):
        """The ``grad_req="null"`` executor of one bucket, bound lazily (its
        graph is captured at its first forward). Weights and aux states are
        the SHARED parameter arrays; its ``_cache`` is the predictor's
        ``"serving"`` cache and its ``_graph_pool`` the predictor's pool."""
        exec_ = self._execs.get(bucket)
        if exec_ is not None:
            return exec_
        with self._lock:
            exec_ = self._execs.get(bucket)
            if exec_ is not None:
                return exec_
            from ..symbol.executor import Executor

            shape_kwargs = {d.name: (bucket,) + tuple(d.shape[1:])
                            for d in self._data_descs}
            shape_kwargs.update({n: (bucket,) + trail
                                 for n, trail in self._label_trails.items()})
            arg_shapes, _, aux_shapes = self._symbol.infer_shape(
                **shape_kwargs)
            dtypes = {d.name: d.dtype for d in self._data_descs}
            args = {}
            for n, s in zip(self._arg_names, arg_shapes):
                p = self._arg_params.get(n)
                if p is not None:
                    if tuple(p.shape) != tuple(s):
                        raise MXNetError(
                            f"parameter {n!r} has shape {tuple(p.shape)} but "
                            f"the graph infers {tuple(s)}: wrong checkpoint "
                            "for this symbol/data_shapes?")
                    args[n] = p
                else:
                    args[n] = nd.zeros(s, ctx=self._ctx,
                                       dtype=dtypes.get(n, "float32"))
            auxs = {}
            for n, s in zip(self._aux_names, aux_shapes):
                a = self._aux_params[n]
                if tuple(a.shape) != tuple(s):
                    raise MXNetError(
                        f"auxiliary state {n!r} has shape {tuple(a.shape)} "
                        f"but the graph infers {tuple(s)}: wrong "
                        "checkpoint for this symbol/data_shapes?")
                auxs[n] = a
            exec_ = Executor(self._symbol, self._ctx, args=args,
                             grad_req="null", aux_states=auxs)
            exec_._cache = self._cache
            exec_._graph_pool = self._pool
            self._execs[bucket] = exec_
            return exec_

    # -- compute -------------------------------------------------------------

    def _run(self, bucket, arrays):
        """Forward ``arrays`` (<= bucket rows, aligned with data_names)
        through the bucket executor; returns the UNSLICED outputs (bucket
        rows), finished, so a failure surfaces HERE, retryable."""
        return self._run_wait(self._run_dispatch(bucket, arrays))

    def _run_dispatch(self, bucket, arrays):
        """Dispatch half of :meth:`_run`: pad, forward, no wait. The
        forward (a graph replay on a card) and the copies of its outputs
        are enqueued under the lock, then an event behind them; between
        this and :meth:`_run_wait` the caller owns the host, and the
        batcher's overlap lane stages its next flush there."""
        exec_ = self._bind_bucket(bucket)
        with tracing.span("serving.pad", cat="serving", bucket=bucket):
            padded, _ = pad_arrays(list(arrays), bucket)
        feed = dict(zip(self._data_names, padded))
        obs = observatory._enabled
        t0 = time.perf_counter() if telemetry._enabled or obs else 0.0
        cuda = self._device.type == "cuda"
        with self._lock, tracing.span("serving.forward", cat="serving",
                                      bucket=bucket):
            start = None
            if obs and cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(self._device))
            outs = list(exec_.forward(is_train=False, **feed))
            done = None
            if cuda:
                done = torch.cuda.Event(enable_timing=start is not None)
                done.record(torch.cuda.current_stream(self._device))
        return outs, done, padded, exec_, t0, start

    def _run_wait(self, pending):
        """Wait for a :meth:`_run_dispatch` handle's outputs, then account
        the batch (its host window from dispatch to the outputs' event;
        the observatory reads the device time between the events)."""
        outs, done, padded, exec_, t0, start = pending
        if done is not None:
            done.synchronize()
        memory.track_transient("serving_batches", padded + outs)
        dt = time.perf_counter() - t0
        if telemetry._enabled:
            telemetry.histogram("serving.compute_us").record(dt * 1e6)
        if observatory._enabled:
            observatory.observe("serving", self._cache, exec_._last_fwd_key,
                                exec_s=dt,
                                events=(start, done) if start is not None
                                else None)
        return outs

    # -- weight rollout ------------------------------------------------------

    @property
    def weights_version(self):
        """Version of the weight set being served (0 until the first
        :meth:`swap_weights`)."""
        return self._weights_version

    def swap_weights(self, arg_params, aux_params=None, version=None):
        """Atomic weight flip with nothing captured again: the new values
        are cast to the bound dtypes and written INTO the shared parameter
        tensors that every bucket's graph reads, under the serving lock. A
        flush already enqueued finishes on the old weights (the writes
        queue behind it on the card); the next flush reads the new ones.
        Every array must match its bound shape.

        ``arg_params`` may be a `rollout.WeightSet` (its version wins
        unless ``version`` is given). Returns the new version, or None
        when ``version`` equals the current one (an idempotent
        re-publish)."""
        if hasattr(arg_params, "arg_params") and hasattr(arg_params,
                                                         "version"):
            ws = arg_params
            aux_params = ws.aux_params if aux_params is None else aux_params
            version = ws.version if version is None else version
            arg_params = ws.arg_params
        new_arg = dict(arg_params or {})
        new_aux = dict(aux_params or {})
        # _serving_fused's aux -> arg move: a checkpoint published by
        # training still carries BatchNorm's moving stats as aux, and the
        # fused serving graph binds them as plain arguments
        for n in list(new_aux):
            if n in self._arg_params and n not in new_arg:
                new_arg[n] = new_aux.pop(n)
        missing = ([n for n in self._arg_params if n not in new_arg]
                   + [n for n in self._aux_params if n not in new_aux])
        if missing:
            raise MXNetError(
                f"swap_weights: bound parameters {missing} are missing "
                "from the new weight set: a hot swap must cover every "
                "bound array (a partial update would serve a chimera)")
        staged = []
        for tgt_map, src in ((self._arg_params, new_arg),
                             (self._aux_params, new_aux)):
            for n, tgt in tgt_map.items():
                arr = src[n]
                arr = (arr.asnumpy() if hasattr(arr, "asnumpy")
                       else np.asarray(arr))
                if tuple(arr.shape) != tuple(tgt.shape):
                    raise MXNetError(
                        f"swap_weights: parameter {n!r} has shape "
                        f"{tuple(arr.shape)} but the bound executors "
                        f"expect {tuple(tgt.shape)}: identical shapes are "
                        "what make the swap capture-free")
                staged.append((tgt, torch.from_numpy(
                    np.ascontiguousarray(arr))))
        with self._lock, torch.no_grad():
            if version is not None and version == self._weights_version:
                return None
            for tgt, src in staged:
                tgt._data.copy_(src)  # casts to the bound dtype
            self._weights_version = (self._weights_version + 1
                                     if version is None else int(version))
            swapped_to = self._weights_version
        if telemetry._enabled:
            telemetry.counter("serving.weight_swaps").inc()
            telemetry.gauge("serving.weights_version").set(swapped_to)
        from .. import health

        if health._enabled:
            health.event("rollout_swap", predictor=self.health_name,
                         version=swapped_to)
        return swapped_to

    def warm_bucket(self, bucket):
        """Build one bucket ahead of traffic: run a zeros batch through it
        (on a card, the capture; a cache hit if already built)."""
        if bucket not in self._buckets:
            raise MXNetError(f"bucket {bucket} not in ladder {self._buckets}")
        zeros = [nd.zeros((bucket,) + tuple(d.shape[1:]), ctx=self._ctx,
                          dtype=d.dtype) for d in self._data_descs]
        self._run(bucket, zeros)

    def warmup(self, buckets=None):
        """Build every bucket ahead of traffic: see
        :func:`mxnet_tpu_torch.serving.warmup`."""
        from .warmup import warmup

        return warmup(self, buckets=buckets)

    def predict(self, data, always_output_list=False):
        """Synchronous inference: pad ``data`` up to its bucket (requests
        larger than :attr:`max_batch` are chunked), run, slice the padding
        back off. Returns one NDArray when the symbol has one output (a
        list otherwise, or always with ``always_output_list``).
        Thread-safe; for concurrent traffic prefer a `DynamicBatcher`,
        which coalesces callers into shared batches."""
        arrays = self._as_arrays(data)
        n = int(arrays[0].shape[0])
        parts, off = [], 0
        while off < n:
            take = min(n - off, self.max_batch)
            chunk = [a[off:off + take] for a in arrays]
            outs = self._run(self.bucket_for(take), chunk)
            parts.append([o[0:take] for o in outs])
            off += take
        if len(parts) == 1:
            outs = parts[0]
        else:
            outs = [nd.concatenate([p[i] for p in parts], axis=0)
                    for i in range(len(parts[0]))]
        return self._wrap_outputs(outs, always_output_list)

    # -- helpers -------------------------------------------------------------

    def _as_arrays(self, data):
        """One request (an array, a list or tuple aligned with data_names,
        or a name -> array dict) as a validated NDArray list on the
        predictor's context."""
        if isinstance(data, dict):
            try:
                arrays = [data[n] for n in self._data_names]
            except KeyError as e:
                raise MXNetError(f"request is missing data input {e}")
        elif isinstance(data, (list, tuple)):
            arrays = list(data)
        else:
            arrays = [data]
        if len(arrays) != len(self._data_names):
            raise MXNetError(f"expected {len(self._data_names)} data inputs "
                             f"({self._data_names}), got {len(arrays)}")
        arrays = [a.as_in_context(self._ctx) if isinstance(a, nd.NDArray)
                  else nd.array(a, ctx=self._ctx) for a in arrays]
        rows = {int(a.shape[0]) for a in arrays}
        if len(rows) != 1:
            raise MXNetError(f"ragged row counts across data inputs: {rows}")
        if rows.pop() == 0:
            raise MXNetError("empty request (0 rows)")
        for a, d in zip(arrays, self._data_descs):
            if tuple(a.shape[1:]) != tuple(d.shape[1:]):
                raise MXNetError(
                    f"input {d.name!r}: trailing shape {tuple(a.shape[1:])} "
                    f"does not match bound {tuple(d.shape[1:])}")
        return arrays

    def _wrap_outputs(self, outs, always_output_list=False):
        if len(outs) == 1 and not always_output_list:
            return outs[0]
        return list(outs)

    def stats(self):
        """{cache snapshot, ladder, bound buckets, weights version}."""
        return {"cache": self._cache.snapshot(),
                "buckets": list(self._buckets),
                "bound": sorted(self._execs),
                "weights_version": self._weights_version}
