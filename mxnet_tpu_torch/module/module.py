"""Module, the symbolic trainer: the port of `mxnet_tpu/module/module.py`
(parity `python/mxnet/module/module.py`: `bind`, `init_params`,
`init_optimizer`, `forward` / `backward` / `update`).

One bound `Executor` runs the whole batch on one device: the module's
context (default: the current context, ``gpu(0)``; without a card that
raises unless ``context=mx.cpu()``). `fused_step` runs forward, backward
and the optimizer's update as one step, on a card one replayed CUDA graph
(`Executor.fused_step`); `fit` takes it wherever `_fused_step_ready`
allows, for the same reasons as the JAX package's, and runs the eager
forward_backward() + update() otherwise. A failed capture raises.

The bound arrays keep their storage: `init_params`, `set_params`,
`copy_params_from` and `load` write into them in place, and `get_params`
returns copies.

The ``MXNET_OVERLAP`` lane (`fit`'s overlap order): `stage_batch` hands
the next batch's pad, cast and copy to the card to a
`io.staging.DeviceStager` thread while the current step runs (a batch
already on the card as bound has none of that left to do and is not
staged: `NDArrayIter` copies its batches there without blocking, unless
its ``host_batches`` is set; nor is a batch below
`io.staging.STAGE_MIN_BYTES`); `fused_step` takes the staged feed
(`_consume_staged`), which reaches the captured step by one copy on the
device into its fixed input tensors, on the main stream behind the
stager's event (no graph per ring slot); `capture_metric_update` defers
the step's metric read, and `retire_staged` frees the slot once that
read has happened.

Not ported yet (ROADMAP.md queue A, item A.7): the bucketed gradient sync
(the kvstore branch here syncs key by key) and the fused step's ZeRO-1,
pipeline and SPMD variants. `as_predictor` serves the module's weights
through `serving.Predictor`.
"""
from __future__ import annotations

import logging
import math

import numpy as _np
import torch

from .. import context as ctx_mod
from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError, getenv
from ..initializer import InitDesc, Uniform
from ..io import staging as _staging
from ..io.io import DataDesc, pad_arrays
from ..model import _create_kvstore
from .base_module import BaseModule

__all__ = ["Module"]


class Module(BaseModule):
    """Bind a Symbol and its data and label names into a trainable
    module."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        context = context if context is not None \
            else ctx_mod.current_context()
        self._context = list(context) if isinstance(context, (list, tuple)) \
            else [context]
        for c in self._context:
            c.torch_device  # noqa: B018 — raises for a card that is absent

        arg_names = symbol.list_arguments()
        input_names = self._data_names + self._label_names
        self._param_names = [n for n in arg_names if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()

        self._arg_params = None
        self._aux_params = None
        self._exec = None
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None
        self._grad_req = "write"
        # rows of padding in the current batch (a short last batch padded
        # up to the bound batch size; outputs and metrics sliced back)
        self._pad = 0
        self._pad_bound = 0
        self._last_short_shape = None  # pad-or-reshape hysteresis
        # the overlap lane: the staging ring (made at the first staged
        # batch) and (batch, its pad state) for every staged batch
        self._stager = None
        self._staged_meta = []

    # -- properties ----------------------------------------------------------

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return [(n, tuple(o.shape))
                for n, o in zip(self._output_names, self._exec.outputs)] \
            if self._exec.outputs else None

    # -- bind ----------------------------------------------------------------

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req

        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        self._label_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                              for d in (label_shapes or [])]

        shape_kwargs = {d.name: d.shape for d in self._data_shapes}
        shape_kwargs.update({d.name: d.shape for d in self._label_shapes})
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shape_kwargs)
        arg_names = self._symbol.list_arguments()

        ctx = self._context[0]
        type_dict = {d.name: getattr(d, "dtype", _np.float32)
                     for d in self._data_shapes + self._label_shapes}
        # with a shared module (the buckets of a BucketingModule), every
        # parameter and aux state of the same name and shape IS the shared
        # module's array, as the reference's executors share memory: one
        # storage that each bucket's captured step reads and updates in place
        shared = {}
        if shared_module is not None and shared_module.binded:
            sx = shared_module._exec
            shared = {n: sx.arg_dict[n] for n in shared_module._param_names}
            shared.update(sx.aux_dict)

        def array(n, s, dtype="float32"):
            a = shared.get(n)
            if a is not None and a.shape == tuple(s):
                return a
            return nd.zeros(s, ctx=ctx, dtype=dtype)

        args = {n: array(n, s, type_dict.get(n, "float32"))
                for n, s in zip(arg_names, arg_shapes)}
        auxs = {n: array(n, s) for n, s in zip(self._aux_names, aux_shapes)}

        req = {}
        for n in arg_names:
            if n in self._data_names:
                req[n] = "write" if inputs_need_grad else "null"
            elif n in self._label_names or n in self._fixed_param_names:
                req[n] = "null"
            else:
                req[n] = grad_req if for_training else "null"

        from ..symbol.executor import Executor

        self._exec = Executor(self._symbol, ctx, args=args, grad_req=req,
                              aux_states=auxs)
        self.binded = True

        if shared_module is not None and shared_module.params_initialized:
            self._arg_params = {n: self._exec.arg_dict[n]
                                for n in self._param_names}
            self._aux_params = dict(self._exec.aux_dict)
            self.params_initialized = True

    # -- params --------------------------------------------------------------

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing parameters"
        if initializer is None and not (arg_params or aux_params):
            initializer = Uniform(0.01)

        def fill(arr, name, given):
            tensor = arr._data
            if given is not None and name in given:
                value = given[name]
                with torch.no_grad():
                    tensor.copy_(value._data if isinstance(value, nd.NDArray)
                                 else torch.as_tensor(_np.asarray(value)))
                return True
            if initializer is None:
                return False
            initializer(InitDesc(name), arr)
            if arr._data is not tensor:  # initializers rebind: write back
                with torch.no_grad():
                    tensor.copy_(arr._data)
                arr._data = tensor
            return True

        for name in self._param_names:
            if not fill(self._exec.arg_dict[name], name, arg_params) \
                    and not allow_missing:
                raise MXNetError(
                    f"no initializer and no value for param {name}")
        for name in self._aux_names:
            fill(self._exec.aux_dict[name], name, aux_params)
        self._arg_params = {n: self._exec.arg_dict[n]
                            for n in self._param_names}
        self._aux_params = dict(self._exec.aux_dict)
        self.params_initialized = True

    def get_params(self):
        assert self.binded and self.params_initialized
        return ({n: self._exec.arg_dict[n].copy() for n in self._param_names},
                {n: v.copy() for n, v in self._exec.aux_dict.items()})

    # -- optimizer -----------------------------------------------------------

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return

        if isinstance(optimizer, str):
            # rescale_grad defaults to 1/batch (reference module.py:503ff:
            # SoftmaxOutput-style heads sum per-example gradients over the
            # batch; the optimizer normalizes)
            batch_size = self._data_shapes[0].shape[0] \
                if self._data_shapes else 1
            params = dict(optimizer_params or ())
            params.setdefault("rescale_grad", 1.0 / max(batch_size, 1))
            idx2name = dict(enumerate(self._param_names))
            optimizer = opt.create(optimizer, param_idx2name=idx2name,
                                   **params)
        self._optimizer = optimizer

        arg_params = {n: self._exec.arg_dict[n]._data
                      for n in self._param_names}
        kv, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), arg_params)
        self._kvstore = kv
        self._update_on_kvstore = update_on_kvstore
        if kv is not None:
            if update_on_kvstore:
                kv.set_optimizer(self._optimizer)
            for name in self._param_names:
                kv.init(name, self._exec.arg_dict[name]._data)
        if not update_on_kvstore:
            self._updater = opt.get_updater(self._optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # -- compute -------------------------------------------------------------

    def _make_feed(self, data_batch):
        """The name → array feed. A short last batch is PADDED up to the
        bound batch size (recycling rows from the batch start), so the step
        already captured for that shape runs it; `self._pad` records the
        rows to slice back off the outputs and metrics. A genuine change of
        shape (a larger batch, or the same smaller batch twice in a row)
        reshapes the executor."""
        feed = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None and self._label_names:
            feed.update(zip(self._label_names, data_batch.label))
        self._pad = 0
        cur = self._exec.arg_dict
        mismatched = [n for n, a in feed.items()
                      if n in cur and cur[n].shape != tuple(a.shape)]
        if not mismatched:
            self._last_short_shape = None
            return feed
        short_shape = tuple(sorted((n, tuple(feed[n].shape))
                                   for n in mismatched))
        # 0-row batches reshape; so does inputs_need_grad: input gradients
        # must come back at the true batch shape
        is_short = not self.inputs_need_grad and all(
            tuple(feed[n].shape[1:]) == cur[n].shape[1:]
            and 0 < feed[n].shape[0] < cur[n].shape[0]
            for n in mismatched)
        # hysteresis: ONE short batch (the epoch's tail) pads; the SAME
        # short shape twice in a row is a smaller stream, which reshapes
        if is_short and short_shape != self._last_short_shape:
            pads = []
            for n in mismatched:
                padded, p = pad_arrays([feed[n]], cur[n].shape[0])
                feed[n] = padded[0]
                pads.append(p)
            self._pad = max(pads)
            self._pad_bound = cur[mismatched[0]].shape[0]
            self._last_short_shape = short_shape
        else:
            self._exec = self._exec.reshape(**{n: tuple(a.shape)
                                               for n, a in feed.items()})
            self._last_short_shape = None
        return feed

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._exec.forward(is_train=is_train, **self._make_feed(data_batch))

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """Apply the gradients (reference module.py:664): through the
        kvstore key by key when there is one, else one updater call for
        every parameter (the fused multi-tensor update, or the aggregated
        ``multi_sgd_*`` ops under `MXNET_FUSED_STEP=0`)."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        live = [(i, name, self._exec.grad_dict[name],
                 self._exec.arg_dict[name])
                for i, name in enumerate(self._param_names)
                if self._exec.grad_dict.get(name) is not None]
        if self._kvstore is not None:
            for i, name, g, w in live:
                self._kvstore.push(name, g._data, priority=-i)
                if self._update_on_kvstore:
                    self._kvstore.pull(name, out=w._data, priority=-i)
                else:
                    self._kvstore.pull(name, out=g._data, priority=-i)
                    self._updater(i, g, w)
        elif live:
            self._updater([i for i, _, _, _ in live],
                          [g for _, _, g, _ in live],
                          [w for _, _, _, w in live])

    # -- fused train step ----------------------------------------------------

    def _fused_step_ready(self):
        """Whether one fused step can replace the eager decomposition.
        Anything that needs each op's or each gradient's values (an
        updater on the kvstore, a store whose sync is not traced into the
        step, a Monitor, input gradients, ``grad_req='add'``) declines, as
        in the JAX package; so does `MXNET_FUSED_STEP=0`. (The JAX
        package's Custom and eager-only ops do not exist in the port.)"""
        if not getenv("MXNET_FUSED_STEP"):
            return False
        if not (self.binded and self.params_initialized
                and self.optimizer_initialized and self.for_training):
            return False
        if self._updater is None:
            return False
        if self._kvstore is not None:
            if self._update_on_kvstore:
                return False  # the optimizer lives on the store, per key
            if not getattr(self._kvstore, "fused_step_compatible", False):
                return False
        if not getattr(self._optimizer, "fused_update_supported", False):
            return False
        if self._exec._monitor_callback is not None or self.inputs_need_grad:
            return False
        return all(self._exec._grad_req.get(n, "null") in ("write", "null")
                   for n in self._param_names)

    def fused_step(self, data_batch):
        """Forward, backward and the optimizer's update as one step
        (`Executor.fused_step`, one CUDA graph a signature on a card).
        Returns True when taken; False tells the caller to run
        forward_backward() + update()."""
        if not self._fused_step_ready():
            return False
        # a batch the staging thread already padded, cast and copied rides
        # straight in (one copy on the device); a miss takes the host feed
        feed = self._consume_staged(data_batch)
        if feed is None:
            feed = self._make_feed(data_batch)
        self._exec.set_args(**feed)
        self._exec.fused_step(self._optimizer, self._updater,
                              self._param_names)
        return True

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        outs = self._exec.outputs
        if self._pad:
            bound = self._pad_bound
            keep = bound - self._pad
            outs = [o[0:keep] if o.ndim and o.shape[0] == bound else o
                    for o in outs]
        return outs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.inputs_need_grad
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels)),
            dict(zip(self._output_names, self.get_outputs())))

    # -- overlap lane (MXNET_OVERLAP) -----------------------------------------

    def capture_metric_update(self, labels):
        """Defer this step's metric read: a thunk holding the CURRENT
        labels and outputs (sliced by the current pad state), on a card
        copied to pinned host buffers behind this step's work
        (`io.staging.host_copies`), that applies them when `fit` settles
        the deferred lane. Its wait is for this step alone, not for the
        next one, queued on the stream by then."""
        if labels is None or not (self.binded and self.params_initialized):
            return None
        labels, outs = list(labels), list(self.get_outputs())
        copies, event = _staging.host_copies(labels + outs)
        label_map = dict(zip(self._label_names, copies[:len(labels)]))
        out_map = dict(zip(self._output_names, copies[len(labels):]))

        def apply(eval_metric):
            if event is not None:
                event.synchronize()
            eval_metric.update_dict(label_map, out_map)

        return apply

    def stage_batch(self, data_batch):
        """Decide on the MAIN thread whether ``data_batch`` can be staged
        (the executor's shapes and the pad-or-reshape hysteresis are only
        coherent here), then hand its pad, cast and copy to the staging
        thread. `_make_feed`'s decision tree, exactly: a batch that would
        reshape the executor is not staged."""
        import torch

        if not _staging.overlap_enabled() or not self._fused_step_ready():
            return False
        if isinstance(data_batch, list) or data_batch.data is None:
            return False
        feed_src = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None and self._label_names:
            feed_src.update(zip(self._label_names, data_batch.label))
        cur = self._exec.arg_dict
        if not feed_src or any(n not in cur for n in feed_src):
            return False
        mismatched = [n for n, a in feed_src.items()
                      if tuple(cur[n].shape) != tuple(a.shape)]
        short_shape = None
        if mismatched:
            short_shape = tuple(sorted((n, tuple(feed_src[n].shape))
                                       for n in mismatched))
            is_short = not self.inputs_need_grad and all(
                tuple(feed_src[n].shape[1:]) == tuple(cur[n].shape[1:])
                and 0 < feed_src[n].shape[0] < cur[n].shape[0]
                for n in mismatched)
            if not is_short or short_shape == self._last_short_shape:
                return False  # a reshape: the lockstep path rebinds
        shapes = {n: tuple(cur[n].shape) for n in feed_src}
        dtypes = {n: cur[n]._data.dtype for n in feed_src}
        device = cur[next(iter(feed_src))]._data.device
        srcs = {n: getattr(a, "_data", a) for n, a in feed_src.items()}
        if device.type == "cuda" and all(
                torch.is_tensor(t) and t.device == device
                and t.dtype == dtypes[n] and tuple(t.shape) == shapes[n]
                for n, t in srcs.items()):
            # already on the card as bound: nothing to pad, cast or copy,
            # and the lockstep feed is the one device copy it needs
            return False
        if sum(math.prod(shapes[n]) * dtypes[n].itemsize
               for n in srcs) < _staging.STAGE_MIN_BYTES:
            return False  # the lockstep feed costs less than the hand-off
        pad_names = frozenset(mismatched)
        bound = cur[mismatched[0]].shape[0] if mismatched else 0
        exec_ref = self._exec

        def prep(put):  # the staging thread: pad -> cast -> copy
            from ..ndarray import NDArray

            feed, pad = {}, 0
            for n, a in feed_src.items():
                if n in pad_names:
                    padded, p = pad_arrays([a], shapes[n][0])
                    a = padded[0]
                    pad = max(pad, p)
                feed[n] = NDArray(put(n, a, dtypes[n]))
            return feed, pad

        if self._stager is None:
            self._stager = _staging.DeviceStager(name="module.stager",
                                                 device=device)
        accepted = self._stager.stage(
            data_batch, prep,
            # a reshape swaps the executor: the staged layout is stale
            guard=lambda: self._exec is exec_ref)
        if accepted:
            self._staged_meta.append(
                (data_batch, {"short_shape": short_shape, "bound": bound}))
            del self._staged_meta[:-self._stager.depth - 2]
        return accepted

    def _consume_staged(self, data_batch):
        """The staged feed of this exact batch (on the device, padded and
        cast), setting the pad and hysteresis state `_make_feed` would
        have set; None for the lockstep feed."""
        st = self._stager
        if st is None or isinstance(data_batch, list):
            return None
        meta = None
        for i, (b, m) in enumerate(self._staged_meta):
            if b is data_batch:
                meta = m
                del self._staged_meta[:i + 1]  # and stale earlier entries
                break
        if meta is None:
            return None
        hit = st.take(data_batch)
        if hit is None:
            return None
        feed, pad = hit
        self._pad = pad
        if pad:
            self._pad_bound = meta["bound"]
        self._last_short_shape = meta["short_shape"]
        return feed

    def retire_staged(self, data_batch):
        st = self._stager
        return st.retire(data_batch) if st is not None else False

    def _overlap_teardown(self):
        st = self._stager
        if st is not None:
            self._stager = None
            self._staged_meta = []
            st.close()

    # -- checkpoint ----------------------------------------------------------

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        from ..model import save_checkpoint

        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self.symbol, arg_params, aux_params,
                        remove_amp_cast=remove_amp_cast)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a saved checkpoint; its parameters are written
        into the bound arrays at `bind`."""
        from ..model import load_checkpoint

        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        orig_bind = mod.bind

        def bind_and_set(*a, **kw):
            orig_bind(*a, **kw)
            mod.init_params(arg_params=args, aux_params=auxs,
                            force_init=True)

        mod.bind = bind_and_set
        return mod

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            raise NotImplementedError(
                "optimizer states on a kvstore are not saved by the port yet")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            raise NotImplementedError(
                "optimizer states on a kvstore are not loaded by the port "
                "yet")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def as_predictor(self, buckets=None, **kwargs):
        """This module's trained weights behind a thread-safe
        `serving.Predictor` on the module's context: one bucket executor
        per batch size (one captured graph each on a card), `warmup()`,
        and dynamic batching when wrapped in a `serving.DynamicBatcher`.
        The Predictor takes COPIES of the current parameters
        (`get_params`), so training this module further never changes a
        live server."""
        from ..serving import Predictor

        return Predictor.from_module(self, buckets=buckets, **kwargs)

    def install_monitor(self, mon):
        assert self.binded
        mon.install(self._exec)

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        self._label_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                              for d in (label_shapes or [])]
        self._exec = self._exec.reshape(**{
            d.name: d.shape for d in self._data_shapes + self._label_shapes})
