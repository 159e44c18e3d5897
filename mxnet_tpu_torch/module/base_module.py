"""BaseModule, the training-loop contract of the Module API: the port of
`mxnet_tpu/module/base_module.py` (parity
`python/mxnet/module/base_module.py`: `fit`, `score`, `predict`,
`forward_backward`). A subclass gives bind → init_params →
init_optimizer → forward / backward / update, and `fused_step`.

`fit` records, each plane gated on its module's ``_enabled``: the
``step.*`` breakdown (``fwdbwd`` / ``update`` / ``sync`` / ``data`` and
``total`` histograms, ``step.fused``, ``step.wall_us_total``), handed to
batch-end callbacks as ``BatchEndParam.step_stats``; a span tree a step
under a deterministic trace id, fed to `tracing.flight_recorder`; the
``fit.step`` beacon of the stall watchdog; and the step's wall for the
observatory's ``step`` lane. Host times around a captured step are enqueue
times until the metric update reads the outputs (the ``sync`` segment).

Under ``MXNET_OVERLAP`` (on by default) `fit` runs the overlap order
where the module supports it (`capture_metric_update`, `stage_batch`,
`retire_staged`): the next batch is fetched and staged while the step
runs, and each step's metric read is applied a step late, settled at
every epoch's end. The trained parameters and epoch-end metrics equal
the lockstep order's, bit for bit.
"""
from __future__ import annotations

import logging
import time

from .. import health, observatory, telemetry, tracing
from .. import metric as _metric
from .. import ndarray as nd
from ..io import staging as _staging


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- properties subclasses provide ---------------------------------------

    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError

    @property
    def data_shapes(self):
        raise NotImplementedError

    @property
    def label_shapes(self):
        raise NotImplementedError

    @property
    def output_shapes(self):
        raise NotImplementedError

    # -- core subclass API ---------------------------------------------------

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError

    def install_monitor(self, mon):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

    # -- composite helpers ---------------------------------------------------

    def forward_backward(self, data_batch):
        """(reference base_module.py:193)"""
        self.forward(data_batch, is_train=True)
        self.backward()

    def fused_step(self, data_batch):
        """Run forward, backward and update as one step. Subclasses that
        can return True; the default False tells `fit` to run the eager
        forward_backward() + update()."""
        return False

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None,
              reset=True, epoch=0, sparse_row_id_fn=None):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(_BatchEndParam(epoch, nbatch, eval_metric, locals()))
            actual_num_batch += 1
        if score_end_callback:
            for cb in _as_list(score_end_callback):
                cb(_BatchEndParam(epoch, actual_num_batch, eval_metric,
                                  locals()))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - (pad or 0)]
                       for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        """Run inference over an eval iterator (reference
        base_module.py)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad].copy()
                       for out in self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                if len(out) != num_outputs:
                    raise ValueError("Cannot merge batches: different number "
                                     "of outputs per batch")
            output_list2 = [nd.concat(*[out[i] for out in output_list],
                                      dim=0)
                            for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """The training loop (reference base_module.py:409): each step is
        `fused_step`, or `forward_backward` + `update` where that declines,
        then the metric."""
        assert num_epoch is not None, "please specify number of epochs"
        from ..initializer import Uniform

        if initializer is None:
            initializer = Uniform(0.01)

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        # the stall watchdog's progress beacon: armed while the loop owes
        # steps, touched per completed step
        fit_beacon = health.beacon("fit.step") if health._enabled else None
        try:
            for epoch in range(begin_epoch, num_epoch):
                self._fit_epoch(epoch, train_data, eval_data, eval_metric,
                                validation_metric, epoch_end_callback,
                                batch_end_callback, eval_end_callback,
                                eval_batch_end_callback, monitor,
                                sparse_row_id_fn, fit_beacon)
        finally:
            self._overlap_teardown()
            if fit_beacon is not None:
                fit_beacon.idle()

    def _fit_epoch(self, epoch, train_data, eval_data, eval_metric,
                   validation_metric, epoch_end_callback, batch_end_callback,
                   eval_end_callback, eval_batch_end_callback, monitor,
                   sparse_row_id_fn, fit_beacon):
        """One epoch of `fit`. Lockstep order: step, metric read, next
        batch. Overlap order (``MXNET_OVERLAP``, a module whose
        `capture_metric_update` defers): step t, then apply step t - 1's
        deferred metric and retire its staged slot, then fetch and stage
        batch t + 1 while step t runs; the epoch's last step settles at
        once, so epoch-end metrics equal the lockstep ones."""
        if fit_beacon is not None:
            # armed per epoch: the tail between epochs has no step
            # cadence, so its silence is not judged by the step median
            fit_beacon.arm()
        tic = time.time()
        eval_metric.reset()
        nbatch = 0
        end_of_batch = False
        data_iter = iter(train_data)
        next_data_batch = next(data_iter)
        overlap = _staging.overlap_enabled()
        if overlap:
            # the epoch's first batch rides the staged feed too
            self.stage_batch(next_data_batch)
        pending_metric = None        # step t - 1's deferred metric update
        pending_batch = None         # and its batch (its staged slot)
        while not end_of_batch:
            data_batch = next_data_batch
            if monitor is not None:
                monitor.tic()
            tele = telemetry._enabled
            trc = tracing._enabled
            timed = tele or trc or observatory._enabled
            step_span = tracing.span(
                "step", cat="train",
                trace_id=(tracing.deterministic_trace_id(
                    "fit", epoch, nbatch) if trc else None),
                epoch=epoch, step=nbatch)
            with step_span:
                t0 = time.perf_counter() if timed else 0.0
                fused = self.fused_step(data_batch)
                if not fused:
                    self.forward_backward(data_batch)
                t_fb = time.perf_counter() if timed else 0.0
                if not fused:
                    self.update()
                t_up = time.perf_counter() if timed else 0.0
                if tele:
                    telemetry.gauge("step.fused").set(1 if fused else 0)
                capture = None
                if overlap and not isinstance(data_batch, list):
                    capture = self.capture_metric_update(data_batch.label)
                if capture is None:
                    if pending_metric is not None:
                        # settle the deferred step before this eager one
                        pending_metric(eval_metric)
                        pending_metric = None
                        self.retire_staged(pending_batch)
                    if isinstance(data_batch, list):
                        self.update_metric(eval_metric,
                                           [db.label for db in data_batch],
                                           pre_sliced=True)
                    else:
                        self.update_metric(eval_metric, data_batch.label)
                        self.retire_staged(data_batch)
                    t_sync = time.perf_counter() if timed else 0.0
                    try:
                        next_data_batch = next(data_iter)
                        self.prepare(next_data_batch,
                                     sparse_row_id_fn=sparse_row_id_fn)
                    except StopIteration:
                        end_of_batch = True
                    t_end = t_data = time.perf_counter() if timed else 0.0
                    marks = (("fwdbwd", t0, t_fb), ("update", t_fb, t_up),
                             ("sync", t_up, t_sync),
                             ("data", t_sync, t_data))
                else:
                    # apply step t - 1's metric (its outputs are a step
                    # old) and free its staged slot, then fetch and stage
                    # batch t + 1 while step t runs
                    if pending_metric is not None:
                        pending_metric(eval_metric)
                        self.retire_staged(pending_batch)
                    pending_metric, pending_batch = capture, data_batch
                    t_sync = time.perf_counter() if timed else 0.0
                    try:
                        next_data_batch = next(data_iter)
                        self.prepare(next_data_batch,
                                     sparse_row_id_fn=sparse_row_id_fn)
                        self.stage_batch(next_data_batch)
                    except StopIteration:
                        end_of_batch = True
                        # the epoch's end is a sync point
                        pending_metric(eval_metric)
                        pending_metric = None
                        self.retire_staged(pending_batch)
                    t_end = t_data = time.perf_counter() if timed else 0.0
                    marks = (("fwdbwd", t0, t_fb), ("update", t_fb, t_up),
                             ("sync", t_up, t_sync),
                             ("data", t_sync, t_data))
                    if tele:
                        telemetry.counter("overlap.steps").inc()
                if trc:
                    # the phase children, rebuilt from the marks
                    end_us = tracing.now_us()
                    for seg, a, b in marks:
                        tracing.emit_span(
                            "step." + seg, end_us - (t_end - a) * 1e6,
                            (b - a) * 1e6, cat="train", parent=step_span)
                    step_span.set(fused=fused)
            if trc:
                tracing.flight_recorder.observe(step_span.tree())
            if observatory._enabled:
                observatory.observe("step", wall_s=t_end - t0)
            step_stats = None
            if tele:
                total_h = telemetry.histogram("step.total_us")
                for seg, a, b in marks:
                    telemetry.histogram(f"step.{seg}_us").record(
                        (b - a) * 1e6)
                total_us = (t_end - t0) * 1e6
                total_h.record(total_us)
                telemetry.counter("step.wall_us_total").inc(int(total_us))
                if batch_end_callback is not None:
                    # quantiles are read by the consumer on its log ticks,
                    # not sorted here each batch
                    step_stats = dict(
                        {f"{seg}_ms": (b - a) * 1e3 for seg, a, b in marks},
                        total_ms=total_us / 1e3, hist=total_h)
            if monitor is not None:
                monitor.toc_print()
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(_BatchEndParam(epoch, nbatch, eval_metric, locals(),
                                      step_stats=step_stats))
            nbatch += 1
            if fit_beacon is not None:
                fit_beacon.touch()
        if fit_beacon is not None:
            fit_beacon.idle()
        for name, val in eval_metric.get_name_value():
            self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
        self.logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)

        arg_p, aux_p = self.get_params()
        self.set_params(arg_p, aux_p)
        if epoch_end_callback is not None:
            for cb in _as_list(epoch_end_callback):
                cb(epoch, self.symbol, arg_p, aux_p)
        if eval_data is not None:
            res = self.score(eval_data, validation_metric,
                             score_end_callback=eval_end_callback,
                             batch_end_callback=eval_batch_end_callback,
                             epoch=epoch)
            for name, val in res:
                self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name,
                                 val)
        train_data.reset()

    def prepare(self, data_batch, sparse_row_id_fn=None):
        pass

    # -- overlap lane hooks (MXNET_OVERLAP) -----------------------------------
    # A subclass that can defer its sync points overrides these; the
    # defaults keep every module on the lockstep order.

    def capture_metric_update(self, labels):
        """A thunk ``f(eval_metric)`` that applies THIS step's metric
        update later, from outputs captured now; None makes the step
        update at once (the lockstep order)."""
        return None

    def stage_batch(self, data_batch):
        """Hand ``data_batch`` to a staging thread, so its pad, cast and
        copy overlap the step in flight. False: not staged."""
        return False

    def retire_staged(self, data_batch):
        """Free the staged slot of ``data_batch``, whose step has been read
        back (False where it had none)."""
        return False

    def _overlap_teardown(self):
        """Stop any staging thread and drop staged buffers (fit's exit)."""
        return None

    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
        save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        from ..context import cpu

        save_dict = nd.load(fname, ctx=cpu())
        arg_params, aux_params = {}, {}
        for k, value in save_dict.items():
            arg_type, _, name = k.partition(":")
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError(f"Invalid param file {fname}")
        self.set_params(arg_params, aux_params)


class _BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric, locals_, step_stats=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals_
        # fit's per-step breakdown with telemetry on (else None)
        self.step_stats = step_stats


def _as_list(obj):
    if isinstance(obj, (list, tuple)):
        return obj
    return [obj]
