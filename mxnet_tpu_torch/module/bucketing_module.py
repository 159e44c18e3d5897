"""BucketingModule: a Module for each bucket key over one parameter set. The
port of `mxnet_tpu/module/bucketing_module.py` (parity
`python/mxnet/module/bucketing_module.py:36`).

``sym_gen(bucket_key)`` gives each bucket's symbol (a sequence length, as
`rnn.BucketSentenceIter` keys its batches). Each bucket's Module is bound
with the default bucket's as its shared module, so its parameters and aux
states ARE the default bucket's arrays (`Module.bind`): one storage, which
every bucket's step reads and the update writes in place, and one
optimizer and updater (its states keyed by parameter position) for all
buckets. Switching buckets is a dict lookup; nothing is copied.

On a card each bucket's `fused_step` is its own signature of the port's
fused step (`Executor.fused_step`): one CUDA graph captured at the
bucket's first step, reading the shared parameter storage in place, and
replayed at its later steps.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._grad_req = None
        self._monitor = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._call_sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._call_sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    def _call_sym_gen(self, bucket_key):
        res = self._sym_gen(bucket_key)
        if not isinstance(res, tuple):
            return res, ("data",), ("softmax_label",)
        return res

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._call_sym_gen(bucket_key)
        return Module(sym, data_names, label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names)

    # -- bind / params -------------------------------------------------------

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, grad_req=grad_req)
        self._buckets = {self._default_bucket_key: module}
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it at its first
        use over the default bucket's arrays."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            default = self._buckets[self._default_bucket_key]
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False, shared_module=default,
                        grad_req=self._grad_req)
            if self.optimizer_initialized:
                self._share_optimizer(module, default)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        self._curr_module.init_params(initializer, arg_params, aux_params,
                                      allow_missing, force_init, allow_extra)
        for mod in self._buckets.values():
            mod.params_initialized = True
        self.params_initialized = True

    def get_params(self):
        assert self.binded and self.params_initialized
        return self._curr_module.get_params()

    @staticmethod
    def _share_optimizer(module, source):
        module._optimizer = source._optimizer
        module._updater = source._updater
        module._kvstore = source._kvstore
        module._update_on_kvstore = source._update_on_kvstore
        module.optimizer_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                self._share_optimizer(mod, self._curr_module)
        self.optimizer_initialized = True

    # -- compute -------------------------------------------------------------

    def _switch_for_batch(self, data_batch):
        bucket_key = getattr(data_batch, "bucket_key", None)
        if bucket_key is None:
            bucket_key = self._default_bucket_key
        self.switch_bucket(bucket_key, data_batch.provide_data,
                           data_batch.provide_label)

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Bind the batch's bucket ahead of its step (reference
        bucketing_module.py prepare)."""
        if self.binded:
            current = self._curr_module
            self._switch_for_batch(data_batch)
            self._curr_module = current

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._switch_for_batch(data_batch)
        self._curr_module.forward(data_batch, is_train=is_train)

    def fused_step(self, data_batch):
        """The bucket's fused training step (one captured CUDA graph a
        bucket on a card); False where its module declines, as
        `Module.fused_step`."""
        assert self.binded and self.params_initialized
        self._switch_for_batch(data_batch)
        return self._curr_module.fused_step(data_batch)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    # -- the overlap lane (MXNET_OVERLAP): the deferred metric read closes
    # over the bucket's module that ran the step; batches are not staged,
    # since the next batch's bucket is switched in only at its own step

    def capture_metric_update(self, labels):
        if self._curr_module is None:
            return None
        return self._curr_module.capture_metric_update(labels)

    def retire_staged(self, data_batch):
        if self._curr_module is None:
            return False
        return self._curr_module.retire_staged(data_batch)

    def _overlap_teardown(self):
        for mod in self._buckets.values():
            mod._overlap_teardown()

    def install_monitor(self, mon):
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)
