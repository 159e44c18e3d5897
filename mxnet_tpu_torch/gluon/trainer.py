"""gluon.Trainer: applies an optimizer to a set of parameters, through a
kvstore when one is asked for. The port of `mxnet_tpu/gluon/trainer.py`.

Parameters are `torch.nn.Parameter`s on one device, given as a dict (taken
in sorted key order, e.g. ``dict(model.named_parameters())``) or a list; a
parameter given twice is registered once. A parameter's gradient is
``p.grad``. After each update the trainer sets ``p.grad`` to None: the next
backward writes a fresh gradient (MXNet's ``grad_req="write"``), and a
parameter whose gradient is still None at the next step has a stale
gradient, which `step` refuses unless ``ignore_stale_grad``.

Gradient sync is the per-key push and pull, one key per parameter: the JAX
package's path for a compressed store, and its bit-exact reference with
`MXNET_GRAD_BUCKETING=0` for any other store. With a ``dist`` store the
optimizer runs on every worker after the sync (``update_on_kvstore`` is
False). Not ported: bucketed gradient sync (`GradSync`), ZeRO-1, row-sparse
gradients, and `save_states` / `load_states`.
"""
from __future__ import annotations

import torch

from .. import optimizer as opt
from ..model import _create_kvstore

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            params = [params[key] for key in sorted(params)]
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                f"got {type(params)}.")
        self._params = []
        self._param2idx = {}
        for param in params:
            if not isinstance(param, torch.nn.Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    f"got list of {type(param)}.")
            if id(param) in self._param2idx:
                continue  # the same Parameter twice (tied weights)
            self._param2idx[id(param)] = len(self._params)
            self._params.append(param)
        self._compression_params = compression_params
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._device = self._check_device()
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._reset_kvstore()

    def _check_device(self):
        devices = {p.device for p in self._params}
        if len(devices) > 1:
            raise ValueError("All Parameters must lie on one device, got "
                             f"{sorted(str(d) for d in devices)}")
        return devices.pop() if devices else None

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)

    def _reset_kvstore(self):
        if getattr(self, "_kvstore", None) and "dist" in self._kvstore.type:
            raise RuntimeError("Cannot reset distributed KVStore.")
        self._kv_initialized = False
        self._kvstore = None
        self._distributed = None
        self._update_on_kvstore = None
        self._params_to_init = list(self._params)

    def _init_kvstore(self):
        """Create the kvstore and decide where the optimizer runs."""
        config = self._kvstore_params
        arg_arrays = {str(i): p for i, p in enumerate(self._params)}
        kvstore, update_on_kvstore = _create_kvstore(config["kvstore"], 1,
                                                     arg_arrays)
        self._distributed = "dist" in kvstore.type if kvstore else False
        if self._distributed:
            # no servers: every worker updates after the sync
            update_on_kvstore = False
        if config["update_on_kvstore"] is not None:
            update_on_kvstore = config["update_on_kvstore"]
        if kvstore:
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            if update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
            self._kvstore = kvstore
            self._update_on_kvstore = update_on_kvstore
        else:
            self._kvstore = None
            self._update_on_kvstore = False
        self._kv_initialized = True

    def _init_params(self):
        """Initialize the parameters not yet in the kvstore with their
        values."""
        if not self._kv_initialized:
            raise RuntimeError("Cannot initialize parameters in KVStore when "
                               "KVStore is not initialized.")
        if self._kvstore:
            for param in self._params_to_init:
                idx = self._param2idx[id(param)]
                self._kvstore.init(idx, param)
                if self._update_on_kvstore:
                    self._kvstore.pull(idx, param, priority=-idx)
        self._params_to_init = []

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One update: rescale gradients by 1/batch_size (in the optimizer),
        sync them through the kvstore, update the parameters."""
        self._check_and_rescale_grad(self._scale / batch_size)
        if not self._kv_initialized:
            self._init_kvstore()
        if self._params_to_init:
            self._init_params()
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def _check_and_rescale_grad(self, scale):
        if self._update_on_kvstore and self._distributed \
                and self._kv_initialized:
            if self._optimizer.rescale_grad != scale:
                raise UserWarning(
                    "Possible change in the `batch_size` from previous `step` "
                    "detected. Optimizer gradient normalizing factor will not "
                    "change w.r.t new batch_size when update_on_kvstore=True")
        self._optimizer.rescale_grad = scale

    def allreduce_grads(self):
        """Sync gradients over devices and workers without updating, for
        gradient manipulation between backward and `update`."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._params_to_init:
            self._init_params()
        if self._kvstore and self._update_on_kvstore:
            raise RuntimeError(
                "allreduce_grads() when parameters are updated on kvstore is "
                "not supported. Try setting `update_on_kvstore` to False "
                "when creating trainer.")
        self._allreduce_grads()

    def _allreduce_grads(self):
        """Per key: push the gradient, then pull the sum back into it (or,
        with the optimizer on the store, push only). On a dist store every
        parameter that requires grad takes part, as in the reference, so
        every worker issues the same collectives in the same order: one with
        no gradient (unused by this worker's backward) pushes and pulls
        zeros, and `_update` still finds it stale."""
        if not self._kvstore:
            return
        for i, param in enumerate(self._params):
            if not param.requires_grad:
                continue
            grad = param.grad
            if grad is None:
                if not self._distributed:
                    continue
                grad = torch.zeros_like(param)
            self._kvstore.push(i, grad, priority=-i)
            if not self._update_on_kvstore:
                self._kvstore.pull(i, grad, priority=-i)

    def update(self, batch_size, ignore_stale_grad=False):
        """Update the parameters without syncing: the second half of a step
        split by `allreduce_grads`."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._params_to_init:
            self._init_params()
        if self._kvstore and self._update_on_kvstore:
            raise RuntimeError(
                "update() when parameters are updated on kvstore is not "
                "supported. Try setting `update_on_kvstore` to False when "
                "creating trainer.")
        self._check_and_rescale_grad(self._scale / batch_size)
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        indices, grads, weights = [], [], []
        for i, param in enumerate(self._params):
            if not param.requires_grad:
                continue
            if param.grad is None:
                if ignore_stale_grad:
                    continue
                raise UserWarning(
                    f"Gradient of Parameter {i} ({tuple(param.shape)}) on "
                    f"{param.device} has not been updated by backward since "
                    "last `step`. This could mean a bug in your model that "
                    "made it only use a subset of the Parameters for this "
                    "iteration. If you are intentionally only using a "
                    "subset, call step with ignore_stale_grad=True to "
                    "suppress this warning")
            if self._kvstore and self._update_on_kvstore:
                # the optimizer ran on the kvstore: fetch the new weights
                self._kvstore.pull(i, param, priority=-i)
            else:
                indices.append(i)
                grads.append(param.grad)
                weights.append(param)
        if indices:
            self._updater(indices, grads, weights)
        for param in self._params:
            param.grad = None  # stale until the next backward
