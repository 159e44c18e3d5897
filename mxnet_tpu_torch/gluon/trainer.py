"""gluon.Trainer: applies an optimizer to a set of parameters, through a
kvstore when one is asked for. The port of `mxnet_tpu/gluon/trainer.py`.

Parameters are gluon `Parameter`s (a `ParameterDict`, e.g.
``net.collect_params()``, or a list) or `torch.nn.Parameter`s (a dict,
e.g. ``dict(model.named_parameters())``, or a list), on one device. A dict
is taken in sorted key order, and a parameter given twice is registered
once.

A gluon Parameter's gradient is its gradient NDArray, which `backward`
writes and marks fresh; `step` refuses a parameter whose gradient is not
fresh unless ``ignore_stale_grad``, and takes every update of a step as one
`Updater` call, so the optimizer can update them as one group (the fused
multi-tensor update). A `torch.nn.Parameter`'s gradient is ``p.grad``,
which the trainer sets to None after each update; a gradient still None at
the next step is stale.

Gradient sync is the per-key push and pull, one key per parameter: the JAX
package's path for a compressed store, and its bit-exact reference with
`MXNET_GRAD_BUCKETING=0` for any other store. One device and no dist
store means no kvstore (`model._create_kvstore`). With a ``dist`` store
the optimizer runs on every worker after the sync (``update_on_kvstore`` is
False). Not ported: bucketed gradient sync (`GradSync`) and ZeRO-1.

Row-sparse gradients (a Parameter with ``grad_stype="row_sparse"``) never
ride the dense push and pull, which would densify the table: the optimizer
runs on the workers (``update_on_kvstore`` is False), and
`_allreduce_sparse_grads` merges the replicas' (indices, rows), through the
dist store's row-sparse push on a ``dist`` store. Such a parameter may hold
replicas on several contexts: each is updated from the merged gradient by
an updater of its own.
"""
from __future__ import annotations

import torch

from .. import optimizer as opt
from ..model import _create_kvstore
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[key] for key in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                f"got {type(params)}.")
        self._params = []
        self._param2idx = {}
        for param in params:
            if not isinstance(param, (Parameter, torch.nn.Parameter)):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    f"got list of {type(param)}.")
            if id(param) in self._param2idx:
                continue  # the same Parameter twice (tied weights)
            self._param2idx[id(param)] = len(self._params)
            self._params.append(param)
        self._gluon = bool(self._params) and isinstance(self._params[0],
                                                        Parameter)
        if any(isinstance(p, Parameter) != self._gluon for p in self._params):
            raise ValueError("Parameters must be all gluon Parameters or all "
                             "torch.nn.Parameters")
        for param in self._params:
            if self._gluon:
                param._set_trainer(self)
        self._compression_params = compression_params
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._device = self._check_device()
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._reset_kvstore()

    # -- what a parameter holds, for both kinds ------------------------------

    def _weight(self, param):
        """The value the optimizer updates: an NDArray or a tensor."""
        return param.list_data()[0] if self._gluon else param

    def _needs_grad(self, param):
        return param.grad_req != "null" if self._gluon \
            else param.requires_grad

    def _grad(self, param):
        """The gradient to sync and apply, or None when none is fresh."""
        if self._gluon:
            data = param.list_data()[0]
            return param.list_grad()[0] if data._fresh_grad else None
        return param.grad

    def _check_device(self):
        devices = {(p.list_data()[0]._data.device if self._gluon
                    and p._data is not None else getattr(p, "device", None))
                   for p in self._params}
        devices.discard(None)
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
        # replica k > 0 of a row-sparse parameter -> its own updater
        self._replica_updaters = {}

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
        arg_arrays = {str(i): self._tensor(p)
                      for i, p in enumerate(self._params)}
        kvstore, update_on_kvstore = _create_kvstore(config["kvstore"], 1,
                                                     arg_arrays)
        self._distributed = "dist" in kvstore.type if kvstore else False
        if self._distributed:
            # no servers: every worker updates after the sync
            update_on_kvstore = False
        if self._sparse_params():
            # row-sparse gradients merge sparsely and update locally (the
            # reference's rule for sparse gradients of dense weights)
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

    def _tensor(self, param):
        w = self._weight(param)
        return w if isinstance(w, torch.Tensor) else w._data

    def _sparse_params(self):
        """(index, Parameter) of each gluon Parameter whose gradient is
        row-sparse and that takes one."""
        if not self._gluon:
            return []
        return [(i, p) for i, p in enumerate(self._params)
                if p._grad_stype == "row_sparse" and p.grad_req != "null"]

    def _init_params(self):
        """Initialize the parameters not yet in the kvstore with their
        values."""
        if not self._kv_initialized:
            raise RuntimeError("Cannot initialize parameters in KVStore when "
                               "KVStore is not initialized.")
        if self._kvstore:
            for param in self._params_to_init:
                idx = self._param2idx[id(param)]
                self._kvstore.init(idx, self._tensor(param))
                if self._update_on_kvstore:
                    self._kvstore.pull(idx, self._tensor(param),
                                       priority=-idx)
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
        sparse = self._sparse_params()
        for i, param in sparse:
            self._allreduce_sparse_grads(i, param)
        if not self._kvstore:
            return
        sparse = {i for i, _ in sparse}
        for i, param in enumerate(self._params):
            if not self._needs_grad(param) or i in sparse:
                continue
            grad = self._grad(param)
            if grad is None:
                if not self._distributed:
                    continue
                grad = torch.zeros_like(self._tensor(param))
            elif not isinstance(grad, torch.Tensor):
                grad = grad._data
            self._kvstore.push(i, grad, priority=-i)
            if not self._update_on_kvstore:
                self._kvstore.pull(i, grad, priority=-i)

    def _allreduce_sparse_grads(self, i, param):
        """Merge a row-sparse gradient over the parameter's replicas and,
        on a dist store, over the workers, staying O(touched rows) (the
        role of the reference's ReduceRowSparse, `comm.h`, and its
        row_sparse push, `kvstore_dist.h:676`): every replica's buffer gets
        the sorted unique rows and their sums. A replica that no backward
        wrote since the last step contributes nothing. One replica and no
        dist store: the buffer is already in that form."""
        from .. import autograd
        from ..ndarray.sparse import RowSparseNDArray

        grads = param.list_grad()
        if len(grads) == 1 and not self._distributed:
            return
        fresh = [g._components() for g, w in zip(grads, param.list_data())
                 if w._fresh_grad]
        # a replica's empty slices keep dtype and device when none is fresh
        empty = {k: t[:0] for k, t in grads[0]._components().items()}
        idx = torch.cat([c["indices"] for c in [empty] + fresh])
        rows = torch.cat([c["data"] for c in [empty] + fresh])
        if self._distributed:
            self._kvstore.push(i, RowSparseNDArray(rows, idx, param.shape),
                               priority=-i)
            uniq, summed = self._kvstore.pull_sparse_grad(i)
        else:
            uniq, summed = autograd.dedup_rows(idx, rows)
        for g in grads:
            g._set_components(data=summed.to(g._dtype_meta, copy=True),
                              indices=uniq.to(torch.int32))

    def _row_sparse_pull(self, parameter, row_id):
        """Refresh the rows ``row_id`` of a sparse parameter from the
        kvstore (parity trainer.py:289). Only a store that holds the
        weights (the optimizer on the store) has newer rows; with local
        updates, the port's rule for sparse gradients, every worker's
        weight is current and this does nothing."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._params_to_init:
            self._init_params()
        if self._kvstore is None or not self._update_on_kvstore:
            return
        from ..ndarray import sparse

        idx = self._param2idx[id(parameter)]
        for w in parameter.list_data():
            tmp = sparse.zeros("row_sparse", w.shape, ctx=w.context,
                               dtype=w._data.dtype)
            self._kvstore.row_sparse_pull(idx, out=tmp, row_ids=row_id,
                                          priority=-idx)
            aux = tmp._components()
            with torch.no_grad():
                w._data.index_copy_(0, aux["indices"].long(),
                                    aux["data"].to(w._data.dtype))

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
            if not self._needs_grad(param):
                continue
            grad = self._grad(param)
            if grad is None:
                if ignore_stale_grad:
                    continue
                name = param.name if self._gluon else i
                raise UserWarning(
                    f"Gradient of Parameter `{name}` "
                    f"({tuple(self._tensor(param).shape)}) on "
                    f"{self._tensor(param).device} has not been updated by "
                    "backward since last `step`. This could mean a bug in "
                    "your model that made it only use a subset of the "
                    "Parameters (Blocks) for this iteration. If you are "
                    "intentionally only using a subset, call step with "
                    "ignore_stale_grad=True to suppress this warning")
            if self._kvstore and self._update_on_kvstore:
                # the optimizer ran on the kvstore: fetch the new weights
                self._kvstore.pull(i, self._tensor(param), priority=-i)
            else:
                indices.append(i)
                grads.append(grad)
                weights.append(self._weight(param))
            if self._gluon:
                # spent as it is taken, so a refusal further down leaves
                # it spent, as in the reference
                param.list_data()[0]._fresh_grad = False
        replicas = [(i, k, w, g) for i, p in self._sparse_params()
                    for k, (w, g) in enumerate(zip(p.list_data(),
                                                   p.list_grad()))
                    if k > 0 and (w._fresh_grad or not ignore_stale_grad)]
        if indices:
            self._updater(indices, grads, weights)
        for i, k, w, g in replicas:
            w._fresh_grad = False
            self._replica_updater(k)([i], [g], [w])
        if not self._gluon:
            for param in self._params:
                param.grad = None  # stale until the next backward

    def _replica_updater(self, k):
        """The updater of replica ``k`` > 0 of the row-sparse parameters:
        its own optimizer states, as the reference keeps one updater a
        context."""
        if k not in self._replica_updaters:
            self._replica_updaters[k] = opt.get_updater(self._optimizer)
        return self._replica_updaters[k]

    def save_states(self, fname):
        """Save the optimizer and its states (the updater's pickle)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._params_to_init:
            self._init_params()
        if self._update_on_kvstore:
            raise NotImplementedError(
                "save_states with the optimizer on the kvstore: the port's "
                "stores keep no savable optimizer states")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Load what `save_states` wrote."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._params_to_init:
            self._init_params()
        if self._update_on_kvstore:
            raise NotImplementedError(
                "load_states with the optimizer on the kvstore: the port's "
                "stores keep no savable optimizer states")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
