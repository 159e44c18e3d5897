"""Optimizers: the port of `mxnet_tpu/optimizer/optimizer.py` (the
`Optimizer` base, SGD, Signum, FTML, DCASGD, NAG, SGLD, Adam, AdamW,
AdaGrad, RMSProp, AdaDelta, Ftrl, Adamax, Nadam, LBSGD, Test, `Updater`,
`get_updater`). SGD's update arithmetic is its own copy of
`mxnet_tpu/ops/optimizer_ops.py`'s; the other optimizers call the
registered update ops (`ops/optimizer_ops.py`) as plain functions, as the
JAX package's call them through `mx.nd`.

The update functions are plain functions on tensors that return the new
weight and states, computed in fp32 and cast back to each input's dtype, as
the JAX package's ops do. A weight is a tensor (an `nn.Parameter`) or an
NDArray (a gluon Parameter's data); the per-parameter updates write the
results into its tensor in place, so an `nn.Parameter` keeps its identity
and a captured CUDA graph reading the weight sees the new value.

An `Updater` given a group of weights updates them as one: under
`MXNET_FUSED_STEP` (on by default) through `Optimizer.fused_update`, one
multi-tensor update over the whole group written in place (the
``torch._foreach_*`` ops; the JAX package's one jitted update with donated
buffers); else, for SGD's NDArray weights, through the aggregated
``multi_sgd_*`` ops in chunks of `MXNET_OPTIMIZER_AGGREGATION_SIZE`
(default 4), which rebind the weights as the JAX package's ops do; else one
parameter at a time. SGD, NAG and Adam have a fused update, as in the JAX
package; the others update one parameter at a time.

A row-sparse gradient (`RowSparseNDArray`) never joins a fused or an
aggregated update: the `Updater` takes it alone. SGD and Adam with
``lazy_update`` (the default) update only its rows, in place: the weight,
the momentum and Adam's moments of every other row stay as they were
(`_sparse_sgd_update`, `_sparse_adam_update`, the reference's
`SGDUpdateRspImpl` / `AdamUpdateRspImpl`). Without ``lazy_update``, and for
the other optimizers, the gradient is densified and the update is the dense
one.
"""
from __future__ import annotations

import logging
import math
import os
import pickle
import warnings

import torch

from ..base import getenv, register_env
from ..ops import optimizer_ops as _ops

register_env("MXNET_FUSED_STEP", True,
             "update a group of parameters as one multi-tensor update "
             "(0: the aggregated or per-parameter updates)")

__all__ = ["Optimizer", "SGD", "Signum", "FTML", "DCASGD", "NAG", "SGLD",
           "Adam", "AdamW", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl",
           "Adamax", "Nadam", "LBSGD", "Test", "Updater", "get_updater",
           "register", "create", "sgd_update", "sgd_mom_update",
           "mp_sgd_update", "mp_sgd_mom_update", "adam_update"]


def _tensor(x):
    """The tensor of an NDArray, or the tensor itself."""
    return x if isinstance(x, torch.Tensor) else x._data


def _row_sparse(x):
    from ..ndarray.sparse import RowSparseNDArray

    return isinstance(x, RowSparseNDArray)


def _dense(grad):
    """A gradient as a tensor: a row-sparse one densified."""
    return grad._data if _row_sparse(grad) else _tensor(grad)


def _is_low_precision(dtype):
    """True for dtypes that want an fp32 master copy under multi_precision:
    fp16, and bf16 as the JAX package counts it too."""
    return dtype in (torch.float16, torch.bfloat16)


# -- update arithmetic (ops/optimizer_ops.py) --------------------------------

def _rescale(grad, rescale_grad, clip_gradient, wd=0.0, weight=None):
    g = grad.float() * float(rescale_grad)
    if clip_gradient is not None and float(clip_gradient) > 0:
        c = float(clip_gradient)
        g = torch.clamp(g, -c, c)
    if wd and weight is not None:
        g = g + float(wd) * weight.float()
    return g


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """Returns the new weight."""
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight)
    return (weight.float() - float(lr) * g).to(weight.dtype)


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (new weight, new momentum)."""
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = float(momentum) * mom.float() - float(lr) * g
    new_w = weight.float() + new_mom
    return new_w.to(weight.dtype), new_mom.to(mom.dtype)


def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """Returns (new weight, new fp32 master)."""
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight32)
    new_w32 = weight32 - float(lr) * g
    return new_w32.to(weight.dtype), new_w32


def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (new weight, new momentum, new fp32 master)."""
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight32)
    new_mom = float(momentum) * mom - float(lr) * g
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


adam_update = _ops._adam_update  # the registered ``adam_update``


# -- optimizers ---------------------------------------------------------------

class Optimizer:
    """The base class of the optimizers: the registry, learning-rate and
    weight-decay multipliers, per-index update counts and the fp32 master
    copy of multi-precision training."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        if not isinstance(klass, type):
            raise TypeError("register takes a class")
        name = klass.__name__.lower()
        if name in Optimizer.opt_registry:
            warnings.warn(f"WARNING: New optimizer {klass.__name__}.{name} is "
                          "overriding existing optimizer "
                          f"{Optimizer.opt_registry[name].__name__}.{name}")
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        """Instantiate an optimizer by registered name."""
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError(f"Cannot find optimizer {name}")

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.aggregate_num = 0
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise TypeError(
                "param_idx2name should be a dict of param indexes to names.")
        self.idx2name = param_idx2name.copy()
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        """Create auxiliary state for a given weight."""

    def create_state_multi_precision(self, index, weight):
        """The state, with an fp32 master copy in front when multi_precision
        is on and the weight is fp16 or bf16: ``(master, state)``."""
        weight = _tensor(weight)
        if self.multi_precision and _is_low_precision(weight.dtype):
            master = weight.detach().float()
            return (master, self.create_state(index, master))
        if _is_low_precision(weight.dtype):
            warnings.warn("Accumulating with float16 in optimizer can lead to "
                          "poor accuracy or slow convergence. "
                          "Consider using multi_precision=True option of the "
                          "optimizer")
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        """Update weight given gradient and state."""
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and _is_low_precision(weight.dtype):
            master, original_state = state
            grad = grad.astype("float32") if _row_sparse(grad) \
                else grad.float()
            self.update(index, master, grad, original_state)
            weight.copy_(master.to(weight.dtype))
        else:
            self.update(index, weight, grad, state)

    fused_update_supported = False
    # whether `update` takes a row-sparse gradient as it is (SGD, Adam);
    # the others get it densified
    takes_row_sparse = False

    def fused_update(self, weights, grads, states, lrs, wds, rescale_grad,
                     groups=None):
        """Update every weight of a group at once, in place: ``weights``,
        ``grads`` and the state trees are tensors, ``lrs`` and ``wds`` one
        float per weight, or 0-dim device tensors with ``groups`` (what a
        captured step reads, `Executor.fused_step`). Optimizers with
        ``fused_update_supported`` implement it: SGD, NAG and Adam."""
        raise NotImplementedError(
            f"{type(self).__name__} has no fused update")

    def _fused_hyperparams(self, indices):
        """The (lrs, wds) of ``indices`` that a fused update applies, with
        any correction that depends on the update count; call after
        `_update_count`."""
        return self._get_lrs(indices), self._get_wds(indices)

    def _fused_static_key(self):
        """What a fused update depends on beyond its tensors and its
        (lrs, wds, rescale_grad): part of a captured step's signature, so
        changing one captures anew."""
        return (type(self).__name__, self.clip_gradient, self.multi_precision)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning(
                "LRScheduler of the optimizer has already been defined. Note "
                "that set_learning_rate can mutate the value of the learning "
                "rate of the optimizer only when the LRScheduler of the "
                "optimizer is undefined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        """Set individual learning-rate multipliers, by index or name."""
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Set individual weight-decay multipliers. Names from
        ``param_idx2name`` that do not end in ``_weight`` get 0."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith("_weight")}
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if not isinstance(index, (list, tuple)):
            index = [index]
        for idx in index:
            if idx not in self._index_update_count:
                self._index_update_count[idx] = self.begin_num_update
            self._index_update_count[idx] += 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _mult(self, index, attr, table):
        """A parameter's multiplier: the ``lr_mult``/``wd_mult`` attribute of
        the parameter in ``param_dict`` (1.0 when it has none), else the
        table's entry by index, else by name."""
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr, 1.0)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lrs(self, indices):
        """The learning rates of ``indices``: the scheduler's rate (asked
        once per update count) or ``lr``, times each multiplier."""
        lr = self.lr
        if self.lr_scheduler is not None:
            memo = getattr(self, "_lr_sched_memo", None)
            if memo is None or memo[0] != self.num_update:
                memo = self._lr_sched_memo = (
                    self.num_update, self.lr_scheduler(self.num_update))
            lr = memo[1]
        return [lr * self._mult(i, "lr_mult", self.lr_mult) for i in indices]

    def _get_wds(self, indices):
        return [self.wd * self._mult(i, "wd_mult", self.wd_mult)
                for i in indices]

    def _get_lr(self, index):
        return self._get_lrs([index])[0]

    def _get_wd(self, index):
        return self._get_wds([index])[0]

    def __getstate__(self):
        # the trainer that loads the states sets its own parameters
        ret = self.__dict__.copy()
        ret["param_dict"] = {}
        ret.pop("_lr_sched_memo", None)
        return ret


register = Optimizer.register
create = Optimizer.create_optimizer


def _sparse_rows(grad, weight, rescale_grad, clip_gradient):
    """The occupied rows of a row-sparse gradient (int64) and their values
    rescaled and clipped, in the weight's dtype; None for no row."""
    aux = grad._components()
    if aux["indices"].numel() == 0:
        return None, None
    g = aux["data"].to(weight.dtype) * rescale_grad
    if clip_gradient:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return aux["indices"].long(), g


def _sparse_sgd_update(weight, grad, state, lr, wd, rescale_grad,
                       clip_gradient, momentum):
    """Lazy (rows-only) SGD for a row-sparse gradient (the reference's
    sgd(_mom)_update with ``lazy_update`` on a row_sparse grad,
    `optimizer_op.cc` SGDUpdateRspImpl): the weight, the momentum and the
    weight decay touch only the occupied rows, written in place."""
    rows, g = _sparse_rows(grad, weight, rescale_grad, clip_gradient)
    if rows is None:
        return
    wr = weight.index_select(0, rows)
    g = g + wd * wr
    if momentum and state is not None:
        mr = state.index_select(0, rows) * momentum - lr * g
        state.index_copy_(0, rows, mr.to(state.dtype))
        weight.index_copy_(0, rows, wr + mr)
    else:
        weight.index_copy_(0, rows, wr - lr * g)


def _sparse_adam_update(weight, grad, state, lr, wd, rescale_grad,
                        clip_gradient, beta1, beta2, epsilon):
    """Lazy (rows-only) Adam for a row-sparse gradient (the reference's
    AdamUpdateRspImpl, `optimizer_op.cc`): the mean and variance decay only
    on the gradient's rows; ``lr`` carries the bias correction."""
    rows, g = _sparse_rows(grad, weight, rescale_grad, clip_gradient)
    if rows is None:
        return
    mean, var = state
    wr = weight.index_select(0, rows)
    g = g + wd * wr
    mr = beta1 * mean.index_select(0, rows) + (1 - beta1) * g
    vr = beta2 * var.index_select(0, rows) + (1 - beta2) * g * g
    mean.index_copy_(0, rows, mr)
    var.index_copy_(0, rows, vr)
    weight.index_copy_(0, rows, wr - lr * mr / (torch.sqrt(vr) + epsilon))


@register
class SGD(Optimizer):
    """Stochastic gradient descent with momentum and multi-precision. The
    multi-precision state is ``(momentum or None, master)``."""

    takes_row_sparse = True

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update
        self.aggregate_num = max(1, min(60, int(os.getenv(
            "MXNET_OPTIMIZER_AGGREGATION_SIZE", "4"))))

    def create_state_multi_precision(self, index, weight):
        weight = _tensor(weight)
        if self.multi_precision and _is_low_precision(weight.dtype):
            master = weight.detach().float()
            return (self.create_state(index, master), master)
        return super().create_state_multi_precision(index, weight)

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(_tensor(weight),
                                    memory_format=torch.contiguous_format)
        return None

    def _update_impl(self, index, weight, grad, state, multi_precision=False):
        if isinstance(index, (list, tuple)):
            self._update_aggregate(index, weight, grad, state,
                                   multi_precision)
            return
        weight = _tensor(weight)
        self._update_count(index)
        kwargs = {"rescale_grad": self.rescale_grad,
                  "lr": self._get_lr(index), "wd": self._get_wd(index)}
        if self.clip_gradient:
            kwargs["clip_gradient"] = self.clip_gradient
        if self.momentum > 0:
            kwargs["momentum"] = self.momentum
        use_mp = multi_precision and isinstance(state, (list, tuple))
        if _row_sparse(grad) and self.lazy_update and not use_mp:
            _sparse_sgd_update(weight, grad, state, kwargs["lr"],
                               kwargs["wd"], self.rescale_grad,
                               self.clip_gradient, self.momentum)
            return
        grad = _dense(grad)
        if not use_mp:
            if state is not None:
                w, m = sgd_mom_update(weight, grad, state, **kwargs)
                state.copy_(m)
            else:
                w = sgd_update(weight, grad, **kwargs)
            weight.copy_(w)
            return
        mom, master = state
        if mom is not None:
            w, m, w32 = mp_sgd_mom_update(weight, grad, mom, master, **kwargs)
            mom.copy_(m)
        else:
            w, w32 = mp_sgd_update(weight, grad, master, **kwargs)
        master.copy_(w32)
        weight.copy_(w)

    def _update_aggregate(self, indices, weights, grads, states,
                          multi_precision):
        """One ``multi_sgd_*`` op over a chunk of NDArray weights, which it
        rebinds to the new values; the states are written in place."""
        from ..ndarray import NDArray, invoke_nd

        self._update_count(indices)
        kwargs = {"rescale_grad": self.rescale_grad,
                  "lrs": self._get_lrs(indices),
                  "wds": self._get_wds(indices), "num_weights": len(indices)}
        if self.momentum > 0:
            kwargs["momentum"] = self.momentum
        if self.clip_gradient:
            kwargs["clip_gradient"] = self.clip_gradient

        # each state as an NDArray over its own tensor: written in place
        data = []
        for w, g, s in zip(weights, grads, states):
            data += [w, g]
            if multi_precision:
                data += ([NDArray(s[0])] if self.momentum > 0 else []) \
                    + [NDArray(s[1])]
            elif self.momentum > 0:
                data.append(NDArray(s))
        op = {(False, False): "multi_sgd_update",
              (False, True): "multi_sgd_mom_update",
              (True, False): "multi_mp_sgd_update",
              (True, True): "multi_mp_sgd_mom_update"}[
                  (bool(multi_precision), self.momentum > 0)]
        invoke_nd(op, *data, out=list(weights), **kwargs)

    def update(self, index, weight, grad, state):
        self._update_impl(index, weight, grad, state, multi_precision=False)

    def update_multi_precision(self, index, weight, grad, state):
        first = weight[0] if isinstance(index, (list, tuple)) else weight
        self._update_impl(index, weight, grad, state,
                          multi_precision=self.multi_precision
                          and _is_low_precision(_tensor(first).dtype))

    fused_update_supported = True

    def _fused_static_key(self):
        return super()._fused_static_key() + (self.momentum,)

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, rescale_grad,
                     groups=None):
        """`sgd_update` / `sgd_mom_update` / `mp_sgd_*`'s arithmetic over a
        group with the ``torch._foreach_*`` ops, in place: fp32 math (the
        rescale, the clip, then ``+ wd * weight`` on the fp32 weight or
        master), the momentum step where a state exists, the results cast
        back into the weights and states. One multi-tensor op per step of
        the arithmetic for each set of parameters sharing (lr, wd,
        momentum or not).

        ``lrs``, ``wds`` and ``rescale_grad`` are floats, or 0-dim fp32
        tensors on the weights' device, which a captured CUDA graph reads
        at each replay (`Executor.fused_step`); then ``groups`` gives one
        key per weight, equal for the weights that share (lr, wd)."""
        clip = float(self.clip_gradient) if self.clip_gradient else 0.0
        for (_, has_mom), (lr, wd, items) in _fused_sets(
                weights, grads, states, lrs, wds, groups,
                lambda w, s: s if isinstance(s, tuple) else (s, w)):
            ws, gs, moms, w32s = (list(t) for t in zip(*items))
            w32 = _f32_views(w32s)
            g = _fused_grads(gs, w32, rescale_grad, clip, wd)
            if has_mom:
                m32 = _f32_views(moms)
                torch._foreach_mul_(m32, float(self.momentum))
                _add_scaled(m32, g, lr)
                torch._foreach_add_(w32, m32)
                _write_back(moms, m32)
            else:
                _add_scaled(w32, g, lr)
            _write_back(w32s, w32)
            _copy_masters(ws, w32s)


def _fused_sets(weights, grads, states, lrs, wds, groups, split):
    """The weights of a fused update grouped by (hyperparameter key,
    whether a momentum-like state exists): ``[((key, has_state), (lr, wd,
    [(weight, grad, state, fp32 weight or master)]))]``. ``split(w, s)``
    gives a weight's (state, fp32 weight or master); ``groups`` (one key
    per weight, equal for the weights that share (lr, wd)) defaults to the
    (lr, wd) pairs themselves."""
    if groups is None:
        groups = list(zip(lrs, wds))
    sets = {}
    for w, g, s, lr, wd, key in zip(weights, grads, states, lrs, wds,
                                    groups):
        st, w32 = split(w, s)
        sets.setdefault((key, st is not None), (lr, wd, []))[2].append(
            (w, g, st, w32))
    return sets.items()


def _fused_grads(gs, w32, rescale_grad, clip, wd):
    """The update's fp32 gradients of a set: ``gs`` times
    ``rescale_grad``, clipped to +-``clip`` when positive, plus ``wd`` times
    the fp32 weights ``w32`` (the reference's order). ``rescale_grad`` and
    ``wd`` are floats or 0-dim device tensors."""
    if isinstance(rescale_grad, torch.Tensor):
        g = list(torch._foreach_mul(_f32_views(gs), rescale_grad))
    else:
        rescale = float(rescale_grad)
        if rescale != 1.0 and all(t.dtype == torch.float32 for t in gs):
            g = list(torch._foreach_mul(gs, rescale))
        else:
            g = _f32_copies(gs)
            if rescale != 1.0:
                torch._foreach_mul_(g, rescale)
    if clip > 0:
        torch._foreach_clamp_min_(g, -clip)
        torch._foreach_clamp_max_(g, clip)
    if isinstance(wd, torch.Tensor):
        torch._foreach_add_(g, torch._foreach_mul(w32, wd))
    elif wd:
        torch._foreach_add_(g, w32, alpha=float(wd))
    return g


def _copy_masters(ws, w32s):
    """Each low-precision weight from its fp32 master, where it has one."""
    if any(w is not m for w, m in zip(ws, w32s)):
        torch._foreach_copy_(ws, w32s)


def _add_scaled(ts, g, lr):
    """``ts -= lr * g``: by ``alpha`` for a float ``lr``; for a tensor, one
    multi-tensor product that reads it on the device."""
    if isinstance(lr, torch.Tensor):
        torch._foreach_sub_(ts, torch._foreach_mul(g, lr))
    else:
        torch._foreach_add_(ts, g, alpha=-float(lr))


def fused_hyper_slots(lrs, wds):
    """The layout of a device tensor of hyperparameters: the weights that
    share (lr, wd) share a slot. Returns one slot per weight and the
    tensor's values, [lr by slot, wd by slot]; `rescale_grad` follows
    them."""
    slots = {}
    groups = tuple(slots.setdefault(key, len(slots))
                   for key in zip(lrs, wds))
    return groups, [lr for lr, _ in slots] + [wd for _, wd in slots]


def fused_hyper_args(hyper, groups):
    """`fused_update`'s (lrs, wds, rescale_grad) as 0-dim views of
    ``hyper``, laid out by `fused_hyper_slots`."""
    n = max(groups, default=-1) + 1
    return [hyper[g] for g in groups], [hyper[n + g] for g in groups], \
        hyper[-1]


def _snapshot_counts(opt, indices):
    """The update-count state that `_update_count` moves, so a step that
    fails before it ran can put it back (`_restore_counts`)."""
    return (opt.num_update, {i: opt._index_update_count.get(i)
                             for i in indices})


def _restore_counts(opt, snap):
    opt.num_update, counts = snap
    for i, c in counts.items():
        if c is None:
            opt._index_update_count.pop(i, None)
        else:
            opt._index_update_count[i] = c


def _f32_copies(ts):
    """fp32 copies of tensors (one multi-tensor copy-cast)."""
    out = [torch.empty(t.shape, dtype=torch.float32, device=t.device)
           for t in ts]
    torch._foreach_copy_(out, ts)
    return out


def _f32_views(ts):
    """The tensors themselves when all are fp32, else fp32 copies that
    `_write_back` returns."""
    if all(t.dtype == torch.float32 for t in ts):
        return ts
    return _f32_copies(ts)


def _write_back(ts, f32):
    if f32 is not ts:
        torch._foreach_copy_(ts, f32)


def _zeros(weight, dtype=None):
    return torch.zeros(weight.shape, dtype=dtype or weight.dtype,
                       device=weight.device)


def _write(pairs):
    """Copy each (destination, value) in place."""
    for dst, value in pairs:
        dst.copy_(value)


def _clip_of(opt):
    """The clip_gradient attribute an update op takes, when set."""
    return {"clip_gradient": opt.clip_gradient} if opt.clip_gradient else {}


@register
class Signum(Optimizer):
    """signSGD (momentum 0) and Signum: the sign of the (momentum of the)
    gradient, with the decoupled decay ``wd_lh``."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = {"rescale_grad": self.rescale_grad,
                  "lr": self._get_lr(index), "wd": self._get_wd(index),
                  **_clip_of(self)}
        if self.momentum > 0:
            kwargs["momentum"] = self.momentum
        if self.wd_lh:
            kwargs["wd_lh"] = self.wd_lh
        if state is not None:
            w, m = _ops._signum_update(weight, grad, state, **kwargs)
            _write([(state, m), (weight, w)])
        else:
            weight.copy_(_ops._signsgd_update(weight, grad, **kwargs))


@register
class FTML(Optimizer):
    """Follow the moving leader; the state is (d, v, z)."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = {"lr": self._get_lr(index), "wd": self._get_wd(index),
                  "t": self._index_update_count[index], "beta1": self.beta1,
                  "beta2": self.beta2, "epsilon": self.epsilon,
                  "rescale_grad": self.rescale_grad}
        if self.clip_gradient:
            kwargs["clip_grad"] = self.clip_gradient
        w, d, v, z = _ops._ftml_update(weight, grad, *state, **kwargs)
        _write(zip(state, (d, v, z)))
        weight.copy_(w)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD; the state is (momentum or None,
    the previous weight). A momentum state takes part wherever it exists
    (the JAX package's ``if mom:`` raises for one of more than one
    element)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (None if self.momentum == 0.0 else _zeros(weight),
                weight.detach().clone())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = torch.clamp(grad, -self.clip_gradient, self.clip_gradient)
        mom, previous = state
        step = -lr * (grad + wd * weight
                      + self.lamda * grad * grad * (weight - previous))
        if mom is not None:
            mom.mul_(self.momentum).add_(step)
            step = mom
        previous.copy_(weight)
        weight.add_(step)


@register
class NAG(Optimizer):
    """Nesterov accelerated gradient. Its multi-precision master is for
    fp16 weights only (the JAX package's rule); the multi-precision state
    is ``(momentum or None, master)``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def _mp(self, weight):
        return self.multi_precision and weight.dtype == torch.float16

    def create_state_multi_precision(self, index, weight):
        weight = _tensor(weight)
        if self._mp(weight):
            master = weight.detach().float()
            return (self.create_state(index, master), master)
        return self.create_state(index, weight)

    def _update_impl(self, index, weight, grad, state, multi_precision):
        self._update_count(index)
        kwargs = {"rescale_grad": self.rescale_grad,
                  "lr": self._get_lr(index), "wd": self._get_wd(index),
                  **_clip_of(self)}
        if self.momentum > 0:
            kwargs["momentum"] = self.momentum
        if not multi_precision:
            if state is not None:
                w, m = _ops._nag_mom_update(weight, grad, state, **kwargs)
                state.copy_(m)
            else:
                w = sgd_update(weight, grad, **kwargs)
            weight.copy_(w)
            return
        mom, master = state
        if mom is not None:
            w, m, w32 = _ops._mp_nag_mom_update(weight, grad, mom, master,
                                                **kwargs)
            mom.copy_(m)
        else:
            w, w32 = mp_sgd_update(weight, grad, master, **kwargs)
        _write([(master, w32), (weight, w)])

    def update(self, index, weight, grad, state):
        self._update_impl(index, weight, grad, state, False)

    def update_multi_precision(self, index, weight, grad, state):
        self._update_impl(index, weight, grad, state, self._mp(weight))

    fused_update_supported = True

    def _fused_static_key(self):
        return super()._fused_static_key() + (self.momentum,)

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, rescale_grad,
                     groups=None):
        """`nag_mom_update` / `mp_nag_mom_update` / `sgd_update`'s
        arithmetic over a group, in place, as `SGD.fused_update`: m =
        momentum m + g, w -= lr (g + momentum m) where a momentum state
        exists, else w -= lr g."""
        clip = float(self.clip_gradient) if self.clip_gradient else 0.0
        mom = float(self.momentum)

        def split(w, s):
            return s if self._mp(w) else (s, w)

        for (_, has_mom), (lr, wd, items) in _fused_sets(
                weights, grads, states, lrs, wds, groups, split):
            ws, gs, moms, w32s = (list(t) for t in zip(*items))
            w32 = _f32_views(w32s)
            g = _fused_grads(gs, w32, rescale_grad, clip, wd)
            if has_mom:
                m32 = _f32_views(moms)
                torch._foreach_mul_(m32, mom)
                torch._foreach_add_(m32, g)
                torch._foreach_add_(g, m32, alpha=mom)
                _write_back(moms, m32)
            _add_scaled(w32, g, lr)
            _write_back(w32s, w32)
            _copy_masters(ws, w32s)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half a gradient step plus
    N(0, lr) noise, drawn from the weight's device generator."""

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        from .. import random as _random

        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = torch.clamp(grad, -self.clip_gradient, self.clip_gradient)
        weight.add_(-lr / 2 * (grad + wd * weight))
        noise = torch.empty(weight.shape, dtype=torch.float32,
                            device=weight.device).normal_(
            0.0, math.sqrt(lr), generator=_random.generator(weight.device))
        weight.add_(noise.to(weight.dtype))


def _adam_lr(opt, lr, index):
    """``lr`` with Adam's bias correction at ``index``'s update count."""
    t = opt._index_update_count[index]
    return lr * math.sqrt(1. - opt.beta2 ** t) / (1. - opt.beta1 ** t)


@register
class Adam(Optimizer):
    """Adam, with the bias correction folded into the learning rate. The
    multi-precision state is the base class's ``(master, (mean, var))``."""

    takes_row_sparse = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, memory_format=torch.contiguous_format),
                torch.zeros_like(weight, memory_format=torch.contiguous_format))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = {"beta1": self.beta1, "beta2": self.beta2,
                  "epsilon": self.epsilon, "rescale_grad": self.rescale_grad,
                  "lr": _adam_lr(self, self._get_lr(index), index),
                  "wd": self._get_wd(index), **_clip_of(self)}
        if _row_sparse(grad) and self.lazy_update:
            _sparse_adam_update(weight, grad, state, kwargs["lr"],
                                kwargs["wd"], self.rescale_grad,
                                self.clip_gradient, self.beta1, self.beta2,
                                self.epsilon)
            return
        mean, var = state
        w, m, v = adam_update(weight, _dense(grad), mean, var, **kwargs)
        _write([(mean, m), (var, v), (weight, w)])

    fused_update_supported = True

    def _fused_static_key(self):
        return super()._fused_static_key() + (self.beta1, self.beta2,
                                              self.epsilon)

    def _fused_hyperparams(self, indices):
        """The bias correction folded into each rate on the host, in
        float64: the rate the per-parameter update gives `adam_update`."""
        lrs, wds = super()._fused_hyperparams(indices)
        return [_adam_lr(self, lr, i) for lr, i in zip(lrs, indices)], wds

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, rescale_grad,
                     groups=None):
        """`adam_update`'s arithmetic over a group, in place, as
        `SGD.fused_update` (the rates already corrected,
        `_fused_hyperparams`): mean and var moved by beta1 and beta2, w -=
        lr mean / (sqrt(var) + epsilon), in fp32 on the weight or its
        master."""
        clip = float(self.clip_gradient) if self.clip_gradient else 0.0
        b1, b2, eps = float(self.beta1), float(self.beta2), \
            float(self.epsilon)

        def split(w, s):
            master, moments = (s if isinstance(s[1], tuple) else (w, s))
            return moments, master

        for _, (lr, wd, items) in _fused_sets(
                weights, grads, states, lrs, wds, groups, split):
            ws, gs, moments, w32s = (list(t) for t in zip(*items))
            means = [m for m, _ in moments]
            variances = [v for _, v in moments]
            w32 = _f32_views(w32s)
            g = _fused_grads(gs, w32, rescale_grad, clip, wd)
            m32, v32 = _f32_views(means), _f32_views(variances)
            torch._foreach_mul_(m32, b1)
            torch._foreach_add_(m32, g, alpha=1 - b1)
            torch._foreach_mul_(v32, b2)
            torch._foreach_addcmul_(v32, g, g, value=1 - b2)
            denom = torch._foreach_sqrt(v32)
            torch._foreach_add_(denom, eps)
            _add_scaled(w32, torch._foreach_div(m32, denom), lr)
            _write_back(means, m32)
            _write_back(variances, v32)
            _write_back(w32s, w32)
            _copy_masters(ws, w32s)


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (`contrib/adamw.cc`), the whole
    step scaled by ``eta``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.eta = eta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = {"beta1": self.beta1, "beta2": self.beta2,
                  "epsilon": self.epsilon, "rescale_grad": self.rescale_grad,
                  "lr": _adam_lr(self, self._get_lr(index), index),
                  "wd": self._get_wd(index), "eta": self.eta,
                  **_clip_of(self)}
        mean, var = state
        w, m, v = _ops._adamw_update(weight, grad, mean, var, **kwargs)
        _write([(mean, m), (var, v), (weight, w)])


@register
class AdaGrad(Optimizer):
    """AdaGrad; its fp32 state is the sum of squared gradients."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight, torch.float32)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = torch.clamp(grad, -self.clip_gradient, self.clip_gradient)
        state.add_(torch.square(grad))
        div = grad / torch.sqrt(state + self.float_stable_eps)
        weight.add_((div + weight * wd) * -lr)


@register
class RMSProp(Optimizer):
    """RMSProp; ``centered`` takes Graves' (2013) form, with the state
    (n, g, delta) in place of (n,)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return tuple(_zeros(weight, torch.float32)
                     for _ in range(3 if self.centered else 1))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = {"gamma1": self.gamma1, "epsilon": self.epsilon,
                  "rescale_grad": self.rescale_grad,
                  "lr": self._get_lr(index), "wd": self._get_wd(index),
                  **_clip_of(self)}
        if self.centered:
            kwargs["gamma2"] = self.gamma2
        if self.clip_weights:
            kwargs["clip_weights"] = self.clip_weights
        if self.centered:
            w, *new = _ops._rmspropalex_update(weight, grad, *state,
                                               **kwargs)
        else:
            w, *new = _ops._rmsprop_update(weight, grad, *state, **kwargs)
        _write(zip(state, new))
        weight.copy_(w)


@register
class AdaDelta(Optimizer):
    """AdaDelta; the fp32 state is (accumulated g^2, accumulated
    delta^2)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = torch.clamp(grad, -self.clip_gradient, self.clip_gradient)
        acc_g, acc_delta = state
        acc_g.mul_(self.rho).add_((1. - self.rho) * grad * grad)
        delta = torch.sqrt(acc_delta + self.epsilon) / \
            torch.sqrt(acc_g + self.epsilon) * grad
        acc_delta.mul_(self.rho).add_((1. - self.rho) * delta * delta)
        weight.sub_(delta + wd * weight)


@register
class Ftrl(Optimizer):
    """FTRL-proximal; the fp32 state is (z, n)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = {"lamda1": self.lamda1, "beta": self.beta,
                  "rescale_grad": self.rescale_grad,
                  "lr": self._get_lr(index), "wd": self._get_wd(index),
                  **_clip_of(self)}
        w, z, n = _ops._ftrl_update(weight, grad, *state, **kwargs)
        _write(zip(state, (z, n)))
        weight.copy_(w)


@register
class Adamax(Optimizer):
    """AdaMax, Adam under the infinity norm."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        lr /= (1. - self.beta1 ** self._index_update_count[index])
        grad = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = torch.clamp(grad, -self.clip_gradient, self.clip_gradient)
        m_t, u_t = state
        m_t.mul_(self.beta1).add_((1. - self.beta1) * grad)
        u_t.copy_(torch.maximum(self.beta2 * u_t, torch.abs(grad)))
        weight.sub_(lr * m_t / u_t)


@register
class Nadam(Optimizer):
    """Nesterov Adam, with the momentum schedule of Dozat (2016); the
    schedule's running product is the optimizer's, over every index."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        grad = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = torch.clamp(grad, -self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (1. - 0.5 * pow(0.96, t
                                                  * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1. - 0.5 * pow(
            0.96, (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = state
        m_t.mul_(self.beta1).add_((1. - self.beta1) * grad)
        v_t.mul_(self.beta2).add_((1. - self.beta2) * grad * grad)
        grad_prime = grad / (1. - self.m_schedule)
        m_t_prime = m_t / (1. - m_schedule_next)
        v_t_prime = v_t / (1. - pow(self.beta2, t))
        m_t_bar = (1. - momentum_t) * grad_prime + momentum_t_1 * m_t_prime
        weight.sub_(lr * m_t_bar / (torch.sqrt(v_t_prime) + self.epsilon))


@register
class LBSGD(Optimizer):
    """Large-batch SGD: the rate scaled by a warm-up schedule
    (``linear``, ``power2``, ``sqrt``) up to ``batch_scale``, or by the
    LARS trust ratio (``lars``, read on the host each update).
    ``begin_epoch`` and ``num_epochs`` are the reference's arguments and
    change nothing, as in the JAX package."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(**kwargs)
        logging.info("Running Large-Batch SGD Algorithm")
        logging.info("(Batch_scale=%f, warmup_epochs=%d, warmup_strategy=%s, "
                     "updates_per_epoch=%d)", batch_scale, warmup_epochs,
                     warmup_strategy, updates_per_epoch)
        self.momentum = momentum
        self.multi_precision = multi_precision
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch

    def create_state(self, index, weight):
        dtype = torch.float32 if self.multi_precision \
            and weight.dtype == torch.float16 else None
        mom = _zeros(weight, dtype) if self.momentum != 0.0 else None
        if dtype is not None:
            return (mom, weight.detach().float())
        return mom

    def _get_lbmult(self, nup):
        nwup = self.warmup_epochs * self.updates_per_epoch
        maxmult = float(self.batch_scale)
        if nup >= nwup:
            return maxmult
        if nwup <= 1:
            return 1.0
        if self.warmup_strategy == "linear":
            return 1.0 + (maxmult - 1) * nup / nwup
        if self.warmup_strategy == "power2":
            return 1.0 + (maxmult - 1) * (nup * nup) / (nwup * nwup)
        if self.warmup_strategy == "sqrt":
            return 1.0 + (maxmult - 1) * math.sqrt(float(nup) / nwup)
        return 1.0

    def _get_lars(self, weight, g, wd):
        """The LARS trust ratio of one weight, within [0.01, 100]."""
        weight2 = float((weight * weight).sum())
        grad2 = float((g * g).sum())
        lars = math.sqrt(weight2 / (grad2 + wd * weight2 + 1e-18))
        return min(max(lars, 0.01), 100)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if self.warmup_strategy == "lars":
            lr *= self._get_lars(weight, grad, wd)
        else:
            lr *= self._get_lbmult(self.num_update)
        kwargs = {"rescale_grad": self.rescale_grad, "lr": lr, "wd": wd,
                  **_clip_of(self)}
        if self.momentum > 0:
            kwargs["momentum"] = self.momentum
        if not isinstance(state, (list, tuple)):
            if state is not None:
                w, m = sgd_mom_update(weight, grad, state, **kwargs)
                state.copy_(m)
            else:
                w = sgd_update(weight, grad, **kwargs)
            weight.copy_(w)
            return
        mom, master = state
        if mom is not None:
            w, m, w32 = mp_sgd_mom_update(weight, grad, mom, master, **kwargs)
            mom.copy_(m)
        else:
            w, w32 = mp_sgd_update(weight, grad, master, **kwargs)
        _write([(master, w32), (weight, w)])


@register
class Test(Optimizer):
    """The reference's test optimizer: weight += rescaled grad; the state
    records the weight."""

    def create_state(self, index, weight):
        return torch.zeros(weight.shape, device=weight.device)

    def update(self, index, weight, grad, state):
        weight.add_(grad * self.rescale_grad)
        state.copy_(weight)


def _state_leaves(state):
    """The tensors of one optimizer state (a tensor, None or a tuple)."""
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, (list, tuple)):
        return [t for s in state for t in _state_leaves(s)]
    return [getattr(state, "_data", state)] if hasattr(state, "_data") \
        else []


class Updater:
    """Applies an optimizer by index, creating each index's state at its
    first update; a group of weights is updated as one (the module's
    docstring)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}
        self.aggregate_updates = optimizer.aggregate_num > 0
        # the memory census's optimizer_state: a live view of the states
        from .. import memory

        memory.register_provider(
            "optimizer_state", self,
            lambda u: [t for st in u.states.values()
                       for t in _state_leaves(st)])

    def ensure_states(self, indices, weights):
        """Create each index's state, or move a loaded one to its weight's
        device."""
        for idx, w in zip(indices, weights):
            if idx not in self.states:
                self.states[idx] = \
                    self.optimizer.create_state_multi_precision(idx, w)
            elif not self.states_synced.get(idx, True):
                self.states[idx] = _to_device(self.states[idx],
                                              _tensor(w).device)
            self.states_synced[idx] = True

    @torch.no_grad()
    def __call__(self, index, grad, weight):
        """Update ``weight`` from ``grad``; ``index``, ``grad`` and
        ``weight`` are one each or equal-length lists."""
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        if not len(index) == len(grad) == len(weight):
            raise ValueError(f"Updater: {len(index)} indices, {len(grad)} "
                             f"gradients and {len(weight)} weights")
        self.ensure_states(index, weight)
        opt = self.optimizer
        if any(_row_sparse(g) for g in grad):
            # a row-sparse gradient is updated alone, never in a fused or
            # an aggregated group
            dense = []
            for idx, g, w in zip(index, grad, weight):
                if not _row_sparse(g):
                    dense.append((idx, g, w))
                    continue
                opt.update_multi_precision(
                    idx, _tensor(w), g if opt.takes_row_sparse else g._data,
                    self.states[idx])
            if not dense:
                return
            index, grad, weight = (list(t) for t in zip(*dense))
        if len(index) > 1 and opt.fused_update_supported \
                and getenv("MXNET_FUSED_STEP"):
            opt._update_count(index)
            opt.fused_update([_tensor(w) for w in weight],
                             [_tensor(g) for g in grad],
                             [self.states[i] for i in index],
                             *opt._fused_hyperparams(index),
                             opt.rescale_grad)
            return
        if self.aggregate_updates and len(index) > 1 and \
                not any(isinstance(w, torch.Tensor) for w in weight):
            self._aggregated_update(index, grad, weight)
            return
        for idx, g, w in zip(index, grad, weight):
            opt.update_multi_precision(idx, _tensor(w), _tensor(g),
                                       self.states[idx])

    def _aggregated_update(self, indices, grads, weights):
        """Same-dtype chunks of ``aggregate_num`` weights, one
        ``multi_sgd_*`` op each."""
        by_type = {}
        for idx, g, w in zip(indices, grads, weights):
            by_type.setdefault(w.dtype, []).append((idx, g, w))
        step = self.optimizer.aggregate_num
        for group in by_type.values():
            for start in range(0, len(group), step):
                idxs, gs, ws = zip(*group[start:start + step])
                self.optimizer.update_multi_precision(
                    list(idxs), list(ws), list(gs),
                    [self.states[i] for i in idxs])

    def get_states(self, dump_optimizer=False):
        """The states (and the optimizer), pickled, their tensors on the
        host."""
        states = {k: _to_device(v, torch.device("cpu"))
                  for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)

    def set_states(self, states):
        """Load states from `get_states`' bytes (the port's own files:
        unpickling runs code, so load only files this program wrote); each
        moves to its weight's device at its next update."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states, False)


def _to_device(state, device):
    if isinstance(state, torch.Tensor):
        return state.detach().to(device)
    if isinstance(state, (tuple, list)):
        return type(state)(_to_device(s, device) for s in state)
    return state


def get_updater(optimizer):
    """Return an `Updater` for ``optimizer``."""
    return Updater(optimizer)
