"""Optimizers: the port of `mxnet_tpu/optimizer/optimizer.py` (the
`Optimizer` base, `SGD`, `Adam`, `Test`, `Updater`, `get_updater`) and of the
update arithmetic of `mxnet_tpu/ops/optimizer_ops.py` (`_rescale`,
`sgd_update`, `sgd_mom_update`, `mp_sgd_update`, `mp_sgd_mom_update`,
`adam_update`).

The update functions are plain functions on tensors that return the new
weight and states, computed in fp32 and cast back to each input's dtype, as
the JAX package's ops do. The optimizers write those results into the
weight and state tensors in place, where the JAX package rebinds its
NDArrays, so an `nn.Parameter` keeps its identity. The updates run eagerly,
one parameter at a time; the JAX package's fused (jitted) whole-step update
computes the same arithmetic. Not ported: the other optimizers, learning-rate
schedulers, row-sparse (lazy) updates, aggregated multi-weight updates and
the save/load of updater states.
"""
from __future__ import annotations

import math
import warnings

import torch

__all__ = ["Optimizer", "SGD", "Adam", "Test", "Updater", "get_updater",
           "register", "create", "sgd_update", "sgd_mom_update",
           "mp_sgd_update", "mp_sgd_mom_update", "adam_update"]


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


def adam_update(weight, grad, mean, var, lr=0.01, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (new weight, new mean, new var)."""
    g = _rescale(grad, rescale_grad, clip_gradient, wd, weight)
    b1, b2 = float(beta1), float(beta2)
    new_mean = b1 * mean.float() + (1 - b1) * g
    new_var = b2 * var.float() + (1 - b2) * torch.square(g)
    new_w = weight.float() - float(lr) * new_mean / (
        torch.sqrt(new_var) + float(epsilon))
    return (new_w.to(weight.dtype), new_mean.to(mean.dtype),
            new_var.to(var.dtype))


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
        if lr_scheduler is not None:
            raise NotImplementedError(
                "the port's optimizers take no lr_scheduler yet")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = None
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
            self.update(index, master, grad.float(), original_state)
            weight.copy_(master.to(weight.dtype))
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
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

    def _get_lr(self, index):
        return self.lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """Stochastic gradient descent with momentum and multi-precision. The
    multi-precision state is ``(momentum or None, master)``."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update  # dense gradients only: no effect

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and _is_low_precision(weight.dtype):
            master = weight.detach().float()
            return (self.create_state(index, master), master)
        return super().create_state_multi_precision(index, weight)

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight, memory_format=torch.contiguous_format)
        return None

    def _update_impl(self, index, weight, grad, state, multi_precision=False):
        self._update_count(index)
        kwargs = {"rescale_grad": self.rescale_grad,
                  "lr": self._get_lr(index), "wd": self._get_wd(index)}
        if self.clip_gradient:
            kwargs["clip_gradient"] = self.clip_gradient
        if self.momentum > 0:
            kwargs["momentum"] = self.momentum
        if not (multi_precision and isinstance(state, (list, tuple))):
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

    def update(self, index, weight, grad, state):
        self._update_impl(index, weight, grad, state, multi_precision=False)

    def update_multi_precision(self, index, weight, grad, state):
        self._update_impl(index, weight, grad, state,
                          multi_precision=self.multi_precision
                          and _is_low_precision(weight.dtype))


@register
class Adam(Optimizer):
    """Adam, with the bias correction folded into the learning rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update  # dense gradients only: no effect

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, memory_format=torch.contiguous_format),
                torch.zeros_like(weight, memory_format=torch.contiguous_format))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        coef1 = 1. - self.beta1 ** t
        coef2 = 1. - self.beta2 ** t
        lr *= math.sqrt(coef2) / coef1
        kwargs = {"beta1": self.beta1, "beta2": self.beta2,
                  "epsilon": self.epsilon, "rescale_grad": self.rescale_grad,
                  "lr": lr, "wd": wd}
        if self.clip_gradient:
            kwargs["clip_gradient"] = self.clip_gradient
        mean, var = state
        w, m, v = adam_update(weight, grad, mean, var, **kwargs)
        mean.copy_(m)
        var.copy_(v)
        weight.copy_(w)


@register
class Test(Optimizer):
    """The reference's test optimizer: weight += rescaled grad; the state
    records the weight."""

    def create_state(self, index, weight):
        return torch.zeros(weight.shape, device=weight.device)

    def update(self, index, weight, grad, state):
        weight.add_(grad * self.rescale_grad)
        state.copy_(weight)


class Updater:
    """Applies an optimizer by index, creating each index's state at its
    first update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    @torch.no_grad()
    def __call__(self, index, grad, weight):
        """Update ``weight`` in place from ``grad``; ``index``, ``grad`` and
        ``weight`` are one each or equal-length lists."""
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        if not len(index) == len(grad) == len(weight):
            raise ValueError(f"Updater: {len(index)} indices, {len(grad)} "
                             f"gradients and {len(weight)} weights")
        for idx, g, w in zip(index, grad, weight):
            if idx not in self.states:
                self.states[idx] = \
                    self.optimizer.create_state_multi_precision(idx, w)
            self.optimizer.update_multi_precision(idx, w, g, self.states[idx])


def get_updater(optimizer):
    """Return an `Updater` for ``optimizer``."""
    return Updater(optimizer)
