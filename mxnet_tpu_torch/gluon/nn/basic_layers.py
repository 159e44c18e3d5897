"""gluon.nn basic layers: the port of `mxnet_tpu/gluon/nn/basic_layers.py`
(Sequential, HybridSequential, Dense, Dropout, Embedding, BatchNorm,
InstanceNorm, LayerNorm, Flatten, Lambda, HybridLambda).

`Embedding` with ``sparse_grad=True`` has a row-sparse gradient buffer
(``grad_stype="row_sparse"``), which backward fills with the touched rows
only; hybridized, its gradient is computed dense and written into that
buffer, as in the JAX package.
"""
from __future__ import annotations

import warnings

import numpy as _np

from ... import ndarray as nd
from ...base import np_dtype
from ..block import Block, HybridBlock
from .activations import Activation

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "InstanceNorm", "LayerNorm", "Flatten", "Lambda",
           "HybridLambda"]


class _Stack:
    """What Sequential and HybridSequential share."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __repr__(self):
        modstr = "\n".join(f"  ({key}): {block}"
                           for key, block in self._children.items())
        return f"{self.__class__.__name__}(\n{modstr}\n)"

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)


class Sequential(_Stack, Block):
    """Blocks run one after another."""

    def __init__(self, prefix=None, params=None):
        Block.__init__(self, prefix=prefix, params=params)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def hybridize(self, active=True, **kwargs):
        if self._children and all(isinstance(c, HybridBlock)
                                  for c in self._children.values()):
            warnings.warn(
                f"All children of this Sequential layer '{self.prefix}' are "
                "HybridBlocks. Consider using HybridSequential for the best "
                "performance.", stacklevel=2)
        super().hybridize(active, **kwargs)


class HybridSequential(_Stack, HybridBlock):
    """HybridBlocks run one after another."""

    def __init__(self, prefix=None, params=None):
        HybridBlock.__init__(self, prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """activation(x W^T + b): the FullyConnected op."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        self._units = units
        self._in_units = in_units
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype, allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def infer_shape(self, x, *args):
        in_units = int(_np.prod(x.shape[1:])) if self._flatten \
            else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        act = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten,
                               name="fwd")
        if self.act is not None:
            act = self.act(act)
        return act

    def __repr__(self):
        shape = self.weight.shape
        act = "linear" if self.act is None \
            else f"Activation({self.act._act_type})"
        return (f"{self.__class__.__name__}("
                f"{shape[1] if shape[1] else None} -> {shape[0]}, {act})")


class Dropout(HybridBlock):
    """Dropout in training mode; the identity otherwise."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes, name="fwd",
                             cudnn_off=False)
        return F.identity(x)

    def __repr__(self):
        return f"{self.__class__.__name__}(p = {self._rate}, axes={self._axes})"


class Embedding(HybridBlock):
    """Indices to dense vectors: one gather of weight rows."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": sparse_grad}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, name="fwd", **self._kwargs)

    def __repr__(self):
        return (f"{self.__class__.__name__}({self._input_dim} -> "
                f"{self._output_dim}, {self._kwargs['dtype']})")


class BatchNorm(HybridBlock):
    """Batch normalization. The moving stats are parameters with
    ``grad_req="null"``, written in place by the op in training mode."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        if in_channels != 0:
            self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def cast(self, dtype):
        """fp16 keeps fp32 parameters; any other dtype, bf16 included, is
        taken as is (the JAX package's rule)."""
        if np_dtype(dtype) == _np.dtype(_np.float16):
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", **self._kwargs)

    def __repr__(self):
        in_channels = self.gamma.shape[0]
        return (f"{self.__class__.__name__}(axis={self._axis}, "
                f"eps={self._kwargs['eps']}, "
                f"momentum={self._kwargs['momentum']}, "
                f"fix_gamma={self._kwargs['fix_gamma']}, "
                f"in_channels={in_channels or None})")


class InstanceNorm(HybridBlock):
    """Instance normalization over ``axis`` (Ulyanov et al. 2016): each
    sample's channels normalized over their other axes; ``gamma`` is
    learned only with ``scale``, ``beta`` only with ``center``."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, name="fwd",
                                  eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta, name="fwd",
                              eps=self._epsilon).swapaxes(1, self._axis)

    def __repr__(self):
        return (f"{self.__class__.__name__}(eps={self._epsilon}, "
                f"axis={self._axis}, in_channels={self.gamma.shape[0]})")


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis``."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)

    def __repr__(self):
        return (f"{self.__class__.__name__}(axis={self._axis}, "
                f"eps={self._epsilon}, center={self._center}, "
                f"scale={self._scale}, in_channels={self.gamma.shape[0]})")


class Flatten(HybridBlock):
    """(batch, ...) -> (batch, -1)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return self.__class__.__name__


def _lambda_function(function, hybrid):
    if isinstance(function, str):
        if not hasattr(nd, function):
            raise ValueError(
                f"Function name {function} is not found in ndarray.")
        if hybrid:
            return (lambda F, *args: getattr(F, function)(*args)), function
        return getattr(nd, function), function
    if callable(function):
        return function, getattr(function, "__name__", "custom")
    raise ValueError("Unrecognized function in lambda: {} of type {}"
                     .format(function, type(function)))


class Lambda(Block):
    """A callable of NDArrays as a Block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_impl, self._func_name = _lambda_function(function, False)

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._func_name})"


class HybridLambda(HybridBlock):
    """A callable ``function(F, x, *args)`` as a HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func, self._func_name = _lambda_function(function, True)

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._func_name})"
