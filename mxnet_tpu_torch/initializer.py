"""Weight initializers: the port of `mxnet_tpu/initializer.py` (parity
`python/mxnet/initializer.py`).

An initializer is called with a name (an `InitDesc`) and an NDArray, and
fills the array by the name's suffix: ``*weight`` by the initializer's own
rule (`_init_weight`), ``*bias`` and ``*beta`` with zeros, ``*gamma`` with
ones, moving means with zeros and moving variances with ones. A parameter
that names its own initializer carries it in ``desc.attrs["__init__"]`` (a
JSON ``[name, kwargs]``), which then applies whatever the suffix.

Random draws come from the port's generator of the array's device
(`mxnet_tpu_torch.random.generator`), in fp32, then cast to the array's
dtype: on a card they are drawn there. The streams are torch's, so they
do not match the JAX package's numpy draws value for value; their
distributions do.
"""
from __future__ import annotations

import json
import re

import numpy as _np
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Mixed", "Load", "register", "create"]

_INIT_REGISTRY = {}


def register(klass):
    """Register an initializer class under its lower-cased name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init=None, *args, **kwargs):
    """An initializer from an instance (returned as is), a registered name
    (``"xavier"``, and ``"zeros"``/``"ones"``), a JSON ``[name, kwargs]``
    string, or None for the default ``Uniform(0.07)``."""
    if isinstance(init, (Initializer, Load, Mixed)):
        return init
    if init is None:
        return Uniform(0.07)
    if isinstance(init, str) and init.startswith("["):
        name, kw = json.loads(init)
        return create(name, **kw)
    key = init.lower()
    if key not in _INIT_REGISTRY:
        raise MXNetError(f"Unknown initializer {init}")
    return _INIT_REGISTRY[key](*args, **kwargs)


class InitDesc(str):
    """A parameter's name with its attributes (parity initializer.py:39)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _draw(arr):
    """An fp32 tensor of the array's shape on its device, for a sampler."""
    return torch.empty(arr.shape, dtype=torch.float32,
                       device=arr._data.device)


class Initializer:
    """The base of the initializers: the suffix dispatch of ``__call__``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        self._verbose = verbose
        self._print_func = print_func
        return self

    def dumps(self):
        """``[name, kwargs]`` as JSON: what `create` takes back."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("first argument must be a name string or InitDesc")
        if isinstance(desc, InitDesc) and desc.global_init is None:
            desc.global_init = self
        init = getattr(desc, "attrs", {}).get("__init__", "")
        if init:
            create(init)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(desc, arr)
        elif name.endswith("moving_inv_var") or name.endswith("moving_avg"):
            self._init_zero(desc, arr)
        elif name.endswith("min") or name.endswith("max"):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    @staticmethod
    def _set(arr, value):
        """Write ``value`` (a tensor, numpy array or number) into ``arr``,
        cast to its dtype."""
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(_np.asarray(value, dtype=_np.float32))
        arr._rebind(value.detach())

    def _init_zero(self, _, arr):
        self._set(arr, torch.zeros(arr.shape))

    def _init_one(self, _, arr):
        self._set(arr, torch.ones(arr.shape))

    _init_bias = _init_zero
    _init_beta = _init_zero
    _init_gamma = _init_one

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        raise MXNetError(
            f"Unknown initialization pattern for {name}; names must end with "
            "weight/bias/gamma/beta or register a custom pattern")


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        self._init_zero(_, arr)


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        self._init_one(_, arr)


_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        self._set(arr, torch.full(arr.shape, float(self.value)))


@register
class Uniform(Initializer):
    """Uniform on [-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        gen = _random.generator(arr._data.device)
        self._set(arr, _draw(arr).uniform_(-self.scale, self.scale,
                                           generator=gen))


@register
class Normal(Initializer):
    """Normal with mean 0 and standard deviation sigma."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        gen = _random.generator(arr._data.device)
        self._set(arr, _draw(arr).normal_(0.0, self.sigma, generator=gen))


@register
class Orthogonal(Initializer):
    """scale times an orthonormal matrix: the left or right singular
    vectors of a uniform or normal draw, reshaped to the array."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(_np.prod(arr.shape[1:]))
        gen = _random.generator(arr._data.device)
        tmp = torch.empty((nout, nin), dtype=torch.float32,
                          device=arr._data.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=gen)
        else:
            tmp.normal_(0.0, 1.0, generator=gen)
        u, _, v = torch.linalg.svd(tmp.cpu().double(), full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        self._set(arr, self.scale * q.reshape(arr.shape).float())


@register
class Xavier(Initializer):
    """Uniform on [-s, s) or normal with deviation s, s = sqrt(magnitude /
    factor), the factor the fan-in, the fan-out or their average (each the
    first two dims times the receptive field)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError(
                f"Xavier initializer cannot init {name} with ndim<2")
        hw_scale = float(_np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError("Incorrect factor type")
        scale = float(_np.sqrt(self.magnitude / factor))
        gen = _random.generator(arr._data.device)
        if self.rnd_type == "uniform":
            self._set(arr, _draw(arr).uniform_(-scale, scale, generator=gen))
        elif self.rnd_type == "gaussian":
            self._set(arr, _draw(arr).normal_(0.0, scale, generator=gen))
        else:
            raise MXNetError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """Xavier with gaussian draws at magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of an (…, H, W) weight."""

    def _init_weight(self, _, arr):
        shape = arr.shape
        f = _np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = _np.arange(int(_np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = (1 - _np.abs(x / f - c)) * (1 - _np.abs(y / f - c))
        self._set(arr, weight.astype(_np.float32).reshape(shape))


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter at ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = torch.zeros(arr.shape)
        num_hidden = int(b.shape[0] / 4)
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(arr, b)


class Load:
    """Initialize from a dict of arrays by name (``arg:``/``aux:`` prefixes
    dropped), else from ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k.replace("arg:", "").replace("aux:", ""): v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise MXNetError(
                    f"Parameter {name} cannot be initialized from loading: "
                    f"shape mismatch {src.shape} vs {arr.shape}")
            Initializer._set(arr, src._data if hasattr(src, "_data")
                             else src)
        else:
            if self.default_init is None:
                raise MXNetError(f"Cannot Initialize parameter {name}: not "
                                 "found in loaded params")
            self.default_init(name, arr)


class Mixed:
    """The first initializer whose pattern matches the name."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError(
                "patterns and initializers must have the same length")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise MXNetError(f"Parameter name {name} did not match any pattern")
