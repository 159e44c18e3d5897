"""gluon.nn activation layers: the port of
`mxnet_tpu/gluon/nn/activations.py`.

`LeakyReLU`, `PReLU`, `ELU`, `SELU` and `GELU` run the LeakyReLU op, which
the port has not yet (ROADMAP.md queue A, item 1): constructing one raises
NotImplementedError.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU"]


class Activation(HybridBlock):
    """An activation function: relu, sigmoid, tanh, softrelu or softsign."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type, name="fwd")

    def __repr__(self):
        return f"{self.__class__.__name__}({self._act_type})"


class _NeedsLeakyReLU(HybridBlock):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} runs the LeakyReLU op, which the port "
            "has not yet (ROADMAP.md queue A, item 1)")


class LeakyReLU(_NeedsLeakyReLU):
    pass


class PReLU(_NeedsLeakyReLU):
    pass


class ELU(_NeedsLeakyReLU):
    pass


class SELU(_NeedsLeakyReLU):
    pass


class GELU(_NeedsLeakyReLU):
    pass


class Swish(HybridBlock):
    """x * sigmoid(beta * x)."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x, name="fwd")
