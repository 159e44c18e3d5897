"""gluon.nn activation layers: the port of
`mxnet_tpu/gluon/nn/activations.py`. `LeakyReLU`, `PReLU`, `ELU`, `SELU`
and `GELU` run the LeakyReLU op's act types."""
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


class LeakyReLU(HybridBlock):
    """x for x >= 0, else ``alpha`` * x."""

    def __init__(self, alpha, **kwargs):
        if alpha < 0:
            raise ValueError(
                "Slope coefficient for LeakyReLU must be no less than 0.")
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha,
                           name="fwd")

    def __repr__(self):
        return f"{self.__class__.__name__}({self._alpha})"


class PReLU(HybridBlock):
    """A leaky ReLU whose slope ``alpha`` is learned (He et al. 2015)."""

    def __init__(self, alpha_initializer=None, **kwargs):
        from ... import initializer

        super().__init__(**kwargs)
        if alpha_initializer is None:
            alpha_initializer = initializer.Constant(0.25)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu", name="fwd")


class ELU(HybridBlock):
    """x for x >= 0, else ``alpha`` * (exp(x) - 1)."""

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """The scaled ELU of Klambauer et al. (2017)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu", name="fwd")


class GELU(HybridBlock):
    """The Gaussian error linear unit, x * Phi(x) (the erf form)."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu", name="fwd")


class Swish(HybridBlock):
    """x * sigmoid(beta * x)."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x, name="fwd")
