"""The gluon layers of slice 13 held to the JAX package's on the CPU, from
the same weights: the transposed convolutions (1-3 d, groups, dilation,
``output_padding``, deferred ``in_channels``), the LeakyReLU family,
InstanceNorm and the output layers' gradients (`_hold`: outputs, the
gradients of every input and parameter, the parameters after). Bounds of
the JAX package's `assert_almost_equal` (`mxnet_tpu/test_utils.py:142-160`):
rtol 1e-4 / atol 1e-6.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_torch_gluon import _hold, _seq, _u

CPU = mx.cpu()


def _lambda(fn):
    return lambda p: p.gluon.nn.HybridLambda(fn)


class _JaxPReLU(jmx.gluon.HybridBlock):
    """The JAX package's PReLU passes its slope as ``gamma=``, which its
    LeakyReLU op refuses (ROADMAP.md, reference-side behaviour): the
    layer with the slope passed as the op's second input."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=jmx.init.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


LAYERS = {
    "conv1d_transpose": (
        lambda p: p.gluon.nn.Conv1DTranspose(3, 3, strides=2, padding=1,
                                             output_padding=1),
        [_u(2, 4, 5)]),
    "conv2d_transpose_groups_dilation": (
        lambda p: p.gluon.nn.Conv2DTranspose(
            4, (3, 2), strides=(2, 1), padding=(1, 0), output_padding=(1, 0),
            dilation=(1, 2), groups=2), [_u(2, 4, 4, 3)]),
    "conv2d_transpose_dcgan": (
        lambda p: p.gluon.nn.Conv2DTranspose(3, 4, 2, 1, use_bias=False),
        [_u(2, 5, 4, 4)]),
    "conv3d_transpose_relu": (
        lambda p: p.gluon.nn.Conv3DTranspose(2, 2, strides=2, use_bias=False,
                                             activation="relu"),
        [_u(1, 2, 3, 3, 3)]),
    "leaky_relu": (lambda p: p.gluon.nn.LeakyReLU(0.1), [_u(3, 4)]),
    "prelu": (lambda p: p.gluon.nn.PReLU() if p is mx else _JaxPReLU(),
              [_u(2, 3, 4)]),
    "elu": (lambda p: p.gluon.nn.ELU(0.5), [_u(3, 4, lo=-2.0, hi=2.0)]),
    "selu": (lambda p: p.gluon.nn.SELU(), [_u(3, 4, lo=-2.0, hi=2.0)]),
    "gelu": (lambda p: p.gluon.nn.GELU(), [_u(3, 4, lo=-3.0, hi=3.0)]),
    "instance_norm_scale": (lambda p: p.gluon.nn.InstanceNorm(scale=True),
                            [_u(2, 3, 4, 4)]),
    "instance_norm_axis": (
        lambda p: p.gluon.nn.InstanceNorm(axis=2, center=False,
                                          epsilon=1e-3), [_u(2, 4, 3)]),
    "dcgan_discriminator_block": (
        lambda p: _seq(p, p.gluon.nn.Conv2D(4, 4, 2, 1, use_bias=False),
                       p.gluon.nn.BatchNorm(), p.gluon.nn.LeakyReLU(0.2)),
        [_u(2, 3, 8, 8)]),
    "linear_regression_output": (
        _lambda(lambda F, x, y: F.LinearRegressionOutput(x, y,
                                                         grad_scale=0.5)),
        [_u(3, 4), _u(3, 4, seed=1)]),
    "mae_regression_output": (
        _lambda(lambda F, x, y: F.MAERegressionOutput(x, y)),
        [_u(3, 4), _u(3, 4, seed=1)]),
    "logistic_regression_output": (
        _lambda(lambda F, x, y: F.LogisticRegressionOutput(x, y)),
        [_u(3, 4), _u(3, 4, seed=1, lo=0.0)]),
    "svm_output": (
        _lambda(lambda F, x, y: F.SVMOutput(x, y, margin=0.5)),
        [_u(4, 3), np.array([0, 2, 1, 2], np.float32)]),
    "make_loss": (_lambda(lambda F, x: F.MakeLoss(F.square(x))),
                  [_u(3, 4)]),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax(name):
    make, inputs = LAYERS[name]
    _hold(make, inputs)


def test_transposed_conv_shapes_and_repr():
    """The deferred weight is (in, channels / groups, *kernel); the output
    grows by the stride, less the padding, plus ``output_padding``."""
    for pkg, ctx in ((mx, CPU), (jmx, jmx.cpu())):
        layer = pkg.gluon.nn.Conv2DTranspose(6, 3, strides=2, padding=1,
                                             output_padding=1, groups=3)
        layer.initialize(ctx=ctx)
        out = layer(pkg.nd.ones((1, 3, 5, 5), ctx=ctx))
        assert out.shape == (1, 6, 10, 10)
        assert layer.weight.shape == (3, 2, 3, 3)
        if pkg is mx:
            assert "output_padding=(1, 1)" in repr(layer)
    with pytest.raises(ValueError):
        mx.gluon.nn.LeakyReLU(-0.1)


@pytest.mark.parametrize("hybridize", [False, True])
def test_rrelu_slopes(hybridize):
    """rrelu in predict mode is the mean slope, as in the JAX package; in
    training each negative element's slope is a draw in [lower, upper)
    (the streams are torch's), and the gradient is that slope."""
    x = -np.abs(_u(64, 64)) - 0.1
    lo, hi = 0.1, 0.4
    want = jmx.nd.LeakyReLU(jmx.nd.array(x), act_type="rrelu",
                            lower_bound=lo, upper_bound=hi).asnumpy()
    net = mx.gluon.nn.HybridLambda(lambda F, v: F.LeakyReLU(
        v, act_type="rrelu", lower_bound=lo, upper_bound=hi))
    if hybridize:
        net.hybridize()
    xs = mx.nd.array(x, ctx=CPU)
    np.testing.assert_allclose(net(xs).asnumpy(), want, rtol=1e-6)
    xs.attach_grad()
    with mx.autograd.record():
        out = net(xs)
    out.backward()
    slope = out.asnumpy() / x
    assert slope.min() >= lo and slope.max() < hi
    assert abs(slope.mean() - (lo + hi) / 2) < 0.01
    np.testing.assert_allclose(xs.grad.asnumpy(), slope, rtol=1e-5)
