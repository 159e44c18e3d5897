"""`gluon.contrib.nn` held to the JAX package's on the CPU (the port of
`tests/python/unittest/test_gluon_contrib.py`): Concurrent,
HybridConcurrent, Identity, SparseEmbedding, SyncBatchNorm and
PixelShuffle1D/2D/3D, from the same weights (`test_torch_gluon._hold`:
outputs, the gradients of every input and parameter, the parameters
after; rtol 1e-4 / atol 1e-6, the JAX package's `assert_almost_equal`
bounds), eager and, for the hybrid blocks, hybridized; and the pixel
shuffles against the numpy reference of the JAX package's test.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.contrib import nn as cnn
from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray
from test_torch_gluon import _hold, _u

CPU = mx.cpu()


def _concurrent(hybrid):
    def make(p):
        net = (p.gluon.contrib.nn.HybridConcurrent if hybrid
               else p.gluon.contrib.nn.Concurrent)(axis=1)
        with net.name_scope():
            net.add(p.gluon.nn.Dense(6, activation="tanh", in_units=5))
            net.add(p.gluon.nn.Dense(3, in_units=5))
            net.add(p.gluon.contrib.nn.Identity())
        return net
    return make


LAYERS = {
    "concurrent": (_concurrent(False), [_u(4, 5)], False),
    "hybrid_concurrent": (_concurrent(True), [_u(4, 5)], False),
    "hybrid_concurrent_hybridized": (_concurrent(True), [_u(4, 5)], True),
    "identity": (lambda p: p.gluon.contrib.nn.Identity(), [_u(3, 4, 2)],
                 True),
    "sparse_embedding": (lambda p: p.gluon.contrib.nn.SparseEmbedding(10, 5),
                         [np.array([3, 4, 2, 3], np.float32)], False),
    "sync_batchnorm": (lambda p: p.gluon.contrib.nn.SyncBatchNorm(
        in_channels=4), [_u(2, 4, 3, 3)], False),
    "sync_batchnorm_hybridized": (lambda p: p.gluon.contrib.nn.SyncBatchNorm(
        in_channels=4, momentum=0.5), [_u(2, 4, 3, 3)], True),
    "pixelshuffle1d": (lambda p: p.gluon.contrib.nn.PixelShuffle1D(4),
                       [_u(1, 12, 5)], True),
    "pixelshuffle2d": (lambda p: p.gluon.contrib.nn.PixelShuffle2D((2, 3)),
                       [_u(2, 12, 3, 4)], True),
    "pixelshuffle3d": (lambda p: p.gluon.contrib.nn.PixelShuffle3D(
        (5, 3, 2)), [_u(1, 30, 2, 3, 4)], True),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_contrib_layer_matches_jax(name):
    make, inputs, hybridize = LAYERS[name]
    outs, grads, _ = _hold(make, inputs, hybridize=hybridize)
    assert all(np.isfinite(o).all() for o in outs)


def _pixelshuffle_ref(x, factors):
    """The JAX package's test's numpy reference: out[n, c, s_i f_i + r_i
    ...] = in[n, c prod(f) + flat(r), s ...]."""
    n, cf = x.shape[:2]
    spatial = x.shape[2:]
    c = cf // int(np.prod(factors))
    x = x.reshape((n, c) + tuple(factors) + spatial)
    ndim = len(spatial)
    perm = [0, 1]
    for i in range(ndim):
        perm.extend([2 + ndim + i, 2 + i])
    out_shape = (n, c) + tuple(s * f for s, f in zip(spatial, factors))
    return x.transpose(perm).reshape(out_shape)


@pytest.mark.parametrize("layer,shape,factors,out_shape", [
    (cnn.PixelShuffle1D, (1, 12, 5), (4,), (1, 3, 20)),
    (cnn.PixelShuffle2D, (2, 12, 3, 4), (2, 3), (2, 2, 6, 12)),
    (cnn.PixelShuffle3D, (1, 30, 2, 3, 4), (5, 3, 2), (1, 1, 10, 9, 8))],
    ids=["1d", "2d", "3d"])
def test_pixelshuffle_against_numpy(layer, shape, factors, out_shape):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    block = layer(factors if len(factors) > 1 else factors[0])
    out = block(mx.nd.array(x, ctx=CPU))
    assert out.shape == out_shape
    np.testing.assert_array_equal(out.asnumpy(),
                                  _pixelshuffle_ref(x, factors))
    assert repr(block) == f"{layer.__name__}({tuple(factors)})"


def test_pixelshuffle_refuses_a_wrong_factor_count():
    with pytest.raises(ValueError):
        cnn.PixelShuffle2D((2, 3, 4))


def test_sparse_embedding_gradient_is_row_sparse():
    layer = cnn.SparseEmbedding(10, 5)
    layer.initialize(ctx=CPU)
    with mx.autograd.record():
        out = layer(mx.nd.array([3, 4, 2, 3], ctx=CPU))
    out.backward()
    g = layer.weight.grad()
    assert out.shape == (4, 5)
    assert isinstance(g, RowSparseNDArray) and not g.densified()
    np.testing.assert_array_equal(g.indices.asnumpy(), [2, 3, 4])
    np.testing.assert_array_equal(g.data.asnumpy()[1], [2.0] * 5)
    assert repr(layer) == "SparseEmbedding(10 -> 5, float32)"
