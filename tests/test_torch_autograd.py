"""The port's autograd (`mxnet_tpu_torch.autograd`) held to the JAX
package's: each case below is written against the package it is given and
runs on both (the port on ``mx.cpu()``), and both give the same arrays, at
rtol 1e-5 / atol 1e-6 (`tests/python/unittest/test_autograd.py`'s
tolerance), and the values that test expects. The cases are that file's,
and `test_graph_image_ops.py`'s writes to recorded arrays.

Only the port computes second derivatives (``grad(create_graph=True)``;
the JAX package raises there), so that case is held to the closed form.
"""
import numpy as np
import pytest

import mxnet_tpu
import mxnet_tpu_torch
from mxnet_tpu_torch.base import MXNetError


def _arr(mx, value):
    return mx.nd.array(np.asarray(value, np.float32), ctx=mx.cpu())


def simple_grad(mx):
    x = _arr(mx, [1.0, 2.0, 3.0])
    x.attach_grad()
    with mx.autograd.record():
        y = (x * x * 2.0).sum()
    y.backward()
    return [x.grad, 4.0 * np.array([1.0, 2.0, 3.0])]


def chain_grad(mx):
    x = _arr(mx, [[1.0, 2.0], [3.0, 4.0]])
    w = _arr(mx, [[0.5, -0.5], [1.0, 2.0]])
    x.attach_grad()
    w.attach_grad()
    with mx.autograd.record():
        z = (mx.nd.dot(x, w) ** 2).sum()
    z.backward()
    xn, wn = x.asnumpy(), w.asnumpy()
    y = xn @ wn
    return [x.grad, 2 * y @ wn.T, w.grad, 2 * xn.T @ y]


def head_gradient(mx):
    x = _arr(mx, [1.0, 2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * 3.0
    y.backward(_arr(mx, [10.0, 100.0]))
    return [x.grad, [30.0, 300.0]]


def grad_req_add(mx):
    x = _arr(mx, [1.0, 2.0])
    x.attach_grad(grad_req="add")
    for _ in range(3):
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward()
    return [x.grad, 3 * 2 * np.array([1.0, 2.0])]


def grad_req_write_and_null(mx):
    x, n = _arr(mx, [1.0, 2.0]), _arr(mx, [3.0, 4.0])
    x.attach_grad()
    n.attach_grad(grad_req="null")
    for _ in range(2):
        with mx.autograd.record():
            y = (x * x * n).sum()
        y.backward()
    return [x.grad, 2 * np.array([3.0, 8.0]), n.grad, [0.0, 0.0]]


def pause(mx):
    x = _arr(mx, [1.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * 2
        with mx.autograd.pause():
            z = y * 3  # not recorded
        w = y * 5
    w.backward()
    return [x.grad, [10.0], z, [6.0]]


def training_modes(mx):
    ag = mx.autograd
    seen = [ag.is_training(), ag.is_recording()]
    with ag.record():
        seen += [ag.is_training(), ag.is_recording()]
        with ag.predict_mode():
            seen.append(ag.is_training())
        with ag.pause():
            seen += [ag.is_training(), ag.is_recording()]
    seen.append(ag.is_recording())
    with ag.train_mode():
        seen.append(ag.is_training())
    prev = ag.set_training(True)
    seen += [prev, ag.set_training(prev), ag.set_recording(False)]
    return [np.asarray(seen, np.float32),
            [0, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 0]]


def retain_graph(mx):
    x = _arr(mx, [3.0])
    x.attach_grad()
    with mx.autograd.record():
        y = (x * x).sum()
    y.backward(retain_graph=True)
    first = x.grad.asnumpy()
    y.backward()
    return [first, [6.0], x.grad, [6.0]]


def grad_function(mx):
    x = _arr(mx, [1.0, 2.0, 3.0])
    x.attach_grad()
    with mx.autograd.record():
        y = (x ** 3).sum()
    gr = mx.autograd.grad([y], x)
    return [gr, 3 * np.array([1.0, 4.0, 9.0]), x.grad, [0.0, 0.0, 0.0]]


def custom_function(mx):
    class Sigmoid(mx.autograd.Function):
        def forward(self, x):
            y = 1.0 / (1.0 + mx.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    x = _arr(mx, [0.0, 1.0, -1.0])
    x.attach_grad()
    with mx.autograd.record():
        y = Sigmoid()(x) * 2
    y.backward()
    sig = 1 / (1 + np.exp(-np.array([0.0, 1.0, -1.0])))
    return [y, 2 * sig, x.grad, 2 * sig * (1 - sig)]


def detach(mx):
    x = _arr(mx, [2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * 4
        z = y.detach() * x
    z.backward()
    return [x.grad, [8.0]]


def mark_variables(mx):
    x = _arr(mx, [1.0, 2.0])
    g = mx.nd.zeros((2,), ctx=mx.cpu())
    mx.autograd.mark_variables([x], [g])
    with mx.autograd.record():
        y = (x * 5).sum()
    y.backward()
    return [g, [5.0, 5.0]]


def getitem_inside_record(mx):
    x = _arr(mx, np.arange(12).reshape(3, 4))
    x.attach_grad()
    with mx.autograd.record():
        loss = (x[1] * x[1]).sum() + x[:, 2].sum() + x[2, 3] * 10
    loss.backward()
    expect = np.zeros((3, 4), np.float32)
    expect[1] = 2 * np.arange(4, 8)
    expect[:, 2] += 1
    expect[2, 3] += 10
    return [x.grad, expect]


def getitem_advanced_index(mx):
    x = _arr(mx, np.arange(10))
    x.attach_grad()
    idx = _arr(mx, [1, 3, 3])
    with mx.autograd.record():
        loss = x[idx].sum()
    loss.backward()
    expect = np.zeros(10, np.float32)
    expect[1], expect[3] = 1, 2
    return [x.grad, expect]


def setitem_gradients(mx):
    """``y[0] = v`` inside record: gradients flow around and into the
    window."""
    x = _arr(mx, np.arange(6).reshape(2, 3))
    x.attach_grad()
    v = _arr(mx, [10.0, 20.0, 30.0])
    v.attach_grad()
    with mx.autograd.record():
        y = x * 3
        y[0] = v
        loss = (y * y).sum()
    loss.backward()
    return [x.grad, [[0, 0, 0], 18 * np.arange(3, 6)],
            v.grad, 2 * np.array([10.0, 20.0, 30.0])]


def setitem_on_leaf(mx):
    """Writing a marked leaf: its gradient is that of the value recording
    saw first, zero in the overwritten window."""
    w = _arr(mx, np.ones(3))
    w.attach_grad()
    with mx.autograd.record():
        w[1:] = 5.0
        loss = (w * w).sum()
    loss.backward()
    return [w.grad, [2.0, 0.0, 0.0], w, [1.0, 5.0, 5.0]]


def setitem_scalar_int_key(mx):
    x = _arr(mx, np.zeros((2, 2)))
    x.attach_grad()
    with mx.autograd.record():
        y = x + 1
        y[1] = 0.0
        loss = y.sum()
    loss.backward()
    return [x.grad, [[1, 1], [0, 0]], y, [[1, 1], [0, 0]]]


def inplace_add_after_use(mx):
    """``y += 10`` on an array that recorded ops already read: they keep the
    value they read, and later reads see the new one."""
    x = _arr(mx, [1.0, 2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * x
        z = y * 3
        y += 10
        loss = (y * y).sum() + z.sum()
    loss.backward()
    xn = np.array([1.0, 2.0])
    return [x.grad, 2 * (xn ** 2 + 10) * 2 * xn + 3 * 2 * xn,
            y, xn ** 2 + 10]


def sgd_update_keeps_leaf(mx):
    """An optimizer's ``out=w`` between steps: the next step's gradient is
    taken at the new weight."""
    w = _arr(mx, [1.0, -2.0])
    w.attach_grad()
    for _ in range(2):
        with mx.autograd.record():
            loss = (w * w).sum()
        loss.backward()
        mx.nd.sgd_update(w, w.grad, lr=0.25, out=w)
    return [w, [0.25, -0.5], w.grad, [1.0, -2.0]]


CASES = [simple_grad, chain_grad, head_gradient, grad_req_add,
         grad_req_write_and_null, pause, training_modes, retain_graph,
         grad_function, custom_function, detach, mark_variables,
         getitem_inside_record, getitem_advanced_index, setitem_gradients,
         setitem_on_leaf, setitem_scalar_int_key, inplace_add_after_use,
         sgd_update_keeps_leaf]


def _numpy(v):
    return np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v,
                      np.float32)


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_port_matches_jax_and_expected(case):
    got, want = case(mxnet_tpu_torch), case(mxnet_tpu)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_numpy(g), _numpy(w), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{case.__name__} {k}")
    for k in range(0, len(got), 2):  # (array, the value it should have)
        np.testing.assert_allclose(_numpy(got[k]), _numpy(got[k + 1]),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{case.__name__} {k}")


def test_second_derivative_through_create_graph():
    mx = mxnet_tpu_torch
    x = _arr(mx, [1.0, 2.0, -1.5])
    x.attach_grad()
    with mx.autograd.record():
        y = (x ** 3).sum()
        dx = mx.autograd.grad(y, x, create_graph=True)  # 3 x^2
        z = (dx * dx).sum()                              # 9 x^4
    z.backward()
    xn = np.array([1.0, 2.0, -1.5], np.float32)
    np.testing.assert_allclose(dx.asnumpy(), 3 * xn ** 2, rtol=1e-6)
    np.testing.assert_allclose(x.grad.asnumpy(), 36 * xn ** 3, rtol=1e-6)


def test_writes_under_record_follow_the_new_value():
    """``*=`` and ``out=`` inside record rebind the array to the result,
    which later ops read and differentiate through. (The JAX package's tape
    keeps the array's old producer there, so its gradient of the same code
    leaves out the write; only the closed form holds the port.)"""
    mx = mxnet_tpu_torch
    x = _arr(mx, [1.0, 2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * x
        z = y * 3
        y *= 2                             # y = 2 x^2
        mx.nd.elemwise_mul(y, y, out=z)    # z = 4 x^4
        loss = z.sum()
    loss.backward()
    xn = np.array([1.0, 2.0], np.float32)
    np.testing.assert_allclose(z.asnumpy(), 4 * xn ** 4)
    np.testing.assert_allclose(x.grad.asnumpy(), 16 * xn ** 3)


def test_errors():
    mx = mxnet_tpu_torch
    x = _arr(mx, [1.0])
    x.attach_grad()
    y = x * 2  # not recorded
    with pytest.raises(MXNetError):
        y.backward()
    with mx.autograd.record():
        y = x * 2
    with pytest.raises(MXNetError):
        mx.autograd.grad(y, _arr(mx, [1.0]))
    # the JAX package raises here too (`mxnet_tpu/autograd.py:363-364`)
    with pytest.raises(MXNetError, match="HybridBlock.export"):
        mx.autograd.get_symbol(y)
