"""The port's mobilenets in training mode, held to the JAX package on the
CPU, beside the predict-mode forwards of
`test_torch_model_zoo_mobile_inception.py`.

Their training-mode BatchNorms (27 in v1, 53 in v2) normalise by batch
statistics that the Xavier-initialised depthwise stack has shrunk, so
fp32 rounding grows on its way back through them, by how much depending
on the batch and the input size; the JAX package's BatchNorm computes in
fp32 at any input type, so it has no float64 step to compare with. One
training-mode step from the JAX package's saved weights at 8 x 32 x 32:
the output, the loss and every gradient of both packages' fp32 steps
within `WITNESS` of the port's float64 step, each error over the array's
scale, the scale at least `WITNESS["floor"]` of the largest gradient's (a
gradient that is zero in exact arithmetic is rounding alone in fp32).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_torch_model_zoo import CPU, jax_net_and_file
from test_torch_model_zoo_mobile_inception import MOBILE

WITNESS = {"of_scale": 2e-3, "floor": 1e-3}
SHAPE = (8, 3, 32, 32)


def training_step(pkg, net, x, y, dtype="float32"):
    """One training-mode forward and backward: {output, loss, grad <name>}
    as float64 numpy."""
    if dtype != "float32":
        net.cast(dtype)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    ctx = pkg.cpu()
    with pkg.autograd.record(train_mode=True):
        out = net(pkg.nd.array(x, ctx=ctx, dtype=dtype))
        loss = loss_fn(out, pkg.nd.array(y, ctx=ctx, dtype=dtype))
    loss.backward()
    state = {"output": out.asnumpy(), "loss": loss.asnumpy()}
    state.update({f"grad {k}": p.grad().asnumpy()
                  for k, p in net._collect_params_with_prefix().items()
                  if p.grad_req != "null"})
    return {k: np.asarray(v, np.float64) for k, v in state.items()}


def errors_of_scale(got, witness):
    top = max(np.abs(v).max() for k, v in witness.items()
              if k.startswith("grad "))
    return {k: np.abs(got[k] - w).max()
            / max(np.abs(w).max(), WITNESS["floor"] * top)
            for k, w in witness.items()}


@pytest.mark.parametrize("name", list(MOBILE))
def test_mobilenet_training_step_against_jax_and_float64(name, tmp_path):
    make = MOBILE[name]
    path = str(tmp_path / "net.params")
    jnet, x = jax_net_and_file(lambda: make(jmx.gluon.model_zoo.vision),
                               SHAPE, path)
    y = np.random.RandomState(2).randint(0, 10, SHAPE[0]).astype(np.float32)
    want = training_step(jmx, jnet, x, y)
    steps = {}
    for dtype in ("float32", "float64"):
        with mx.cpu():
            net = make(mx.gluon.model_zoo.vision)
            net.load_parameters(path, ctx=CPU)
            steps[dtype] = training_step(mx, net, x, y, dtype)
    assert sorted(steps["float64"]) == sorted(want)
    for side, state in (("port", steps["float32"]), ("jax", want)):
        errs = errors_of_scale(state, steps["float64"])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= WITNESS["of_scale"], (side, worst, errs[worst])


def test_batch_norm_trains_in_float64_on_float64_data():
    rng = np.random.RandomState(3)
    x = rng.normal(2.0, 1e-3, (4, 3, 5, 5))
    gamma, beta = rng.uniform(0.5, 1.5, 3), rng.uniform(-1, 1, 3)
    with mx.cpu():
        out = mx.nd.BatchNorm(
            mx.nd.array(x, dtype="float64"),
            mx.nd.array(gamma, dtype="float64"),
            mx.nd.array(beta, dtype="float64"),
            mx.nd.zeros(3, dtype="float64"), mx.nd.ones(3, dtype="float64"),
            eps=1e-5, fix_gamma=False, _train=True)
    mean = x.mean(axis=(0, 2, 3), keepdims=True)
    var = x.var(axis=(0, 2, 3), keepdims=True)
    ref = (x - mean) / np.sqrt(var + 1e-5) * gamma.reshape(1, 3, 1, 1) \
        + beta.reshape(1, 3, 1, 1)
    assert out.dtype == np.float64
    np.testing.assert_allclose(out.asnumpy(), ref, rtol=1e-10, atol=1e-12)
