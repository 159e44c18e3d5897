"""The port's mobilenet v1 and v2 and inception v3 held to the JAX
package's on the CPU, as `test_torch_model_zoo.py` holds the other
families (`hold_to_jax`: the JAX package's saved weights, one forward in
predict mode, rtol 1e-4 / atol 1e-5). `Inception3`, whose widths are
fixed, is held block by block (the five mixed blocks and the auxiliary
head) at a small spatial size. Hybridized mobilenets (depthwise
convolutions) give the eager forward in the port.
"""
import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.model_zoo import vision as jv
from mxnet_tpu.gluon.model_zoo.vision import inception as jinc
from mxnet_tpu_torch.gluon.model_zoo import vision as tv
from mxnet_tpu_torch.gluon.model_zoo.vision import inception as tinc
from test_torch_model_zoo import TOL, hold_to_jax

MOBILE = {
    "mobilenet0.25": lambda v: v.MobileNet(0.25, classes=10,
                                           prefix="mobilenet0_"),
    "mobilenetv2_0.25": lambda v: v.MobileNetV2(0.25, classes=10,
                                                prefix="mobilenetv20_"),
}

# block -> (constructor(inception module), input channels, spatial size)
INCEPTION_BLOCKS = {
    "A": (lambda m: m._make_A(32, "A1_"), 192, 9),
    "B": (lambda m: m._make_B("B_"), 288, 9),
    "C": (lambda m: m._make_C(128, "C1_"), 768, 9),
    "D": (lambda m: m._make_D("D_"), 768, 9),
    "E": (lambda m: m._make_E("E1_"), 1280, 9),
    "aux": (lambda m: m.make_aux(10), 768, 17),
}


@pytest.mark.parametrize("name", list(MOBILE))
def test_mobilenet_matches_jax_from_its_saved_weights(name, tmp_path):
    make = MOBILE[name]
    net = hold_to_jax(lambda: make(jv), lambda: make(tv), (2, 3, 32, 32),
                      str(tmp_path / "net.params"))
    x = np.random.RandomState(1).uniform(-1, 1, (2, 3, 32, 32)).astype(
        np.float32)
    with mx.cpu():
        eager = net(mx.nd.array(x)).asnumpy()
        net.hybridize()
        np.testing.assert_allclose(net(mx.nd.array(x)).asnumpy(), eager,
                                   **TOL)


@pytest.mark.parametrize("block", list(INCEPTION_BLOCKS))
def test_inception_block_matches_jax(block, tmp_path):
    make, channels, size = INCEPTION_BLOCKS[block]
    hold_to_jax(lambda: make(jinc), lambda: make(tinc),
                (1, channels, size, size), str(tmp_path / "block.params"))
