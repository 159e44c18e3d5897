"""The port's vision model zoo (`gluon.model_zoo.vision`) held to the JAX
package's on the CPU: alexnet, vgg (with and without BatchNorm),
squeezenet 1.0 and 1.1 and densenet here; mobilenet v1 and v2 and
inception v3 in `test_torch_model_zoo_mobile_inception.py`. Each family at
a narrow configuration of its own constructor is built in both packages
under one prefix (equal parameter names), initialised by the JAX package
with its BatchNorm moving stats drawn from a seed, saved there by
`save_parameters` and loaded into the port; one forward in predict mode
(Dropout is the identity there) on the same numpy input agrees within
rtol 1e-4 / atol 1e-5. Squeezenet's last pool (13 x 13) needs 224 x 224
input: at 64 x 64 the JAX package gives an empty output and the port
raises, as torch's pooling does. Each full-size network's parameter count
(the JAX package's pinned numbers,
`tests/python/unittest/test_model_zoo_strict.py`) and output shape are
checked in the port alone.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.model_zoo import vision as jv
from mxnet_tpu_torch.gluon.model_zoo import vision as tv

CPU = mx.cpu()
TOL = {"rtol": 1e-4, "atol": 1e-5}

# name -> (constructor(vision module), input shape)
NARROW = {
    "alexnet": (lambda v: v.AlexNet(classes=10, prefix="alexnet0_"),
                (2, 3, 64, 64)),
    "vgg": (lambda v: v.VGG([1] * 5, [8, 16, 16, 32, 32], classes=10,
                            prefix="vgg0_"), (2, 3, 32, 32)),
    "vgg_bn": (lambda v: v.VGG([1, 2, 1, 1, 1], [8, 16, 16, 32, 32],
                               classes=10, batch_norm=True,
                               prefix="vgg1_"), (2, 3, 32, 32)),
    "squeezenet1.0": (lambda v: v.SqueezeNet("1.0", classes=10,
                                             prefix="squeezenet0_"),
                      (1, 3, 224, 224)),
    "squeezenet1.1": (lambda v: v.SqueezeNet("1.1", classes=10,
                                             prefix="squeezenet1_"),
                      (1, 3, 224, 224)),
    "densenet": (lambda v: v.DenseNet(16, 8, (2, 2, 2, 2), classes=10,
                                      prefix="densenet0_"),
                 (1, 3, 224, 224)),
}

def jax_net_and_file(make, shape, path, seed=0):
    """The JAX net built by ``make``, initialised (Xavier) at ``shape``,
    its moving stats drawn from ``seed``; saved to ``path``. Returns it
    and the input."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    jmx.random.seed(seed)
    net = make()
    net.initialize(jmx.init.Xavier())
    net.hybridize()  # one compiled program, not one an op
    net(jmx.nd.array(x))
    for name, p in sorted(net.collect_params().items()):
        if name.endswith("running_mean"):
            p.set_data(jmx.nd.array(rng.uniform(-0.1, 0.1, p.shape)))
        elif name.endswith("running_var"):
            p.set_data(jmx.nd.array(rng.uniform(0.5, 1.5, p.shape)))
    net.save_parameters(path)
    jmx.nd.load(path)  # the JAX package writes its files asynchronously
    return net, x


def hold_to_jax(jmake, tmake, shape, path):
    jnet, x = jax_net_and_file(jmake, shape, path)
    want = jnet(jmx.nd.array(x)).asnumpy()
    with mx.cpu():
        tnet = tmake()
        assert sorted(tnet.collect_params().keys()) == \
            sorted(jnet.collect_params().keys())
        tnet.load_parameters(path, ctx=CPU)
        got = tnet(mx.nd.array(x, ctx=CPU)).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    return tnet


@pytest.mark.parametrize("name", list(NARROW))
def test_family_matches_jax_from_its_saved_weights(name, tmp_path):
    make, shape = NARROW[name]
    hold_to_jax(lambda: make(jv), lambda: make(tv), shape,
                str(tmp_path / "net.params"))


# name, input size, parameters (the JAX package's pinned counts)
FULL = [("alexnet", 224, 61_100_840), ("vgg16", 224, 138_357_544),
        ("squeezenet1.1", 224, 1_235_496), ("mobilenet1.0", 32, 4_253_864),
        ("mobilenetv2_1.0", 32, 3_539_136), ("densenet121", 224, 8_062_504),
        ("inceptionv3", 299, 23_869_000)]


@pytest.mark.parametrize("name,size,count", FULL, ids=[f[0] for f in FULL])
def test_full_size_parameter_count_and_output(name, size, count):
    with mx.cpu():
        net = tv.get_model(name, classes=1000)
        net.initialize()
        out = net(mx.nd.zeros((1, 3, size, size)))
        assert out.shape == (1, 1000)
        assert sum(int(np.prod(p.shape))
                   for p in net.collect_params().values()) == count
