"""The port's model store (`gluon.model_zoo.model_store`) and
`get_model(pretrained=True)` held to the JAX package's (ROADMAP C.8: the
port's `get_resnet` raised `NotImplementedError` where the JAX package
loads ``{root}/resnet{n}_v{v}.params``). A `resnet18_v1` weight file saved
by the JAX package under a temporary ``root`` loads in both packages to
the same forward (within 1e-5); a missing file raises `FileNotFoundError`
naming its path in both; `get_model` serves exactly the JAX package's 34
names and raises `ValueError` on another.
"""
import os
import re

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.model_zoo import model_store as jstore
from mxnet_tpu.gluon.model_zoo import vision as jv
from mxnet_tpu_torch.gluon.model_zoo import model_store as tstore
from mxnet_tpu_torch.gluon.model_zoo import vision as tv

CPU = mx.cpu()


def test_pretrained_loads_the_same_weights(tmp_path):
    root = str(tmp_path)
    rng = np.random.RandomState(0)
    jmx.random.seed(0)
    src = jv.get_model("resnet18_v1", classes=10)
    src.initialize(jmx.init.Xavier())
    x = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    src(jmx.nd.array(x))
    path = os.path.join(root, "resnet18_v1.params")
    src.save_parameters(path)
    jmx.nd.load(path)  # the JAX package writes its files asynchronously
    assert tstore.get_model_file("resnet18_v1", root=root) == \
        jstore.get_model_file("resnet18_v1", root=root) == path
    want = jv.get_model("resnet18_v1", classes=10, pretrained=True,
                        root=root)(jmx.nd.array(x)).asnumpy()
    np.testing.assert_array_equal(want, src(jmx.nd.array(x)).asnumpy())
    net = tv.get_model("resnet18_v1", classes=10, pretrained=True,
                       root=root, ctx=CPU)
    got = net(mx.nd.array(x, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["resnet50_v2", "vgg11_bn", "mobilenet0.5",
                                  "squeezenet1.0"])
def test_missing_file_raises_with_its_path(tmp_path, name):
    root = str(tmp_path / "none")
    path = os.path.join(root, f"{name}.params")
    for vision in (jv, tv):
        with pytest.raises(FileNotFoundError, match=re.escape(path)):
            vision.get_model(name, pretrained=True, root=root)


def served_names(vision):
    """The names a package's `get_model` lists when asked for an unknown
    one."""
    with pytest.raises(ValueError, match="not supported") as err:
        vision.get_model("resnet0_v9")
    return set(str(err.value).split("\n\t")[1:])


def test_get_model_serves_exactly_the_jax_names():
    names = served_names(tv)
    assert names == served_names(jv) and len(names) == 34
    for name in names:
        net = tv.get_model(name.upper(), classes=7)
        assert type(net).__name__ == type(jv.get_model(name,
                                                       classes=7)).__name__
    tstore.purge(os.path.join(os.getcwd(), "no-such-model-store"))
