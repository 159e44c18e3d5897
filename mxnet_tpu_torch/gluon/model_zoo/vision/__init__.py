"""gluon.model_zoo.vision: the ResNet family (parity
`mxnet_tpu/gluon/model_zoo/vision/__init__.py` `get_model`).

The other families of the JAX package's model zoo (alexnet, vgg, densenet,
squeezenet, inception, mobilenet) are not ported yet (ROADMAP.md queue A):
`get_model` names them and raises NotImplementedError.
"""
from .resnet import *  # noqa: F401,F403
from . import resnet as _resnet

_NOT_PORTED = ("vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
               "vgg16_bn", "vgg19_bn", "alexnet", "densenet121",
               "densenet161", "densenet169", "densenet201", "squeezenet1.0",
               "squeezenet1.1", "inceptionv3", "mobilenet1.0",
               "mobilenet0.75", "mobilenet0.5", "mobilenet0.25",
               "mobilenetv2_1.0", "mobilenetv2_0.75", "mobilenetv2_0.5",
               "mobilenetv2_0.25")


def get_model(name, **kwargs):
    """A model by name, e.g. ``"resnet50_v1"``; ``kwargs`` go to its
    constructor (``classes``, ``thumbnail``). ``pretrained=True`` raises:
    there are no weight files."""
    models = {f"resnet{n}_v{v}": getattr(_resnet, f"resnet{n}_v{v}")
              for n in (18, 34, 50, 101, 152) for v in (1, 2)}
    name = name.lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name} is not ported yet (ROADMAP.md queue A, the other "
            "model-zoo families)")
    if name not in models:
        raise ValueError(
            f"Model {name} is not supported. Available options are\n\t"
            + "\n\t".join(sorted(models)))
    return models[name](**kwargs)
