"""The symbolic ResNet: the port of `mxnet_tpu/models/resnet.py` (parity
the reference's `example/image-classification/symbols/resnet.py`), with
the same node names, so `Module.fit` and the fused train step drive the
ResNet-50 that `bench.py`'s `_measure_module` measures, and its symbol
JSON is the JAX package's text."""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["resnet", "resnet50_symbol"]


def _residual_unit(data, num_filter, stride, dim_match, name,
                   bottle_neck=True, bn_mom=0.9):
    """One residual block (reference resnet.py `residual_unit`)."""
    if bottle_neck:
        bn1 = sym.BatchNorm(data=data, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(data=act1, num_filter=num_filter // 4,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(data=act2, num_filter=num_filter // 4,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(data=conv2, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn3")
        act3 = sym.Activation(data=bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(data=act3, num_filter=num_filter,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv3")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(data=act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + "_sc")
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data=data, fix_gamma=False, eps=2e-5,
                        momentum=bn_mom, name=name + "_bn1")
    act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
    conv1 = sym.Convolution(data=act1, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True,
                            name=name + "_conv1")
    bn2 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=2e-5,
                        momentum=bn_mom, name=name + "_bn2")
    act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
    conv2 = sym.Convolution(data=act2, num_filter=num_filter, kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True,
                            name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(data=act1, num_filter=num_filter,
                                   kernel=(1, 1), stride=stride, no_bias=True,
                                   name=name + "_sc")
    return conv2 + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9):
    """Build a symbolic ResNet (reference resnet.py `resnet`)."""
    data = sym.Variable(name="data")
    data = sym.BatchNorm(data=data, fix_gamma=True, eps=2e-5,
                         momentum=bn_mom, name="bn_data")
    height = image_shape[1]
    if height <= 32:  # cifar-style stem
        body = sym.Convolution(data=data, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name="conv0")
    else:  # imagenet stem
        body = sym.Convolution(data=data, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name="conv0")
        body = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name="bn0")
        body = sym.Activation(data=body, act_type="relu", name="relu0")
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                           pad=(1, 1), pool_type="max")

    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = _residual_unit(body, filter_list[i + 1], stride, False,
                              name=f"stage{i + 1}_unit1",
                              bottle_neck=bottle_neck, bn_mom=bn_mom)
        for j in range(units[i] - 1):
            body = _residual_unit(body, filter_list[i + 1], (1, 1), True,
                                  name=f"stage{i + 1}_unit{j + 2}",
                                  bottle_neck=bottle_neck, bn_mom=bn_mom)
    bn1 = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                        momentum=bn_mom, name="bn1")
    relu1 = sym.Activation(data=bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(data=relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")


def resnet50_symbol(num_classes=1000, image_shape=(3, 224, 224)):
    """ResNet-50 v1 (the headline benchmark network) as a Symbol."""
    return resnet(units=[3, 4, 6, 3], num_stages=4,
                  filter_list=[64, 256, 512, 1024, 2048],
                  num_classes=num_classes, image_shape=image_shape,
                  bottle_neck=True)
