"""ResNet v1 and v2: the port of
`mxnet_tpu/gluon/model_zoo/vision/resnet.py` (parity
`python/mxnet/gluon/model_zoo/vision/resnet.py`): "Deep Residual Learning
for Image Recognition" (v1) and "Identity Mappings in Deep Residual
Networks" (v2, pre-activation), in NCHW.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


def _downsample(channels, stride, in_channels):
    """1x1 convolution + BatchNorm: a v1 unit's projection shortcut."""
    down = nn.HybridSequential(prefix="")
    down.add(nn.Conv2D(channels, kernel_size=1, strides=stride,
                       use_bias=False, in_channels=in_channels))
    down.add(nn.BatchNorm())
    return down


class BasicBlockV1(HybridBlock):
    """Two 3x3 convolutions with BatchNorm, ReLU after the sum."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNorm())
        self.downsample = _downsample(channels, stride, in_channels) \
            if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    """1x1 (with the stride) -> 3x3 -> 1x1, each with BatchNorm, ReLU
    after the sum."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1))
        self.body.add(nn.BatchNorm())
        self.downsample = _downsample(channels, stride, in_channels) \
            if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    """Pre-activation: (BatchNorm, ReLU, 3x3 convolution) twice."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels, 1, channels)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels) \
            if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    """Pre-activation bottleneck."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels) \
            if downsample else None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = F.Activation(self.bn3(x), act_type="relu")
        return self.conv3(x) + residual


def _make_layer(block, layers, channels, stride, stage_index, in_channels):
    layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
    with layer.name_scope():
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, prefix=""))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            prefix=""))
    return layer


class ResNetV1(HybridBlock):
    """ResNet v1: a 7x7/2 convolution, BatchNorm, ReLU and 3x3/2 max pool
    (or one 3x3 convolution with ``thumbnail``), the stages, a global
    average pool and a Dense layer of ``classes``."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("layers needs one entry less than channels")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                    i + 1, in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """ResNet v2 (pre-activation), with a BatchNorm of the input first."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("layers needs one entry less than channels")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                self.features.add(_make_layer(
                    block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                    i + 1, in_channels=in_channels))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# depth -> (block kind, units per stage, channels)
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}

resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2}]


def get_resnet(version, num_layers, pretrained=False, ctx=None,
               root="~/.mxnet/models", **kwargs):
    """A ResNet of ``version`` 1 or 2 and depth ``num_layers``; with
    ``pretrained``, its parameters loaded onto ``ctx`` from
    ``{root}/resnet{num_layers}_v{version}.params`` (`model_store`, which
    raises `FileNotFoundError` without the file)."""
    if num_layers not in resnet_spec:
        raise ValueError(f"Invalid number of layers: {num_layers}. Options "
                         f"are {sorted(resnet_spec)}")
    if version not in (1, 2):
        raise ValueError(f"Invalid resnet version: {version}. Options are 1 "
                         "and 2.")
    block_type, layers, channels = resnet_spec[num_layers]
    block_class = resnet_block_versions[version - 1][block_type]
    net = resnet_net_versions[version - 1](block_class, layers, channels,
                                           **kwargs)
    if pretrained:
        from ..model_store import get_model_file

        net.load_parameters(get_model_file(
            f"resnet{num_layers}_v{version}", root=root), ctx=ctx)
    return net


def _named(version, depth):
    def make(**kwargs):
        return get_resnet(version, depth, **kwargs)
    make.__name__ = make.__qualname__ = f"resnet{depth}_v{version}"
    make.__doc__ = f"ResNet-{depth} v{version}."
    return make


resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1, resnet152_v1 = (
    _named(1, d) for d in (18, 34, 50, 101, 152))
resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2 = (
    _named(2, d) for d in (18, 34, 50, 101, 152))
