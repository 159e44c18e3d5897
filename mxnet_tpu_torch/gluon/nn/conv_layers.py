"""gluon.nn convolution and pooling layers: the port of
`mxnet_tpu/gluon/nn/conv_layers.py` (Conv1D/2D/3D, their transposes
Conv1D/2D/3DTranspose over the Deconvolution op, the max, average and
global pooling layers in 1, 2 and 3 dims, ReflectionPad2D), NCHW-family
layouts only.
"""
from __future__ import annotations

import numpy as _np

from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]

_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _to_tuple(v, n):
    if isinstance(v, (int, _np.integer)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


class _Conv(HybridBlock):
    """A convolution (``op_name`` Convolution, weight (channels,
    in_channels / groups, *kernel)) or a transposed one (Deconvolution,
    weight (in_channels, channels / groups, *kernel), ``adj`` its output
    padding), with an optional bias and activation."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        ndim = len(kernel_size)
        if layout != _LAYOUTS[ndim]:
            raise ValueError(f"Only supports '{_LAYOUTS[ndim]}' layout for "
                             "now")
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            self._kwargs = {
                "kernel": tuple(kernel_size),
                "stride": _to_tuple(strides, ndim),
                "dilate": _to_tuple(dilation, ndim),
                "pad": _to_tuple(padding, ndim), "num_filter": channels,
                "num_group": groups, "no_bias": not use_bias,
                "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = tuple(adj)
            self._op_name = op_name
            self.weight = self.params.get("weight",
                                          shape=self._weight_shape(
                                              in_channels),
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _weight_shape(self, in_channels):
        groups = self._kwargs["num_group"]
        if self._op_name == "Convolution":
            io = (self._channels, in_channels // groups)
        else:
            io = (in_channels, self._channels // groups)
        return io + tuple(self._kwargs["kernel"])

    def infer_shape(self, x, *args):
        in_channels = x.shape[1]
        self.weight.shape = self._weight_shape(in_channels)
        self._in_channels = in_channels

    def hybrid_forward(self, F, x, weight, bias=None):
        args = (x, weight) if bias is None else (x, weight, bias)
        act = getattr(F, self._op_name)(*args, name="fwd", **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def _alias(self):
        return "conv"

    def __repr__(self):
        k = self._kwargs
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride}"
        n = len(k["kernel"])
        if k["pad"] != (0,) * n:
            s += ", padding={pad}"
        if k["dilate"] != (1,) * n:
            s += ", dilation={dilate}"
        if k.get("adj", (0,) * n) != (0,) * n:
            s += ", output_padding={adj}"
        if k["num_group"] != 1:
            s += ", groups={num_group}"
        if self.bias is None:
            s += ", bias=False"
        if self.act:
            s += ", {}".format(self.act)
        s += ")"
        shape = self.weight.shape
        return s.format(name=self.__class__.__name__,
                        mapping="{0} -> {1}".format(
                            shape[1] if shape[1] else None, shape[0]), **k)


def _conv_class(ndim):
    class Conv(_Conv):
        def __init__(self, channels, kernel_size, strides=1, padding=0,
                     dilation=1, groups=1, layout=_LAYOUTS[ndim],
                     activation=None, use_bias=True, weight_initializer=None,
                     bias_initializer="zeros", in_channels=0, **kwargs):
            kernel_size = _to_tuple(kernel_size, ndim)
            if len(kernel_size) != ndim:
                raise ValueError(f"kernel_size must be a number or a list of "
                                 f"{ndim} ints")
            super().__init__(channels, kernel_size, strides, padding,
                             dilation, groups, layout, in_channels,
                             activation, use_bias, weight_initializer,
                             bias_initializer, **kwargs)

    Conv.__name__ = Conv.__qualname__ = f"Conv{ndim}D"
    Conv.__doc__ = f"A {ndim}-d convolution ({_LAYOUTS[ndim]})."
    return Conv


Conv1D, Conv2D, Conv3D = (_conv_class(n) for n in (1, 2, 3))


def _conv_transpose_class(ndim):
    class ConvTranspose(_Conv):
        def __init__(self, channels, kernel_size, strides=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     layout=_LAYOUTS[ndim], activation=None, use_bias=True,
                     weight_initializer=None, bias_initializer="zeros",
                     in_channels=0, **kwargs):
            kernel_size = _to_tuple(kernel_size, ndim)
            output_padding = _to_tuple(output_padding, ndim)
            if len(kernel_size) != ndim or len(output_padding) != ndim:
                raise ValueError(f"kernel_size and output_padding must be "
                                 f"numbers or lists of {ndim} ints")
            super().__init__(channels, kernel_size, strides, padding,
                             dilation, groups, layout, in_channels,
                             activation, use_bias, weight_initializer,
                             bias_initializer, op_name="Deconvolution",
                             adj=output_padding, **kwargs)
            self.outpad = output_padding

    name = f"Conv{ndim}DTranspose"
    ConvTranspose.__name__ = ConvTranspose.__qualname__ = name
    ConvTranspose.__doc__ = (f"A {ndim}-d transposed convolution "
                             f"({_LAYOUTS[ndim]}).")
    return ConvTranspose


Conv1DTranspose, Conv2DTranspose, Conv3DTranspose = (
    _conv_transpose_class(n) for n in (1, 2, 3))


class _Pooling(HybridBlock):
    """The Pooling op with fixed attributes."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", layout=None,
                 count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        ndim = len(pool_size)
        if layout != _LAYOUTS[ndim]:
            raise ValueError(f"Only supports '{_LAYOUTS[ndim]}' layout for "
                             "now")
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": _to_tuple(strides, ndim),
            "pad": _to_tuple(padding, ndim), "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, name="fwd", **self._kwargs)

    def __repr__(self):
        return ("{name}(size={kernel}, stride={stride}, padding={pad}, "
                "ceil_mode={ceil_mode})").format(
                    name=self.__class__.__name__,
                    ceil_mode=self._kwargs["pooling_convention"] == "full",
                    **self._kwargs)


def _pool_class(ndim, pool_type):
    kind = "Max" if pool_type == "max" else "Avg"

    if pool_type == "max":
        def __init__(self, pool_size=2, strides=None, padding=0,
                     layout=_LAYOUTS[ndim], ceil_mode=False, **kwargs):
            _Pooling.__init__(self, _to_tuple(pool_size, ndim), strides,
                              padding, ceil_mode, False, "max", layout,
                              **kwargs)
    elif ndim == 1:  # the reference's argument order differs in 1-d
        def __init__(self, pool_size=2, strides=None, padding=0,
                     layout=_LAYOUTS[ndim], ceil_mode=False,
                     count_include_pad=True, **kwargs):
            _Pooling.__init__(self, _to_tuple(pool_size, ndim), strides,
                              padding, ceil_mode, False, "avg", layout,
                              count_include_pad, **kwargs)
    else:
        def __init__(self, pool_size=2, strides=None, padding=0,
                     ceil_mode=False, layout=_LAYOUTS[ndim],
                     count_include_pad=True, **kwargs):
            _Pooling.__init__(self, _to_tuple(pool_size, ndim), strides,
                              padding, ceil_mode, False, "avg", layout,
                              count_include_pad, **kwargs)

    name = f"{kind}Pool{ndim}D"
    return type(name, (_Pooling,), {
        "__init__": __init__, "__qualname__": name,
        "__doc__": f"{kind} pooling over {ndim}-d windows."})


def _global_pool_class(ndim, pool_type):
    kind = "Max" if pool_type == "max" else "Avg"

    def __init__(self, layout=_LAYOUTS[ndim], **kwargs):
        _Pooling.__init__(self, (1,) * ndim, None, 0, True, True, pool_type,
                          layout, **kwargs)

    name = f"Global{kind}Pool{ndim}D"
    return type(name, (_Pooling,), {
        "__init__": __init__, "__qualname__": name,
        "__doc__": f"{kind} over each channel's whole {ndim}-d extent."})


MaxPool1D, MaxPool2D, MaxPool3D = (_pool_class(n, "max") for n in (1, 2, 3))
AvgPool1D, AvgPool2D, AvgPool3D = (_pool_class(n, "avg") for n in (1, 2, 3))
GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D = (
    _global_pool_class(n, "max") for n in (1, 2, 3))
GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D = (
    _global_pool_class(n, "avg") for n in (1, 2, 3))


class ReflectionPad2D(HybridBlock):
    """Pads H and W by reflecting the input at its edges."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, (int, _np.integer)):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        if len(padding) != 8:
            raise ValueError("padding must be a number or 8 ints")
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
