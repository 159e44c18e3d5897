"""Convolutional recurrent cells: the port of
`mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py` (parity
`python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py`, Conv{1,2,3}D{RNN,LSTM,
GRU}Cell): the i2h and h2h projections are convolutions over spatial
feature maps (cuDNN on a card) instead of dense products; states are
(batch, channels, *spatial).

`input_shape` is (channels, *spatial) and is required, as in the
reference: the states' spatial dims follow from it."""
from __future__ import annotations

from ...rnn.rnn_cell import HybridRecurrentCell
from ....base import MXNetError

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    assert len(v) == n
    return tuple(v)


class _BaseConvRNNCell(HybridRecurrentCell):
    """Shared conv-cell machinery (reference conv_rnn_cell.py:37)."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dims, conv_layout, activation,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_channels = hidden_channels
        self._input_shape = tuple(input_shape)
        self._conv_layout = conv_layout
        self._activation = activation
        self._dims = dims

        self._i2h_kernel = _tup(i2h_kernel, dims)
        self._h2h_kernel = _tup(h2h_kernel, dims)
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise MXNetError(
                    f"h2h_kernel must be odd to preserve spatial dims, got "
                    f"{self._h2h_kernel} (reference conv_rnn_cell.py:68)")
        self._i2h_pad = _tup(i2h_pad, dims)
        self._i2h_dilate = _tup(i2h_dilate, dims)
        self._h2h_dilate = _tup(h2h_dilate, dims)
        # h2h 'same' padding so the state spatial dims are preserved
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))

        in_channels = self._input_shape[0]
        spatial = self._input_shape[1:]
        self._state_spatial = tuple(
            (s + 2 * p - d * (k - 1) - 1) + 1
            for s, p, d, k in zip(spatial, self._i2h_pad, self._i2h_dilate,
                                  self._i2h_kernel))

        ng = self._num_gates
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(ng * hidden_channels, in_channels)
            + self._i2h_kernel, init=i2h_weight_initializer,
            allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(ng * hidden_channels, hidden_channels)
            + self._h2h_kernel, init=h2h_weight_initializer,
            allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(ng * hidden_channels,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(ng * hidden_channels,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    @property
    def _num_gates(self):
        raise NotImplementedError

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hidden_channels) + self._state_spatial
        return [{"shape": shape, "__layout__": self._conv_layout}
                for _ in range(self._num_states)]

    def _conv_pair(self, F, inputs, state, i2h_weight, h2h_weight, i2h_bias,
                   h2h_bias):
        prefix = f"t{self._counter}_"
        ng = self._num_gates
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            dilate=self._i2h_dilate,
                            num_filter=ng * self._hidden_channels,
                            name=prefix + "i2h")
        h2h = F.Convolution(state, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            dilate=self._h2h_dilate,
                            num_filter=ng * self._hidden_channels,
                            name=prefix + "h2h")
        return i2h, h2h


class _ConvRNNCell(_BaseConvRNNCell):
    _num_states = 1

    @property
    def _num_gates(self):
        return 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_pair(F, inputs, states[0], i2h_weight,
                                   h2h_weight, i2h_bias, h2h_bias)
        out = self._get_activation(F, F.elemwise_add(i2h, h2h),
                                   self._activation)
        return out, [out]


class _ConvLSTMCell(_BaseConvRNNCell):
    _num_states = 2

    @property
    def _num_gates(self):
        return 4

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_pair(F, inputs, states[0], i2h_weight,
                                   h2h_weight, i2h_bias, h2h_bias)
        gates = F.elemwise_add(i2h, h2h)
        sl = F.SliceChannel(gates, num_outputs=4, axis=1)
        i = F.Activation(sl[0], act_type="sigmoid")
        f = F.Activation(sl[1], act_type="sigmoid")
        g = self._get_activation(F, sl[2], self._activation)
        o = F.Activation(sl[3], act_type="sigmoid")
        next_c = F.elemwise_add(F.elemwise_mul(f, states[1]),
                                F.elemwise_mul(i, g))
        next_h = F.elemwise_mul(o, self._get_activation(F, next_c,
                                                        self._activation))
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    _num_states = 1

    @property
    def _num_gates(self):
        return 3

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_pair(F, inputs, states[0], i2h_weight,
                                   h2h_weight, i2h_bias, h2h_bias)
        i2h_sl = F.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_sl = F.SliceChannel(h2h, num_outputs=3, axis=1)
        r = F.Activation(F.elemwise_add(i2h_sl[0], h2h_sl[0]),
                         act_type="sigmoid")
        z = F.Activation(F.elemwise_add(i2h_sl[1], h2h_sl[1]),
                         act_type="sigmoid")
        n = self._get_activation(
            F, F.elemwise_add(i2h_sl[2], F.elemwise_mul(r, h2h_sl[2])),
            self._activation)
        one = F.ones_like(z)
        out = F.elemwise_add(
            F.elemwise_mul(z, states[0]),
            F.elemwise_mul(F.elemwise_sub(one, z), n))
        return out, [out]


def _make(base, dims, doc_name, ref_line):
    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 conv_layout=None, activation="tanh", prefix=None,
                 params=None):
        base.__init__(self, input_shape, hidden_channels, i2h_kernel,
                      h2h_kernel, i2h_pad, i2h_dilate, h2h_dilate,
                      i2h_weight_initializer, h2h_weight_initializer,
                      i2h_bias_initializer, h2h_bias_initializer,
                      dims, conv_layout or "NC" + "DHW"[3 - dims:],
                      activation, prefix, params)

    cls = type(doc_name, (base,), {
        "__init__": __init__,
        "__doc__": f"{doc_name} (reference conv_rnn_cell.py:{ref_line}).",
    })
    return cls


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell", 218)
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell", 285)
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell", 352)
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell", 473)
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell", 545)
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell", 617)
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell", 738)
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell", 805)
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell", 872)
