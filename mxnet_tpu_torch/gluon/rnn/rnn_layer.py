"""Fused recurrent layers: the port of `mxnet_tpu/gluon/rnn/rnn_layer.py`
(parity `python/mxnet/gluon/rnn/rnn_layer.py`).

RNN, LSTM and GRU over the fused `RNN` op (`ops/rnn.py`: cuDNN through
`torch._VF` on a card, one call a layer). The parameters are registered
per layer and direction (``l0_i2h_weight`` ...) as in the reference, so
checkpoints keep the same names, and concatenated into the op's flat
vector with `_rnn_param_concat` at each forward. Begin states are made on
the context of the inputs and in their dtype.
"""
from __future__ import annotations

from ... import ndarray as nd
from ...base import dtype_name
from ..block import HybridBlock
from . import rnn_cell

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), f"Invalid layout {layout}"
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer

        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        np_ = projection_size if projection_size else nh
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param(f"{j}{i}_i2h_weight", (ng * nh, ni),
                                     i2h_weight_initializer)
                self._register_param(f"{j}{i}_h2h_weight", (ng * nh, np_),
                                     h2h_weight_initializer)
                self._register_param(f"{j}{i}_i2h_bias", (ng * nh,),
                                     i2h_bias_initializer)
                self._register_param(f"{j}{i}_h2h_bias", (ng * nh,),
                                     h2h_bias_initializer)
                if projection_size:
                    self._register_param(f"{j}{i}_h2r_weight", (np_, nh),
                                         h2h_weight_initializer)
            ni = np_ * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        self._reg_params[name] = p
        setattr(self, name, p)
        return p

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = f"{shape[1] if shape[1] else None} -> {shape[0] // self._gates}"
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _alias(self):
        # may be called from Block.__init__ before _mode is assigned
        return getattr(self, "_mode", type(self).__name__.lower())

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(**info))
        return states

    def infer_shape(self, x, *args):
        ni = x.shape[-1] if self._layout[-1] == "C" else x.shape[-1]
        ng, nh = self._gates, self._hidden_size
        np_ = self._projection_size if self._projection_size else nh
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                self._reg_params[f"{j}{i}_i2h_weight"].shape = (ng * nh, ni)
            ni = np_ * self._dir

    def __call__(self, inputs, states=None, **kwargs):
        self.skip_states = states is None
        if states is None:
            if isinstance(inputs, nd.NDArray):
                batch_size = inputs.shape[self._layout.find("N")]
                states = self.begin_state(batch_size, ctx=inputs.context,
                                          dtype=dtype_name(inputs.dtype))
            else:
                states = self.begin_state(0)
        if isinstance(states, nd.NDArray):
            states = [states]
        return super().__call__(inputs, *states, **kwargs)

    def hybrid_forward(self, F, inputs, states=None, *extra_states, **params):
        if states is not None and not isinstance(states, (list, tuple)):
            states = [states] + list(extra_states)
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        # flat param vector in the fused op's layout: all weights
        # (layer-major, dir-minor, i2h then h2h), then all biases
        plist = []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                plist.append(params[f"{j}{i}_i2h_weight"])
                plist.append(params[f"{j}{i}_h2h_weight"])
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                plist.append(params[f"{j}{i}_i2h_bias"])
                plist.append(params[f"{j}{i}_h2h_bias"])
        if self._projection_size:
            for i in range(self._num_layers):
                for j in ["l", "r"][:self._dir]:
                    plist.append(params[f"{j}{i}_h2r_weight"])
        flat = F._internal._rnn_param_concat(*plist, dim=0)

        if self._mode == "lstm":
            h0, c0 = states
            out = F.RNN(inputs, flat, h0, c0, state_size=self._hidden_size,
                        num_layers=self._num_layers, mode=self._mode,
                        bidirectional=self._dir == 2, p=self._dropout,
                        projection_size=self._projection_size,
                        state_outputs=True)
            outputs, hT, cT = out
            new_states = [hT, cT]
        else:
            out = F.RNN(inputs, flat, states[0], state_size=self._hidden_size,
                        num_layers=self._num_layers, mode=self._mode,
                        bidirectional=self._dir == 2, p=self._dropout,
                        state_outputs=True)
            outputs, hT = out
            new_states = [hT]

        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        if self.skip_states:
            return outputs
        return outputs, new_states


class RNN(_RNNLayer):
    """Multi-layer Elman RNN with tanh/relu (reference rnn_layer.py:281)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference rnn_layer.py:383)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", projection_size=None, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", projection_size, **kwargs)

    def state_info(self, batch_size=0):
        # h state carries the projected size for LSTMP (reference
        # rnn_layer.py LSTM.state_info with projection_size)
        hsz = self._projection_size if self._projection_size else self._hidden_size
        return [{"shape": (self._num_layers * self._dir, batch_size, hsz),
                 "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU (reference rnn_layer.py:499)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
