"""contrib recurrent cells: the port of
`mxnet_tpu/gluon/contrib/rnn/rnn_cell.py` (parity
`python/mxnet/gluon/contrib/rnn/rnn_cell.py`: VariationalDropoutCell:27,
LSTMPCell:198)."""
from __future__ import annotations

from ...rnn.rnn_cell import HybridRecurrentCell, ModifierCell, BidirectionalCell

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """Variational (locked) dropout: ONE dropout mask per unroll, reused at
    every time step, applied to inputs/states/outputs (reference
    rnn_cell.py:27; Gal & Ghahramani recipe)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        assert not drop_states or not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support variational state dropout; " \
            "wrap the cells underneath instead."
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        super().__init__(base_cell)
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _initialize_input_masks(self, F, inputs, states):
        if self.drop_states and self.drop_states_mask is None:
            self.drop_states_mask = F.Dropout(F.ones_like(states[0]),
                                              p=self.drop_states)
        if self.drop_inputs and self.drop_inputs_mask is None:
            self.drop_inputs_mask = F.Dropout(F.ones_like(inputs),
                                              p=self.drop_inputs)

    def _initialize_output_mask(self, F, output):
        if self.drop_outputs and self.drop_outputs_mask is None:
            self.drop_outputs_mask = F.Dropout(F.ones_like(output),
                                               p=self.drop_outputs)

    def hybrid_forward(self, F, inputs, states):
        cell = self.base_cell
        self._initialize_input_masks(F, inputs, states)
        if self.drop_states:
            states = list(states)
            # reference drops only the first state (the hidden h)
            states[0] = F.elemwise_mul(states[0], self.drop_states_mask)
        if self.drop_inputs:
            inputs = F.elemwise_mul(inputs, self.drop_inputs_mask)
        next_output, next_states = cell(inputs, states)
        self._initialize_output_mask(F, next_output)
        if self.drop_outputs:
            next_output = F.elemwise_mul(next_output,
                                         self.drop_outputs_mask)
        return next_output, next_states


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a linear recurrent projection (reference rnn_cell.py:198;
    Sak et al. 2014): h_t = W_r (o * tanh(c_t)) — the recurrent/hidden
    state is the lower-dim projection."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        prefix = f"t{self._counter}_"
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "h2h")
        gates = F.elemwise_add(i2h, h2h, name=prefix + "plus0")
        sl = F.SliceChannel(gates, num_outputs=4, name=prefix + "slice")
        in_gate = F.Activation(sl[0], act_type="sigmoid", name=prefix + "i")
        forget_gate = F.Activation(sl[1], act_type="sigmoid",
                                   name=prefix + "f")
        in_transform = F.Activation(sl[2], act_type="tanh", name=prefix + "c")
        out_gate = F.Activation(sl[3], act_type="sigmoid", name=prefix + "o")
        next_c = F.elemwise_add(
            F.elemwise_mul(forget_gate, states[1], name=prefix + "mul0"),
            F.elemwise_mul(in_gate, in_transform, name=prefix + "mul1"),
            name=prefix + "state")
        hidden = F.elemwise_mul(
            out_gate, F.Activation(next_c, act_type="tanh"),
            name=prefix + "hidden")
        next_r = F.FullyConnected(hidden, h2r_weight, no_bias=True,
                                  num_hidden=self._projection_size,
                                  name=prefix + "out")
        return next_r, [next_r, next_c]
