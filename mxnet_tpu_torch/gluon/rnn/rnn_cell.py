"""Recurrent cells: the port of `mxnet_tpu/gluon/rnn/rnn_cell.py` (parity
`python/mxnet/gluon/rnn/rnn_cell.py`).

Each cell is a HybridBlock whose ``__call__(input, states)`` advances one
step; `unroll` lays the steps out one call after another, so a hybridized
block that unrolls a cell captures the whole unrolled sequence as one CUDA
graph on a card (the reference unrolls into one symbol graph). The begin
states are made on the context of the inputs, as the reference's
`_get_begin_state` does.
"""
from __future__ import annotations

from ... import ndarray as nd
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _get_begin_state(cell, F, begin_state, inputs, batch_size):
    if begin_state is None:
        ctx = inputs.context if isinstance(inputs, nd.NDArray) \
            else inputs[0].context
        with ctx:
            begin_state = cell.begin_state(batch_size=batch_size)
    return begin_state


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """Normalize inputs to a list of per-step tensors or one merged tensor."""
    assert layout in ("NTC", "TNC"), f"unsupported layout {layout}"
    axis = layout.find("T")
    batch_axis = layout.find("N")
    batch_size = 0
    in_axis = in_layout.find("T") if in_layout else axis
    if isinstance(inputs, nd.NDArray):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            assert length is None or length == inputs.shape[in_axis]
            inputs = list(nd.split(inputs, axis=in_axis,
                                   num_outputs=inputs.shape[in_axis],
                                   squeeze_axis=1))
    else:
        assert length is None or len(inputs) == length
        batch_size = inputs[0].shape[0]
        if merge is True:
            inputs = [nd.expand_dims(i, axis=axis) for i in inputs]
            inputs = nd.concat(*inputs, dim=axis)
            in_axis = axis
    if isinstance(inputs, nd.NDArray) and axis != in_axis:
        inputs = nd.swapaxes(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis, batch_size


def _mask_sequence_variable_length(F, data, length, valid_length, time_axis,
                                   merge):
    assert valid_length is not None
    if not isinstance(data, nd.NDArray):
        data = nd.stack(*data, axis=time_axis)
    outputs = nd.SequenceMask(data, valid_length, use_sequence_length=True,
                              axis=time_axis)
    if not merge:
        outputs = list(nd.split(outputs, num_outputs=outputs.shape[time_axis],
                                axis=time_axis, squeeze_axis=True))
    return outputs


class RecurrentCell(Block):
    """Base class for recurrent cells (reference rnn_cell.py:60)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    @property
    def _curr_prefix(self):
        return f"{self.prefix}t{self._counter}_"

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called directly."
        states = []
        func = func or nd.zeros
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            state = func(name=f"{self._prefix}begin_state_{self._init_counter}",
                         **info) if "name" in _fn_params(func) else func(**info)
            states.append(state)
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell for `length` steps (reference rnn_cell.py:305)."""
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout, False)
        begin_state = _get_begin_state(self, nd, begin_state, inputs, batch_size)

        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [nd.SequenceLast(nd.stack(*ele_list, axis=0),
                                      valid_length, use_sequence_length=True,
                                      axis=0)
                      for ele_list in zip(*all_states)]
            # masked and merged, or split again, as the reference's
            # `_mask_sequence_variable_length` + `_format_sequence` leave it
            outputs = _mask_sequence_variable_length(
                nd, outputs, length, valid_length, axis, bool(merge_outputs))
        elif merge_outputs:
            outputs = [nd.expand_dims(o, axis=axis) for o in outputs]
            outputs = nd.concat(*outputs, dim=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


def _fn_params(fn):
    import inspect
    try:
        return inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return {}


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Recurrent cells implementing hybrid_forward."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    """Elman RNN cell: h' = act(W_i x + b_i + W_h h + b_h)
    (reference rnn_cell.py:345)."""

    def __init__(self, hidden_size, activation="tanh", i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight", shape=(hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight", shape=(hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = f"t{self._counter}_"
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size, name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size, name=prefix + "h2h")
        i2h_plus_h2h = F.elemwise_add(i2h, h2h, name=prefix + "plus0")
        output = self._get_activation(F, i2h_plus_h2h, self._activation,
                                      name=prefix + "out")
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell, gate order [i, f, g, o] (reference rnn_cell.py:447,
    matching the fused RNN op's cuDNN layout)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, activation="tanh", recurrent_activation="sigmoid"):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._activation = activation
        self._recurrent_activation = recurrent_activation
        self.i2h_weight = self.params.get("i2h_weight", shape=(4 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight", shape=(4 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(4 * hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(4 * hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = f"t{self._counter}_"
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "h2h")
        gates = F.elemwise_add(i2h, h2h, name=prefix + "plus0")
        slice_gates = F.SliceChannel(gates, num_outputs=4,
                                     name=prefix + "slice")
        in_gate = self._get_activation(F, slice_gates[0],
                                       self._recurrent_activation, name=prefix + "i")
        forget_gate = self._get_activation(F, slice_gates[1],
                                           self._recurrent_activation, name=prefix + "f")
        in_transform = self._get_activation(F, slice_gates[2],
                                            self._activation, name=prefix + "c")
        out_gate = self._get_activation(F, slice_gates[3],
                                        self._recurrent_activation, name=prefix + "o")
        next_c = F.elemwise_add(
            F.elemwise_mul(forget_gate, states[1], name=prefix + "mul0"),
            F.elemwise_mul(in_gate, in_transform, name=prefix + "mul1"),
            name=prefix + "state")
        next_h = F.elemwise_mul(
            out_gate, self._get_activation(F, next_c, self._activation),
            name=prefix + "out")
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell, gate order [r, z, n] (reference rnn_cell.py:599)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight", shape=(3 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight", shape=(3 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(3 * hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(3 * hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (3 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = f"t{self._counter}_"
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size,
                               name=prefix + "h2h")
        i2h_r, i2h_z, i2h = F.SliceChannel(i2h, num_outputs=3,
                                           name=prefix + "i2h_slice")
        h2h_r, h2h_z, h2h = F.SliceChannel(h2h, num_outputs=3,
                                           name=prefix + "h2h_slice")
        reset_gate = F.Activation(F.elemwise_add(i2h_r, h2h_r), act_type="sigmoid",
                                  name=prefix + "r_act")
        update_gate = F.Activation(F.elemwise_add(i2h_z, h2h_z), act_type="sigmoid",
                                   name=prefix + "z_act")
        next_h_tmp = F.Activation(
            F.elemwise_add(i2h, F.elemwise_mul(reset_gate, h2h)),
            act_type="tanh", name=prefix + "h_act")
        ones = F.ones_like(update_gate, name=prefix + "ones")
        next_h = F.elemwise_add(
            F.elemwise_mul(F.elemwise_sub(ones, update_gate), next_h_tmp),
            F.elemwise_mul(update_gate, prev_state_h), name=prefix + "out")
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack cells sequentially (reference rnn_cell.py:690)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[p:p + n])
            p += n
            next_states.extend(state)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, _, batch_size = _format_sequence(length, inputs, layout, None)
        num_cells = len(self._children)
        begin_state = _get_begin_state(self, nd, begin_state, inputs, batch_size)
        p = 0
        next_states = []
        for i, cell in enumerate(self._children.values()):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs,
                valid_length=valid_length)
            next_states.extend(states)
        return inputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)


class HybridSequentialRNNCell(SequentialRNNCell):
    pass


class DropoutCell(HybridRecurrentCell):
    """Apply dropout on input (reference rnn_cell.py:789)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes,
                               name=f"t{self._counter}_fwd")
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Base for cells that modify another cell (reference rnn_cell.py:841)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified." % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference rnn_cell.py:896)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell)
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        super().__init__(base_cell)
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)
        mask = (lambda p, like: F.Dropout(F.ones_like(like), p=p)
                if p > 0 else None)
        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        p_outputs = self._zoneout_outputs
        m_out = mask(p_outputs, next_output)
        output = F.where(m_out, next_output, prev_output) \
            if m_out is not None else next_output
        p_states = self._zoneout_states
        if p_states > 0:
            new_states = []
            for new_s, old_s in zip(next_states, states):
                m = mask(p_states, new_s)
                new_states.append(F.where(m, new_s, old_s))
            states = new_states
        else:
            states = next_states
        self._prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Add residual connection around a cell (reference rnn_cell.py:964)."""

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = F.elemwise_add(output, inputs,
                                name=f"t{self._counter}_fwd")
        return output, states

    def _alias(self):
        return "residual"

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True
        merge_outputs = isinstance(outputs, nd.NDArray) \
            if merge_outputs is None else merge_outputs
        inputs, axis, _ = _format_sequence(length, inputs, layout, merge_outputs)
        if valid_length is not None:
            inputs = _mask_sequence_variable_length(nd, inputs, length,
                                                    valid_length, axis,
                                                    merge_outputs)
        if merge_outputs:
            outputs = outputs + inputs
        else:
            outputs = [o + i for o, i in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Run two cells in opposite directions (reference rnn_cell.py:1030)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cells cannot be stepped; "
                                  "use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout, False)
        reversed_inputs = list(reversed(inputs))
        begin_state = _get_begin_state(self, nd, begin_state, inputs, batch_size)

        states = begin_state
        l_cell, r_cell = self._children.values()
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info(batch_size))],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=reversed_inputs,
            begin_state=states[len(l_cell.state_info(batch_size)):],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        if valid_length is not None:
            r_outputs = _mask_sequence_variable_length(
                nd, list(reversed(r_outputs)), length, valid_length, axis, False)
        else:
            r_outputs = list(reversed(r_outputs))
        outputs = [nd.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, r_outputs)]
        if merge_outputs:
            outputs = [nd.expand_dims(o, axis=axis) for o in outputs]
            outputs = nd.concat(*outputs, dim=axis)
        states = l_states + r_states
        return outputs, states
