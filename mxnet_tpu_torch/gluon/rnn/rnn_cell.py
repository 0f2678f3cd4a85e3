"""Recurrent cell zoo (ref: python/mxnet/gluon/rnn/rnn_cell.py).

Counterpart: ``mxnet_tpu/gluon/rnn/rnn_cell.py``, a copy.  Cells are
step functions ``cell(input_t, states) -> (output_t, new_states)`` plus
an ``unroll`` that lays the steps out over time, eagerly (a hybridized
cell runs the same steps: the port's blocks run eagerly).  The fused
``rnn_layer`` path runs the ``RNN`` op (``ops/rnn.py``).  Gate order
matches the fused op (cuDNN's, which is torch's): LSTM ``[i, f, g, o]``,
GRU ``[r, z, n]`` — so cell and fused-layer parameters are
interchangeable per layer/direction.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import Block, HybridBlock

__all__ = [
    "RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
    "SequentialRNNCell", "DropoutCell", "ModifierCell", "ZoneoutCell",
    "ResidualCell", "BidirectionalCell",
]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge):
    """Normalise inputs to a list of per-step arrays (ref: rnn_cell.py
    _format_sequence).  Returns (inputs_list_or_array, axis, batch_size)."""
    from ... import ndarray as nd

    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, (list, tuple)):
        batch_size = inputs[0].shape[batch_axis - (1 if batch_axis > axis else 0)] \
            if inputs[0].ndim > 1 else inputs[0].shape[0]
        if merge:
            stacked = nd.stack(*inputs, axis=axis)
            return stacked, axis, batch_size
        return list(inputs), axis, batch_size
    batch_size = inputs.shape[batch_axis]
    if length is not None and inputs.shape[axis] != length:
        raise MXNetError("unroll length %d != input length %d"
                         % (length, inputs.shape[axis]))
    if merge is False:
        split = nd.SliceChannel(inputs, num_outputs=inputs.shape[axis],
                                axis=axis, squeeze_axis=True)
        return list(split) if isinstance(split, (list, tuple)) else [split], \
            axis, batch_size
    return inputs, axis, batch_size


class RecurrentCell(Block):
    """Base cell (ref: rnn_cell.py RecurrentCell:58)."""

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

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states (ref: rnn_cell.py begin_state:93)."""
        from ... import ndarray as nd

        if self._modified:
            raise MXNetError(
                "After applying modifier cells the base cell cannot be called "
                "directly. Call the modifier cell instead.")
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            info.pop("__layout__", None)
            states.append(func(shape=info.pop("shape"), **info, **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Explicit time unroll (ref: rnn_cell.py unroll:136)."""
        from ... import ndarray as nd

        self.reset()
        inputs_list, axis, batch_size = _format_sequence(length, inputs,
                                                         layout, False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs_list[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            # final state of each sample is the state at its last *valid*
            # step, not step T (ref: rnn_cell.py unroll valid_length branch)
            states = [nd.SequenceLast(nd.stack(*ele_list, axis=0),
                                      sequence_length=valid_length,
                                      use_sequence_length=True, axis=0)
                      for ele_list in zip(*all_states)]
            stacked = nd.stack(*outputs, axis=0)  # (T, N, C)
            masked = nd.SequenceMask(stacked, sequence_length=valid_length,
                                     use_sequence_length=True, axis=0)
            outputs = [masked[i] for i in range(length)]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Cells whose step is a pure hybrid function."""

    def forward(self, inputs, states):
        params = {name: p.data() for name, p in self._reg_params.items()}
        from ... import ndarray as nd_mod

        return self.hybrid_forward(nd_mod, inputs, states, **params)

    def hybrid_forward(self, F, inputs, states, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    """Elman cell: h' = act(W x + b_i + R h + b_h) (ref: rnn_cell.py
    RNNCell:281)."""

    def __init__(self, hidden_size, activation="tanh", i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell, gate order [i, f, g, o] (ref: rnn_cell.py LSTMCell:363)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        sliced = F.SliceChannel(gates, num_outputs=4, axis=-1)
        in_gate = F.Activation(sliced[0], act_type="sigmoid")
        forget_gate = F.Activation(sliced[1], act_type="sigmoid")
        in_transform = F.Activation(sliced[2], act_type="tanh")
        out_gate = F.Activation(sliced[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell, gate order [r, z, n], linear-before-reset (ref:
    rnn_cell.py GRUCell:461)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(3 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(3 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(3 * hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(3 * hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = list(F.SliceChannel(i2h, num_outputs=3, axis=-1))
        h2h_r, h2h_z, h2h_n = list(F.SliceChannel(h2h, num_outputs=3, axis=-1))
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h_n + reset_gate * h2h_n, act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * states[0]
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells applied in sequence each step (ref: rnn_cell.py
    SequentialRNNCell:573)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        pos = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            cell_states = states[pos:pos + n]
            pos += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def forward(self, *args):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Applies dropout on input each step (ref: rnn_cell.py DropoutCell:653)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Base for cells that wrap another cell (ref: rnn_cell.py
    ModifierCell:704)."""

    def __init__(self, base_cell):
        super().__init__(prefix=None, params=None)
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout regularisation (ref: rnn_cell.py ZoneoutCell:753)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        p_out, p_st = self.zoneout_outputs, self.zoneout_states

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = F.where(mask(p_out, next_output), next_output, prev_output) \
            if p_out != 0.0 else next_output
        new_states = [F.where(mask(p_st, ns), ns, s) for ns, s in
                      zip(next_states, states)] if p_st != 0.0 else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Adds input to output (ref: rnn_cell.py ResidualCell:806)."""

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Runs two cells over opposite time directions; only usable via
    ``unroll`` (ref: rnn_cell.py BidirectionalCell:850)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as nd

        self.reset()
        inputs_list, axis, batch_size = _format_sequence(length, inputs,
                                                         layout, False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info(batch_size))
        l_outputs, l_states = l_cell.unroll(
            length, inputs_list, begin_state[:n_l], layout="NTC",
            merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            rev_inputs = list(reversed(inputs_list))
        else:
            # reverse each sample only over its valid prefix so the reverse
            # cell never sees padding first (ref: BidirectionalCell.unroll
            # uses SequenceReverse with sequence_length)
            stacked_in = nd.stack(*inputs_list, axis=0)
            reversed_in = nd.SequenceReverse(
                stacked_in, sequence_length=valid_length,
                use_sequence_length=True)
            rev_inputs = [reversed_in[i] for i in range(length)]
        r_outputs, r_states = r_cell.unroll(
            length, rev_inputs, begin_state[n_l:], layout="NTC",
            merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            r_outputs = list(reversed(r_outputs))
        else:
            stacked_r = nd.stack(*r_outputs, axis=0)
            unreversed = nd.SequenceReverse(
                stacked_r, sequence_length=valid_length,
                use_sequence_length=True)
            r_outputs = [unreversed[i] for i in range(length)]
        outputs = [nd.concat(lo, ro, dim=-1)
                   for lo, ro in zip(l_outputs, r_outputs)]
        if valid_length is not None:
            stacked = nd.stack(*outputs, axis=0)
            masked = nd.SequenceMask(stacked, sequence_length=valid_length,
                                     use_sequence_length=True, axis=0)
            outputs = [masked[i] for i in range(length)]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
