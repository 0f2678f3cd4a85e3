"""Symbolic RNN cells (ref: python/mxnet/rnn/rnn_cell.py).

Counterpart: ``mxnet_tpu/rnn/rnn_cell.py``, a copy.  These build
``Symbol`` graphs — the bucketing workflow composes one symbol per
sequence length (``BucketingModule``) and this module supplies the cell
bodies.  Parameter symbols are created lazily through ``RNNParams`` so
cells that share a ``params`` object share weights, exactly as the
reference (rnn_cell.py RNNParams:36).

Gate order matches ``ops/rnn.py`` (cuDNN's, which is torch's), so
``FusedRNNCell`` — which lowers to the fused ``RNN`` op — and the
explicit cells are parameter-compatible per layer/direction.
"""
from __future__ import annotations

from ..base import MXNetError
from .. import symbol as sym

__all__ = [
    "RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
    "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
    "ModifierCell", "ZoneoutCell", "ResidualCell",
]


class RNNParams:
    """Lazy container of parameter Variables (ref: rnn_cell.py RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract symbolic cell (ref: rnn_cell.py BaseRNNCell:53)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, **kwargs):
        """Symbolic initial states.  With no ``batch_size`` the shape row is
        0 (= infer), realised by unroll's zeros-from-input trick."""
        if self._modified:
            raise MXNetError(
                "After applying modifier cells the base cell cannot be called "
                "directly. Call the modifier cell instead.")
        states = []
        if func is None:
            func = sym.zeros
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            if func is sym.zeros and info is not None and \
                    0 in info.get("shape", ()):
                # deferred-batch zeros become Variables tagged for zero-init;
                # simple_bind initialises them (ref: the reference defers to
                # shape inference the same way)
                state = sym.Variable(name, init="zeros",
                                     shape=info["shape"])
            else:
                kw = dict(info) if info is not None else {}
                kw.pop("__layout__", None)
                state = func(name=name, **kw, **kwargs)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split fused parameter blobs into per-gate arrays (ref:
        rnn_cell.py unpack_weights:152)."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop("%s%s_weight" % (self._prefix, group_name))
            bias = args.pop("%s%s_bias" % (self._prefix, group_name))
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                args[wname] = weight[j * h: (j + 1) * h].copy()
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                args[bname] = bias[j * h: (j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """Inverse of unpack_weights (ref: rnn_cell.py pack_weights:174)."""
        from .. import ndarray as nd

        args = dict(args)
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            weight = []
            bias = []
            for gate in self._gate_names:
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                weight.append(args.pop(wname))
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                bias.append(args.pop(bname))
            args["%s%s_weight" % (self._prefix, group_name)] = nd.concat(
                *weight, dim=0)
            args["%s%s_bias" % (self._prefix, group_name)] = nd.concat(
                *bias, dim=0)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the cell over ``length`` steps (ref: rnn_cell.py
        unroll:200)."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = _zeros_like_states(self, inputs[0])
        else:
            begin_state = _resolve_begin_state(self, begin_state, inputs[0])
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return sym.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """ref: rnn_cell.py _normalize_sequence."""
    axis = layout.find("T")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, sym.Symbol):
        if merge is False:
            outputs = sym.SliceChannel(inputs, axis=in_axis,
                                       num_outputs=length, squeeze_axis=1)
            outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
                else [outputs[i] for i in range(length)]
            return outputs, axis
        if in_axis != axis:
            inputs = sym.SwapAxis(inputs, dim1=axis, dim2=in_axis)
        return inputs, axis
    assert isinstance(inputs, (list, tuple))
    if merge is True:
        inputs = [sym.expand_dims(i, axis=axis) for i in inputs]
        ret = sym.Concat(*inputs, dim=axis)
        return ret, axis
    return list(inputs), axis


def _zeros_from_input(info, x0):
    """One batch-size-agnostic zero state derived from an input symbol:
    zeros(N, H) = broadcast_to(sum(x0, -1, keepdims) * 0, (0, H)).  The 0 in
    the target shape keeps the batch dim (reference broadcast_to
    semantics), so one symbol serves every bucket's batch."""
    shape = info["shape"]
    base = sym.sum(x0, axis=-1, keepdims=True) * 0.0
    tgt = (0,) * (len(shape) - 1) + (shape[-1],)
    if len(shape) > 2:
        # leading (layers*dir) dim for fused cells
        base = sym.expand_dims(base, axis=0)
        tgt = (shape[0],) + (0,) + (shape[-1],)
    return sym.broadcast_to(base, shape=tgt)


def _zeros_like_states(cell, x0):
    return [_zeros_from_input(info, x0) for info in cell.state_info]


def _resolve_begin_state(cell, states, x0):
    """Replace deferred-batch zero placeholders (begin_state() without a
    ``batch_size``) with input-derived zeros, so single-pass shape
    inference never sees an unknown-batch Variable."""
    resolved = []
    for s, info in zip(states, cell.state_info):
        node, _ = s._entries[0]
        if node.is_variable and node.attrs.get("__init__") == "zeros" and \
                0 in tuple(node.attrs.get("__shape__", ())):
            resolved.append(_zeros_from_input(info, x0))
        else:
            resolved.append(s)
    return resolved


class RNNCell(BaseRNNCell):
    """Vanilla cell (ref: rnn_cell.py RNNCell:247)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB, num_hidden=self._num_hidden,
                                 name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gates [i, f, g(c), o] (ref: rnn_cell.py LSTMCell:301)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        from ..initializer import LSTMBias

        self._iB = self.params.get(
            "i2h_bias", init=LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden * 4,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=self._num_hidden * 4,
                                 name="%sh2h" % name)
        gates = i2h + h2h
        slice_gates = sym.SliceChannel(gates, num_outputs=4, axis=-1,
                                       name="%sslice" % name)
        in_gate = sym.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = sym.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = sym.Activation(slice_gates[2], act_type="tanh")
        out_gate = sym.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * sym.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gates [r, z, n] linear-before-reset (ref: rnn_cell.py
    GRUCell:377)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden * 3,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(data=prev_h, weight=self._hW, bias=self._hB,
                                 num_hidden=self._num_hidden * 3,
                                 name="%sh2h" % name)
        i2h_s = sym.SliceChannel(i2h, num_outputs=3, axis=-1)
        h2h_s = sym.SliceChannel(h2h, num_outputs=3, axis=-1)
        reset_gate = sym.Activation(i2h_s[0] + h2h_s[0], act_type="sigmoid")
        update_gate = sym.Activation(i2h_s[1] + h2h_s[1], act_type="sigmoid")
        next_h_tmp = sym.Activation(i2h_s[2] + reset_gate * h2h_s[2],
                                    act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer cell lowering to the scan-based ``RNN`` op (ref:
    rnn_cell.py FusedRNNCell:439, whose backend was cuDNN)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        self._parameter = self.params.get("parameters")

    @property
    def state_info(self):
        b = self._num_layers * len(self._directions)
        n = (self._mode == "lstm") + 1
        return [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _slice_weights(self, arr, li, lh):
        """Per-layer/direction views of the fused blob (ref: rnn_cell.py
        _slice_weights:527)."""
        args = {}
        gate_names = self._gate_names
        directions = self._directions
        b = len(directions)
        p = 0
        for layer in range(self._num_layers):
            for direction in directions:
                for group in ["i2h", "h2h"]:
                    ni = li if layer == 0 and group == "i2h" else \
                        (lh * b if group == "i2h" else lh)
                    for gate in gate_names:
                        name = "%s%s%d_%s%s_weight" % (
                            self._prefix, direction, layer, group, gate)
                        size = lh * ni
                        args[name] = arr[p:p + size].reshape((lh, ni))
                        p += size
        for layer in range(self._num_layers):
            for direction in directions:
                for group in ["i2h", "h2h"]:
                    for gate in gate_names:
                        name = "%s%s%d_%s%s_bias" % (
                            self._prefix, direction, layer, group, gate)
                        args[name] = arr[p:p + lh]
                        p += lh
        return args

    def unpack_weights(self, args):
        args = dict(args)
        arr = args.pop("%sparameters" % self._prefix)
        b = len(self._directions)
        m = self._num_gates
        h = self._num_hidden
        # invert rnn_param_size for the input size: total = b*m*h*(ni+h+2)
        # + (L-1)*b*m*h*(b*h + h + 2)
        num_input = (arr.size // (b * m * h)
                     - (self._num_layers - 1) * (b * h + h + 2) - h - 2)
        from ..ops.rnn import rnn_param_size

        assert rnn_param_size(self._num_layers, num_input, h, b == 2,
                              self._mode) == arr.size, \
            "parameter blob size does not match cell spec"
        sliced = self._slice_weights(arr, num_input, h)
        args.update({k: v.copy() for k, v in sliced.items()})
        return args

    def pack_weights(self, args):
        from .. import ndarray as nd

        args = dict(args)
        b = len(self._directions)
        m = self._num_gates
        h = self._num_hidden
        w0 = args["%sl0_i2h%s_weight" % (self._prefix, self._gate_names[0])]
        num_input = w0.shape[1]
        total = (num_input + h + 2) * (h * m * b) + \
            (self._num_layers - 1) * m * h * (h + b * h + 2) * b
        parts = []
        for layer in range(self._num_layers):
            for direction in self._directions:
                for group in ["i2h", "h2h"]:
                    for gate in self._gate_names:
                        name = "%s%s%d_%s%s_weight" % (
                            self._prefix, direction, layer, group, gate)
                        parts.append(args.pop(name).reshape((-1,)))
        for layer in range(self._num_layers):
            for direction in self._directions:
                for group in ["i2h", "h2h"]:
                    for gate in self._gate_names:
                        name = "%s%s%d_%s%s_bias" % (
                            self._prefix, direction, layer, group, gate)
                        parts.append(args.pop(name).reshape((-1,)))
        blob = nd.concat(*parts, dim=0)
        assert blob.shape[0] == total, (blob.shape, total)
        args["%sparameters" % self._prefix] = blob
        return args

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:  # NTC → fused op wants TNC
            inputs = sym.SwapAxis(inputs, dim1=0, dim2=1)
        x0 = sym.Reshape(sym.slice_axis(inputs, axis=0, begin=0, end=1),
                         shape=(-3, -2))
        if begin_state is None:
            begin_state = _zeros_like_states(self, x0)
        else:
            begin_state = _resolve_begin_state(self, begin_state, x0)
        states = begin_state
        rnn_args = dict(state_size=self._num_hidden,
                        num_layers=self._num_layers,
                        bidirectional=self._bidirectional, mode=self._mode,
                        p=self._dropout,
                        state_outputs=self._get_next_state,
                        name="%srnn" % self._prefix)
        if self._mode == "lstm":
            rnn = sym.RNN(data=inputs, parameters=self._parameter,
                          state=states[0], state_cell=states[1], **rnn_args)
        else:
            rnn = sym.RNN(data=inputs, parameters=self._parameter,
                          state=states[0], **rnn_args)
        if self._get_next_state:
            outputs = rnn[0]
            states = [rnn[1], rnn[2]] if self._mode == "lstm" else [rnn[1]]
        else:
            outputs, states = rnn, []
        if axis == 1:
            outputs = sym.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs, _ = _normalize_sequence(length, outputs, layout, False,
                                             in_layout=layout)
        return outputs, states

    def unfuse(self):
        """Equivalent stack of explicit cells (ref: rnn_cell.py
        unfuse:600)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda pre: RNNCell(self._num_hidden,
                                            activation="relu", prefix=pre),
            "rnn_tanh": lambda pre: RNNCell(self._num_hidden,
                                            activation="tanh", prefix=pre),
            "lstm": lambda pre: LSTMCell(self._num_hidden, prefix=pre),
            "gru": lambda pre: GRUCell(self._num_hidden, prefix=pre),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (self._prefix,
                                                                i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stacked cells (ref: rnn_cell.py SequentialRNNCell:658)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, \
                "Either specify params for SequentialRNNCell or child cells, not both."
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        x_for_zeros, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = _zeros_like_states(self, x_for_zeros[0])
        else:
            begin_state = _resolve_begin_state(self, begin_state,
                                               x_for_zeros[0])
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """ref: rnn_cell.py DropoutCell:772."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = sym.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """ref: rnn_cell.py ModifierCell:810."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ZoneoutCell(ModifierCell):
    """ref: rnn_cell.py ZoneoutCell:871."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout. Use unfuse() first."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: sym.Dropout(sym.ones_like(like), p=p)
        prev_output = self.prev_output if self.prev_output is not None else \
            sym.zeros_like(next_output)
        output = sym.where(mask(p_outputs, next_output), next_output,
                           prev_output) if p_outputs != 0.0 else next_output
        states = [sym.where(mask(p_states, new_s), new_s, old_s)
                  for new_s, old_s in zip(next_states, states)] \
            if p_states != 0.0 else next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """ref: rnn_cell.py ResidualCell:927."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        if isinstance(outputs, sym.Symbol):
            inputs_m, _ = _normalize_sequence(length, inputs, layout, True)
            outputs = outputs + inputs_m
        else:
            inputs_l, _ = _normalize_sequence(length, inputs, layout, False)
            outputs = [o + i for o, i in zip(outputs, inputs_l)]
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    """ref: rnn_cell.py BidirectionalCell:982."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = _zeros_like_states(self, inputs[0])
        else:
            begin_state = _resolve_begin_state(self, begin_state, inputs[0])
        states = begin_state
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[n_l:], layout=layout, merge_outputs=False)
        r_outputs = list(reversed(r_outputs))
        outputs = [sym.Concat(l_o, r_o, dim=1,
                              name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(zip(l_outputs, r_outputs))]
        if merge_outputs:
            outputs, _ = _normalize_sequence(length, outputs, layout, True)
        return outputs, l_states + r_states


def _cells_unpack_weights(cells, args):
    for cell in cells:
        args = cell.unpack_weights(args)
    return args


def _cells_pack_weights(cells, args):
    for cell in cells:
        args = cell.pack_weights(args)
    return args
