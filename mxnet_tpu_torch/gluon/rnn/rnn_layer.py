"""Fused recurrent layers (ref: python/mxnet/gluon/rnn/rnn_layer.py).

Counterpart: ``mxnet_tpu/gluon/rnn/rnn_layer.py``, a copy.
``RNN``/``LSTM``/``GRU`` hold per-(layer, direction) ``i2h``/``h2h``
parameters — the reference's naming: ``l0_i2h_weight``, ``r0_h2h_bias`` … —
and concatenate them into the fused blob of the ``RNN`` op
(``ops/rnn.py``: cuDNN on the card) each forward.  The reference did the
same concat into the cuDNN workspace (python/mxnet/gluon/rnn/rnn_layer.py
_forward_kernel).
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import Block

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(Block):
    """ref: rnn_layer.py _RNNLayer:33."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise MXNetError("Invalid layout %s; must be one of ['TNC', 'NTC']"
                             % layout)
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                name = "%s%d" % (j, i)
                setattr(self, "%s_i2h_weight" % name, self.params.get(
                    "%s_i2h_weight" % name, shape=(ng * nh, ni),
                    init=i2h_weight_initializer, allow_deferred_init=True))
                setattr(self, "%s_h2h_weight" % name, self.params.get(
                    "%s_h2h_weight" % name, shape=(ng * nh, nh),
                    init=h2h_weight_initializer, allow_deferred_init=True))
                setattr(self, "%s_i2h_bias" % name, self.params.get(
                    "%s_i2h_bias" % name, shape=(ng * nh,),
                    init=i2h_bias_initializer, allow_deferred_init=True))
                setattr(self, "%s_h2h_bias" % name, self.params.get(
                    "%s_h2h_bias" % name, shape=(ng * nh,),
                    init=h2h_bias_initializer, allow_deferred_init=True))
            ni = nh * self._dir

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        mapping = "{0} -> {1}".format(
            self._input_size if self._input_size else None, self._hidden_size)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _ordered_params(self):
        """Parameters in fused-blob order: all weights, then all biases
        (ops/rnn.py layout)."""
        dirs = ["l", "r"] if self._dir == 2 else ["l"]
        ws, bs = [], []
        for i in range(self._num_layers):
            for j in dirs:
                ws.append(getattr(self, "%s_i2h_weight" % (j + str(i))))
                ws.append(getattr(self, "%s_h2h_weight" % (j + str(i))))
        for i in range(self._num_layers):
            for j in dirs:
                bs.append(getattr(self, "%s_i2h_bias" % (j + str(i))))
                bs.append(getattr(self, "%s_h2h_bias" % (j + str(i))))
        return ws + bs

    def _finish_deferred(self, input_size):
        ng, nh = self._gates, self._hidden_size
        dirs = ["l", "r"] if self._dir == 2 else ["l"]
        ni = input_size
        for i in range(self._num_layers):
            for j in dirs:
                p = getattr(self, "%s_i2h_weight" % (j + str(i)))
                if p._deferred_init is not None:
                    p._finish_deferred_init((ng * nh, ni))
            ni = nh * self._dir
        for p in self._ordered_params():
            if p._deferred_init is not None and p._shape_complete():
                p._finish_deferred_init(p.shape)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        from ... import ndarray as nd

        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            info = dict(info)
            info.pop("__layout__", None)
            states.append(func(shape=info.pop("shape"), **info, **kwargs))
        return states

    def forward(self, inputs, states=None):
        from ... import ndarray as nd

        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            # on the input's device and in its dtype, as the reference
            # (the JAX package makes float32 states on the default
            # context)
            states = self.begin_state(batch_size, ctx=inputs.context,
                                      dtype=inputs.dtype)
        if isinstance(states, nd.NDArray):
            states = [states]
        for info, state in zip(self.state_info(batch_size), states):
            if state.shape != info["shape"]:
                raise MXNetError(
                    "Invalid recurrent state shape. Expecting %s, got %s."
                    % (str(info["shape"]), str(state.shape)))
        if self._layout == "NTC":
            inputs = nd.SwapAxis(inputs, dim1=0, dim2=1)
        self._finish_deferred(inputs.shape[2])
        flat = nd.concat(
            *[p.data().reshape((-1,)) for p in self._ordered_params()], dim=0)
        rnn_args = [inputs, flat, states[0]]
        if self._mode == "lstm":
            rnn_args.append(states[1])
        out = nd.RNN(*rnn_args, state_size=self._hidden_size,
                     num_layers=self._num_layers,
                     bidirectional=self._dir == 2, mode=self._mode,
                     p=self._dropout, state_outputs=True)
        outputs, states = out[0], list(out[1:])
        if self._layout == "NTC":
            outputs = nd.SwapAxis(outputs, dim1=0, dim2=1)
        if skip_states:
            return outputs
        return outputs, states


class RNN(_RNNLayer):
    """Multi-layer Elman RNN (ref: rnn_layer.py RNN:201)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (ref: rnn_layer.py LSTM:288)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU, linear-before-reset (ref: rnn_layer.py GRU:389)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
