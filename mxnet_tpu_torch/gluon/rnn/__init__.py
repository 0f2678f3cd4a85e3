"""Gluon recurrent API (ref: python/mxnet/gluon/rnn/__init__.py).

Counterpart: ``mxnet_tpu/gluon/rnn/__init__.py``."""
from .rnn_cell import (
    RecurrentCell,
    HybridRecurrentCell,
    RNNCell,
    LSTMCell,
    GRUCell,
    SequentialRNNCell,
    DropoutCell,
    ModifierCell,
    ZoneoutCell,
    ResidualCell,
    BidirectionalCell,
)
from .rnn_layer import RNN, LSTM, GRU
