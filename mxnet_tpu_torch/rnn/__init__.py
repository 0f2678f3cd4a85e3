"""Symbolic RNN API (ref: python/mxnet/rnn/__init__.py) — cells that build
``Symbol`` graphs, the bucketing sentence iterator, and RNN checkpoint
helpers.

Counterpart: ``mxnet_tpu/rnn/__init__.py``."""
from .rnn_cell import (
    BaseRNNCell,
    RNNParams,
    RNNCell,
    LSTMCell,
    GRUCell,
    FusedRNNCell,
    SequentialRNNCell,
    BidirectionalCell,
    DropoutCell,
    ModifierCell,
    ZoneoutCell,
    ResidualCell,
)
from .io import BucketSentenceIter, encode_sentences
from .rnn import save_rnn_checkpoint, load_rnn_checkpoint, do_rnn_checkpoint
