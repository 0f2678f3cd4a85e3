"""Gluon — the imperative NN API.

Counterpart: ``mxnet_tpu/gluon/__init__.py``.  Ported: parameters,
blocks, ``nn`` and ``rnn`` layers, losses, ``Trainer``, the ResNet zoo
and ``gluon.data``.  ``gluon.utils`` is queued (ROADMAP A12).
"""
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import rnn
from . import loss
from . import model_zoo
from . import data
