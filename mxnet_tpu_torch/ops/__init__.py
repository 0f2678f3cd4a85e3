"""Operator library: plain PyTorch bodies behind the MXNet op registry.

Counterpart: ``mxnet_tpu/ops/``.  Importing this package registers every
ported operator: the core modules (elementwise, reduce, matrix, init),
``nn`` up to ``Pad``, three samplers of ``random_ops``, the SGD, Adam
and AdaGrad updates of ``optimizer_ops`` (dense and lazy), the
sparse ops and ``bipartite_matching`` of ``extra``, the ``Sequence*``
ops, the fused ``RNN``, ``nn``'s spatial tail and the detection ops of
``contrib``.
"""
from . import registry
from .registry import Op, get, list_ops, register

# registration side-effect imports
from . import elemwise  # noqa: F401
from . import reduce  # noqa: F401
from . import matrix  # noqa: F401
from . import init_ops  # noqa: F401
from . import nn  # noqa: F401
from . import random_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import extra  # noqa: F401
from . import sequence  # noqa: F401
from . import rnn  # noqa: F401
from . import contrib  # noqa: F401

__all__ = ["Op", "get", "list_ops", "register", "registry"]
