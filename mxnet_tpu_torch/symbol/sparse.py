"""``mx.sym.sparse`` (ref: python/mxnet/symbol/sparse.py).

Counterpart: ``mxnet_tpu/symbol/sparse.py``.  Sparse storage is not
ported (ROADMAP A10), so every name raises.
"""
from ..base import MXNetError


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise MXNetError("mx.sym.sparse.%s: sparse storage is not ported to "
                     "mxnet_tpu_torch yet (ROADMAP A10)" % name)
