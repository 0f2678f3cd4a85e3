"""``mx.sym.linalg`` (ref: python/mxnet/symbol/linalg.py).

Counterpart: ``mxnet_tpu/symbol/linalg.py``, which wraps the
``_linalg_*`` ops.  The port's registry has none yet (ROADMAP A12), so
every name raises.
"""
from ..base import MXNetError


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise MXNetError("mx.sym.linalg.%s: the _linalg_* ops are not ported "
                     "to mxnet_tpu_torch yet (ROADMAP A12)" % name)
