"""``mx.sym`` — the symbolic graph namespace (ref: python/mxnet/symbol/).

Counterpart: ``mxnet_tpu/symbol/__init__.py``.  One creator per op of
the port's registry and ``sparse``; ``linalg`` waits for its ops
(ROADMAP A12) and raises on use.
"""
from .symbol import (Symbol, Variable, var, Group, load, load_json,
                     AttrScope, zeros, ones)
from . import register as _register
from .infer import infer_shape, infer_type

_register.populate(globals())

from . import linalg  # noqa: F401,E402
from . import sparse  # noqa: F401,E402
