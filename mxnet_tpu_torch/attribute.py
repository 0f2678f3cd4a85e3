"""mx.attribute — AttrScope lives with the symbol layer; this module
keeps the reference's import path working
(ref: python/mxnet/attribute.py).  Counterpart:
``mxnet_tpu/attribute.py``."""
from .symbol.symbol import AttrScope  # noqa: F401

__all__ = ["AttrScope"]
