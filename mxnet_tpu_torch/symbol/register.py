"""The generated symbol op namespace (ref: python/mxnet/symbol/register.py).

Counterpart: ``mxnet_tpu/symbol/register.py``.  ``mx.sym.<op>`` is one
creator per name of the port's op registry (aliases included), as
``ndarray/register.py`` builds ``mx.nd``, with the same ``contrib``
sub-namespace.
"""
from __future__ import annotations

from typing import Any, Dict

from ..ops import registry as _registry
from .symbol import create


def _make_wrapper(op: _registry.Op):
    name = op.name

    def wrapper(*args, **kwargs):
        return create(name, *args, **kwargs)

    wrapper.__name__ = name
    wrapper.__qualname__ = name
    wrapper.__doc__ = op.doc
    return wrapper


def populate(module_dict: Dict[str, Any]) -> None:
    for reg_name, op in list(_registry._REGISTRY.items()):
        if reg_name not in module_dict:
            module_dict[reg_name] = _make_wrapper(op)
    from ..ndarray.register import _populate_contrib

    _populate_contrib(module_dict, _make_wrapper)
