"""Generated op namespace.

Counterpart: ``mxnet_tpu/ndarray/register.py``.  ``mx.nd.<op>`` is built
from the Python op registry: one wrapper per op that binds tensor inputs
(positional, or by keyword in the body's declared order), forwards the
params and ``out=``/``ctx=`` to :func:`invoke`.  ``mx.nd.contrib``
holds every ``_contrib_X`` op as ``X`` and under its snake_case
aliases (``box_nms``, ``ctc_loss``, ...).
"""
from __future__ import annotations

from typing import Any, Dict

from .. import autograd
from ..ops import registry as _registry
from .ndarray import NDArray, invoke


def _make_wrapper(op: _registry.Op):
    input_names = op.input_names
    train_aware = op.train_aware

    def wrapper(*args, **kwargs):
        out = kwargs.pop("out", None)
        ctx = kwargs.pop("ctx", None)
        kwargs.pop("name", None)  # symbol-layer arg, ignored imperatively
        # a trailing optional input passed as None (Dense's bias with
        # use_bias=False) is absent, not a value
        inputs = list(args)
        while inputs and inputs[-1] is None:
            inputs.pop()
        # MXNet's most common convention passes tensor inputs by keyword
        # (data=..., weight=...): bind them positionally in the op body's
        # declared order, after any positional inputs
        for iname in input_names[len(inputs):]:
            if isinstance(kwargs.get(iname), NDArray):
                inputs.append(kwargs.pop(iname))
            elif iname in kwargs and kwargs[iname] is None:
                kwargs.pop(iname)
            else:
                break
        if train_aware and "_training" not in kwargs:
            kwargs["_training"] = autograd.is_training()
        return invoke(op, inputs, kwargs, out=out, ctx=ctx)

    wrapper.__name__ = op.name
    wrapper.__qualname__ = op.name
    wrapper.__doc__ = op.doc
    return wrapper


def populate(module_dict: Dict[str, Any]) -> None:
    """One wrapper per registered name (aliases included) that the
    module does not define already."""
    for name, op in list(_registry._REGISTRY.items()):
        if name not in module_dict:
            module_dict[name] = _make_wrapper(op)
    _populate_contrib(module_dict, _make_wrapper)


def _populate_contrib(module_dict: Dict[str, Any], make_wrapper) -> None:
    """Expose the ``_contrib_X`` ops as a ``contrib`` sub-namespace
    (ref: python/mxnet/ndarray/contrib.py's generated namespace)."""
    import types

    contrib = module_dict.get("contrib")
    if contrib is None:
        contrib = types.SimpleNamespace()
        module_dict["contrib"] = contrib
    for name, op in list(_registry._REGISTRY.items()):
        if name.startswith("_contrib_"):
            shorts = [name[len("_contrib_"):]]
            shorts += [a for a in op.aliases if not a.startswith("_")]
            for short in shorts:
                if not hasattr(contrib, short):
                    setattr(contrib, short, make_wrapper(op))
