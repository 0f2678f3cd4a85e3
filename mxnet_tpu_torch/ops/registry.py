"""Operator registry — the NNVM ``Op`` analogue.

Counterpart: ``mxnet_tpu/ops/registry.py``.  One registration carries
an op's name, aliases and attributes; its body is a plain function over
``torch.Tensor``s with the signature ``fn(*tensors, **params) -> tensor |
tuple``.  Gradients come from ``torch.autograd`` running through the
body (custom ones from a ``torch.autograd.Function`` inside it), so
there is no per-op gradient registration.  PyTorch runs eagerly: where
the JAX package jit-caches one executable per signature, :meth:`Op.bound`
is a plain partial over the parsed params.
"""
from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["Op", "register", "get", "exists", "list_ops", "alias",
           "coerce_attr"]

_REGISTRY: Dict[str, "Op"] = {}


class Op:
    """A registered operator.

    Attributes
    ----------
    name : canonical registered name (may be CamelCase, like the
        reference's ``FullyConnected``).
    fn : function over tensors.
    num_outputs : static output count.
    mutate_aux : indices of inputs the op *updates* (returned as extra
        outputs after the visible ones); the NDArray layer writes them
        back into the input cells.
    rng : whether the op consumes random state.
    nondiff : whether the op is outside autograd (indices, comparisons).
    train_aware : whether the body takes a ``_training`` keyword; the
        ``mx.nd`` wrappers pass ``autograd.is_training()``.
    remat : whether a whole-program op opts in to recomputation.
    """

    __slots__ = ("name", "fn", "num_outputs", "num_visible_outputs",
                 "mutate_aux", "rng", "nondiff", "train_aware", "doc",
                 "aliases", "input_names", "remat")

    def __init__(self, name: str, fn: Callable, num_outputs: int = 1,
                 num_visible_outputs: Optional[int] = None,
                 mutate_aux: Sequence[int] = (), rng: bool = False,
                 nondiff: bool = False, train_aware: bool = False,
                 doc: str = "", input_names: Optional[Sequence[str]] = None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.num_visible_outputs = (num_visible_outputs
                                    if num_visible_outputs is not None
                                    else num_outputs)
        self.mutate_aux = tuple(mutate_aux)
        self.rng = rng
        self.nondiff = nondiff
        self.train_aware = train_aware
        self.doc = doc or (fn.__doc__ or "")
        self.remat = False
        self.aliases: List[str] = []
        if input_names is None:
            # the body's leading positional params without defaults;
            # ops with *varargs inputs must declare input_names
            try:
                spec = inspect.getfullargspec(fn)
                n_defaults = len(spec.defaults or ())
                names = spec.args[:len(spec.args) - n_defaults]
                names = [a for a in names if not a.startswith("_")]
                if rng and names and names[0] == "key":
                    names = names[1:]
                input_names = names
            except TypeError:
                input_names = []
        self.input_names = tuple(input_names)

    def __repr__(self) -> str:
        return "<Op %s>" % self.name

    def bound(self, **params) -> Callable:
        """The body with its params parsed and bound."""
        return functools.partial(
            self.fn, **{k: coerce_attr(v) for k, v in params.items()})

    def __call__(self, *arrays, **params):
        return self.fn(*arrays, **params)


def _parse_scalar(s: str):
    t = s.strip()
    if t in ("True", "true"):
        return True
    if t in ("False", "false"):
        return False
    if t == "None":
        return None
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    return s


def coerce_attr(v: Any):
    """Parse a string attribute into its typed value (the
    dmlc::Parameter string-parsing analogue).  Numbers, booleans,
    ``None`` and flat ``(a, b)``/``[a, b]`` tuples parse; any other
    string (act_type names, dtype names, ...) passes through."""
    if not isinstance(v, str):
        return tuple(v) if isinstance(v, list) else v
    t = v.strip()
    if t.startswith(("(", "[")) and t.endswith((")", "]")):
        inner = t[1:-1].strip()
        if not inner:
            return ()
        parts = [p.strip() for p in inner.split(",") if p.strip()]
        return tuple(_parse_scalar(p) for p in parts)
    return _parse_scalar(t)


def register(name: str, aliases: Sequence[str] = (),
             **kwargs) -> Callable[[Callable], Callable]:
    """Decorator: register ``fn`` as operator ``name``; ``aliases`` adds
    alternate lookup names."""

    def deco(fn: Callable) -> Callable:
        op = Op(name, fn, **kwargs)
        if name in _REGISTRY:
            raise ValueError("duplicate op registration: %s" % name)
        _REGISTRY[name] = op
        for a in aliases:
            if a in _REGISTRY:
                raise ValueError("duplicate op alias: %s" % a)
            _REGISTRY[a] = op
            op.aliases.append(a)
        return fn

    return deco


def get(name: str) -> Op:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError("operator %r is not registered (have %d ops)"
                       % (name, len(set(_REGISTRY.values())))) from None


def exists(name: str) -> bool:
    return name in _REGISTRY


def list_ops(include_aliases: bool = False) -> List[str]:
    """Registered op names; with ``include_aliases`` every resolvable
    lookup name."""
    if include_aliases:
        return sorted(_REGISTRY)
    return sorted({op.name for op in _REGISTRY.values()})


def alias(name: str, new_name: str) -> None:
    _REGISTRY[new_name] = _REGISTRY[name]
