"""Imperative autograd on ``torch.autograd``.

Counterpart: ``mxnet_tpu/autograd.py``, which keeps its own tape of
``jax.vjp`` pullbacks.  Here the tape is torch's graph:

  * ``record()``/``pause()`` set a thread-local flag.  ``invoke`` runs an
    op under ``torch.enable_grad()`` only while recording and only when
    an input carries a gradient (the JAX package's rule); every other
    op runs under ``torch.no_grad()``, so nothing outside ``record()``
    builds graph, a ``pause()`` block included.
  * a marked variable holds a leaf tensor (``requires_grad``) that
    remembers its ``NDArray`` cell.  Every value a cell takes is its own
    tensor (arrays are copy-on-write), so a gradient flows to the value
    that was read when the op was recorded, even after the cell was
    updated in place.
  * ``backward`` walks the graph from the heads to those leaves, asks
    ``torch.autograd.grad`` for their gradients (graphs are kept, as the
    JAX package's pullbacks are reusable) and writes them into each
    cell's gradient buffer with its ``grad_req`` (``write``/``add``/
    ``null``).
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from .base import storage_id

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]

_STATE = threading.local()


def _st():
    if not hasattr(_STATE, "recording"):
        _STATE.recording = False
        _STATE.training = False
    return _STATE


def is_recording() -> bool:
    return _st().recording


def is_training() -> bool:
    return _st().training


def set_recording(flag: bool) -> bool:
    st = _st()
    prev, st.recording = st.recording, bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    st = _st()
    prev, st.training = st.training, bool(flag)
    return prev


class _RecordingScope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._recording = recording
        self._training = training

    def __enter__(self):
        if self._recording is not None:
            self._prev_rec = set_recording(self._recording)
        if self._training is not None:
            self._prev_train = set_training(self._training)
        return self

    def __exit__(self, *exc):
        if self._recording is not None:
            set_recording(self._prev_rec)
        if self._training is not None:
            set_training(self._prev_train)


def record(train_mode: bool = True) -> _RecordingScope:
    """``with autograd.record():`` — ref: python/mxnet/autograd.py:48."""
    return _RecordingScope(True, train_mode)


def pause(train_mode: bool = False) -> _RecordingScope:
    return _RecordingScope(False, train_mode)


def train_mode() -> _RecordingScope:
    return _RecordingScope(None, True)


def predict_mode() -> _RecordingScope:
    return _RecordingScope(None, False)


def make_leaf(arr, t: torch.Tensor) -> torch.Tensor:
    """``t`` as a fresh leaf that requires grad and remembers ``arr``,
    its cell.  Only floating-point values can carry a gradient."""
    if not (t.is_floating_point() or t.is_complex()):
        return t
    t = t.detach().requires_grad_(True)
    t._mx_cell = weakref.ref(arr)
    return t


def mark_variables(variables, gradients, grad_reqs="write") -> None:
    """Attach gradient buffers (ref: imperative.cc:112 MarkVariables).
    Each variable's current value becomes a leaf."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._grad = g
        v._grad_req = req
        v._data = make_leaf(v, v._data)


def _leaves(roots: List[torch.Tensor]) -> List[torch.Tensor]:
    """The leaf tensors of marked variables that ``roots`` depend on."""
    out: List[torch.Tensor] = []
    seen_t, seen_fn = set(), set()
    keep = []          # holds nodes so their ids stay unique during the walk

    def add(t):
        if id(t) not in seen_t and getattr(t, "_mx_cell", None) is not None:
            seen_t.add(id(t))
            out.append(t)

    stack = []
    for r in roots:
        if r.grad_fn is None:
            add(r)
        else:
            stack.append(r.grad_fn)
    while stack:
        fn = stack.pop()
        if id(fn) in seen_fn:
            continue
        seen_fn.add(id(fn))
        keep.append(fn)
        var = getattr(fn, "variable", None)   # AccumulateGrad
        if var is not None:
            add(var)
        for nxt, _ in fn.next_functions:
            if nxt is not None:
                stack.append(nxt)
    return out


def _cell_grads(heads, head_grads) -> Dict[int, Tuple[object, torch.Tensor]]:
    """``{id(cell): (cell, gradient)}`` for every marked variable the
    heads depend on; the gradients of several values of one cell add."""
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    roots, cots = [], []
    for h, hg in zip(heads, head_grads):
        if not h._data.requires_grad:
            raise ValueError("cannot differentiate a head that is neither "
                             "recorded nor a marked variable")
        roots.append(h._data)
        cots.append(torch.ones_like(h._data) if hg is None
                    else hg._data.to(h._data.dtype))
    leaves = _leaves(roots)
    if not leaves:
        return {}
    grads = torch.autograd.grad(roots, leaves, cots, retain_graph=True,
                                allow_unused=True)
    # gradients handed to cells must not share storage with each other
    # or with a head gradient (torch passes some through unchanged)
    taken = {storage_id(c) for c in cots}
    out: Dict[int, Tuple[object, torch.Tensor]] = {}
    for leaf, g in zip(leaves, grads):
        cell = leaf._mx_cell()
        if g is None or cell is None:
            continue
        if id(cell) in out:
            out[id(cell)] = (cell, out[id(cell)][1] + g)
            continue
        if storage_id(g) in taken:
            g = g.clone()
        taken.add(storage_id(g))
        out[id(cell)] = (cell, g)
    return out


def backward(heads, head_grads=None, retain_graph=False,
             train_mode=True) -> None:
    """Run reverse mode from ``heads`` and write each marked variable's
    gradient into its buffer (ref: imperative.cc:357 Backward).  Graphs
    stay reusable whatever ``retain_graph`` says, as in the JAX
    package."""
    for cell, g in _cell_grads(heads, head_grads).values():
        buf, req = cell._grad, cell._grad_req
        if buf is None or req == "null":
            continue
        g = g.detach().to(buf._data.dtype)
        buf._set_data(buf._data + g if req == "add" else g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` w.r.t. ``variables`` without touching the
    attached buffers (ref: python/mxnet/autograd.py:360); zeros for a
    variable the heads do not depend on."""
    from .ndarray.ndarray import NDArray

    single = isinstance(variables, NDArray)
    vars_list = [variables] if single else list(variables)
    got = _cell_grads(heads, head_grads)
    out = []
    for v in vars_list:
        g = got.get(id(v))
        t = (g[1].detach().to(v._data.dtype) if g is not None
             else torch.zeros_like(v._data, requires_grad=False))
        out.append(NDArray.from_raw(t, v.ctx))
    return out[0] if single else out


class _FunctionNode(torch.autograd.Function):
    """Splices a user :class:`Function` into torch's graph: the forward
    already ran (under ``pause()``); backward calls the user's."""

    @staticmethod
    def forward(ctx, func, outs, in_ctx, *tensors):
        ctx.func, ctx.in_ctx = func, in_ctx
        return tuple(o.clone() for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray.ndarray import NDArray

        with pause():
            in_grads = ctx.func.backward(
                *[NDArray.from_raw(g.detach(), ctx.in_ctx)
                  for g in out_grads])
        if isinstance(in_grads, NDArray):
            in_grads = (in_grads,)
        return (None, None, None) + tuple(g._data for g in in_grads)


class Function:
    """Custom differentiable function (ref: python/mxnet/autograd.py:364).

    Subclass and implement ``forward`` and ``backward`` over NDArrays.
    """

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        with pause():
            outputs = self.forward(*inputs)
        single = isinstance(outputs, NDArray)
        outs = [outputs] if single else list(outputs)
        if is_recording() and any(x._data.requires_grad for x in inputs):
            with torch.enable_grad():
                tensors = _FunctionNode.apply(
                    self, [o._data for o in outs], inputs[0].ctx,
                    *[x._data for x in inputs])
            for o, t in zip(outs, tensors):
                o._data = t
        return outputs if single else outs

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
