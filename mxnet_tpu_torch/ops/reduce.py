"""Reductions and broadcasting ops.

Counterpart: ``mxnet_tpu/ops/reduce.py``.  Axis semantics follow the
reference: ``axis=None`` reduces all; ``keepdims`` preserved;
``exclude`` reduces every axis *except* the listed ones; an empty axis
tuple reduces nothing (numpy's rule, which torch's ``dim=()`` does not
follow, hence :func:`_reduce`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .registry import register


def _norm_axes(axis, ndim: int,
               exclude: bool = False) -> Optional[Tuple[int, ...]]:
    if axis is None or axis == ():
        axes = None
    elif isinstance(axis, int):
        axes = (axis % ndim,)
    else:
        axes = tuple(a % ndim for a in axis)
    if exclude:
        keep = set(axes or ())
        axes = tuple(a for a in range(ndim) if a not in keep)
    return axes


def _reduce(fn, data, axes, keepdims, single_dim=False):
    """``fn(data, dim, keepdim)`` over ``axes`` (None = all).  Bodies
    that take one dim at a time (``prod``) reduce the axes in turn."""
    dims = tuple(range(data.ndim)) if axes is None else tuple(axes)
    if not dims:
        return data
    if not single_dim:
        return fn(data, dim=dims, keepdim=keepdims)
    out = data
    for d in sorted(dims, reverse=True):
        out = fn(out, dim=d, keepdim=True)
    return out if keepdims else out.reshape(
        [s for i, s in enumerate(data.shape) if i not in dims])


def _make_reduce(fn, single_dim=False):
    def body(data, axis=None, keepdims=False, exclude=False, **_):
        axes = _norm_axes(axis, data.ndim, exclude)
        return _reduce(fn, data, axes, bool(keepdims), single_dim)

    return body


def _nanprod(x, dim, keepdim):
    return torch.prod(torch.where(torch.isnan(x), torch.ones_like(x), x),
                      dim=dim, keepdim=keepdim)


register("sum", aliases=("sum_axis",))(_make_reduce(torch.sum))
register("mean")(_make_reduce(torch.mean))
register("prod")(_make_reduce(torch.prod, single_dim=True))
register("nansum")(_make_reduce(torch.nansum))
register("nanprod")(_make_reduce(_nanprod, single_dim=True))
register("max", aliases=("max_axis",))(_make_reduce(torch.amax))
register("min", aliases=("min_axis",))(_make_reduce(torch.amin))


@register("norm")
def _norm(data, ord=2, axis=None, keepdims=False, **_):
    axes = _norm_axes(axis, data.ndim)
    if ord == 1:
        return _reduce(torch.sum, torch.abs(data), axes, bool(keepdims))
    return torch.sqrt(_reduce(torch.sum, torch.square(data), axes,
                              bool(keepdims)))


def _arg(fn, data, axis, keepdims):
    out = fn(data, dim=axis)
    if keepdims and axis is not None:
        out = out.unsqueeze(axis)
    return out.to(torch.float32)  # reference returns real dtype indices


@register("argmax", nondiff=True)
def _argmax(data, axis=None, keepdims=False, **_):
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin", nondiff=True)
def _argmin(data, axis=None, keepdims=False, **_):
    return _arg(torch.argmin, data, axis, keepdims)


@register("argmax_channel", nondiff=True)
def _argmax_channel(data, **_):
    return torch.argmax(data, dim=1).to(torch.float32)


@register("broadcast_to")
def _broadcast_to(data, shape=(), **_):
    # reference semantics: 0 in target shape keeps the source dim
    tgt = tuple(int(s) if int(s) != 0 else int(d)
                for s, d in zip(shape, data.shape))
    return data.expand(tgt)


@register("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(data, axis=(), size=(), **_):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = int(s)
    return data.expand(tuple(tgt))


@register("broadcast_like")
def _broadcast_like(lhs, rhs, **_):
    return lhs.expand(rhs.shape)


@register("L2Normalization")
def _l2_normalization(data, eps=1e-10, mode="instance", **_):
    # ref: src/operator/l2_normalization.cc
    if mode == "instance":
        axes = tuple(range(1, data.ndim))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, data.ndim))
    else:
        raise ValueError("unknown L2Normalization mode %r" % mode)
    denom = torch.sqrt(_reduce(torch.sum, torch.square(data), axes, True)
                       + eps)
    return data / denom


@register("square_sum", aliases=("_square_sum",))
def _square_sum(data, axis=None, keepdims=False, **_):
    axes = _norm_axes(axis, data.ndim)
    return _reduce(torch.sum, torch.square(data), axes, bool(keepdims))
