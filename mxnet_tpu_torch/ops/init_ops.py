"""Creation ops — zero-input operators (ref: src/operator/tensor/init_op.cc).

Counterpart: ``mxnet_tpu/ops/init_ops.py``.  These take no tensor
inputs; shape and dtype are params.  The NDArray layer runs them under
the target context's ``torch.device``, so they allocate there directly.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


@register("_zeros", nondiff=True)
def _zeros(shape=(), dtype="float32", **_):
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype))


@register("_ones", nondiff=True)
def _ones(shape=(), dtype="float32", **_):
    return torch.ones(tuple(shape), dtype=torch_dtype(dtype))


@register("_full", nondiff=True)
def _full(shape=(), value=0.0, dtype="float32", **_):
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype))


@register("_arange", nondiff=True)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32", **_):
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=torch_dtype(dtype))
    if repeat != 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register("_eye", nondiff=True)
def _eye(N=0, M=0, k=0, dtype="float32", **_):
    rows = torch.arange(int(N)).unsqueeze(1)
    cols = torch.arange(int(M) or int(N))
    return (cols - rows == int(k)).to(torch_dtype(dtype))
