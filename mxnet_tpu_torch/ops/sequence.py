"""Sequence ops (ref: src/operator/sequence_last.cc, sequence_mask.cc,
sequence_reverse.cc): masking, last-step selection and reversal of
padded batches, each with an optional per-sample ``sequence_length``.

Counterpart: ``mxnet_tpu/ops/sequence.py``.  Layout follows the
reference: time-major ``(T, N, ...)`` unless ``axis`` says otherwise
(``SequenceMask`` and ``SequenceLast`` take axis 0 or 1;
``SequenceReverse`` reverses axis 0).  The bodies are index arithmetic
on the input's device, so they run on ``meta`` tensors too (shape
inference).
"""
from __future__ import annotations

import torch

from .registry import register


def _steps(data, axis):
    return torch.arange(data.shape[axis], device=data.device)


@register("SequenceMask", input_names=("data", "sequence_length"))
def _sequence_mask(data, *maybe_len, use_sequence_length=False, value=0.0,
                   axis=0, **_):
    if not use_sequence_length or not maybe_len:
        return data
    seq_len = maybe_len[0].to(torch.int64)
    steps = _steps(data, axis)
    if axis == 0:
        mask = steps[:, None] < seq_len[None, :]  # (T, N)
    else:
        mask = steps[None, :] < seq_len[:, None]  # (N, T)
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                               device=data.device))


@register("SequenceLast", input_names=("data", "sequence_length"))
def _sequence_last(data, *maybe_len, use_sequence_length=False, axis=0, **_):
    if not use_sequence_length or not maybe_len:
        return data.select(axis, data.shape[axis] - 1)
    seq_len = maybe_len[0].to(torch.int64)
    idx = torch.clamp(seq_len - 1, 0, data.shape[axis] - 1)
    moved = data.movedim(0, 1) if axis == 0 else data  # (N, T, ...)
    idx = idx.reshape((-1, 1) + (1,) * (moved.ndim - 2))
    idx = idx.expand((moved.shape[0], 1) + tuple(moved.shape[2:]))
    return torch.gather(moved, 1, idx).squeeze(1)


@register("SequenceReverse", input_names=("data", "sequence_length"))
def _sequence_reverse(data, *maybe_len, use_sequence_length=False, axis=0,
                      **_):
    if not use_sequence_length or not maybe_len:
        return torch.flip(data, dims=(0,))
    seq_len = maybe_len[0].to(torch.int64)  # (N,)
    steps = _steps(data, 0)
    # step i maps to (len-1-i) when i < len, else stays i
    idx = torch.where(steps[:, None] < seq_len[None, :],
                      seq_len[None, :] - 1 - steps[:, None],
                      steps[:, None])  # (T, N)
    idx = idx.reshape(idx.shape + (1,) * (data.ndim - 2))
    return torch.gather(data, 0, idx.expand(data.shape))
