"""Ulysses sequence parallelism: an all-to-all from sequence to heads.

Counterpart: ``mxnet_tpu/parallel/sequence.py`` (``ulysses_attention``
:25, ``ulysses_attention_sharded`` :60).  Activations arrive sharded
over the sequence on a mesh axis; an all-to-all (``dist.
all_to_all_single`` over the axis's subgroup) reshards them over the
heads, (B, T/n, H, D) -> (B, T, H/n, D), so each rank runs attention
over the full sequence for H/n heads, and the inverse all-to-all
restores the sequence sharding.  The attention is ``FlashAttention``:
the hand-written forward and backward kernels on the card, autograd of
their plain version on CPU tensors.  Each all-to-all is an autograd
Function whose backward is the inverse all-to-all (gloo takes CUDA
tensors here, as NCCL does).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .attention import flash_attention_train
from .ring_attention import _gather_seq, _my_slice

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def _all_to_all(chunks, mesh, axis_name):
    """``chunks`` (n, ...) contiguous: chunk j goes to the axis's rank j;
    returns (n, ...) with chunk j from rank j."""
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=mesh.axis_group(axis_name))
    return out


def _seq_to_heads(x, mesh, axis_name):
    n = mesh.axis_size(axis_name)
    B, t, H, D = x.shape
    h = H // n
    chunks = x.reshape(B, t, n, h, D).permute(2, 0, 1, 3, 4).contiguous()
    got = _all_to_all(chunks, mesh, axis_name)        # (n, B, t, h, D)
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * t, h, D)


def _heads_to_seq(x, mesh, axis_name):
    n = mesh.axis_size(axis_name)
    B, T, h, D = x.shape
    t = T // n
    chunks = x.reshape(B, n, t, h, D).permute(1, 0, 2, 3, 4).contiguous()
    got = _all_to_all(chunks, mesh, axis_name)        # (n, B, t, h, D)
    return got.permute(1, 2, 0, 3, 4).reshape(B, t, n * h, D)


class _SeqToHeads(torch.autograd.Function):
    """(B, T/n, H, D) sequence shards -> (B, T, H/n, D) head shards."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.cfg = (mesh, axis_name)
        return _seq_to_heads(x, mesh, axis_name)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, *ctx.cfg), None, None


class _HeadsToSeq(torch.autograd.Function):
    """(B, T, H/n, D) head shards -> (B, T/n, H, D) sequence shards."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.cfg = (mesh, axis_name)
        return _heads_to_seq(x, mesh, axis_name)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, *ctx.cfg), None, None


def ulysses_attention(q, k, v, mesh, axis_name="sp", causal=False,
                      sm_scale=None):
    """Per-shard body: ``q``/``k``/``v`` are this rank's (B, T/n, H, D)
    sequence slices over the mesh axis ``axis_name``; the heads H must
    divide by the axis size.  Returns this rank's (B, T/n, H, D) output
    slice, with a gradient."""
    n = mesh.axis_size(axis_name)
    H = q.shape[2]
    if H % n:
        raise ValueError("num heads %d must divide sp axis size %d"
                         % (H, n))
    qf, kf, vf = (_SeqToHeads.apply(x, mesh, axis_name) for x in (q, k, v))
    out = flash_attention_train(qf, kf, vf, causal=causal,
                                sm_scale=sm_scale)
    return _HeadsToSeq.apply(out, mesh, axis_name)


def ulysses_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False,
                              sm_scale=None):
    """Global view over full (B, T, H, D) arrays on every rank: this
    rank's slice runs :func:`ulysses_attention` and the slices are
    gathered (no gradient across the gather)."""
    out = ulysses_attention(*(_my_slice(x, mesh, axis_name)
                              for x in (q, k, v)), mesh,
                            axis_name=axis_name, causal=causal,
                            sm_scale=sm_scale)
    return _gather_seq(out.detach(), mesh, axis_name)
