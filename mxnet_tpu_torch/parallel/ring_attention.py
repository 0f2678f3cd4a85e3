"""Ring attention: the sequence sharded over a mesh axis, K/V rotating.

Counterpart: ``mxnet_tpu/parallel/ring_attention.py`` (``ring_attention``
:34, ``ring_attention_sharded`` :86).  Each rank of the ``sp`` axis owns
Q/K/V for its slice of the sequence; the K/V blocks rotate one rank
along the ring per step (rank i sends to i+1), and each rank merges the
partial results of its resident Q block against every block it holds.

The JAX package accumulates each step with ``_online_block`` in ``jnp``.
The port runs every visible step on the hand-written flash kernels
(``parallel.attention``): the forward kernel with the log-sum-exp, the
partials merged in float32 (``merge_partials``), and in the backward
the backward kernel from the MERGED output and log-sum-exp (exact:
``P = exp(S * scale - lse)`` and ``D = rowsum(dO * O)`` are the global
ones).  dq sums on the rank; the float32 dk/dv accumulators travel
around the ring with their K/V block, and one last rotation brings them
home.  CPU tensors take the kernels' plain versions through the same
wrappers.

Layout: contiguous, as the reference (rank i owns positions
[i*t, (i+1)*t)).  Under ``causal`` at rotation step s rank i holds the
block of rank src = (i - s) mod n: src < i is fully visible (the kernel
without a mask), src == i is the diagonal (the kernel's causal mask),
src > i is fully masked: no kernel runs, but the block still rotates,
so every rank posts the same transfers in the same order.  Each step's
transfer is posted before its kernel runs, so the two overlap.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .attention import flash_attention_bwd, flash_attention_fwd, \
    merge_partials

__all__ = ["ring_attention", "ring_attention_sharded"]


class _Transfer:
    """One rotation along an axis of the mesh: each tensor goes to the
    next rank of the line and a tensor of the same shape comes from the
    previous one (``dist.batch_isend_irecv``).  ``wait()`` returns the
    received tensors.  On gloo, a CUDA tensor crosses through a host
    buffer: gloo's point-to-point refuses CUDA tensors ("writev: Bad
    address" on the H100 machine), where its all-to-all and
    all-reduce take them.  The attention stays on the card."""

    def __init__(self, tensors, mesh, axis_name):
        ranks = mesh.axis_ranks(axis_name)
        i, n = mesh.axis_index(axis_name), len(ranks)
        group = mesh.axis_group(axis_name)
        self._dev = tensors[0].device
        self._staged = tensors[0].is_cuda and \
            dist.get_backend(group) == "gloo"
        send = [t.contiguous() for t in tensors]
        if self._staged:
            send = [t.cpu() for t in send]
        self._recv = [torch.empty_like(t) for t in send]
        ops = []
        for s, r in zip(send, self._recv):
            ops.append(dist.P2POp(dist.isend, s, ranks[(i + 1) % n],
                                  group=group))
            ops.append(dist.P2POp(dist.irecv, r, ranks[(i - 1) % n],
                                  group=group))
        self._send = send          # alive until the transfer completes
        self._works = dist.batch_isend_irecv(ops)

    def wait(self):
        for w in self._works:
            w.wait()
        if self._staged:
            return [r.to(self._dev) for r in self._recv]
        return self._recv


def _visible(causal: bool, src: int, i: int) -> bool:
    return not causal or src <= i


def _ring_forward(q, k, v, mesh, axis_name, causal, sm_scale):
    n, i = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    acc = torch.promote_types(q.dtype, torch.float32)
    B, t, H, _ = q.shape
    o = torch.zeros(q.shape, dtype=acc, device=q.device)
    lse = torch.full((B, H, t), float("-inf"), dtype=torch.float32,
                     device=q.device)
    kv = [k.contiguous(), v.contiguous()]
    for s in range(n):
        src = (i - s) % n
        nxt = _Transfer(kv, mesh, axis_name) if s < n - 1 else None
        if _visible(causal, src, i):
            o_s, lse_s = flash_attention_fwd(
                q, kv[0], kv[1], causal=causal and src == i,
                sm_scale=sm_scale, return_lse=True)
            o, lse = merge_partials(o, lse, o_s, lse_s)
        if nxt is not None:
            kv = nxt.wait()
    return o.to(q.dtype), lse.contiguous()


def _ring_backward(q, k, v, o, lse, do, mesh, axis_name, causal,
                   sm_scale, _home=True):
    """dq, dk and dv of this rank's block.  ``_home=False`` keeps the
    accumulators this rank holds after the last step instead of the ones
    the last rotation brings (a planted fault of the on-card check; the
    rotation still runs, so the ranks stay in step)."""
    n, i = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    acc = torch.promote_types(q.dtype, torch.float32)
    do = do.contiguous()
    dq = torch.zeros(q.shape, dtype=acc, device=q.device)
    dkv = [torch.zeros(k.shape, dtype=acc, device=q.device),
           torch.zeros(v.shape, dtype=acc, device=q.device)]
    kv = [k.contiguous(), v.contiguous()]
    grads = None           # the accumulators' rotation of the last step
    for s in range(n):
        src = (i - s) % n
        nxt = _Transfer(kv, mesh, axis_name) if s < n - 1 else None
        part = None
        if _visible(causal, src, i):
            part = flash_attention_bwd(q, kv[0], kv[1], o, lse, do,
                                       causal=causal and src == i,
                                       sm_scale=sm_scale)
        if grads is not None:
            dkv = grads.wait()
        if part is not None:
            dq += part[0]
            dkv[0] += part[1]
            dkv[1] += part[2]
        # the accumulators travel with their block: the next rank holds
        # it at the next step
        grads = _Transfer(dkv, mesh, axis_name)
        if nxt is not None:
            kv = nxt.wait()
    # the last rotation: each accumulator reaches the rank of its block
    home = grads.wait()
    dk, dv = home if _home else dkv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The ring with its gradient: saves q, k, v, the merged output and
    the merged log-sum-exp (O(t) beyond the inputs)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name, causal, sm_scale):
        o, lse = _ring_forward(q, k, v, mesh, axis_name, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (mesh, axis_name, causal, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, o, lse, do, *ctx.cfg)
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, mesh, axis_name="sp", causal=False,
                   sm_scale=None):
    """Per-shard body: ``q``/``k``/``v`` are this rank's (B, T/n, H, D)
    slices of the sequence over the mesh axis ``axis_name``; returns
    this rank's (B, T/n, H, D) output slice, with a gradient.  Every
    rank of the axis calls it with the same shapes and flags."""
    return _RingAttention.apply(q, k, v, mesh, axis_name, bool(causal),
                                sm_scale)


def _my_slice(x, mesh, axis_name):
    n, i = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    T = x.shape[1]
    if T % n:
        raise ValueError("sequence length %d does not divide over the %d "
                         "ranks of axis %r" % (T, n, axis_name))
    t = T // n
    return x[:, i * t:(i + 1) * t]


def _gather_seq(x, mesh, axis_name):
    """The full sequence from every rank's (B, t, H, D) slice."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.axis_size(axis_name))]
    dist.all_gather(parts, x, group=mesh.axis_group(axis_name))
    return torch.cat(parts, dim=1)


def ring_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False,
                           sm_scale=None):
    """Global view: full (B, T, H, D) ``q``/``k``/``v`` on every rank;
    this rank's slice runs :func:`ring_attention` and the slices are
    gathered, so every rank returns the full output (no gradient across
    the gather: differentiate :func:`ring_attention` itself)."""
    out = ring_attention(*(_my_slice(x, mesh, axis_name)
                           for x in (q, k, v)), mesh, axis_name=axis_name,
                         causal=causal, sm_scale=sm_scale)
    return _gather_seq(out.detach(), mesh, axis_name)
