"""Fused attention — the long-context compute primitive.

Counterpart: ``mxnet_tpu/parallel/attention.py``.

Three implementations of one contract, over (batch, seq, heads,
head_dim) — "BTHD" — tensors:

  * ``attention_reference`` — materialised scores; the numerics oracle
    (O(T^2) memory, tests only).
  * ``flash_attention`` — the plain PyTorch version of the kernel:
    blockwise online softmax over KV blocks, the same math as the JAX
    package's scan formulation (aligned causal diagonal, ragged-tail
    masking, ``l == 0`` guard).
  * ``flash_attention_fwd`` — the wrapper of the hand-written Hopper
    kernels in ``csrc/flash_attn_fwd.cu``, the counterpart of
    ``pallas_flash_attention``.  A CPU tensor takes ``flash_attention``;
    a CUDA tensor launches a kernel or raises.  Two routes, chosen on
    dtype and head dim (:func:`kernel_route`): ``wgmma`` (bf16 with
    head_dim 64 or 128, the serving prefill: tensor cores fed by TMA)
    and ``simt`` (float32, and bf16 with other head dims: CUDA-core
    FMAs in f32).  On request it also returns each row's log-sum-exp.

The gradient, for training (the JAX package trains through the scan
``flash_attention`` and lets XLA derive its VJP):

  * ``flash_attention_bwd_reference`` — the plain PyTorch backward from
    the forward's output and log-sum-exp, blockwise by the
    FlashAttention-2 formulas (tests, and the card's check);
  * ``flash_attention_bwd`` — the wrapper of the hand-written backward
    kernels in ``csrc/flash_attn_bwd.cu``, two routes chosen from the
    inputs (:func:`bwd_route`): ``wgmma`` (bf16 with head_dim 64 or 128
    and 16-byte aligned bases and strides, the training path: tensor
    cores through ``wgmma`` fed by TMA, as the forward) and ``simt`` (the
    rest: CUDA-core FMAs in f32);
  * ``flash_attention_train`` — attention with a gradient: autograd of
    ``flash_attention`` on CPU tensors, the two kernels (through the
    autograd Function ``FlashAttention``) on CUDA tensors.

For the sequence-parallel impls (``ring_attention.py``): ``merge_partials``
combines two partial results ``(o, lse)`` of attention over disjoint
key blocks into the result over their union, in float32 (elementwise
PyTorch on either device: it is no kernel).
"""
from __future__ import annotations

import ctypes
import struct

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ["attention_reference", "flash_attention", "flash_attention_fwd",
           "kernel_route", "bwd_route", "flash_attention_bwd_reference",
           "flash_attention_bwd", "FlashAttention", "flash_attention_train",
           "merge_partials"]

_NEG_INF = -1e30


def attention_reference(q, k, v, causal=False, sm_scale=None):
    """Materialised-scores attention; the numerics oracle for every other
    implementation (O(T^2) memory — tests only)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) \
        * sm_scale
    if causal:
        Tq, Tk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((Tq, Tk), dtype=torch.bool,
                          device=q.device).tril(Tk - Tq)
        logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _online_block(q, k_blk, v_blk, m, l, o, mask, sm_scale):
    """One online-softmax accumulation step.

    q (B,Tq,H,D); k_blk/v_blk (B,Tb,H,D); m,l (B,H,Tq); o (B,Tq,H,D) f32.
    ``mask`` broadcastable to (B,H,Tq,Tb), True = attend.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).to(torch.float32) \
        * sm_scale
    s = torch.where(mask, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a fully-masked row has exp(-inf - (-inf)) = 1 here; the mask zeroes
    # it and the l == 0 guard in _finalize handles the row
    p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v_blk.to(torch.float32))
    return m_new, l_new, o_new


def _finalize(m, l, o, dtype):
    denom = torch.where(l == 0.0, 1.0, l).transpose(1, 2)[..., None]
    return (o / denom).to(dtype)


def flash_attention(q, k, v, causal=False, sm_scale=None, block_size=512,
                    return_lse=False):
    """Blockwise online-softmax attention over KV blocks of
    ``block_size`` (the plain version of :func:`flash_attention_fwd`).
    Equal to :func:`attention_reference` to f32 round-off, except that
    a row whose every key is masked (causal with Tq > Tk) is 0.  With
    ``return_lse`` also returns the (B, H, Tq) float32 log-sum-exp of
    each row's scaled scores, +inf for a fully masked row."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if sm_scale is None:
        sm_scale = D ** -0.5
    blk = min(block_size, Tk)
    n_blocks = -(-Tk // blk)
    pad = n_blocks * blk - Tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = torch.arange(Tq, device=q.device) + (Tk - Tq)
    m = torch.full((B, H, Tq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
    for i in range(n_blocks):
        lo = i * blk
        kv_pos = lo + torch.arange(blk, device=q.device)
        mask = kv_pos[None, :] < Tk  # padding mask (1, blk)
        if causal:
            mask = mask & (q_pos[:, None] >= kv_pos[None, :])
        m, l, o = _online_block(q, k[:, lo:lo + blk], v[:, lo:lo + blk],
                                m, l, o, mask[None, None], sm_scale)
    out = _finalize(m, l, o, q.dtype)
    if return_lse:
        return out, _lse(m, l)
    return out


def _lse(m, l):
    """Log-sum-exp of the scaled scores from the online softmax's max
    ``m`` and denominator ``l``: +inf where ``l == 0`` (a fully masked
    row), so that ``exp(s - lse)`` recomputes P = 0 there."""
    return torch.where(l == 0.0, float("inf"),
                       m + torch.log(torch.where(l == 0.0, 1.0, l)))


def merge_partials(o1, lse1, o2, lse2):
    """Attention over the union of two disjoint key blocks from the
    partial results over each: ``o`` (B, Tq, H, D) normalised within its
    block and ``lse`` (B, H, Tq) the log-sum-exp of its scaled scores.
    Returns ``(o, lse)`` in float32: ``lse = logaddexp(lse1, lse2)`` and
    ``o = o1 * exp(lse1 - lse) + o2 * exp(lse2 - lse)``.  A partial with
    ``lse = -inf`` (no key seen: an empty accumulator, or a fully masked
    block) weighs 0 and leaves the other untouched; both empty gives an
    empty result (o 0, lse -inf)."""
    f32 = torch.float32
    lse1, lse2 = lse1.to(f32), lse2.to(f32)
    lse = torch.logaddexp(lse1, lse2)
    empty = lse == float("-inf")
    safe = torch.where(empty, 0.0, lse)
    w1 = torch.where(lse1 == float("-inf"), 0.0, torch.exp(lse1 - safe))
    w2 = torch.where(lse2 == float("-inf"), 0.0, torch.exp(lse2 - safe))
    o = o1.to(f32) * w1.transpose(1, 2)[..., None] + \
        o2.to(f32) * w2.transpose(1, 2)[..., None]
    return o, lse


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=False,
                                  sm_scale=None, block_size=512):
    """The plain backward of :func:`flash_attention` from its output
    ``o`` and log-sum-exp ``lse`` (B, H, Tq): ``(dq, dk, dv)`` in q's
    dtype, blockwise over KV blocks by the FlashAttention-2 formulas
    the kernel uses (``D = rowsum(dO * O)``, ``P = exp(S*scale - lse)``
    masked, ``dV = P^T dO``, ``dS = P * (dO V^T - D)``,
    ``dQ = dS K * scale``, ``dK = dS^T Q * scale``).

    Precision follows the VJP of the JAX package's scan: scores, P, dP,
    dS and dV in float32 (the scan casts its scores and V to f32);
    dQ and dK from dS in ``promote(dtype, float32)`` (the einsums before
    the cast), so float64 inputs keep float64 products there."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if sm_scale is None:
        sm_scale = D ** -0.5
    f32 = torch.float32
    wdt = torch.promote_types(q.dtype, f32)
    dof = do.to(f32)
    dsum = (dof * o.to(f32)).sum(-1).transpose(1, 2)  # (B, H, Tq)
    q_pos = torch.arange(Tq, device=q.device) + (Tk - Tq)
    qw = q.to(wdt)
    dq = torch.zeros((B, Tq, H, D), dtype=wdt, device=q.device)
    dks, dvs = [], []
    blk = min(block_size, Tk)
    for lo in range(0, Tk, blk):
        kb, vb = k[:, lo:lo + blk], v[:, lo:lo + blk]
        kv_pos = lo + torch.arange(kb.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb).to(f32) * sm_scale
        if causal:
            mask = (q_pos[:, None] >= kv_pos[None, :])[None, None]
            p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        else:
            p = torch.exp(s - lse[..., None])
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, dof))
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vb.to(f32))
        ds = (p * (dp - dsum[..., None])).to(wdt)
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, kb.to(wdt)) * sm_scale
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qw) * sm_scale)
    return (dq.to(q.dtype), torch.cat(dks, 1).to(q.dtype),
            torch.cat(dvs, 1).to(q.dtype))


# ---------------------------------------------------------------------------
# the Hopper kernels (csrc/flash_attn_fwd.cu)
# ---------------------------------------------------------------------------
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_Q = 64  # q rows per thread block in both kernels
_WGMMA_HEAD_DIMS = (64, 128)
# TMA box of the wgmma kernel over (D, H, T, B): 64 columns (128 bytes,
# the swizzle span) of one head, 64 rows, one batch
_TMA_BOX = (64, 1, 64, 1)


def kernel_route(dtype, head_dim) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for bfloat16 with head
    dim 64 or 128, ``"simt"`` for every other input the kernels take
    (float32 stays off the tensor cores, which would round it to
    TF32)."""
    if dtype == torch.bfloat16 and head_dim in _WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _tma_map(t, ptr, who="flash_attention_fwd"):
    """The 11 TMA map numbers of a wgmma kernel for a (B, T, H, D) bf16
    tensor at base address ``ptr``, read or written in place through its
    strides, in the order ``make_map`` (``csrc/hopper.cuh``) reads them:
    the dims innermost first ``(D, H, T, B)``, the byte strides of H, T
    and B, and :data:`_TMA_BOX`.  The stride of a size-1 dim is never
    read and is given as the packed one.  Raises ``ValueError`` (naming
    ``who``) where TMA cannot take the tensor: a last dim that is not
    contiguous, or a base address or stride that is not a multiple of 16
    bytes."""
    B, T, H, D = t.shape
    sb, st, sh, sd = t.stride()
    es = 2  # bf16, the wgmma route's one dtype
    hs = sh * es if H > 1 else D * es
    ts = st * es if T > 1 else hs * H
    bs = sb * es if B > 1 else ts * T
    if sd != 1:
        raise ValueError("%s: the last dim must be contiguous for TMA "
                         "(stride %d)" % (who, sd))
    if ptr & 15:
        raise ValueError("%s: TMA needs a 16-byte aligned base address, "
                         "got %#x" % (who, ptr))
    if (hs | ts | bs) & 15:
        raise ValueError("%s: TMA needs byte strides that are multiples of "
                         "16, got element strides %s of %d bytes, shape %s"
                         % (who, t.stride(), es, tuple(t.shape)))
    return (D, H, T, B, hs, ts, bs) + _TMA_BOX


def _kernel_lib():
    lib = _build.load("flash_attn_fwd")
    if lib.mxt_flash_attn_fwd.argtypes is None:
        for fn in (lib.mxt_flash_attn_fwd, lib.mxt_flash_attn_fwd_wgmma):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, ctypes.c_float, ctypes.c_void_p]
    return lib


def _bwd_kernel_lib():
    lib = _build.load("flash_attn_bwd")
    if lib.mxt_flash_attn_bwd.argtypes is None:
        for fn in (lib.mxt_flash_attn_bwd, lib.mxt_flash_attn_bwd_wgmma):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, ctypes.c_float]
    return lib


def bwd_route(q, k, v, o, do) -> str:
    """The backward kernel a CUDA call takes: ``"wgmma"`` for bfloat16
    with head dim 64 or 128 when TMA can read q, k, v, o and do (base
    addresses and the byte strides of every dim longer than 1 multiples
    of 16; :func:`_tma_map`), ``"simt"`` for every other input the
    kernels take."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in _WGMMA_HEAD_DIMS:
        return "simt"
    for t in (q, k, v, o, do):
        if t.data_ptr() % 16 or any(
                st % 8 for st, n in zip(t.stride()[:3], t.shape[:3])
                if n > 1):
            return "simt"
    return "wgmma"


def _check_kernel_args(q, k, v, who="flash_attention_fwd"):
    """Raise (naming ``who``) unless the kernels take q, k and v: one
    CUDA device, float32 or bfloat16 of one dtype, (B, T, H, D) with the
    last dim contiguous, head_dim a multiple of 8 up to 128."""
    # the common case in a few cheap reads; the messages are built only
    # on the way to raising
    dev = q.get_device()
    if not (q.is_cuda and k.is_cuda and v.is_cuda) \
            or k.get_device() != dev or v.get_device() != dev:
        name, t = next((n, t) for n, t in (("k", k), ("v", v), ("q", q))
                       if not t.is_cuda or t.device != q.device)
        raise ValueError(
            "%s: q, k and v must all lie on one CUDA device or all on "
            "the CPU (got q on %s, %s on %s)" % (who, q.device, name,
                                                 t.device))
    dt = q.dtype
    if dt not in _KERNEL_DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError(
            "%s: the kernel takes float32 or bfloat16 q/k/v of one dtype "
            "(got q %s, k %s, v %s)" % (who, dt, k.dtype, v.dtype))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError("%s: %s must be (B, T, H, D), got shape %s"
                             % (who, name, tuple(t.shape)))
        if t.stride(3) != 1:
            raise ValueError("%s: the last dim of %s must be contiguous "
                             "(stride %d)" % (who, name, t.stride(3)))
    B, Tq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(
            "%s: k and v must be (B, Tk, H, D) = (%d, Tk, %d, %d), got k "
            "%s and v %s" % (who, B, H, D, tuple(k.shape), tuple(v.shape)))
    if D % 8 or not 0 < D <= 128:
        raise ValueError("%s: head_dim must be a multiple of 8 in [8, "
                         "128], got %d" % (who, D))
    if Tq < 1 or k.shape[1] < 1 or B < 1 or H < 1:
        raise ValueError("%s: empty input %s / %s"
                         % (who, tuple(q.shape), tuple(k.shape)))
    if B * H * -(-max(Tq, k.shape[1]) // _BLOCK_Q) >= 2 ** 31:
        raise ValueError("%s: grid of B*H*ceil(T/64) blocks exceeds the "
                         "launch limit" % who)


def _launch_args(route, q, k, v, o, causal, stream, device) -> bytes:
    """Every integer argument of one kernel launch, packed as the C
    interface of ``csrc/flash_attn_fwd.cu`` reads it: one int64 array,
    packed with ``struct`` (a ctypes array of the same numbers takes
    longer to build than the kernel runs on the card).  The 12-number
    head: the four base addresses, B, H, Tq, Tk, D, causal, the stream
    and the device; then, for ``wgmma``, the 11 TMA map numbers of q,
    k, v and o (:func:`_tma_map`; raises where TMA cannot take one), for
    ``simt`` the dtype code and the (batch, seq, head) element strides
    of q, k, v and o."""
    B, Tq, H, D = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    head = ptrs + (B, H, Tq, k.shape[1], D, int(bool(causal)), stream,
                   device)
    if route == "wgmma":
        maps = ()
        for t, ptr in zip((q, k, v, o), ptrs):
            maps += _tma_map(t, ptr)
        return struct.pack("56q", *head, *maps)
    strides = q.stride()[:3] + k.stride()[:3] + v.stride()[:3] + \
        o.stride()[:3]
    return struct.pack("25q", *head, _KERNEL_DTYPES[q.dtype], *strides)


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None,
                        return_lse=False):
    """Forward flash attention over BTHD ``q`` (B, Tq, H, D) and ``k``,
    ``v`` (B, Tk, H, D); causal masking aligns the diagonal at
    ``q_pos = i + Tk - Tq``.  Returns (B, Tq, H, D) in q's dtype, and
    with ``return_lse`` also the (B, H, Tq) float32 log-sum-exp of each
    row's scaled scores (+inf for a fully masked row), which
    :func:`flash_attention_bwd` needs.

    CPU tensors run :func:`flash_attention`.  CUDA tensors launch a
    Hopper kernel on the current stream, or raise: float32 or bfloat16,
    head_dim a multiple of 8 up to 128, last dim contiguous; the
    ``wgmma`` route (:func:`kernel_route`) also needs 16-byte aligned
    bases and strides (:func:`_tma_map`).  The bf16 ``wgmma`` route
    rounds the probabilities to bf16 for P·V, as the TPU kernel does;
    the ``simt`` route keeps them in f32."""
    if q.is_cpu and k.is_cpu and v.is_cpu:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               return_lse=return_lse)
    _check_kernel_args(q, k, v)
    B, Tq, H, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    route = kernel_route(q.dtype, D)
    o = q.new_empty((B, Tq, H, D))
    lse = q.new_empty((B, H, Tq), dtype=torch.float32) if return_lse \
        else None
    dev = q.get_device()
    args = _launch_args(route, q, k, v, o, causal,
                        torch._C._cuda_getCurrentRawStream(dev), dev)
    lib = _kernel_lib()
    lse_ptr = None if lse is None else lse.data_ptr()
    if route == "wgmma":
        err = lib.mxt_flash_attn_fwd_wgmma(args, sm_scale, lse_ptr)
    else:
        err = lib.mxt_flash_attn_fwd(args, sm_scale, lse_ptr)
    if err != 0:
        raise RuntimeError("flash_attention_fwd: %s kernel launch failed "
                           "with CUDA error %d" % (route, err))
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_route[route] += 1
    return (o, lse) if return_lse else o


#: kernel launches since the last reset (CPU calls are not launches), in
#: all and by route
flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_route = {"wgmma": 0, "simt": 0}


def _bwd_launch_args(route, q, k, v, o, do, lse, dsum, dq, dk, dv, causal,
                     stream, device) -> bytes:
    """The packed int64 arguments of the backward entries of
    ``csrc/flash_attn_bwd.cu``.  The 19-number head: the ten base
    addresses (q, k, v, o, dO, lse, the D scratch, dq, dk, dv), B, H, Tq,
    Tk, D, causal, the stream, the device and the dtype code; then, for
    ``wgmma``, the 11 TMA map numbers of q, k, v, o, dO, dq, dk and dv
    (:func:`_tma_map`; raises where TMA cannot take one), for ``simt``
    the (batch, seq, head) element strides of the same eight."""
    B, Tq, H, D = q.shape
    ts = (q, k, v, o, do, lse, dsum, dq, dk, dv)
    ptrs = tuple(t.data_ptr() for t in ts)
    head = ptrs + (B, H, Tq, k.shape[1], D, int(bool(causal)), stream,
                   device, _KERNEL_DTYPES[q.dtype])
    tail = ()
    for t, ptr in zip(ts[:5] + ts[7:], ptrs[:5] + ptrs[7:]):
        tail += _tma_map(t, ptr, "flash_attention_bwd") \
            if route == "wgmma" else t.stride()[:3]
    return struct.pack("%dq" % (len(head) + len(tail)), *head, *tail)


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, sm_scale=None):
    """The gradient of :func:`flash_attention_fwd`: ``(dq, dk, dv)`` in
    q's dtype from q, k, v, the forward's output ``o`` and log-sum-exp
    ``lse`` (B, H, Tq) float32, and the output's gradient ``do``.

    CPU tensors run :func:`flash_attention_bwd_reference`.  CUDA tensors
    launch a Hopper backward kernel on the current stream (two launches:
    dq and the rows' ``D``, then dk and dv; the route by
    :func:`bwd_route`), or raise; it takes what the forward takes
    (float32 or bfloat16, head_dim a multiple of 8 up to 128, any Tq and
    Tk, strided q/k/v with the last dim contiguous), accumulates in f32
    and uses no atomics, so its result is the same bits on every run.
    The ``wgmma`` route rounds P and dS to bf16 for their products, as
    FlashAttention-2 does; ``simt`` keeps them in f32."""
    if all(t.is_cpu for t in (q, k, v, o, lse, do)):
        return flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=causal,
                                             sm_scale=sm_scale)
    who = "flash_attention_bwd"
    _check_kernel_args(q, k, v, who)
    B, Tq, H, D = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype \
                or t.shape != q.shape:
            raise ValueError(
                "%s: %s must match q (%s %s on %s), got %s %s on %s"
                % (who, name, tuple(q.shape), q.dtype, q.device,
                   tuple(t.shape), t.dtype, t.device))
    if lse.device != q.device or lse.dtype != torch.float32 \
            or lse.shape != (B, H, Tq) or not lse.is_contiguous():
        raise ValueError(
            "%s: lse must be a contiguous (B, H, Tq) = (%d, %d, %d) "
            "float32 tensor on %s, got %s %s on %s"
            % (who, B, H, Tq, q.device, tuple(lse.shape), lse.dtype,
               lse.device))
    if o.stride(3) != 1:
        o = o.contiguous()
    if do.stride(3) != 1:
        do = do.contiguous()
    if sm_scale is None:
        sm_scale = D ** -0.5
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    dsum = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    route = bwd_route(q, k, v, o, do)
    dev = q.get_device()
    args = _bwd_launch_args(route, q, k, v, o, do, lse, dsum, dq, dk, dv,
                            causal, torch._C._cuda_getCurrentRawStream(dev),
                            dev)
    lib = _bwd_kernel_lib()
    if route == "wgmma":
        err = lib.mxt_flash_attn_bwd_wgmma(args, sm_scale)
    else:
        err = lib.mxt_flash_attn_bwd(args, sm_scale)
    if err != 0:
        raise RuntimeError("%s: %s kernel launch failed with CUDA error %d"
                           % (who, route, err))
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route[route] += 1
    return dq, dk, dv


#: backward calls that launched the kernels since the last reset (each
#: is the dq launch and the dk/dv launch; CPU calls are not launches),
#: in all and by route
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = {"wgmma": 0, "simt": 0}


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient on the Hopper kernels: the
    forward kernel with the log-sum-exp, then the backward kernel.
    Saves q, k, v, the output and the log-sum-exp (O(T) beyond the
    inputs, never the (T, T) scores)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     sm_scale=sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal,
                                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, causal=False, sm_scale=None):
    """Attention with a gradient, for training: CPU tensors go through
    autograd of :func:`flash_attention` (the plain math of the JAX
    package's scan); CUDA tensors through :class:`FlashAttention` (the
    forward and backward kernels), or raise — a float64 CUDA tensor
    raises as the forward kernel does."""
    if q.is_cpu and k.is_cpu and v.is_cpu:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return FlashAttention.apply(q, k, v, causal, sm_scale)
