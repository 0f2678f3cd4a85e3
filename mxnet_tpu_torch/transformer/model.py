"""Decoder-only transformer LM (RMSNorm, RoPE, tied embedding head).

Counterpart: ``mxnet_tpu/transformer/model.py``.  The model is a
function of a flat ``{name: tensor}`` parameter dict with the JAX
package's names, shapes and ``(in, out)`` orientation (``x @ W``), so
``convert.params_from_jax`` carries parameters across unchanged.

``apply`` takes the attention as an ``attn_fn``: :func:`make_attn_fn`
binds the training attention, ``flash`` on one sequence
(``parallel.attention.flash_attention_train``: the Hopper forward and
backward kernels on the card), or ``ring`` / ``ulysses`` on a sequence
sharded over a mesh's ``sp`` axis (``parallel.ring_attention``,
``parallel.sequence``: the same kernels under them), and the generation
prefill runs the forward kernel (``flash_attention_fwd``) where the JAX
package runs the dense ``_masked_attn``.  Decode keeps the gather and
the masked attention in plain PyTorch, as the JAX package leaves them
to XLA.  ``apply`` takes the JAX package's ``remat`` policies ``none``,
``block`` and ``attention`` (``remat.py``); ``lm_loss`` is its loss.
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import env as _env
from .._device import resolve_device
from ..parallel.attention import flash_attention_fwd, flash_attention_train
from ..remat import checkpoint_scope, remat_policy

__all__ = [
    "TransformerConfig", "ATTENTION_IMPLS", "attention_impl",
    "make_attn_fn", "param_shapes", "init_params", "apply", "lm_loss",
    "dense_causal_attn", "gather_kv", "apply_prefill", "apply_decode",
]

ATTENTION_IMPLS = ("flash", "ring", "ulysses")


class TransformerConfig(NamedTuple):
    """Decoder-only LM dimensions + dtypes.  ``d_ff`` ``None`` means
    the conventional ``4*d_model``."""
    vocab_size: int = 256
    n_layers: int = 2
    d_model: int = 64
    n_heads: int = 4
    d_ff: Optional[int] = None
    rope_base: float = 10000.0
    dtype: str = "float32"        # compute (activation) dtype
    param_dtype: str = "float32"  # parameter storage dtype
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError("unknown dtype %r" % (name,))
    return dt


def _acc_dtype(compute: torch.dtype) -> torch.dtype:
    """``promote_types(compute, float32)``: the head's accumulation type
    (f32, or f64 under the fp64 control methodology)."""
    return torch.promote_types(compute, torch.float32)


def attention_impl(override: Optional[str] = None) -> str:
    """The selected attention implementation: explicit argument wins,
    else ``MXNET_ATTENTION_IMPL`` (default ``flash``).  Unknown names
    raise: a typo'd impl silently falling back would train the wrong
    kernel."""
    impl = override if override is not None \
        else _env.get_str("MXNET_ATTENTION_IMPL")
    if impl not in ATTENTION_IMPLS:
        raise ValueError(
            "unknown attention impl %r (MXNET_ATTENTION_IMPL); pick one "
            "of %s" % (impl, "/".join(ATTENTION_IMPLS)))
    return impl


def make_attn_fn(impl: Optional[str] = None, sp_axis: Optional[str] = None,
                 causal: bool = True, mesh=None):
    """Bind an attention impl to ``fn(q, k, v) -> out`` over
    (B, T_local, H, Dh) activations, with a gradient (the JAX package's
    rules, ``mxnet_tpu/transformer/model.py:87-120``).

    Without ``sp_axis``: ``flash``, the Hopper forward and backward
    kernels on CUDA tensors and autograd of their plain version on CPU
    tensors (``parallel.attention.flash_attention_train``); ``ring`` and
    ``ulysses`` raise (their collectives need the axis).  With
    ``sp_axis`` (a mesh axis of ``mesh``) the fn is a per-rank body over
    this rank's slice of the sequence: ``ring`` or ``ulysses``; ``flash``
    raises, because attention over a sequence shard alone is wrong math,
    not a slower variant."""
    impl = attention_impl(impl)
    if sp_axis is None:
        if impl != "flash":
            raise ValueError(
                "attention impl %r needs a sequence-parallel mesh axis; "
                "build the step over a mesh with 'sp' (or select "
                "MXNET_ATTENTION_IMPL=flash)" % impl)
        return functools.partial(flash_attention_train, causal=causal)
    if mesh is None:
        raise ValueError("make_attn_fn: sp_axis %r needs the mesh it "
                         "names" % (sp_axis,))
    if impl == "ring":
        from ..parallel.ring_attention import ring_attention

        return functools.partial(ring_attention, mesh=mesh,
                                 axis_name=sp_axis, causal=causal)
    if impl == "ulysses":
        from ..parallel.sequence import ulysses_attention

        return functools.partial(ulysses_attention, mesh=mesh,
                                 axis_name=sp_axis, causal=causal)
    raise ValueError(
        "attention impl %r cannot run sequence-sharded (sp axis %r); "
        "pick ring or ulysses" % (impl, sp_axis))


# ---------------------------------------------------------------------------
# parameters: flat dict in forward (layer) order
# ---------------------------------------------------------------------------
def param_shapes(cfg: TransformerConfig) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, dtype)`` for every parameter in layer order."""
    D, F_, V = cfg.d_model, cfg.ff_dim, cfg.vocab_size
    dt = cfg.param_dtype
    out = [("embed", (V, D), dt)]
    for i in range(cfg.n_layers):
        p = "blk%d." % i
        out += [
            (p + "attn_norm", (D,), dt),
            (p + "wqkv", (D, 3 * D), dt),
            (p + "wo", (D, D), dt),
            (p + "mlp_norm", (D,), dt),
            (p + "w1", (D, F_), dt),
            (p + "w2", (F_, D), dt),
        ]
    out.append(("final_norm", (D,), dt))
    return out


def init_params(generator: torch.Generator, cfg: TransformerConfig, *,
                device=None) -> Dict[str, torch.Tensor]:
    """Initialize the flat param dict: N(0, 0.02) matrices (wo/w2
    scaled down by sqrt(2L) — the GPT-2 residual-stream convention),
    unit norms.  Draws in f32 from ``generator`` (a CPU generator, so
    the weights do not depend on the device) in parameter order, then
    casts to ``param_dtype`` on ``device`` (default ``cuda``).  The
    draws differ from the JAX package's for the same seed: parity
    tests carry parameters across with ``convert.params_from_jax``."""
    device = resolve_device(device)
    if cfg.d_model % cfg.n_heads:
        raise ValueError("d_model %d must divide by n_heads %d"
                         % (cfg.d_model, cfg.n_heads))
    resid_scale = (2.0 * max(cfg.n_layers, 1)) ** -0.5
    params: Dict[str, torch.Tensor] = {}
    for name, shape, dtype in param_shapes(cfg):
        dt = _dtype(dtype)
        if name.endswith("norm"):
            params[name] = torch.ones(shape, dtype=dt, device=device)
            continue
        scale = 0.02
        if name.endswith(("wo", "w2")):
            scale *= resid_scale
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        params[name] = (scale * w).to(device=device, dtype=dt)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _rmsnorm(x, gain, eps):
    # f32 statistics (or wider, for the fp64 control methodology) — never
    # narrower than f32, exactly as the JAX package promotes
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    scale = torch.reciprocal(torch.sqrt(
        torch.mean(xf * xf, dim=-1, keepdim=True) + eps))
    return (xf * scale).to(x.dtype) * gain.to(x.dtype)


def _rope(x, positions, base):
    """Rotary position embedding over (B, T, H, Dh) with ``positions``
    (T,) shared across the batch or (B, T) per sequence.  Angles, cos,
    sin and the rotation run in float32 whatever x's dtype (fp64
    included), as in the JAX package."""
    Dh = x.shape[-1]
    half = Dh // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    if ang.dim() == 2:                    # (T, half)
        cos = torch.cos(ang)[None, :, None, :]
        sin = torch.sin(ang)[None, :, None, :]
    else:                                 # (B, T, half)
        cos = torch.cos(ang)[:, :, None, :]
        sin = torch.sin(ang)[:, :, None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _mlp(h, params, p, eps):
    m = _rmsnorm(h, params[p + "mlp_norm"], eps)
    m = _gelu(m @ params[p + "w1"].to(m.dtype)) @ params[p + "w2"].to(
        m.dtype)
    return h + m


def _qkv(h, params, p, cfg, shape, positions):
    a = _rmsnorm(h, params[p + "attn_norm"], cfg.eps)
    qkv = a @ params[p + "wqkv"].to(a.dtype)
    q, k, v = torch.split(qkv, cfg.d_model, dim=-1)
    q = _rope(q.reshape(shape), positions, cfg.rope_base)
    k = _rope(k.reshape(shape), positions, cfg.rope_base)
    return q, k, v.reshape(shape)


def _tied_head(h, embed, compute):
    # logits accumulate in f32 (f64 under the control methodology)
    # regardless of the bf16 compute dtype
    acc = _acc_dtype(compute)
    return h.to(acc) @ embed.to(acc).t()


def apply(params: Dict, tokens, cfg: TransformerConfig, *, attn_fn,
          pos_offset: int = 0, remat: Optional[str] = None):
    """Forward pass: ``tokens`` (B, T) int -> logits (B, T, vocab) in
    ``promote(dtype, float32)`` (tied embedding head).  ``remat``
    overrides ``MXNET_REMAT_POLICY``: ``block`` recomputes each decoder
    block in the backward pass, ``attention`` each block's attention
    sub-graph (``remat.checkpoint_scope``)."""
    policy = remat_policy(remat)
    compute = _dtype(cfg.dtype)
    B, t = tokens.shape
    positions = pos_offset + torch.arange(t, device=tokens.device)
    embed = params["embed"]
    h = embed.to(compute)[tokens]
    shape = (B, t, cfg.n_heads, cfg.head_dim)

    def attn_part(h, p):
        q, k, v = _qkv(h, params, p, cfg, shape, positions)
        o = attn_fn(q, k, v)
        return o.reshape(B, t, cfg.d_model) @ params[p + "wo"].to(o.dtype)

    def block(h, p):
        h = h + checkpoint_scope(attn_part, policy, "attention")(h, p)
        return _mlp(h, params, p, cfg.eps)

    block = checkpoint_scope(block, policy, "block")
    for i in range(cfg.n_layers):
        h = block(h, "blk%d." % i)
    h = _rmsnorm(h, params["final_norm"], cfg.eps)
    return _tied_head(h, embed, compute)


def lm_loss(logits, labels):
    """Mean next-token cross entropy: logits (B, T, V) f32 (or f64),
    labels (B, T) int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# generation forwards: prefill/decode over a PAGED KV cache
#
# The cache is a per-layer pool of fixed-size token blocks
# ``{"k<i>"|"v<i>": (num_blocks, block_tokens, H, Dh)}`` plus a
# per-sequence block table (serving/kvcache.py owns allocation; block 0
# is the GARBAGE block — every write from a padded position or an
# inactive slot is routed there, so the step never branches on
# liveness).  Unlike the JAX package, the pools are updated IN PLACE
# (a functional copy of every pool per layer per token would move the
# whole cache each tick); ``apply_prefill``/``apply_decode`` still
# return the pages dict so callers read like the reference.
# ---------------------------------------------------------------------------
def _masked_attn(q, k, v, mask):
    """Naive dense attention with an explicit boolean ``mask``
    (B, Tq, Tk): f32 scores/softmax, output cast back to q's dtype —
    the generation tier's reference math."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    s = torch.where(mask[:, None, :, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v.to(torch.float32)).to(q.dtype)


def dense_causal_attn(q, k, v):
    """Dense causal attention over (B, T, H, Dh) in the generation
    tier's reference formulation — pass as ``attn_fn`` to :func:`apply`
    for the single-sequence reference the paged decode must match."""
    t = q.shape[1]
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    return _masked_attn(q, k, v, causal[None].expand(q.shape[0], t, t))


def _scatter_tokens(pool, x, block_tables, pos, block_tokens, valid=None):
    """Write per-token K or V rows ``x`` (B, T, H, Dh) into the block
    ``pool`` (N, block_tokens, H, Dh), in place, at token positions
    ``pos`` (B, T) addressed through ``block_tables`` (B, W).  Positions
    with ``valid`` False collapse to flat index 0, the garbage block."""
    bt = int(block_tokens)
    blk = torch.gather(block_tables, 1, torch.div(pos, bt,
                                                  rounding_mode="floor"))
    flat = blk * bt + pos % bt
    if valid is not None:
        flat = torch.where(valid, flat, 0)
    flat_pool = pool.view((-1,) + tuple(pool.shape[2:]))
    flat_pool.index_copy_(0, flat.reshape(-1),
                          x.reshape((-1,) + tuple(x.shape[2:])).to(
                              pool.dtype))
    return pool


def gather_kv(pages, block_tables, layer):
    """Gather one layer's cached K/V through the block tables:
    ``(B, W)`` tables over ``(N, bt, H, Dh)`` pools -> two
    ``(B, W*bt, H, Dh)`` dense views."""
    k = pages["k%d" % layer][block_tables]
    v = pages["v%d" % layer][block_tables]
    b, w, bt = k.shape[:3]
    return (k.reshape((b, w * bt) + tuple(k.shape[3:])),
            v.reshape((b, w * bt) + tuple(v.shape[3:])))


def apply_prefill(params, tokens, prompt_lens, cfg: TransformerConfig, *,
                  pages, block_tables, block_tokens):
    """Prefill forward: right-padded prompts ``tokens`` (B, T) with
    real lengths ``prompt_lens`` (B,) -> (last-real-token logits
    (B, vocab), pages).  Causal attention over the padded length runs
    the flash-attention kernel (causality makes the padding rows
    invisible to every real row); each layer's roped K and raw V are
    scattered into the paged cache.  ``block_tables`` is
    (B, T // block_tokens)."""
    compute = _dtype(cfg.dtype)
    b, t = tokens.shape
    dev = tokens.device
    positions = torch.arange(t, device=dev)
    pos2 = positions[None, :].expand(b, t)
    valid = pos2 < prompt_lens[:, None]
    embed = params["embed"]
    h = embed.to(compute)[tokens]
    shape = (b, t, cfg.n_heads, cfg.head_dim)
    for i in range(cfg.n_layers):
        p = "blk%d." % i
        q, k, v = _qkv(h, params, p, cfg, shape, positions)
        for nm, val in (("k%d" % i, k), ("v%d" % i, v)):
            _scatter_tokens(pages[nm], val, block_tables, pos2,
                            block_tokens, valid=valid)
        o = flash_attention_fwd(q, k, v, causal=True)
        h = h + o.reshape(b, t, cfg.d_model) @ params[p + "wo"].to(o.dtype)
        h = _mlp(h, params, p, cfg.eps)
    h = _rmsnorm(h, params["final_norm"], cfg.eps)
    last = h[torch.arange(b, device=dev), (prompt_lens - 1).clamp(0, t - 1)]
    return _tied_head(last, embed, compute), pages


def apply_decode(params, tokens, positions, cfg: TransformerConfig, *,
                 pages, block_tables, block_tokens):
    """One decode tick: current tokens (B,) at cache cursors
    ``positions`` (B,) -> (next-token logits (B, vocab), pages).  Per
    layer: rope q/k at the cursor, scatter k/v into the paged cache,
    THEN gather the (B, W*bt) history through the block tables — the
    new token reads itself back through the cache — and attend under
    the inclusive length mask.  Inactive slots ride along with all-zero
    tables (every write lands in the garbage block)."""
    compute = _dtype(cfg.dtype)
    b = tokens.shape[0]
    span = block_tables.shape[1] * int(block_tokens)
    pos2 = positions[:, None]
    mask = (torch.arange(span, device=tokens.device)[None, :]
            <= positions[:, None])[:, None, :]
    embed = params["embed"]
    h = embed.to(compute)[tokens][:, None, :]
    shape = (b, 1, cfg.n_heads, cfg.head_dim)
    for i in range(cfg.n_layers):
        p = "blk%d." % i
        q, k, v = _qkv(h, params, p, cfg, shape, pos2)
        for nm, val in (("k%d" % i, k), ("v%d" % i, v)):
            _scatter_tokens(pages[nm], val, block_tables, pos2,
                            block_tokens)
        kc, vc = gather_kv(pages, block_tables, i)
        o = _masked_attn(q, kc, vc, mask)
        h = h + o.reshape(b, 1, cfg.d_model) @ params[p + "wo"].to(o.dtype)
        h = _mlp(h, params, p, cfg.eps)
    h = _rmsnorm(h, params["final_norm"], cfg.eps)
    return _tied_head(h[:, 0], embed, compute), pages
