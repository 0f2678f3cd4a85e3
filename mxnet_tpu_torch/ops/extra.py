"""The sparse ops of the reference's op tail: ``cast_storage``,
``row_sparse_embedding_grad``, ``_contrib_SparseEmbedding`` and
``_sparse_retain``; and ``bipartite_matching``.

Counterpart: ``mxnet_tpu/ops/extra.py`` (:158, :289-367).  The rest of
that module (SVMOutput, Correlation, the loss and alias tail) is queued
(ROADMAP A12).  The JAX package's ``custom_vjp`` is a
``torch.autograd.Function`` here.
"""
from __future__ import annotations

import math

import torch

from .registry import register


@register("cast_storage")
def _cast_storage_op(data, stype="default", **_):
    """ref: src/operator/tensor/cast_storage.cc:33.  Storage types are
    per-NDArray in this package (graphs run dense), so inside a graph the
    op is the identity; the imperative ``nd.cast_storage`` converts the
    container (``ndarray/sparse.py``)."""
    if stype not in ("default", "row_sparse", "csr"):
        raise ValueError("cast_storage: unknown stype %r" % (stype,))
    return data


def row_sparse_embedding_grad(ids, cotangent, vocab):
    """The row-sparse ``(rows, values)`` gradient of an embedding gather.

    The batch's ids deduplicate into at most B = ``ids.numel()`` sorted
    unique rows, padded to B with row id ``vocab`` (one past the table)
    as the JAX package's static-size ``jnp.unique`` pads them, and the
    per-sample cotangents segment-sum over them: the workspace is B rows,
    never ``vocab``.  The padding slots carry zero values; a caller drops
    them or scatters into a table of ``vocab + 1`` rows (never past the
    end, which is a device-side assert on CUDA).

    Returns ``(rows (B,) int64, values (B, dim))``.  On a CUDA tensor the
    unique's size is data-dependent: one host sync."""
    flat = ids.reshape(-1).to(torch.int64)
    b = flat.shape[0]
    cot = cotangent.reshape(b, -1)
    uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
    rows = torch.full((b,), int(vocab), dtype=torch.int64,
                      device=flat.device)
    rows[:uniq.numel()] = uniq
    values = torch.zeros((b, cot.shape[1]), dtype=cot.dtype,
                         device=cot.device)
    values.index_add_(0, inv.reshape(-1), cot)
    return rows, values


class _SparseEmbeddingFn(torch.autograd.Function):
    """The gather of ``Embedding``, whose weight gradient is computed
    row-sparsely (dedup + segment sum over <= B rows) and scattered once
    into the dense gradient the autograd contract hands back."""

    @staticmethod
    def forward(ctx, weight, idx):
        ctx.save_for_backward(idx)
        ctx.vocab = weight.shape[0]
        return weight.index_select(0, idx.reshape(-1)).reshape(
            tuple(idx.shape) + tuple(weight.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        vocab = ctx.vocab
        rows, values = row_sparse_embedding_grad(idx, g, vocab)
        # one spare row takes the padding slots (their values are zero):
        # no index reaches past the buffer, and nothing syncs the host
        dw = torch.zeros((vocab + 1,) + tuple(g.shape[idx.dim():]),
                         dtype=g.dtype, device=g.device)
        dw.index_add_(0, rows, values.reshape((rows.numel(),)
                                              + tuple(dw.shape[1:])))
        return dw[:vocab], None


@register("_contrib_SparseEmbedding", input_names=["data", "weight"])
def _sparse_embedding(data, weight, input_dim=0, output_dim=0,
                      dtype="float32", **_):
    """ref: src/operator/contrib/ SparseEmbeddingOpForwardEx: the gather
    of ``Embedding`` (ids clipped to [0, vocab - 1]); the weight's
    gradient comes from :func:`row_sparse_embedding_grad`."""
    idx = torch.clamp(data.to(torch.int64), 0, weight.shape[0] - 1)
    return _SparseEmbeddingFn.apply(weight, idx)


@register("_sparse_retain", aliases=("sparse_retain",))
def _sparse_retain_op(data, indices, **_):
    """ref: src/operator/tensor/sparse_retain.cc:33: keep only the listed
    rows.  Dense form: zero every row not in ``indices`` (its gradient is
    the same row mask)."""
    idx = indices.to(torch.int64).reshape(-1)
    mask = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    mask[idx] = True
    mask = mask.reshape((-1,) + (1,) * (data.dim() - 1))
    return torch.where(mask, data, torch.zeros((), dtype=data.dtype,
                                               device=data.device))


@register("_contrib_bipartite_matching", aliases=("bipartite_matching",),
          nondiff=True, num_outputs=2)
def _bipartite_matching(data, threshold=None, is_ascend=False, topk=-1,
                        **_):
    """Greedy bipartite matching on a (..., N, M) score matrix ->
    (row->col (..., N), col->row (..., M)), -1 where unmatched (ref:
    contrib/bounding_box.cc).  Each round takes the best pair left (the
    first on ties) if it passes ``threshold``; scores compare in float32,
    as the JAX package's.  ``topk`` > 0 stops after topk + 1 matches (the
    reference's post-increment break)."""
    if threshold is None:
        threshold = -math.inf if not is_ascend else math.inf
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
    B, N, M = data.shape
    dev = data.device
    work = (-data if is_ascend else data).to(torch.float32)
    limit = -threshold if is_ascend else threshold
    rounds = min(N, M) if topk <= 0 else min(topk + 1, N, M)
    rm = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    cm = torch.full((B, M), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(N, device=dev)
    cols = torch.arange(M, device=dev)
    bidx = torch.arange(B, device=dev)
    neg_inf = torch.full((), -math.inf, dtype=torch.float32, device=dev)
    for _ in range(rounds):
        flat = work.reshape(B, -1).argmax(dim=1)
        i, j = flat // M, flat % M
        good = work[bidx, i, j] > limit
        hit_r = (rows[None, :] == i[:, None]) & good[:, None]
        hit_c = (cols[None, :] == j[:, None]) & good[:, None]
        rm = torch.where(hit_r, j[:, None], rm)
        cm = torch.where(hit_c, i[:, None], cm)
        work = torch.where(hit_r[:, :, None] | hit_c[:, None, :], neg_inf,
                           work)
    rm, cm = rm.to(data.dtype), cm.to(data.dtype)
    if squeeze:
        return rm[0], cm[0]
    return rm, cm
