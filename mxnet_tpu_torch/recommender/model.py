"""The embedding-dominated CTR model of the recommender tier.

Counterpart: ``mxnet_tpu/recommender/model.py``.  Wide categorical
features -> one embedding table a field -> concat -> a small MLP head ->
a click logit.  The tables hold nearly all the parameters, so the
sparse step takes the batch's pulled unique rows as its inputs and its
embedding gradients come back over those rows, ``(unique_rows, dim)``,
never ``(vocab, dim)``.  The dense twin (full tables, a vocab-sized
scatter in backward) is the numerics control.

The model is a function of a flat ``{name: tensor}`` dict in forward
order, like ``transformer/model.py``; the train steps are plain
functions with autograd where the JAX package jits ``value_and_grad``.
Promotion follows JAX: a float32 operand meets a float64 one in the
wider dtype (``torch.matmul`` refuses mixed operands, so :func:`_mm`
casts), and :func:`logloss` works in float32.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from .._device import resolve_device
from ..base import torch_dtype

__all__ = [
    "RecommenderConfig", "param_shapes", "table_names",
    "dense_param_names", "init_params", "apply", "apply_rows",
    "logloss", "make_sparse_train_step", "make_dense_train_step",
]


class RecommenderConfig(NamedTuple):
    """Dimensions of the clickstream model.  ``vocab`` is the rows of
    EACH field's table: with Zipf ids the ideal pulled-bytes ratio is
    ``unique_rows_per_batch / (n_fields * vocab)``."""
    n_fields: int = 8
    vocab: int = 65536
    embed_dim: int = 16
    mlp_hidden: Tuple[int, ...] = (64, 32)
    dtype: str = "float32"


def table_names(cfg: RecommenderConfig) -> List[str]:
    return ["emb%d" % f for f in range(cfg.n_fields)]


def param_shapes(cfg: RecommenderConfig) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, dtype)`` in forward order: the tables, then the
    MLP head (``train.py`` shards the first row-sparsely over the store
    and replicates the second)."""
    D = cfg.embed_dim
    out = [(n, (cfg.vocab, D), cfg.dtype) for n in table_names(cfg)]
    fan_in = cfg.n_fields * D
    for i, h in enumerate(cfg.mlp_hidden):
        out += [("mlp%d_w" % i, (fan_in, int(h)), cfg.dtype),
                ("mlp%d_b" % i, (int(h),), cfg.dtype)]
        fan_in = int(h)
    out += [("out_w", (fan_in, 1), cfg.dtype), ("out_b", (1,), cfg.dtype)]
    return out


def dense_param_names(cfg: RecommenderConfig) -> List[str]:
    tables = set(table_names(cfg))
    return [n for n, _s, _d in param_shapes(cfg) if n not in tables]


def init_params(generator: torch.Generator, cfg: RecommenderConfig,
                device=None) -> Dict[str, torch.Tensor]:
    """The flat parameter dict from ``generator`` (a CPU generator: the
    draws do not depend on the device): N(0, 0.01) tables, He-scaled
    MLP matrices, zero biases, drawn in ``param_shapes`` order, on
    ``device`` (default ``cuda``).  The JAX package draws from
    ``jax.random``; to start from its parameters, carry its dict across
    (``convert.params_from_jax``, ``RecommenderTrainStep(params=)``)."""
    dev = resolve_device(device)
    params: Dict[str, torch.Tensor] = {}
    for name, shape, dtype in param_shapes(cfg):
        if name.endswith("_b"):
            t = torch.zeros(shape, dtype=torch.float32)
        else:
            scale = 0.01 if name.startswith("emb") else (2.0 / shape[0]) ** 0.5
            t = scale * torch.randn(shape, generator=generator,
                                    dtype=torch.float32)
        params[name] = t.to(device=dev, dtype=torch_dtype(dtype))
    return params


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _mlp(x, params: Dict, cfg: RecommenderConfig):
    h = x
    for i in range(len(cfg.mlp_hidden)):
        h = torch.relu(_mm(h, params["mlp%d_w" % i]) + params["mlp%d_b" % i])
    return (_mm(h, params["out_w"]) + params["out_b"]).squeeze(-1)


def apply(params: Dict, ids: torch.Tensor, cfg: RecommenderConfig):
    """The dense forward (full tables): ``ids`` (B, n_fields) -> click
    logits (B,), ids clipped to [0, vocab - 1] as the JAX package's
    ``take`` clips them (``index_select`` would raise).  The control:
    its backward scatter-adds into vocab-sized buffers."""
    ids = torch.clamp(ids.to(torch.int64), 0, cfg.vocab - 1)
    embs = [params[n].index_select(0, ids[:, f])
            for f, n in enumerate(table_names(cfg))]
    return _mlp(torch.cat(embs, dim=-1), params, cfg)


def apply_rows(rows_data, inverse, dense_params: Dict,
               cfg: RecommenderConfig):
    """The sparse forward over PULLED rows: ``rows_data[f]`` is the
    (U_pad, dim) block of field f's unique rows, ``inverse[f]`` (B,)
    maps each sample into it (the host's ``np.unique(...,
    return_inverse=True)``).  No (vocab, dim) table exists here, so
    neither does its gradient."""
    embs = [rows_data[f].index_select(0, inverse[f].to(torch.int64))
            for f in range(cfg.n_fields)]
    return _mlp(torch.cat(embs, dim=-1), dense_params, cfg)


def logloss(logits, labels):
    """Sigmoid binary cross-entropy, numerically stable, in float32,
    the batch's mean."""
    z = logits.to(torch.float32)
    y = labels.to(torch.float32)
    return torch.mean(torch.maximum(z, torch.zeros_like(z)) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def _leaves(tensors):
    return [t.detach().requires_grad_(True) for t in tensors]


def make_sparse_train_step(cfg: RecommenderConfig):
    """``step(rows_data, inverse, dense_params, labels) -> (loss, d_rows,
    d_dense)``: ``d_rows[f]`` in the same (U_pad, dim) space as
    ``rows_data[f]`` (the gather's backward is a segment sum over the
    batch's rows there), ``d_dense`` by name."""

    def step(rows_data, inverse, dense_params, labels):
        names = list(dense_params)
        rows = _leaves(rows_data)
        dense = dict(zip(names, _leaves(dense_params[n] for n in names)))
        with torch.enable_grad():
            loss = logloss(apply_rows(rows, inverse, dense, cfg), labels)
            grads = torch.autograd.grad(loss, rows + [dense[n]
                                                      for n in names])
        n = len(rows)
        return (loss.detach(), tuple(grads[:n]),
                dict(zip(names, grads[n:])))

    return step


def make_dense_train_step(cfg: RecommenderConfig):
    """The dense control ``step(params, ids, labels) -> (loss, grads)``
    with full tables: its embedding gradients are dense (vocab, dim)
    scatter-adds."""

    def step(params, ids, labels):
        names = list(params)
        leaves = dict(zip(names, _leaves(params[n] for n in names)))
        with torch.enable_grad():
            loss = logloss(apply(leaves, ids, cfg), labels)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        return loss.detach(), dict(zip(names, grads))

    return step
