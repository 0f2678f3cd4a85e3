"""Recommender training over store-sharded embedding tables.

Counterpart: ``mxnet_tpu/recommender/train.py``.  Each logical
``(vocab, dim)`` table splits into row-block SHARD KEYS (``emb0:s0``,
``emb0:s1``, ...) that the store places by its crc32 key rule: the
sharding is the key naming.  Each step:

  1. ``np.unique(ids, return_inverse=True)`` a field on the host: the
     dedup that makes the traffic proportional to unique rows;
  2. ``row_sparse_pull`` of only those rows, a request a shard key
     (``op=row_sparse_pull``), gathered into a host block as the JAX
     package does (a device-to-host copy a shard key a field);
  3. the sparse step over the pulled rows, padded to the batch size, on
     the step's device: the embedding gradients come back over the
     unique rows, never (vocab, dim);
  4. a row-sparse push of those gradients a shard key
     (``op=row_sparse_push``): the store's lazy update touches only
     those rows.  EVERY shard key is pushed every step, with zero rows
     where the batch touched none, so sync rounds stay aligned across
     workers;
  5. a dense push and pull of the small MLP head.

``sparse=False`` is the dense-embedding control on the same store and
data: every table pulled and pushed whole each step, and a vocab-sized
scatter in backward.

Departure: the gradient rows pushed in step 4 stay on the step's device
(the JAX package brings them to the host first); the store moves them
where it keeps the table.  Parameters start from ``seed`` through the
port's own generator, or from ``params=``, a flat dict of arrays (the
JAX package's ``init_params`` as numpy, ``convert.params_to_numpy`` of
the port's): the way to carry weights across packages.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as _np
import torch

from .. import ndarray as nd
from ..context import Context, current_context
from ..ndarray import NDArray
from ..ndarray import sparse as _sp
from . import model as _model
from .model import RecommenderConfig

__all__ = ["ShardedEmbeddingTable", "RecommenderTrainStep"]


class ShardedEmbeddingTable:
    """One logical ``(vocab, dim)`` table, row-block-sharded into
    ``n_shards`` store keys: global row ``r`` lives in shard
    ``r // rows_per_shard`` at local row ``r % rows_per_shard``; pulls
    and pushes fan out a shard at a time with only that shard's rows."""

    def __init__(self, name: str, vocab: int, dim: int,
                 n_shards: int = 1, dtype=_np.float32,
                 ctx: Optional[Context] = None):
        if n_shards < 1 or n_shards > vocab:
            raise ValueError("n_shards %d outside [1, vocab=%d]"
                             % (n_shards, vocab))
        self.name = name
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.n_shards = int(n_shards)
        self.dtype = _np.dtype(dtype)
        self.ctx = ctx if ctx is not None else current_context()
        self.rows_per_shard = -(-self.vocab // self.n_shards)
        self.keys = ["%s:s%d" % (name, s) for s in range(self.n_shards)]

    def shard_rows(self, s: int) -> int:
        lo = s * self.rows_per_shard
        return min(self.rows_per_shard, self.vocab - lo)

    def shard_shape(self, s: int) -> tuple:
        return (self.shard_rows(s), self.dim)

    def init(self, kv, table_np: _np.ndarray) -> None:
        """Register every shard's row block (``kv.init`` sets if absent,
        so every worker may call it with the same seeded table)."""
        if table_np.shape != (self.vocab, self.dim):
            raise ValueError("table shape %s != (%d, %d)"
                             % (table_np.shape, self.vocab, self.dim))
        for s, key in enumerate(self.keys):
            lo = s * self.rows_per_shard
            kv.init(key, nd.array(_np.ascontiguousarray(
                table_np[lo:lo + self.shard_rows(s)], dtype=self.dtype),
                ctx=self.ctx))

    def pull_rows(self, kv, rows: _np.ndarray) -> _np.ndarray:
        """The listed global rows (sorted unique int64) as a dense
        ``(len(rows), dim)`` host block: only those rows travel, a shard
        key at a time."""
        rows = _np.asarray(rows, dtype=_np.int64).reshape(-1)
        out = _np.zeros((rows.size, self.dim), self.dtype)
        for s, key in enumerate(self.keys):
            mask = (rows // self.rows_per_shard) == s
            if not mask.any():
                continue  # reads need no round alignment: no request
            local = rows[mask] - s * self.rows_per_shard
            o = _sp.zeros("row_sparse", self.shard_shape(s), ctx=self.ctx,
                          dtype=self.dtype)
            kv.row_sparse_pull(key, out=o, row_ids=local)
            # rows[mask] is sorted, so the pulled (sorted unique) rows
            # line up with the mask's True slots
            out[mask] = o.data.asnumpy()
        return out

    def push_rows(self, kv, rows: _np.ndarray, values,
                  always_all_shards: bool = True) -> None:
        """Push a row-sparse gradient (``values`` a tensor or array of
        ``len(rows)`` rows), a shard key at a time.  With
        ``always_all_shards`` every shard key is pushed, with zero rows
        where the batch touched none: in sync mode the server counts a
        key's parts, so every worker pushes every key every round."""
        rows = _np.asarray(rows, dtype=_np.int64).reshape(-1)
        if not isinstance(values, torch.Tensor):
            values = torch.from_numpy(_np.asarray(values))
        values = values.reshape(rows.size, self.dim)
        for s, key in enumerate(self.keys):
            mask = (rows // self.rows_per_shard) == s
            if not mask.any() and not always_all_shards:
                continue
            pos = torch.from_numpy(_np.nonzero(mask)[0]).to(values.device)
            local = rows[mask] - s * self.rows_per_shard
            kv.push(key, _sp.row_sparse_array(
                (values.index_select(0, pos), local),
                shape=self.shard_shape(s), ctx=self.ctx, dtype=self.dtype))


def _host_params(cfg, seed, params) -> Dict[str, _np.ndarray]:
    if params is None:
        gen = torch.Generator().manual_seed(int(seed))
        params = _model.init_params(gen, cfg, device="cpu")
    out = {}
    for name, _shape, _dtype in _model.param_shapes(cfg):
        v = params[name]
        if isinstance(v, NDArray):
            v = v.asnumpy()
        elif isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[name] = _np.array(v)
    return out


class RecommenderTrainStep:
    """One worker's store-backed recommender step: the sparse tier, or
    the dense-embedding control (same data, same store, same optimizer
    placement, so the byte counters' deltas between the two are the
    traffic claim).  ``ctx`` is where the step computes and where the
    store keeps the values pushed from here (default: the current
    context, the card)."""

    def __init__(self, cfg: RecommenderConfig, kv, optimizer=None,
                 n_shards: int = 2, seed: int = 0, sparse: bool = True,
                 params: Optional[Dict] = None,
                 ctx: Optional[Context] = None):
        self.cfg = cfg
        self.kv = kv
        self.sparse = bool(sparse)
        self.ctx = ctx if ctx is not None else current_context()
        self.device = self.ctx.torch_device()
        host = _host_params(cfg, seed, params)
        self._dense_names = _model.dense_param_names(cfg)
        self.tables: Dict[str, ShardedEmbeddingTable] = {}
        if self.sparse:
            for name in _model.table_names(cfg):
                t = ShardedEmbeddingTable(name, cfg.vocab, cfg.embed_dim,
                                          n_shards=n_shards, ctx=self.ctx)
                t.init(kv, host[name])
                self.tables[name] = t
            self._step_fn = _model.make_sparse_train_step(cfg)
        else:
            for name in _model.table_names(cfg):
                kv.init("rec:" + name, nd.array(host[name], ctx=self.ctx))
            self._step_fn = _model.make_dense_train_step(cfg)
        for name in self._dense_names:
            kv.init("rec:" + name, nd.array(host[name], ctx=self.ctx))
        if optimizer is not None:
            kv.set_optimizer(optimizer)
        self.dense_params = {n: self._tensor(host[n])
                             for n in self._dense_names}
        # the dense control keeps whole tables here between pulls
        self._full_tables = (None if self.sparse else
                             {n: self._tensor(host[n])
                              for n in _model.table_names(cfg)})

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(_np.asarray(a)).to(self.device)

    # -- one step ------------------------------------------------------
    def step(self, ids_np: _np.ndarray, clicks_np: _np.ndarray) -> dict:
        if self.sparse:
            return self._step_sparse(ids_np, clicks_np)
        return self._step_dense(ids_np, clicks_np)

    def _push_pull_dense_head(self, grads) -> None:
        for n in self._dense_names:
            self.kv.push("rec:" + n, NDArray.from_raw(grads[n], self.ctx))
        for n in self._dense_names:
            # float32 cells, as the JAX package pulls them
            o = nd.zeros(tuple(self.dense_params[n].shape), ctx=self.ctx)
            self.kv.pull("rec:" + n, out=o)
            self.dense_params[n] = o._data

    def _step_sparse(self, ids_np, clicks_np) -> dict:
        cfg = self.cfg
        B = ids_np.shape[0]
        uniqs: List[_np.ndarray] = []
        rows_pad: List[torch.Tensor] = []
        inverse: List[torch.Tensor] = []
        for f, name in enumerate(_model.table_names(cfg)):
            uniq, inv = _np.unique(ids_np[:, f].astype(_np.int64),
                                   return_inverse=True)
            pulled = self.tables[name].pull_rows(self.kv, uniq)
            # unique rows padded to the batch size (float32, as the JAX
            # package pads them); only uniq.size rows travelled
            pad = _np.zeros((B, cfg.embed_dim), _np.float32)
            pad[:uniq.size] = pulled
            uniqs.append(uniq)
            rows_pad.append(self._tensor(pad))
            inverse.append(self._tensor(inv.reshape(-1).astype(_np.int32)))
        loss, d_rows, d_dense = self._step_fn(
            tuple(rows_pad), tuple(inverse), self.dense_params,
            self._tensor(clicks_np))
        for f, name in enumerate(_model.table_names(cfg)):
            self.tables[name].push_rows(self.kv, uniqs[f],
                                        d_rows[f][:uniqs[f].size])
        self._push_pull_dense_head(d_dense)
        return {"loss": float(loss),
                "unique_rows": int(sum(u.size for u in uniqs)),
                "batch": int(B)}

    def _step_dense(self, ids_np, clicks_np) -> dict:
        cfg = self.cfg
        # the control pays for whole tables every step: every (vocab,
        # dim) table pulled, every dense (vocab, dim) gradient pushed
        for n in _model.table_names(cfg):
            o = nd.zeros((cfg.vocab, cfg.embed_dim), ctx=self.ctx)
            self.kv.pull("rec:" + n, out=o)
            self._full_tables[n] = o._data
        params = dict(self._full_tables)
        params.update(self.dense_params)
        loss, grads = self._step_fn(params, self._tensor(ids_np),
                                    self._tensor(clicks_np))
        for n in _model.table_names(cfg):
            self.kv.push("rec:" + n, NDArray.from_raw(grads[n], self.ctx))
        self._push_pull_dense_head({n: grads[n] for n in self._dense_names})
        uniq = sum(_np.unique(ids_np[:, f]).size
                   for f in range(cfg.n_fields))
        return {"loss": float(loss), "unique_rows": int(uniq),
                "batch": int(ids_np.shape[0])}

    # -- loop ----------------------------------------------------------
    def fit(self, it, num_steps: int) -> dict:
        """``num_steps`` batches off the iterator (reset when it runs
        out): losses, samples/s and the mean unique rows a batch (the
        numerator of the ideal pulled-bytes ratio)."""
        losses: List[float] = []
        uniq = 0
        samples = 0
        t0 = time.perf_counter()
        for _ in range(int(num_steps)):
            try:
                data, label, _pad = it.next_raw()
            except StopIteration:
                it.reset()
                data, label, _pad = it.next_raw()
            out = self.step(data[0], label[0])
            losses.append(out["loss"])
            uniq += out["unique_rows"]
            samples += out["batch"]
        dt = time.perf_counter() - t0
        return {
            "losses": losses,
            "samples_per_s": samples / dt if dt > 0 else float("inf"),
            "mean_unique_rows_per_batch": uniq / max(len(losses), 1),
            "steps": len(losses),
        }
