"""A synthetic Zipf clickstream on the ``io`` iterator contract.

Counterpart: ``mxnet_tpu/recommender/data.py``, bit for bit: the ids and
labels come from numpy's ``RandomState`` in the same order.  Ids follow
a Zipf(alpha) law over each field's vocab, so a batch touches a small
hot set of rows; a click is whether the sampled ids' scores (a seeded
per-field table) sum above zero, so the data is learnable.  Riding
``NDArrayIter`` gives ``num_parts`` / ``part_index`` sharding,
``next_raw`` and the reset semantics.
"""
from __future__ import annotations

import numpy as _np

from ..io import NDArrayIter

__all__ = ["ClickstreamIter", "make_clickstream"]


def make_clickstream(num_samples: int, n_fields: int, vocab: int,
                     alpha: float = 1.05, seed: int = 0):
    """``(ids (N, n_fields) int32, clicks (N,) float32)``, Zipf ids and
    score-table labels, deterministic per (args, seed)."""
    rng = _np.random.RandomState(seed)
    ranks = _np.arange(1, vocab + 1, dtype=_np.float64)
    p = ranks ** -float(alpha)
    p /= p.sum()
    ids = rng.choice(vocab, size=(int(num_samples), int(n_fields)),
                     p=p).astype(_np.int32)
    scores = rng.randn(int(n_fields), vocab).astype(_np.float32)
    raw = scores[_np.arange(int(n_fields))[None, :], ids].sum(axis=1)
    clicks = (raw > 0).astype(_np.float32)
    return ids, clicks


class ClickstreamIter(NDArrayIter):
    """CTR batches: ``data`` (B, n_fields) int32 ids, ``label`` (B,)
    float32 clicks; padding, sharding, ``next_raw`` and reset come from
    ``NDArrayIter``."""

    def __init__(self, batch_size: int = 32, n_fields: int = 8,
                 vocab: int = 65536, num_samples: int = 1024,
                 alpha: float = 1.05, seed: int = 0,
                 shuffle: bool = False,
                 last_batch_handle: str = "discard",
                 num_parts: int = 1, part_index: int = 0):
        ids, clicks = make_clickstream(num_samples, n_fields, vocab,
                                       alpha=alpha, seed=seed)
        self.n_fields = int(n_fields)
        self.vocab = int(vocab)
        self.num_samples = int(num_samples)
        self.alpha = float(alpha)
        self.seed = int(seed)
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        super().__init__(
            ids, label=clicks, batch_size=batch_size, shuffle=shuffle,
            last_batch_handle=last_batch_handle, data_name="ids",
            label_name="click", num_parts=num_parts,
            part_index=part_index)

    def replay_spec(self) -> dict:
        """The scalars that determine this stream: a resumed worker or
        an audit re-creates the same batches from them."""
        return {
            "kind": "clickstream_iter",
            "batch_size": int(self.batch_size),
            "n_fields": self.n_fields,
            "vocab": self.vocab,
            "num_samples": self.num_samples,
            "alpha": self.alpha,
            "seed": self.seed,
            "num_parts": self.num_parts,
            "part_index": self.part_index,
        }

    def skip_batches(self, n: int) -> None:
        """Fast-forward ``n`` batches (the cursor moves, nothing is
        built)."""
        for _ in range(int(n)):
            if not self.iter_next():
                self.reset()
                self.iter_next()
