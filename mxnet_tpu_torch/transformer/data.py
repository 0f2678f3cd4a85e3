"""Synthetic tokenized LM stream on the ``io.py`` iterator contract.

Counterpart: ``mxnet_tpu/transformer/data.py``.  The corpus is a seeded
offset-chain: token ``t+1 = (t + delta) % V`` with ``delta`` drawn from
a small fixed set — a learnable bigram structure (the loss drops below
``log(V)`` within a few steps).  It is made with numpy's
``RandomState`` exactly as the JAX package makes it, so the two
packages train on the same bits for the same arguments.  Batches are
global: a train step over a mesh takes its rank's (dp, sp) block of
each (``parallel.dp.shard_batch``).
"""
from __future__ import annotations

import numpy as _np

from ..io import NDArrayIter

__all__ = ["LMTokenIter", "make_corpus"]

_DELTAS = _np.array([1, 2, 3, 5, 7], dtype=_np.int64)


def make_corpus(num_sequences: int, seq_len: int, vocab_size: int,
                seed: int = 0) -> _np.ndarray:
    """``(num_sequences, seq_len + 1)`` int32 token matrix (the +1
    column provides the shifted next-token labels)."""
    rng = _np.random.RandomState(seed)
    start = rng.randint(0, vocab_size, size=(num_sequences, 1))
    deltas = _DELTAS[rng.randint(0, len(_DELTAS),
                                 size=(num_sequences, seq_len))]
    toks = _np.concatenate(
        [start, start + _np.cumsum(deltas, axis=1)], axis=1)
    return (toks % vocab_size).astype(_np.int32)


class LMTokenIter(NDArrayIter):
    """Decoder-LM batches: ``data`` (B, T) int32 tokens, ``label``
    (B, T) int32 next tokens, as NDArrays on ``mx.cpu()``.  Padding,
    sharding, ``next_raw`` and reset come from ``NDArrayIter``."""

    def __init__(self, batch_size: int = 8, seq_len: int = 64,
                 vocab_size: int = 256, num_sequences: int = 64,
                 seed: int = 0, shuffle: bool = False,
                 last_batch_handle: str = "discard",
                 num_parts: int = 1, part_index: int = 0):
        corpus = make_corpus(num_sequences, seq_len, vocab_size, seed)
        self.seq_len = int(seq_len)
        self.vocab_size = int(vocab_size)
        self.num_sequences = int(num_sequences)
        self.seed = int(seed)
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        super().__init__(
            corpus[:, :-1], label=corpus[:, 1:], batch_size=batch_size,
            shuffle=shuffle, last_batch_handle=last_batch_handle,
            data_name="tokens", label_name="next_tokens",
            num_parts=num_parts, part_index=part_index)

    def replay_spec(self) -> dict:
        """The scalars that determine this stream: what a checkpoint
        records so the run can be re-created bit for bit."""
        return {
            "kind": "lm_token_iter",
            "batch_size": int(self.batch_size),
            "seq_len": self.seq_len,
            "vocab_size": self.vocab_size,
            "num_sequences": self.num_sequences,
            "seed": self.seed,
            "num_parts": self.num_parts,
            "part_index": self.part_index,
        }

    def skip_batches(self, n: int) -> None:
        """Fast-forward ``n`` batches (the cursor moves, nothing is
        built) — the exact-resume replay path."""
        for _ in range(int(n)):
            if not self.iter_next():
                self.reset()
                self.iter_next()
