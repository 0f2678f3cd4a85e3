"""Paged KV-cache allocator: fixed-size token blocks with a free list.

Counterpart: ``mxnet_tpu/serving/kvcache.py``.  The allocator (block
tables, free list, cursors) is the same host code and hands out the
same block ids for the same call sequence; the pools are torch tensors
on the runtime's device, written in place by the prefill/decode
forwards.

Each layer owns two pools ``(num_blocks, block_tokens, n_heads,
head_dim)`` — K and V — and a sequence holds a LIST of block ids, not
a contiguous span, so slot churn from continuous batching cannot
fragment the pool: any free block serves any sequence.

Block 0 is the GARBAGE block, never allocated: every write from a
padded position or an inactive slot is routed there (see
``transformer.model._scatter_tokens``), so the forwards never branch
on liveness.
"""
from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np
import torch

from . import reqtrace as _reqtrace

__all__ = ["CacheExhausted", "PagedKVCache"]


class CacheExhausted(RuntimeError):
    """No free blocks left for an allocation — the engine's cue to
    evict (retire a sequence early, counted) or defer admission."""


class PagedKVCache:
    """Free-list block allocator over per-layer K/V pools."""

    def __init__(self, *, n_layers: int, n_heads: int, head_dim: int,
                 num_blocks: int, block_tokens: int,
                 dtype: torch.dtype = torch.float32, device="cpu",
                 name: str = "gen"):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "garbage block)")
        self.name = str(name)
        self.n_layers = int(n_layers)
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        self._lock = threading.Lock()
        #: blocks available for allocation — 0 reserved as garbage
        self._free: List[int] = list(range(1, self.num_blocks))
        #: seq_id -> ordered block ids (index i covers tokens
        #: [i*bt, (i+1)*bt))
        self._blocks: Dict[str, List[int]] = {}
        #: seq_id -> tokens actually written (fragmentation accounting)
        self._lengths: Dict[str, int] = {}
        self.evictions = 0
        shape = (self.num_blocks, self.block_tokens, int(n_heads),
                 int(head_dim))
        #: device pools, updated in place by the forwards
        self.pages: Dict[str, torch.Tensor] = {}
        for i in range(self.n_layers):
            self.pages["k%d" % i] = torch.zeros(shape, dtype=dtype,
                                                device=device)
            self.pages["v%d" % i] = torch.zeros(shape, dtype=dtype,
                                                device=device)

    # -- allocation ----------------------------------------------------
    def _blocks_for(self, n_tokens: int) -> int:
        return max(1, -(-int(n_tokens) // self.block_tokens))

    def alloc(self, seq_id: str, n_tokens: int) -> List[int]:
        """Claim blocks covering ``n_tokens`` for a NEW sequence.
        Raises :class:`CacheExhausted` (allocating nothing) if the free
        list cannot cover it."""
        need = self._blocks_for(n_tokens)
        with self._lock:
            if seq_id in self._blocks:
                raise ValueError("sequence %r already holds blocks"
                                 % seq_id)
            if need > len(self._free):
                raise CacheExhausted(
                    "need %d blocks for %r, %d free (of %d)"
                    % (need, seq_id, len(self._free),
                       self.num_blocks - 1))
            got = [self._free.pop() for _ in range(need)]
            self._blocks[seq_id] = got
            self._lengths[seq_id] = int(n_tokens)
        # seq_id IS the request id: KV allocations land in the
        # request's lifecycle trace
        _reqtrace.event(seq_id, "kv_alloc", blocks=len(got))
        return list(got)

    def extend(self, seq_id: str, new_len: int) -> List[int]:
        """Grow a sequence's coverage to ``new_len`` tokens, claiming
        blocks as its cursor crosses block boundaries.  Raises
        :class:`CacheExhausted` without partial allocation."""
        with self._lock:
            held = self._blocks[seq_id]
            need = self._blocks_for(new_len) - len(held)
            if need > len(self._free):
                raise CacheExhausted(
                    "need %d more blocks for %r, %d free"
                    % (need, seq_id, len(self._free)))
            for _ in range(max(need, 0)):
                held.append(self._free.pop())
            self._lengths[seq_id] = max(self._lengths[seq_id],
                                        int(new_len))
            out = list(held)
        if need > 0:
            _reqtrace.event(seq_id, "kv_extend", blocks=need)
        return out

    def free(self, seq_id: str, evicted: bool = False) -> int:
        """Return a sequence's blocks to the free list (idempotent);
        ``evicted`` marks an under-pressure early retirement for the
        stats feed.  Returns the number of blocks released."""
        with self._lock:
            held = self._blocks.pop(seq_id, None)
            self._lengths.pop(seq_id, None)
            if held is None:
                return 0
            self._free.extend(held)
            if evicted:
                self.evictions += 1
        _reqtrace.event(seq_id, "evicted" if evicted else "kv_free",
                        blocks=len(held))
        return len(held)

    def block_table(self, seq_id: str, width: int) -> np.ndarray:
        """This sequence's block table padded to ``width`` entries with
        the garbage block — the row the forwards consume."""
        with self._lock:
            held = self._blocks.get(seq_id, [])
            if len(held) > int(width):
                raise ValueError(
                    "sequence %r holds %d blocks > table width %d"
                    % (seq_id, len(held), width))
            row = np.zeros(int(width), dtype=np.int64)
            row[:len(held)] = held
            return row

    def note_length(self, seq_id: str, n_tokens: int) -> None:
        with self._lock:
            if seq_id in self._lengths:
                self._lengths[seq_id] = max(self._lengths[seq_id],
                                            int(n_tokens))

    # -- accounting ----------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Allocator accounting: blocks live/free, sequence count, and
        internal fragmentation (allocated token slots not yet holding a
        token, over all allocated slots)."""
        with self._lock:
            live = sum(len(b) for b in self._blocks.values())
            slots = live * self.block_tokens
            used = sum(self._lengths.values())
            frag = (slots - used) / slots if slots else 0.0
            return {
                "blocks_total": self.num_blocks - 1,
                "blocks_live": live,
                "blocks_free": len(self._free),
                "seqs": len(self._blocks),
                "fragmentation": round(frag, 4),
                "evictions": self.evictions,
            }

    def feed_metrics(self) -> None:
        """Push allocator gauges/counters into diagnostics.metrics —
        best-effort, the serving convention (a metrics hiccup must not
        fail a decode tick)."""
        try:
            from .. import diagnostics as _diag

            st = self.stats()
            lab = {"model": self.name}
            _diag.metrics.gauge("mxnet_serve_kv_blocks_live",
                                help="paged KV-cache blocks allocated",
                                labels=lab).set(st["blocks_live"])
            _diag.metrics.gauge("mxnet_serve_kv_blocks_free",
                                help="paged KV-cache blocks free",
                                labels=lab).set(st["blocks_free"])
            _diag.metrics.gauge(
                "mxnet_serve_kv_fragmentation",
                help="unused fraction of allocated KV token slots",
                labels=lab).set(st["fragmentation"])
            c = _diag.metrics.counter(
                "mxnet_serve_kv_evictions_total",
                help="sequences evicted under cache pressure",
                labels=lab)
            if st["evictions"] > c.value:
                c.inc(st["evictions"] - c.value)
        except Exception:
            pass
