"""Autoregressive generation serving: prefill/decode split over a
paged KV cache, with continuous (per-slot) batching.

Counterpart: ``mxnet_tpu/serving/generate.py``: the same plans,
engine, request tracer and chaos hooks, the whole-batch comparator
(``continuous=False``), the reload successor and the host-only
:class:`StubGenerationRuntime`.

  * **prefill** runs once per sequence over the whole prompt, in a
    bucketed ``(batch, prompt_len)`` shape, through the flash-attention
    kernel;
  * **decode** runs once per output token over ONE new token + the
    cache, in a bucketed ``(batch, cache_len)`` shape.

Both plans are 2-D cross products from ``bucket_ladder`` — the same
plans as the JAX package.  PyTorch runs eagerly, so where the JAX
package compiles one executable per plan cell, :meth:`GenerationRuntime.
compile` is a warmup pass that runs every cell once before traffic
(the kernels are built and every shape has been seen).

The cache is paged (kvcache.py): a sequence holds a LIST of fixed-size
token blocks, gathered through its block table inside the decode
forward, so slot churn never copies or compacts cache memory.
Continuous batching rides on top: a finished (or cancelled, or
evicted) sequence's slot and blocks are reclaimed on the NEXT tick and
refilled from the queue without draining the co-riding sequences —
the whole-batch comparator mode (``continuous=False``) admits only
into an empty engine, so a load run can measure what that buys.

Numerics contract, pinned by tests/test_torch_serving.py: greedy decode
through this engine is token-for-token identical to the JAX package's
dense-cache reference (``model.apply`` with ``dense_causal_attn``) run
one sequence at a time.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import bind_device, resolve_device
from ..transformer import model as _model
from . import reqtrace as _reqtrace
from .batching import Request
from .bucket_ladder import bucket_for, ladder
from .errors import Cancelled, DeadlineExceeded, ExecutorFailure
from .kvcache import CacheExhausted, PagedKVCache

__all__ = ["GenRequest", "GenerationRuntime", "GenerationEngine",
           "demo_generation_runtime", "StubGenerationRuntime",
           "stub_greedy_reference"]

_log = logging.getLogger(__name__)


class GenRequest(Request):
    """One admitted generation request: the prompt, the output budget,
    per-token streaming (``on_token``) and timing (TTFT / TPOT), and a
    cancel flag the engine honors at its next tick."""

    __slots__ = ("prompt", "max_new", "on_token", "tokens",
                 "first_token_ts", "token_ts", "_cancelled")

    def __init__(self, model: str, prompt, max_new: int,
                 deadline_s: Optional[float] = None,
                 request_id: Optional[str] = None,
                 on_token: Optional[Callable[[Optional[int]], None]]
                 = None):
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        super().__init__(model, prompt, 1, deadline_s=deadline_s,
                         request_id=request_id)
        self.prompt = prompt
        self.max_new = max(int(max_new), 1)
        #: called from the ENGINE thread with each generated token id,
        #: then once with None at end-of-stream (any outcome).  Must
        #: not block: a slow consumer stalls every co-riding sequence.
        self.on_token = on_token
        self.tokens: List[int] = []
        self.first_token_ts: Optional[float] = None
        self.token_ts: List[float] = []
        self._cancelled = threading.Event()

    def cancel(self) -> None:
        """Client disconnect / explicit abandon: the engine reclaims
        the slot and cache blocks at its next tick."""
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    # -- engine side ---------------------------------------------------
    def _emit(self, tok: int) -> None:
        now = time.monotonic()
        if self.first_token_ts is None:
            self.first_token_ts = now
        self.token_ts.append(now)
        self.tokens.append(int(tok))
        if self.on_token is not None:
            try:
                self.on_token(int(tok))
            except Exception:
                # a broken stream consumer becomes a cancel, never an
                # engine fault — co-riders must not feel it
                self._cancelled.set()

    def _close_stream(self) -> None:
        if self.on_token is not None:
            try:
                self.on_token(None)
            except Exception:
                pass

    def ttft_s(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.enqueue_ts

    def tpot_s(self) -> List[float]:
        """Per-output-token intervals (decode cadence; excludes the
        prefill-bound first token, which TTFT owns)."""
        return [b - a for a, b in zip(self.token_ts, self.token_ts[1:])]


class _Slot(object):
    __slots__ = ("req", "seq_id", "pos", "next_token", "decode_s",
                 "ticks")

    def __init__(self, req: GenRequest, seq_id: str, pos: int,
                 next_token: int):
        self.req = req
        self.seq_id = seq_id
        self.pos = int(pos)          # cache cursor: where next_token
        self.next_token = int(next_token)  # ...will be written
        # decode residency accumulates here and flushes to the request
        # recorder once at retire (a per-tick recorder call would
        # dominate the recorder's cost)
        self.decode_s = 0.0
        self.ticks = 0


def _argmax(logits) -> np.ndarray:
    """Greedy next tokens as host ints: the one device->host read of a
    prefill or decode tick."""
    if isinstance(logits, torch.Tensor):
        return logits.argmax(dim=-1).cpu().numpy()
    return np.asarray(logits).argmax(axis=-1)


class GenerationRuntime:
    """One served generator: transformer params on ``device`` (default
    ``cuda``) + the 2-D bucket plans + the paged cache + the
    continuous-batching engine.  Presents the surface ``ModelServer``
    expects of a runtime (name/version/sample_shape/plan/compiled/
    compile/max_batch), so breakers, drain, probes and live reload
    carry over unchanged."""

    def __init__(self, name: str, params: Dict[str, Any], cfg, *,
                 slots: Optional[int] = None,
                 block_tokens: Optional[int] = None,
                 max_prompt: Optional[int] = None,
                 max_context: Optional[int] = None,
                 max_new: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefill_batch: Optional[int] = None,
                 continuous: bool = True,
                 source: str = "inline",
                 device=None):
        from .. import env as _env

        def knob(v, envname):
            return _env.get_int(envname) if v is None else int(v)

        self.device = resolve_device(device)
        self.name = str(name)
        self.version = 1
        self.source = source
        self.cfg = cfg
        self.continuous = bool(continuous)
        self.slots = max(knob(slots, "MXNET_SERVE_GEN_SLOTS"), 1)
        self.block_tokens = max(
            knob(block_tokens, "MXNET_SERVE_KV_BLOCK_TOKENS"), 1)
        bt = self.block_tokens

        def round_up(n):
            return -(-int(n) // bt) * bt

        self.max_prompt = round_up(max(
            knob(max_prompt, "MXNET_SERVE_GEN_MAX_PROMPT"), 1))
        self.max_context = round_up(max(
            knob(max_context, "MXNET_SERVE_GEN_MAX_CONTEXT"),
            self.max_prompt))
        self.max_new = max(knob(max_new, "MXNET_SERVE_GEN_MAX_NEW"), 1)
        self.prefill_batch = min(
            max(knob(prefill_batch, "MXNET_SERVE_GEN_PREFILL_BATCH"), 1),
            self.slots)
        nb = knob(num_blocks, "MXNET_SERVE_GEN_BLOCKS")
        if nb <= 0:  # auto: every slot can hold a full context
            nb = self.slots * (self.max_context // bt) + 1
        #: ModelServer compatibility surface
        self.sample_shape = (self.max_prompt,)
        self.max_batch = self.slots
        # -- the four ladders -> two 2-D plans ------------------------
        self.batch_plan = ladder(self.slots)
        self.cache_plan = tuple(
            b * bt for b in ladder(self.max_context // bt))
        self.prompt_plan = tuple(
            b * bt for b in ladder(self.max_prompt // bt))
        self.prefill_plan: Tuple[Tuple[int, int], ...] = tuple(
            (a, b) for a in ladder(self.prefill_batch)
            for b in self.prompt_plan)
        self.decode_plan: Tuple[Tuple[int, int], ...] = tuple(
            (a, b) for a in self.batch_plan for b in self.cache_plan)
        self.plan = self.decode_plan  # what stats()/dashboards show
        self._params = {k: torch.as_tensor(v).to(self.device)
                        for k, v in params.items()}
        self.kv = PagedKVCache(
            n_layers=cfg.n_layers, n_heads=cfg.n_heads,
            head_dim=cfg.head_dim, num_blocks=nb, block_tokens=bt,
            dtype=_model._dtype(cfg.dtype), device=self.device,
            name=self.name)
        self._warm: set = set()
        #: forwards run per plan cell, ``(kind, (batch, len))`` -> n:
        #: every cell traffic reaches must be a warmed plan cell
        self.cell_calls: Dict[Tuple[str, Tuple[int, int]], int] = {}
        self._compile_ms: Dict[str, float] = {}
        self._lock = threading.Lock()
        self.engine = GenerationEngine(self)

    # -- the two forwards, one plan cell per call ----------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    @torch.no_grad()
    def prefill(self, tokens: np.ndarray, prompt_lens: np.ndarray,
                tables: np.ndarray) -> torch.Tensor:
        """Prefill one ``(batch, prompt_len)`` plan cell; writes the
        prompts' K/V into the cache and returns last-token logits."""
        cell = tuple(int(d) for d in tokens.shape)
        if cell not in self.prefill_plan:
            raise KeyError("prefill shape %s is not a cell of %s"
                           % (cell, self.prefill_plan))
        key = ("prefill", cell)
        self.cell_calls[key] = self.cell_calls.get(key, 0) + 1
        return self._prefill_forward(tokens, prompt_lens, tables)

    def _prefill_forward(self, tokens, prompt_lens, tables):
        logits, self.kv.pages = _model.apply_prefill(
            self._params, self._tensor(tokens), self._tensor(prompt_lens),
            self.cfg, pages=self.kv.pages, block_tables=self._tensor(tables),
            block_tokens=self.block_tokens)
        return logits

    @torch.no_grad()
    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               tables: np.ndarray) -> torch.Tensor:
        """One decode tick in a ``(batch, cache_len)`` plan cell."""
        cell = (int(tokens.shape[0]), int(tables.shape[1]) *
                self.block_tokens)
        if cell not in self.decode_plan:
            raise KeyError("decode cell %s is not in %s"
                           % (cell, self.decode_plan))
        key = ("decode", cell)
        self.cell_calls[key] = self.cell_calls.get(key, 0) + 1
        return self._decode_forward(tokens, positions, tables)

    def _decode_forward(self, tokens, positions, tables):
        logits, self.kv.pages = _model.apply_decode(
            self._params, self._tensor(tokens), self._tensor(positions),
            self.cfg, pages=self.kv.pages, block_tables=self._tensor(tables),
            block_tokens=self.block_tokens)
        return logits

    # -- warmup ----------------------------------------------------------
    @property
    def compiled(self) -> bool:
        return len(self._warm) == len(self.prefill_plan) + \
            len(self.decode_plan)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def compile(self, warmup: bool = True) -> Dict[str, float]:
        """Run every cell of BOTH plans once (every write lands in the
        garbage block), so the first request pays neither the kernel
        build nor a first-shape cost — the eager counterpart of the JAX
        package's per-cell AOT compile.  ``warmup=False`` marks the
        cells ready without running them.  Idempotent; returns
        ``{cell name: warmup ms}``."""
        with self._lock:
            bind_device(self.device)
            bt = self.block_tokens
            cells = [("prefill", c) for c in self.prefill_plan] + \
                [("decode", c) for c in self.decode_plan]
            for kind, (bb, tb) in cells:
                nm = "gen_%s:%s:v%d:%dx%d" % (kind, self.name,
                                              self.version, bb, tb)
                if nm in self._warm:
                    continue
                t0 = time.perf_counter()
                if warmup:
                    zeros = np.zeros((bb,), dtype=np.int64)
                    table = np.zeros((bb, tb // bt), dtype=np.int64)
                    if kind == "prefill":
                        self.prefill(np.zeros((bb, tb), dtype=np.int64),
                                     zeros, table)
                    else:
                        self.decode(zeros, zeros, table)
                    self._sync()
                self._compile_ms[nm] = (time.perf_counter() - t0) * 1e3
                self._warm.add(nm)
                self._feed_compile_metrics(self._compile_ms[nm])
            _log.info("serving: warmed generator %r — %d prefill + %d "
                      "decode plan cells (warmup=%s)", self.name,
                      len(self.prefill_plan), len(self.decode_plan),
                      warmup)
            return dict(self._compile_ms)

    def _feed_compile_metrics(self, dur_ms: float) -> None:
        try:
            from .. import diagnostics as _diag

            _diag.metrics.counter(
                "mxnet_serve_compiles_total",
                help="AOT-compiled serving executors",
                labels={"model": self.name}).inc()
            _diag.metrics.gauge(
                "mxnet_serve_compile_ms_last",
                labels={"model": self.name}).set(dur_ms)
        except Exception:
            pass

    def compile_stats(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._compile_ms)

    # -- reload support ------------------------------------------------
    def successor_from_checkpoint(self, directory: str,
                                  step: Optional[int] = None
                                  ) -> "GenerationRuntime":
        """A NEW version of this generator from a (verified)
        checkpoint: same config, plans, cache geometry and device —
        only the weights change (what :meth:`ModelServer.reload`
        canaries)."""
        from .. import checkpoint as _ckpt

        payload = _ckpt.load_checkpoint(directory, step=step)
        params = payload.get("params") or {}
        if not params:
            raise ValueError(
                "checkpoint step %s under %r holds no params"
                % (payload.get("step"), directory))
        return type(self)(
            self.name, params, self.cfg, slots=self.slots,
            block_tokens=self.block_tokens, max_prompt=self.max_prompt,
            max_context=self.max_context, max_new=self.max_new,
            num_blocks=self.kv.num_blocks,
            prefill_batch=self.prefill_batch,
            continuous=self.continuous, device=self.device,
            source="checkpoint:%s@step%s" % (directory,
                                             payload.get("step")))


class GenerationEngine:
    """The continuous batcher: a waiting line, up to ``slots`` active
    sequences, and a tick loop — reap (cancel/expire/evict), admit
    (batched prefill), decode (one token for every rider).  All engine
    state is touched from ONE worker thread (``ModelServer`` owns it);
    requests/cancel flags are the thread-safe crossings."""

    def __init__(self, runtime: GenerationRuntime):
        self.rt = runtime
        self.kv = runtime.kv
        self.active: List[_Slot] = []
        self.waiting: "deque[GenRequest]" = deque()
        self.ticks = 0
        self.tokens_out = 0
        self.prefill_batches = 0
        # stable physical slot indices (not positions in ``active``):
        # the reqtrace slot timeline needs one lane per slot
        self._slot_idx: Dict[str, int] = {}
        self._free_idx: List[int] = list(range(runtime.slots))
        _reqtrace.set_slots(runtime.name, runtime.slots)

    def _slot_on(self, seq_id: str) -> None:
        idx = self._free_idx.pop(0) if self._free_idx \
            else len(self._slot_idx)
        self._slot_idx[seq_id] = idx
        _reqtrace.slot_acquire(self.rt.name, idx, seq_id)

    def _slot_off(self, seq_id: str) -> None:
        idx = self._slot_idx.pop(seq_id, None)
        if idx is not None:
            self._free_idx.append(idx)
            self._free_idx.sort()
            _reqtrace.slot_release(self.rt.name, idx)

    # -- server-facing surface ----------------------------------------
    def enqueue(self, req: GenRequest) -> None:
        self.waiting.append(req)

    def free_slots(self) -> int:
        return max(self.rt.slots - len(self.active) - len(self.waiting),
                   0)

    def idle(self) -> bool:
        return not self.active and not self.waiting

    def abort_all(self, make_error) -> List[tuple]:
        """Fail every waiting + active sequence (rollback of a canary
        engine).  Returns the outcome tuples."""
        outcomes = []
        for req in list(self.waiting):
            self._finish(req, "error", make_error(req))
            outcomes.append((req, "error", None))
        self.waiting.clear()
        for s in list(self.active):
            self.kv.free(s.seq_id)
            self._slot_off(s.seq_id)
            self._flush_trace(s)
            self._finish(s.req, "error", make_error(s.req))
            outcomes.append((s.req, "error", None))
        self.active = []
        return outcomes

    # -- one engine tick ----------------------------------------------
    def step(self, is_canary: bool = False) -> Dict[str, Any]:
        """Reap, admit, decode — one tick.  Returns {outcomes:
        [(req, outcome, exc)], ticked, exec_error, tokens}."""
        rep: Dict[str, Any] = {"outcomes": [], "ticked": False,
                               "exec_error": None, "tokens": 0}
        self.ticks += 1
        self._reap(rep)
        try:
            self._admit(rep)
            self._decode(rep, is_canary)
        except ExecutorFailure as e:
            rep["exec_error"] = e
        self.kv.feed_metrics()
        return rep

    def _finish(self, req: GenRequest, outcome: str,
                error: Optional[BaseException] = None) -> None:
        if not req.done():
            if error is None:
                req.set_result({"tokens": list(req.tokens),
                                "prompt_len": len(req.prompt)})
            else:
                req.set_error(error)
        req._close_stream()

    def _flush_trace(self, slot: _Slot) -> None:
        """Fold the slot's accumulated decode residency into the
        request's trace — before the terminal set_result/set_error
        pops the open record."""
        if slot.ticks:
            _reqtrace.phase(slot.req.id, "decode", slot.decode_s)
            _reqtrace.event(slot.req.id, "decode_ticks", n=slot.ticks)
            slot.decode_s, slot.ticks = 0.0, 0

    def _retire(self, rep, slot: _Slot, outcome: str,
                error: Optional[BaseException] = None,
                evicted: bool = False) -> None:
        self.kv.free(slot.seq_id, evicted=evicted)
        self._slot_off(slot.seq_id)
        self._flush_trace(slot)
        self._finish(slot.req, outcome, error)
        rep["outcomes"].append((slot.req, outcome, error))

    def _reap(self, rep) -> None:
        """Cancellations (client or chaos ``cancel_request``), deadline
        expiry — slot + blocks reclaimed NOW, co-riders untouched."""
        from .. import chaos as _chaos

        now = time.monotonic()
        keep_w: "deque[GenRequest]" = deque()
        for req in self.waiting:
            if req.cancelled:
                _reqtrace.phase(req.id, "queue", now - req.enqueue_ts)
                self._finish(req, "cancelled", Cancelled(
                    "request %s cancelled while waiting" % req.id))
                rep["outcomes"].append((req, "cancelled", None))
            elif req.expired(now):
                # the whole life was queue residency: the autopsy says
                # "died waiting", not just "expired"
                _reqtrace.phase(req.id, "queue", now - req.enqueue_ts)
                self._finish(req, "expired", DeadlineExceeded(
                    "request %s: deadline expired before a slot freed"
                    % req.id))
                rep["outcomes"].append((req, "expired", None))
            else:
                keep_w.append(req)
        self.waiting = keep_w
        chaos_on = _chaos.enabled()
        keep: List[_Slot] = []
        for s in self.active:
            if chaos_on and _chaos.should_cancel_request(self.rt.name):
                s.req.cancel()
            if s.req.cancelled:
                self._retire(rep, s, "cancelled", Cancelled(
                    "request %s cancelled mid-stream after %d tokens"
                    % (s.req.id, len(s.req.tokens))))
            elif s.req.expired(now):
                self._retire(rep, s, "expired", DeadlineExceeded(
                    "request %s: deadline expired mid-generation "
                    "(%d tokens out)" % (s.req.id, len(s.req.tokens))))
            else:
                keep.append(s)
        self.active = keep

    def _admit(self, rep) -> None:
        """Batched prefill for up to ``prefill_batch`` waiting
        sequences (whole-batch comparator mode only admits into an
        EMPTY engine — that is the A/B).  Cache-exhausted admissions
        stay waiting; their deadline keeps running."""
        from .. import chaos as _chaos

        rt = self.rt
        if not rt.continuous and self.active:
            return
        room = rt.slots - len(self.active)
        group: List[GenRequest] = []
        admit_t = time.monotonic()
        while self.waiting and len(group) < min(room, rt.prefill_batch):
            req = self.waiting[0]
            try:
                self.kv.alloc(req.id, len(req.prompt))
            except CacheExhausted:
                # admitted-blocked: "Nms waiting on CacheExhausted" is
                # a traced phase
                _reqtrace.cache_wait(req.id)
                break  # blocks free as riders finish; stay waiting
            self.waiting.popleft()
            _reqtrace.phase(req.id, "queue", admit_t - req.enqueue_ts)
            group.append(req)
        if not group:
            return
        prefill_t0 = time.monotonic()
        try:
            if _chaos.enabled() and _chaos.should_fail_execute(rt.name):
                raise ExecutorFailure(
                    "chaos fail_execute injected for generator %r"
                    % rt.name)
            bb = bucket_for([a for a, _ in rt.prefill_plan], len(group))
            tb = bucket_for(rt.prompt_plan,
                            max(len(r.prompt) for r in group))
            bt = rt.block_tokens
            tokens = np.zeros((bb, tb), dtype=np.int64)
            plens = np.ones((bb,), dtype=np.int64)
            tables = np.zeros((bb, tb // bt), dtype=np.int64)
            for i, req in enumerate(group):
                p = len(req.prompt)
                tokens[i, :p] = req.prompt
                plens[i] = p
                tables[i] = self.kv.block_table(req.id, tb // bt)
            first = _argmax(rt.prefill(tokens, plens, tables))
        except Exception as e:
            err = e if isinstance(e, ExecutorFailure) else \
                ExecutorFailure("prefill for %r failed: %r"
                                % (rt.name, e))
            for req in group:
                self.kv.free(req.id)
                self._finish(req, "error", err)
                rep["outcomes"].append((req, "error", err))
            raise err
        self.prefill_batches += 1
        rep["ticked"] = True
        prefill_dur = time.monotonic() - prefill_t0
        rider_ids = [r.id for r in group]
        for i, req in enumerate(group):
            _reqtrace.phase(req.id, "prefill", prefill_dur,
                            bucket="%dx%d" % (bb, tb))
            _reqtrace.event(req.id, "batch_formed",
                            bucket="%dx%d" % (bb, tb),
                            co_riders=[r for r in rider_ids
                                       if r != req.id])
            tok = int(first[i])
            req._emit(tok)
            rep["tokens"] += 1
            self.tokens_out += 1
            slot = _Slot(req, req.id, pos=len(req.prompt), next_token=tok)
            self._slot_on(req.id)
            if len(req.tokens) >= req.max_new:
                self._retire(rep, slot, "ok")
            else:
                self.active.append(slot)

    def _decode(self, rep, is_canary: bool) -> None:
        """One decode tick for every rider: grow cache coverage (a
        sequence that cannot get its next block is EVICTED, counted),
        pick the (batch, cache_len) plan cell, run the step, stream the
        new tokens, retire the finished."""
        from .. import chaos as _chaos

        rt = self.rt
        if not self.active:
            return
        riders: List[_Slot] = []
        for s in self.active:
            try:
                self.kv.extend(s.seq_id, s.pos + 1)
                riders.append(s)
            except CacheExhausted as e:
                self._retire(rep, s, "error", ExecutorFailure(
                    "sequence %s evicted under cache pressure: %r"
                    % (s.req.id, e)), evicted=True)
        self.active = riders
        if not riders:
            return
        trace_on = _reqtrace.recorder.enabled
        tick_t0 = time.monotonic() if trace_on else 0.0
        injected = None
        if _chaos.enabled():
            if _chaos.should_fail_execute(rt.name):
                raise self._fail_riders(rep, ExecutorFailure(
                    "chaos fail_execute injected for generator %r"
                    % rt.name))
            if is_canary and _chaos.should_fail_version(
                    rt.name, rt.version):
                raise self._fail_riders(rep, ExecutorFailure(
                    "chaos bad_version injected for %r v%d"
                    % (rt.name, rt.version)))
            # a seeded tick stall sleeps here (inside the measured
            # tick) and comes back tagged, so the autopsy pins it on
            # chaos rather than an organically slow decode step
            injected = _chaos.maybe_stall_decode_tick(rt.name)
        bb = bucket_for(rt.batch_plan, len(riders))
        lb = bucket_for(rt.cache_plan, max(s.pos + 1 for s in riders))
        bt = rt.block_tokens
        tokens = np.zeros((bb,), dtype=np.int64)
        positions = np.zeros((bb,), dtype=np.int64)
        tables = np.zeros((bb, lb // bt), dtype=np.int64)
        for i, s in enumerate(riders):
            tokens[i] = s.next_token
            positions[i] = s.pos
            tables[i] = self.kv.block_table(s.seq_id, lb // bt)
        try:
            nxt = _argmax(rt.decode(tokens, positions, tables))
        except Exception as e:
            raise self._fail_riders(rep, ExecutorFailure(
                "decode tick for %r (bucket %dx%d) failed: %r"
                % (rt.name, bb, lb, e))) from e
        rep["ticked"] = True
        if trace_on:
            tick_dur = time.monotonic() - tick_t0
            if injected is not None:
                _reqtrace.tick(rt.name, tick_dur,
                               [s.req.id for s in riders],
                               injected=injected)
            else:
                for s in riders:
                    s.decode_s += tick_dur
                    s.ticks += 1
        keep: List[_Slot] = []
        for i, s in enumerate(riders):
            tok = int(nxt[i])
            s.req._emit(tok)
            rep["tokens"] += 1
            self.tokens_out += 1
            s.pos += 1
            s.next_token = tok
            self.kv.note_length(s.seq_id, s.pos)
            if len(s.req.tokens) >= s.req.max_new:
                self._retire(rep, s, "ok")
            else:
                keep.append(s)
        self.active = keep

    def _fail_riders(self, rep, err: ExecutorFailure) -> ExecutorFailure:
        """Decode-tick failure: every rider rode the failed batch —
        error them all, free their blocks, return the error for the
        caller to raise (the breaker's food)."""
        for s in self.active:
            self.kv.free(s.seq_id)
            self._slot_off(s.seq_id)
            self._flush_trace(s)
            self._finish(s.req, "error", err)
            rep["outcomes"].append((s.req, "error", err))
        self.active = []
        return err


def demo_generation_runtime(name: str = "gen", seed: int = 0, *,
                            vocab: int = 64, n_layers: int = 2,
                            d_model: int = 32, n_heads: int = 2,
                            device=None, **kw) -> GenerationRuntime:
    """A small fixed-seed transformer generator on ``device`` (default
    ``cuda``); ``kw`` goes to :class:`GenerationRuntime`."""
    cfg = _model.TransformerConfig(vocab_size=vocab, n_layers=n_layers,
                                   d_model=d_model, n_heads=n_heads,
                                   d_ff=2 * d_model)
    params = _model.init_params(torch.Generator().manual_seed(seed), cfg,
                                device=device)
    return GenerationRuntime(name, params, cfg, device=device, **kw)


class _StubGenConfig:
    """Minimal config surface StubGenerationRuntime needs (the paged
    cache geometry + vocab for the arithmetic token rule)."""

    vocab_size = 64
    n_layers = 1
    n_heads = 1
    head_dim = 1
    dtype = "float32"


def stub_greedy_reference(prompt, n_new: int, vocab: int = 64):
    """The dense reference for :class:`StubGenerationRuntime`'s token
    rule: ``next = sum(history) % vocab`` over the raw token ids."""
    hist = [int(t) for t in prompt]
    out: List[int] = []
    for _ in range(n_new):
        nxt = sum(hist) % int(vocab)
        out.append(nxt)
        hist.append(nxt)
    return out


class StubGenerationRuntime(GenerationRuntime):
    """Host-only generator for the self-tests: the REAL engine, plans,
    paged allocator and per-cell dispatch, on the CPU — but each
    forward is a numpy function that scatters the new tokens into the
    pages and gathers the history back THROUGH THE BLOCK TABLE
    (``next = sum(gathered history) % vocab``).  A broken allocator,
    table or garbage-block contract therefore diverges from
    :func:`stub_greedy_reference` exactly like a broken kernel would,
    in milliseconds.  The real-model numerics pins live in
    tests/test_torch_serving.py."""

    def __init__(self, name: str, **kw):
        kw["device"] = "cpu"
        super().__init__(name, {}, _StubGenConfig(), **kw)

    def _pages(self) -> np.ndarray:
        # a numpy view of the CPU pool: writes land in the cache
        return self.kv.pages["k0"].numpy()

    def _prefill_forward(self, tokens, prompt_lens, tables):
        k = self._pages()
        bt, vocab = self.block_tokens, self.cfg.vocab_size
        bb = int(tokens.shape[0])
        logits = np.zeros((bb, vocab), dtype=np.float32)
        for i in range(bb):
            p = int(prompt_lens[i])
            for j in range(p):
                k[tables[i, j // bt], j % bt, 0, 0] = tokens[i, j]
            hist = k[tables[i], :, 0, 0].reshape(-1)[:p]
            logits[i, int(hist.sum()) % vocab] = 1.0
        k[0] = 0.0  # padded rows wrote here; garbage stays garbage
        return logits

    def _decode_forward(self, tokens, positions, tables):
        k = self._pages()
        bt, vocab = self.block_tokens, self.cfg.vocab_size
        bb = int(tokens.shape[0])
        logits = np.zeros((bb, vocab), dtype=np.float32)
        for i in range(bb):
            pos = int(positions[i])
            k[tables[i, pos // bt], pos % bt, 0, 0] = tokens[i]
            hist = k[tables[i], :, 0, 0].reshape(-1)[:pos + 1]
            logits[i, int(hist.sum()) % vocab] = 1.0
        k[0] = 0.0
        return logits
