"""ModelServer — per-model queues, dispatch workers, and the
robustness layer (admission control, deadline propagation, circuit
breaker, graceful drain, probes, live reload with a canary).

Counterpart: ``mxnet_tpu/serving/server.py``: the predictor tier
(:meth:`ModelServer.add_model` / :meth:`~ModelServer.submit` /
:meth:`~ModelServer.predict`, the dynamic batcher's dispatch worker),
the generation tier (:meth:`~ModelServer.add_generator` /
:meth:`~ModelServer.submit_generation`, the continuous-batching engine
loop), live reload + canary + rollback, the SIGTERM drain hook, the
probes and the ``mxnet_serve_*`` metrics, with the JAX package's names
and label sets.  Each predictor dispatch runs in a
``traceview.step_window`` (``serving.dispatch``), as in the JAX package;
the port also makes each generation engine tick with work a window
(``serving.generate``), so a device trace of the generation tier shows
its prefill and decode launches by tick.

Threads and the card: the dispatch/engine worker of a model and its
reload thread are the only threads that issue device work; each binds
the runtime's CUDA device before its first launch.  Requests, results
and the HTTP handlers only ever see host values (numpy arrays, ints).

Degradation contract under overload: admitted requests keep a bounded
p99 because the queue is bounded and expired work is dropped before
dispatch; EXCESS traffic is shed with ``Rejected(queue_full)`` +
retry-after, counted in ``mxnet_serve_rejected_total{reason=...}``.  A
model whose executor fails ``MXNET_SERVE_BREAKER_N`` consecutive times
trips its circuit breaker: submits fast-fail (reason=breaker_open) and
the already-queued doomed work is failed immediately; after
``MXNET_SERVE_BREAKER_RESET_S`` one half-open probe batch decides
re-close vs re-open.

SIGTERM drain: the server registers a
``diagnostics.register_preemption_hook`` that stops admission, flushes
every queued + in-flight batch within ``MXNET_SERVE_DRAIN_S``, and lets
the shared handler exit with code 83 (``EXIT_PREEMPTED``: drained,
zero admitted requests lost).

Probes are distinct: ``live()`` is "the process is worth keeping"
(workers alive, not drained); ``ready()`` is "send traffic here now"
(every model warm, queues below the shed watermark, not draining).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .. import traceview as _traceview
from .._device import bind_device
from . import reqtrace as _reqtrace
from .batching import Request, RequestQueue
from .errors import DeadlineExceeded, ExecutorFailure, Rejected

__all__ = ["CircuitBreaker", "ModelServer"]

_log = logging.getLogger(__name__)

#: ready() flips false once any queue passes this fraction of its bound
READY_WATERMARK = 0.8


def _bind_device(runtime) -> None:
    """Make the runtime's CUDA device current on the calling thread
    (stub runtimes have no device)."""
    bind_device(getattr(runtime, "device", None))


def _slice_rows(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: _slice_rows(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_slice_rows(v, lo, hi) for v in tree)
    return tree[lo:hi]


class CircuitBreaker:
    """Per-model consecutive-failure breaker: ``closed`` (healthy) ->
    ``open`` after N consecutive executor failures (submits fast-fail)
    -> ``half_open`` after the reset window (ONE probe batch through;
    success closes, failure re-opens)."""

    def __init__(self, n_failures: int, reset_s: float):
        self.n_failures = int(n_failures)
        self.reset_s = float(reset_s)
        self._lock = threading.Lock()
        self._consecutive = 0
        self._opened_ts: Optional[float] = None
        self._probing = False
        self._probe_ts = 0.0
        # last explicit state transition — /stats surfaces its age so
        # "open" vs "open for the last 40 minutes" are distinguishable
        self._state_ts = time.monotonic()

    def state_age_s(self) -> float:
        with self._lock:
            return max(time.monotonic() - self._state_ts, 0.0)

    def state(self) -> str:
        with self._lock:
            if self._opened_ts is None:
                return "closed"
            if self._probing:
                return "half_open"
            if time.monotonic() - self._opened_ts >= self.reset_s:
                return "half_open"
            return "open"

    def admit(self) -> bool:
        """May new work enter the queue?  closed: yes.  open: no.
        half-open: one probe's worth (the first admit after the reset
        window) — concurrent submits keep fast-failing until the probe
        decides.  A probe that vanished without a verdict (shed at
        offer, expired in the queue) must not wedge the breaker open
        forever: the reservation itself times out after reset_s and a
        new probe is allowed."""
        with self._lock:
            if self._opened_ts is None:
                return True
            now = time.monotonic()
            if self._probing:
                if now - self._probe_ts >= self.reset_s:
                    self._probe_ts = now  # lost probe: allow another
                    return True
                return False
            if now - self._opened_ts >= self.reset_s:
                self._probing = True
                self._probe_ts = now
                self._state_ts = now
                return True
            return False

    def abort_probe(self) -> None:
        """The admitted probe never made it into the queue (offer
        shed it) — release the reservation so the next submit can
        probe immediately instead of waiting out the reservation
        timeout."""
        with self._lock:
            self._probing = False
            self._state_ts = time.monotonic()

    def retry_after_s(self) -> Optional[float]:
        with self._lock:
            if self._opened_ts is None:
                return None
            return max(self.reset_s -
                       (time.monotonic() - self._opened_ts), 0.0)

    def on_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._opened_ts is not None or self._probing:
                self._state_ts = time.monotonic()
            self._opened_ts = None
            self._probing = False

    def on_failure(self) -> bool:
        """Returns True when this failure TRIPPED the breaker (closed
        -> open transition, or a failed half-open probe re-opening)."""
        with self._lock:
            self._consecutive += 1
            if self._probing or (self.n_failures > 0
                                 and self._consecutive >= self.n_failures
                                 and self._opened_ts is None):
                # closed -> open, or a failed half-open probe re-opening
                self._opened_ts = time.monotonic()
                self._state_ts = self._opened_ts
                self._probing = False
                return True
            return False


class _ServedModel:
    """One model's runtime + queue + worker + breaker + throughput
    estimate (the retry-after hint) + the live-reload state machine."""

    def __init__(self, runtime, queue_max: int, breaker_n: int,
                 breaker_reset_s: float, on_expired):
        self.runtime = runtime     # the STABLE version (atomic swap)
        self.queue = RequestQueue(queue_max, on_expired=on_expired)
        self.breaker = CircuitBreaker(breaker_n, breaker_reset_s)
        self.worker: Optional[threading.Thread] = None
        self.inflight = 0          # samples taken off-queue, not done
        self.ewma_batch_s = 0.05   # batch latency estimate (retry-after)
        self.completed = 0
        self.failed = 0
        self._lock = threading.Lock()
        # -- live reload / canary state (guarded by _lock) ------------
        self.canary = None               # new runtime while canarying
        self.reload_state: Dict[str, Any] = {"state": "idle"}
        self.reload_thread: Optional[threading.Thread] = None
        self._canary_seq = 0             # deterministic routing counter
        # per-version {n, errors} since the canary started — the
        # promote-vs-rollback evidence window
        self._vstats: Dict[int, Dict[str, int]] = {}


class ModelServer:
    """The batching model server.  In-process API: :meth:`submit` (a
    Request future) / :meth:`predict` (blocking); the HTTP front-end
    (serving/http.py) is a thin adapter over the same calls."""

    def __init__(self, *, queue_max: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 batch_deadline_ms: Optional[float] = None,
                 default_deadline_ms: Optional[float] = None,
                 drain_s: Optional[float] = None,
                 breaker_n: Optional[int] = None,
                 breaker_reset_s: Optional[float] = None,
                 canary_pct: Optional[float] = None,
                 canary_min_n: Optional[int] = None,
                 rollback_err_ratio: Optional[float] = None):
        from .. import env as _env

        def knob(v, name, get=_env.get_float):
            return get(name) if v is None else v

        self.queue_max = int(knob(queue_max, "MXNET_SERVE_QUEUE_MAX",
                                  _env.get_int))
        self.max_batch = int(knob(max_batch, "MXNET_SERVE_MAX_BATCH",
                                  _env.get_int))
        self.batch_deadline_s = float(
            knob(batch_deadline_ms, "MXNET_SERVE_BATCH_DEADLINE_MS")) / 1e3
        self.default_deadline_s = float(
            knob(default_deadline_ms, "MXNET_SERVE_DEADLINE_MS")) / 1e3
        self.drain_timeout_s = float(knob(drain_s, "MXNET_SERVE_DRAIN_S"))
        self._breaker_n = int(knob(breaker_n, "MXNET_SERVE_BREAKER_N",
                                   _env.get_int))
        self._breaker_reset_s = float(
            knob(breaker_reset_s, "MXNET_SERVE_BREAKER_RESET_S"))
        self.canary_pct = float(knob(canary_pct,
                                     "MXNET_SERVE_CANARY_PCT"))
        self.canary_min_n = int(knob(canary_min_n,
                                     "MXNET_SERVE_CANARY_MIN_N",
                                     _env.get_int))
        self.rollback_err_ratio = float(
            knob(rollback_err_ratio, "MXNET_SERVE_ROLLBACK_ERR_RATIO"))
        self._models: Dict[str, _ServedModel] = {}
        # reentrant: the SIGTERM preemption hook runs drain() inside a
        # signal handler ON the main thread, which may be interrupted
        # while holding this lock in submit()/_get()/stats() — the same
        # self-deadlock class diagnostics' _preempt_lock was converted
        # to RLock for.  (Queue Conditions are reentrant by default.)
        self._lock = threading.RLock()
        self._draining = False
        self._drained = False
        self._hook_key: Optional[Any] = None

    # -- model lifecycle ----------------------------------------------
    def add_model(self, runtime, warmup: bool = True) -> None:
        """Register + warm a model (one batch per bucket: the JAX
        package's AOT compile) and start its dispatch worker.  The
        server only reports ready() once every added model is warm."""
        if runtime.name in self._models:
            raise ValueError("model %r already served" % runtime.name)
        runtime.version = getattr(runtime, "version", 1) or 1
        sm = _ServedModel(runtime, self.queue_max, self._breaker_n,
                          self._breaker_reset_s,
                          on_expired=lambda r: self._count_outcome(
                              runtime.name, "expired",
                              self._version_of(runtime.name)))
        if hasattr(runtime, "compile") and not runtime.compiled:
            runtime.compile(warmup=warmup)
        sm.worker = threading.Thread(
            target=self._worker_loop, args=(sm,), daemon=True,
            name="mx-serve-%s" % runtime.name)
        with self._lock:
            self._models[runtime.name] = sm
        sm.worker.start()

    def add_generator(self, runtime, warmup: bool = True) -> None:
        """Register + warm a GENERATION runtime
        (:class:`~mxnet_tpu_torch.serving.generate.GenerationRuntime`) and
        start its continuous-batching engine loop.  Everything else —
        queue, breaker, drain, canary reload, readiness — is the same
        machinery the predictor tier uses; only the worker differs
        (per-slot admission + decode ticks instead of take_batch +
        dispatch)."""
        if runtime.name in self._models:
            raise ValueError("model %r already served" % runtime.name)
        runtime.version = getattr(runtime, "version", 1) or 1
        sm = _ServedModel(runtime, self.queue_max, self._breaker_n,
                          self._breaker_reset_s,
                          on_expired=lambda r: self._count_outcome(
                              runtime.name, "expired",
                              self._version_of(runtime.name)))
        sm.is_generator = True
        #: promoted-away runtimes whose engines still hold riders —
        #: they keep ticking (no new admissions) until empty, so a hot
        #: swap never drops an in-flight generation
        sm.gen_retired = []
        if hasattr(runtime, "compile") and not runtime.compiled:
            runtime.compile(warmup=warmup)
        sm.worker = threading.Thread(
            target=self._gen_worker_loop, args=(sm,), daemon=True,
            name="mx-serve-%s" % runtime.name)
        with self._lock:
            self._models[runtime.name] = sm
        sm.worker.start()

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def _get(self, model: str) -> _ServedModel:
        with self._lock:
            sm = self._models.get(model)
        if sm is None:
            self._count_rejected("unknown_model")
            raise Rejected("unknown_model", "no model %r (serving: %s)"
                           % (model, self.models()))
        return sm

    # -- submission ----------------------------------------------------
    def submit(self, model: str, data, *,
               deadline_ms: Any = "default",
               request_id: Optional[str] = None) -> Request:
        """Admit one request (``data``: one sample of the model's
        sample shape, or a ``(n, *sample_shape)`` mini-batch) or shed
        it by raising :class:`Rejected`.  Returns the Request future;
        ``wait()`` it for the result."""
        sm = self._get(model)
        if self._draining:
            self._count_rejected("draining")
            _reqtrace.reject(request_id, model, "draining")
            raise Rejected("draining", "server is draining")
        arr = np.asarray(data)
        if arr.shape == tuple(sm.runtime.sample_shape):
            arr = arr[None]  # single sample convenience
        if arr.shape[1:] != tuple(sm.runtime.sample_shape):
            self._count_rejected("bad_input")
            _reqtrace.reject(request_id, model, "bad_input")
            raise Rejected("bad_input",
                           "expected sample shape %s, got %s"
                           % (sm.runtime.sample_shape, arr.shape[1:]))
        n = int(arr.shape[0])
        max_n = min(self.max_batch, sm.runtime.max_batch)
        if n > max_n:
            self._count_rejected("too_large")
            _reqtrace.reject(request_id, model, "too_large")
            raise Rejected("too_large",
                           "%d samples > max batch %d" % (n, max_n))
        if not sm.breaker.admit():
            self._count_rejected("breaker_open")
            _reqtrace.reject(request_id, model, "breaker_open")
            raise Rejected(
                "breaker_open",
                "model %r breaker is open after consecutive executor "
                "failures" % model,
                retry_after_s=sm.breaker.retry_after_s())
        deadline_s = self.default_deadline_s \
            if deadline_ms == "default" else (
                None if deadline_ms is None else float(deadline_ms) / 1e3)
        req = Request(model, arr, n, deadline_s=deadline_s,
                      request_id=request_id)
        try:
            sm.queue.offer(req, retry_after_s=self._retry_after(sm))
        except Rejected as e:
            # if this submit was the half-open probe, release the
            # reservation — a shed probe must not wedge the breaker
            sm.breaker.abort_probe()
            self._count_rejected(e.reason)
            raise
        self._gauge_depth(sm)
        return req

    def predict(self, model: str, data, *, deadline_ms: Any = "default",
                timeout_s: Optional[float] = None,
                request_id: Optional[str] = None):
        """submit + wait.  The default wait bound is the request's own
        deadline plus one batch-latency of slack."""
        req = self.submit(model, data, deadline_ms=deadline_ms,
                          request_id=request_id)
        if timeout_s is None:
            sm = self._get(model)
            slack = max(sm.ewma_batch_s * 4, 1.0)
            timeout_s = slack if req.deadline_ts is None else \
                (req.deadline_ts - time.monotonic()) + slack
        return req.wait(timeout_s)

    # -- generation submission ----------------------------------------
    def submit_generation(self, model: str, prompt, *,
                          max_new: Optional[int] = None,
                          deadline_ms: Any = "default",
                          on_token=None,
                          request_id: Optional[str] = None):
        """Admit one generation request (``prompt``: 1-D int token
        ids) or shed it — the same admission gates as :meth:`submit`
        (draining, shape, breaker, bounded queue, deadline), plus the
        generation-specific feasibility gates: prompt within the
        compiled prompt ladder, ``prompt + max_new`` within the cache
        ladder AND the block pool.  Returns the
        :class:`~mxnet_tpu_torch.serving.generate.GenRequest` future;
        ``wait()`` it, stream via ``on_token``, abandon via
        ``.cancel()``."""
        from .generate import GenRequest

        sm = self._get(model)
        rt = sm.runtime
        if not getattr(sm, "is_generator", False):
            self._count_rejected("bad_input")
            _reqtrace.reject(request_id, model, "bad_input")
            raise Rejected("bad_input",
                           "model %r is a predictor, not a generator"
                           % model)
        if self._draining:
            self._count_rejected("draining")
            _reqtrace.reject(request_id, model, "draining")
            raise Rejected("draining", "server is draining")
        arr = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if arr.size < 1:
            self._count_rejected("bad_input")
            _reqtrace.reject(request_id, model, "bad_input")
            raise Rejected("bad_input", "empty prompt")
        mn = rt.max_new if max_new is None else max(int(max_new), 1)
        if arr.size > rt.max_prompt:
            self._count_rejected("too_large")
            _reqtrace.reject(request_id, model, "too_large")
            raise Rejected("too_large",
                           "prompt of %d tokens > max prompt %d"
                           % (arr.size, rt.max_prompt))
        need_blocks = -(-(arr.size + mn) // rt.block_tokens)
        if arr.size + mn > rt.max_context or \
                need_blocks > rt.kv.num_blocks - 1:
            self._count_rejected("too_large")
            _reqtrace.reject(request_id, model, "too_large")
            raise Rejected(
                "too_large",
                "%d prompt + %d new tokens exceeds max context %d "
                "(or the %d-block cache pool)"
                % (arr.size, mn, rt.max_context, rt.kv.num_blocks - 1))
        if not sm.breaker.admit():
            self._count_rejected("breaker_open")
            _reqtrace.reject(request_id, model, "breaker_open")
            raise Rejected(
                "breaker_open",
                "model %r breaker is open after consecutive executor "
                "failures" % model,
                retry_after_s=sm.breaker.retry_after_s())
        deadline_s = self.default_deadline_s \
            if deadline_ms == "default" else (
                None if deadline_ms is None else float(deadline_ms) / 1e3)
        req = GenRequest(model, arr, mn, deadline_s=deadline_s,
                         request_id=request_id, on_token=on_token)
        try:
            sm.queue.offer(req, retry_after_s=self._retry_after(sm))
        except Rejected as e:
            sm.breaker.abort_probe()
            self._count_rejected(e.reason)
            raise
        self._gauge_depth(sm)
        return req

    def generate(self, model: str, prompt, *,
                 max_new: Optional[int] = None,
                 deadline_ms: Any = "default",
                 timeout_s: Optional[float] = None):
        """submit_generation + wait.  Returns the result dict
        ``{tokens, prompt_len}``."""
        req = self.submit_generation(model, prompt, max_new=max_new,
                                     deadline_ms=deadline_ms)
        if timeout_s is None:
            sm = self._get(model)
            slack = max(sm.ewma_batch_s * 4 * req.max_new, 5.0)
            timeout_s = slack if req.deadline_ts is None else \
                (req.deadline_ts - time.monotonic()) + slack
        return req.wait(timeout_s)

    def _retry_after(self, sm: _ServedModel) -> float:
        """Shed hint: how long until a full queue's worth of work
        drains at the current batch rate."""
        batches_queued = max(sm.queue.depth() / max(self.max_batch, 1),
                             1.0)
        return round(batches_queued * max(sm.ewma_batch_s, 1e-3), 3)

    # -- dispatch worker ----------------------------------------------
    def _worker_loop(self, sm: _ServedModel) -> None:
        from .. import chaos as _chaos
        from .. import diagnostics as _diag

        _bind_device(sm.runtime)
        while True:
            # liveness beacon: a supervised server that idles between
            # requests (or sits in a long AOT compile before traffic)
            # must not read as "hung" to the elastic supervisor's
            # MXNET_ELASTIC_HEARTBEAT_TIMEOUT_S — the batcher loop IS
            # the proof of life (rate-limited, no-op unsupervised)
            _diag.touch_heartbeat()
            batch = sm.queue.take_batch(
                min(self.max_batch, sm.runtime.max_batch),
                self.batch_deadline_s)
            self._gauge_depth(sm)
            if batch is None:
                return  # drained: queue closed and empty
            if not batch:
                continue
            # final deadline gate: expired co-riders are rejected HERE,
            # before dispatch — an expired request is never executed
            now = time.monotonic()
            live = []
            for r in batch:
                if r.expired(now):
                    _reqtrace.phase(r.id, "queue", now - r.enqueue_ts)
                    r.set_error(DeadlineExceeded(
                        "request %s: deadline expired at dispatch"
                        % r.id))
                    self._count_outcome(sm.runtime.name, "expired",
                                        sm.runtime.version)
                else:
                    live.append(r)
            if not live:
                continue
            if _chaos.enabled():
                # chaos 'slow_request': the seeded slow executor the
                # overload test bounds — injected at the dispatch point
                # so queue-depth/deadline behavior is what's exercised;
                # the tagged phase keeps the seeded stall from reading
                # as an organically slow executor in the autopsy
                inj = _chaos.maybe_slow_request(sm.runtime.name)
                if inj is not None:
                    for r in live:
                        _reqtrace.phase(
                            r.id, "stall:injected:%s" % inj["kind"],
                            float(inj["ms"]) / 1e3, injected=True)
            self._dispatch(sm, live)

    # -- generation worker: the continuous-batching engine loop --------
    def _gen_worker_loop(self, sm: _ServedModel) -> None:
        """One tick per iteration: admit per-slot (queue.poll with the
        engines' free-slot count), reap/prefill/decode every engine —
        stable, canary (per-SEQUENCE Bresenham routing), and any
        promoted-away runtime still finishing riders — then feed the
        breaker/canary evidence exactly as the predictor dispatch path
        does.  Exits when the queue reports drain-complete and every
        engine is empty: the SIGTERM drain finishes every admitted
        generation."""
        from .. import diagnostics as _diag

        _bind_device(sm.runtime)
        prev_stable = sm.runtime
        prev_canary = None
        while True:
            _diag.touch_heartbeat()
            stable = sm.runtime
            with sm._lock:
                canary = sm.canary
            # reload transitions since last tick
            if prev_canary is not None and canary is None:
                if stable is prev_canary:
                    # promoted: the old stable's riders finish on it
                    if not prev_stable.engine.idle():
                        sm.gen_retired.append(prev_stable)
                else:
                    # rolled back: the canary's riders are aborted —
                    # a bad version must not keep streaming tokens
                    outs = prev_canary.engine.abort_all(
                        lambda r: ExecutorFailure(
                            "version v%d rolled back mid-generation"
                            % prev_canary.version))
                    for req, outcome, _ in outs:
                        self._count_outcome(stable.name, outcome,
                                            prev_canary.version)
                    with sm._lock:
                        sm.failed += len(outs)
            prev_stable, prev_canary = stable, canary
            # per-slot admission, routed per sequence
            free = stable.engine.free_slots() + \
                (canary.engine.free_slots() if canary else 0)
            polled = sm.queue.poll(free)
            self._gauge_depth(sm)
            for req in (polled or []):
                eng = stable.engine
                if canary is not None:
                    with sm._lock:
                        sm._canary_seq += 1
                        seq = sm._canary_seq
                    pct = max(min(self.canary_pct, 100.0), 0.0)
                    if int(seq * pct) // 100 > \
                            int((seq - 1) * pct) // 100:
                        eng = canary.engine
                        _reqtrace.event(req.id, "canary_route",
                                        version=canary.version)
                eng.enqueue(req)
            # tick every engine
            worked = bool(polled)
            engines = [(stable, False)]
            if canary is not None:
                engines.append((canary, True))
            for rt, is_canary in engines:
                worked |= self._gen_tick(sm, rt, is_canary)
            for rt in list(sm.gen_retired):
                worked |= self._gen_tick(sm, rt, False)
                if rt.engine.idle():
                    sm.gen_retired.remove(rt)
            self._maybe_decide_canary(sm)
            with sm._lock:
                sm.inflight = sum(
                    len(e.engine.active) + len(e.engine.waiting)
                    for e in [stable] + ([canary] if canary else [])
                    + sm.gen_retired)
            self._gauge_inflight(sm)
            if polled is None and sm.inflight == 0 and \
                    not sm.gen_retired:
                return  # drained: queue closed+empty, engines empty
            if not worked:
                time.sleep(0.001)  # idle tick: don't spin a core

    def _gen_tick(self, sm: _ServedModel, rt, is_canary: bool) -> bool:
        """step() one engine and account the report: outcomes ->
        requests_total/latency, tokens -> tokens_total, executor
        failures -> breaker (stable only) + canary evidence — the same
        accounting split _dispatch applies to predictor batches."""
        name = sm.runtime.name
        t0 = time.monotonic()
        eng = rt.engine
        if eng.waiting or eng.active:
            # a tick with work is a dispatch window of the device trace
            # (an idle tick launches nothing and is not one)
            with _traceview.step_window(
                    "serving.generate",
                    device=getattr(rt, "device", None) or "cpu") as tvw:
                rep = eng.step(is_canary=is_canary)
                if tvw is not None:
                    tvw.block()
        else:
            rep = eng.step(is_canary=is_canary)
        tick_s = time.monotonic() - t0
        for req, outcome, _err in rep["outcomes"]:
            self._count_outcome(name, outcome, rt.version)
            if outcome == "ok":
                self._observe_latency(req)
                with sm._lock:
                    sm.completed += 1
            elif outcome == "error":
                with sm._lock:
                    sm.failed += 1
        if rep["tokens"]:
            self._count_gen_tokens(name, rt.version, rep["tokens"])
        if rep["exec_error"] is not None:
            if is_canary:
                self._record_version_result(sm, rt.version, ok=False)
            else:
                if sm.canary is not None:
                    self._record_version_result(sm, rt.version,
                                                ok=False)
                if sm.breaker.on_failure():
                    self._on_breaker_trip(sm)
        elif rep["ticked"]:
            sm.ewma_batch_s = 0.8 * sm.ewma_batch_s + 0.2 * tick_s
            if is_canary:
                self._record_version_result(sm, rt.version, ok=True)
            else:
                sm.breaker.on_success()
                if sm.canary is not None:
                    self._record_version_result(sm, rt.version, ok=True)
        return bool(rep["ticked"] or rep["outcomes"])

    def _count_gen_tokens(self, model: str, version: Optional[int],
                          n: int) -> None:
        try:
            from .. import diagnostics as _diag

            _diag.metrics.counter(
                "mxnet_serve_gen_tokens_total",
                help="generated tokens streamed to callers",
                labels={"model": model,
                        "version": "v%d" % version if version
                        else "unknown"}).inc(n)
            _diag.metrics.maybe_flush()
        except Exception:
            pass

    def _route(self, sm: _ServedModel):
        """Pick the runtime for THIS batch: the stable version, or —
        while a reload is canarying — the new version for
        ``canary_pct`` percent of batches (deterministic Bresenham
        routing on a per-model counter, so tests and rollback evidence
        are reproducible, not coin-flips)."""
        with sm._lock:
            canary = sm.canary
            if canary is None:
                return sm.runtime, False
            sm._canary_seq += 1
            seq = sm._canary_seq
            pct = max(min(self.canary_pct, 100.0), 0.0)
            take = int(seq * pct) // 100 > int((seq - 1) * pct) // 100
            return (canary, True) if take else (sm.runtime, False)

    def _dispatch(self, sm: _ServedModel, live: List[Request]) -> None:
        from .. import chaos as _chaos

        def _exec(rt_, data_):
            with _traceview.step_window(
                    "serving.dispatch",
                    device=getattr(rt_, "device", None) or "cpu") as tvw:
                out_ = rt_.execute(data_)
                if tvw is not None:
                    tvw.block()
            return out_

        name = sm.runtime.name
        total = sum(r.n for r in live)
        with sm._lock:
            sm.inflight += total
        self._gauge_inflight(sm)
        rt, is_canary = self._route(sm)
        t0 = time.monotonic()
        rider_ids = [r.id for r in live]
        try:
            bucket = rt.bucket_for(total)
        except Exception:
            bucket = None
        for r in live:
            _reqtrace.phase(r.id, "queue", t0 - r.enqueue_ts)
            _reqtrace.event(r.id, "batch_formed", samples=total,
                            bucket=bucket,
                            co_riders=[i for i in rider_ids
                                       if i != r.id])
            if is_canary:
                _reqtrace.event(r.id, "canary_route",
                                version=rt.version)
        try:
            data = live[0].data if len(live) == 1 else \
                np.concatenate([r.data for r in live], axis=0)
            if is_canary:
                try:
                    if _chaos.enabled() and _chaos.should_fail_version(
                            name, rt.version):
                        raise ExecutorFailure(
                            "chaos bad_version injected for %r v%d"
                            % (name, rt.version))
                    out = _exec(rt, data)
                except Exception as ce:
                    # the canary never hurts callers: record the strike
                    # against the NEW version, then transparently
                    # re-execute the batch on the stable version
                    self._record_version_result(sm, rt.version,
                                                ok=False)
                    _log.warning(
                        "serving: canary v%d batch for %r failed (%r) "
                        "— re-executing on stable v%d", rt.version,
                        name, ce, sm.runtime.version)
                    rt, is_canary = sm.runtime, False
                    out = _exec(rt, data)
                else:
                    self._record_version_result(sm, rt.version, ok=True)
            else:
                out = _exec(rt, data)
                if sm.canary is not None:
                    self._record_version_result(sm, rt.version, ok=True)
            batch_s = time.monotonic() - t0
            for r in live:
                # before set_result: finish() pops the open record
                _reqtrace.phase(r.id, "execute", batch_s)
            self._split_results(live, out, rt.version)
            sm.ewma_batch_s = 0.8 * sm.ewma_batch_s + 0.2 * batch_s
            if not is_canary:
                # only stable executions feed the breaker: a canary
                # success must not reset strikes the stable version
                # earned, and canary failures roll back, not trip
                sm.breaker.on_success()
            with sm._lock:
                sm.completed += len(live)
            self._observe_batch(sm, live, total, batch_s, rt.version)
        except Exception as e:
            err = e if isinstance(e, ExecutorFailure) else \
                ExecutorFailure("dispatch for %r failed: %r"
                                % (name, e))
            err_s = time.monotonic() - t0
            # a chaos-injected executor fault attributes as an injected
            # stall, not organic execute time (runtime.execute tags it)
            err_phase = ("stall:injected:fail_execute"
                         if getattr(err, "injected", False) else
                         "execute")
            for r in live:
                _reqtrace.phase(r.id, err_phase, err_s)
                r.set_error(err)
                self._count_outcome(name, "error", rt.version)
            with sm._lock:
                sm.failed += len(live)
            if sm.canary is not None and not is_canary:
                self._record_version_result(sm, rt.version, ok=False)
            tripped = sm.breaker.on_failure()
            _log.warning("serving: batch of %d for %r failed: %r",
                         len(live), name, e)
            if tripped:
                self._on_breaker_trip(sm)
        finally:
            with sm._lock:
                sm.inflight -= total
            self._gauge_inflight(sm)
        self._maybe_decide_canary(sm)

    def _split_results(self, live: List[Request], out,
                       version: int) -> None:
        """Slice the batch output tree back into per-request results
        (row ranges in ride order)."""
        off = 0
        for r in live:
            lo, hi = off, off + r.n
            r.set_result(_slice_rows(out, lo, hi))
            off = hi
            self._count_outcome(r.model, "ok", version)
            self._observe_latency(r)

    def _on_breaker_trip(self, sm: _ServedModel) -> None:
        """Fast-fail the queued doomed work and flag the gauge — the
        fleet's scrapers see the trip, and callers get answers NOW
        instead of deadline timeouts one batch at a time."""
        name = sm.runtime.name
        _log.error(
            "serving: circuit breaker OPEN for %r after %d consecutive "
            "executor failures — fast-failing queued work, half-open "
            "probe in %.1fs", name, sm.breaker.n_failures,
            sm.breaker.reset_s)
        failed = sm.queue.fail_all(lambda r: Rejected(
            "breaker_open", "model %r breaker tripped while request "
            "was queued" % name,
            retry_after_s=sm.breaker.retry_after_s()))
        for _ in failed:
            self._count_rejected("breaker_open")
        self._gauge_breaker(sm)
        self._gauge_depth(sm)

    # -- live reload: load -> compile+warm -> canary -> promote/rollback
    def reload(self, model: str, directory: Optional[str] = None, *,
               step: Optional[int] = None, runtime=None,
               wait_s: Optional[float] = None) -> Dict[str, Any]:
        """Zero-downtime model reload: load a NEW version of ``model``
        from a (digest-verified) checkpoint directory, AOT-compile and
        warm it in the background, canary ``canary_pct`` percent of
        traffic through it, then atomically swap it in — or auto-roll-
        back when its error rate exceeds the stable version's by
        ``rollback_err_ratio``.  No admitted request is ever dropped:
        queued and in-flight work is untouched by the swap, and a
        failed canary batch transparently re-executes on the stable
        version.

        ``runtime`` bypasses the checkpoint load with a prebuilt
        runtime (tests / in-process weight pushes).  ``wait_s`` blocks
        until the reload reaches a terminal state.  Returns the reload
        state dict (a snapshot; poll :meth:`reload_status`)."""
        sm = self._get(model)
        with sm._lock:
            if sm.reload_state.get("state") in ("loading", "canary"):
                raise Rejected(
                    "reload_in_progress",
                    "model %r is already reloading (%s)"
                    % (model, sm.reload_state))
            new_version = sm.runtime.version + 1
            sm.reload_state = {
                "state": "loading", "model": model,
                "from_version": sm.runtime.version,
                "to_version": new_version,
                "directory": directory, "started_ts": time.monotonic(),
            }
            sm.reload_thread = threading.Thread(
                target=self._reload_worker,
                args=(sm, directory, step, runtime, new_version),
                daemon=True, name="mx-serve-reload-%s" % model)
            sm.reload_thread.start()
        if wait_s is not None:
            return self.wait_reload(model, wait_s)
        return self.reload_status(model)

    def _reload_worker(self, sm: _ServedModel, directory, step,
                       runtime, new_version: int) -> None:
        name = sm.runtime.name
        _bind_device(sm.runtime)
        try:
            rt = runtime if runtime is not None else \
                sm.runtime.successor_from_checkpoint(directory,
                                                     step=step)
            if tuple(rt.sample_shape) != tuple(sm.runtime.sample_shape):
                raise ValueError(
                    "new version's sample shape %s != serving shape %s"
                    % (rt.sample_shape, sm.runtime.sample_shape))
            rt.version = new_version
            if hasattr(rt, "compile") and not rt.compiled:
                rt.compile(warmup=True)  # first canary batch pays zero
        except Exception as e:
            # fail CLOSED: the stable version keeps serving untouched —
            # a corrupt checkpoint (CheckpointCorrupt names the shard)
            # or a compile failure never degrades live traffic
            with sm._lock:
                sm.reload_state.update(state="failed", error=repr(e))
            self._count_reload(name, "failed")
            _log.error("serving: reload of %r -> v%d FAILED (stable "
                       "v%d keeps serving): %r", name, new_version,
                       sm.runtime.version, e)
            return
        with sm._lock:
            sm._vstats = {}
            sm._canary_seq = 0
            if self.canary_pct <= 0:
                self._promote_locked(sm, rt, skipped_canary=True)
                return
            sm.canary = rt
            sm.reload_state.update(state="canary")
        _log.warning(
            "serving: reload of %r — v%d compiled + warm, canarying "
            "%.0f%% of batches (decision after %d canary batches, "
            "rollback if err rate > stable x %.1f)", name, new_version,
            self.canary_pct, self.canary_min_n, self.rollback_err_ratio)

    def _record_version_result(self, sm: _ServedModel, version: int,
                               ok: bool) -> None:
        with sm._lock:
            st = sm._vstats.setdefault(version, {"n": 0, "errors": 0})
            st["n"] += 1
            if not ok:
                st["errors"] += 1

    def _maybe_decide_canary(self, sm: _ServedModel) -> None:
        """Promote or roll back once the canary window holds
        ``canary_min_n`` batches: roll back when the new version's
        error rate exceeds the stable version's (over the SAME window)
        times ``rollback_err_ratio`` — a canary that errors while
        stable is clean always rolls back."""
        with sm._lock:
            rt = sm.canary
            if rt is None:
                return
            cs = dict(sm._vstats.get(rt.version, {"n": 0, "errors": 0}))
            ss = dict(sm._vstats.get(sm.runtime.version,
                                     {"n": 0, "errors": 0}))
            if cs["n"] < self.canary_min_n:
                return
            err_new = cs["errors"] / max(cs["n"], 1)
            err_old = ss["errors"] / max(ss["n"], 1)
            if err_new > err_old * self.rollback_err_ratio or \
                    (err_new > 0 and err_old == 0):
                self._rollback_locked(sm, rt, cs, ss)
            else:
                self._promote_locked(sm, rt, canary_stats=cs,
                                     stable_stats=ss)

    def _promote_locked(self, sm: _ServedModel, rt,
                        skipped_canary: bool = False,
                        canary_stats=None, stable_stats=None) -> None:
        """Atomic swap (caller holds sm._lock): future batches execute
        on the new version; queued requests and the batch in flight are
        untouched, so zero admitted requests are dropped."""
        old_v = sm.runtime.version
        sm.runtime = rt
        sm.canary = None
        sm.reload_state.update(
            state="promoted", skipped_canary=skipped_canary,
            canary_stats=canary_stats, stable_stats=stable_stats,
            swap_s=round(time.monotonic() -
                         sm.reload_state.get("started_ts", 0.0), 3))
        self._count_reload(rt.name, "promoted")
        _log.warning(
            "serving: PROMOTED %r v%d -> v%d (%s) — hot swap, zero "
            "admitted requests dropped", rt.name, old_v, rt.version,
            "canary skipped (pct=0)" if skipped_canary else
            "canary clean: %s vs stable %s" % (canary_stats,
                                               stable_stats))

    def _rollback_locked(self, sm: _ServedModel, rt, cs, ss) -> None:
        sm.canary = None
        sm.reload_state.update(state="rolled_back", canary_stats=cs,
                               stable_stats=ss)
        self._count_reload(rt.name, "rolled_back")
        try:
            from .. import diagnostics as _diag

            _diag.metrics.counter(
                "mxnet_serve_rollbacks_total",
                help="canaried reloads auto-rolled-back",
                labels={"model": rt.name}).inc()
        except Exception:
            pass
        _log.error(
            "serving: ROLLED BACK %r v%d — canary error rate %.3f "
            "(%d/%d) vs stable v%d %.3f (%d/%d) exceeded ratio %.1f; "
            "stable keeps serving, zero admitted requests dropped",
            rt.name, rt.version, cs["errors"] / max(cs["n"], 1),
            cs["errors"], cs["n"], sm.runtime.version,
            ss["errors"] / max(ss["n"], 1), ss["errors"], ss["n"],
            self.rollback_err_ratio)

    def reload_status(self, model: str) -> Dict[str, Any]:
        sm = self._get(model)
        with sm._lock:
            return dict(sm.reload_state)

    def wait_reload(self, model: str,
                    timeout_s: float = 30.0) -> Dict[str, Any]:
        """Poll until the reload reaches a terminal state (promoted /
        rolled_back / failed) or the timeout passes (returns the
        current state either way — a canary with no traffic flowing
        stays in 'canary')."""
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            st = self.reload_status(model)
            if st.get("state") in ("promoted", "rolled_back", "failed",
                                   "idle"):
                return st
            time.sleep(0.01)
        return self.reload_status(model)

    def _count_reload(self, model: str, outcome: str) -> None:
        try:
            from .. import diagnostics as _diag

            _diag.metrics.counter(
                "mxnet_serve_reloads_total",
                help="live reload attempts by terminal outcome",
                labels={"model": model, "outcome": outcome}).inc()
        except Exception:
            pass

    # -- drain + probes -----------------------------------------------
    def drain(self, timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Graceful drain: stop admitting (submits shed with
        reason=draining), flush every queued + in-flight batch, join
        workers.  Returns {drained, completed, failed, left} —
        ``left`` MUST be 0 on a clean drain (no admitted request is
        ever lost)."""
        timeout = self.drain_timeout_s if timeout_s is None \
            else float(timeout_s)
        self._draining = True
        with self._lock:
            models = list(self._models.values())
        for sm in models:
            sm.queue.close()
        deadline = time.monotonic() + timeout
        for sm in models:
            remaining = max(deadline - time.monotonic(), 0.0)
            if sm.worker is not None:
                sm.worker.join(remaining)
        left = sum(sm.queue.depth() + sm.inflight for sm in models)
        report = {
            "drained": all(sm.worker is None or not sm.worker.is_alive()
                           for sm in models) and left == 0,
            "completed": sum(sm.completed for sm in models),
            "failed": sum(sm.failed for sm in models),
            "left": left,
        }
        self._drained = True
        _log.info("serving: drain %s — %d completed, %d failed, %d "
                  "left", "complete" if report["drained"] else
                  "TIMED OUT", report["completed"], report["failed"],
                  left)
        return report

    def install_preemption_hook(self) -> Any:
        """SIGTERM -> (shared handler: dump hooks) -> THIS hook drains
        the server -> exit 83.  For serving, "checkpoint" is "answer
        everything you admitted".  Install from the main thread
        (``signal.signal`` works there only)."""
        from .. import diagnostics as _diag

        if self._hook_key is None:
            self._hook_key = _diag.register_preemption_hook(
                lambda: self.drain(), key="mx-serve-drain-%d" % id(self))
        return self._hook_key

    def uninstall_preemption_hook(self) -> None:
        from .. import diagnostics as _diag

        if self._hook_key is not None:
            _diag.unregister_preemption_hook(self._hook_key)
            self._hook_key = None

    def live(self) -> bool:
        """Liveness: the process is worth keeping — workers healthy (or
        never started), not yet drained.  After drain() this goes
        false so an orchestrator recycles the pod."""
        if self._drained:
            return False
        with self._lock:
            models = list(self._models.values())
        return all(sm.worker is None or sm.worker.is_alive()
                   for sm in models)

    def ready(self) -> Dict[str, Any]:
        """Readiness: send traffic here NOW — every model compiled,
        every queue below the shed watermark, not draining.  Returns a
        dict with ``ready`` plus the failing conditions (the HTTP probe
        body)."""
        with self._lock:
            models = dict(self._models)
        not_compiled = [n for n, sm in models.items()
                        if not sm.runtime.compiled]
        watermark = int(self.queue_max * READY_WATERMARK)
        congested = {n: sm.queue.depth() for n, sm in models.items()
                     if sm.queue.depth() >= watermark}
        breakers = {n: sm.breaker.state() for n, sm in models.items()
                    if sm.breaker.state() != "closed"}
        return {
            "ready": (not self._draining and not not_compiled
                      and not congested and bool(models)),
            "draining": self._draining,
            "models": sorted(models),
            "not_compiled": not_compiled,
            "congested": congested,
            "breakers_open": breakers,
            "queue_watermark": watermark,
        }

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            models = dict(self._models)
        out = {}
        for name, sm in models.items():
            # snapshot: a canary decision on the worker thread may null
            # sm.canary between a check and an attribute access
            canary = sm.canary
            out[name] = {
                "queue_depth": sm.queue.depth(),
                "inflight": sm.inflight,
                "completed": sm.completed,
                "failed": sm.failed,
                "breaker": sm.breaker.state(),
                "breaker_age_s": round(sm.breaker.state_age_s(), 3),
                "retry_after_hint_s": self._retry_after(sm),
                "ewma_batch_ms": round(sm.ewma_batch_s * 1e3, 3),
                "buckets": list(getattr(sm.runtime, "plan", ())),
                "compiled": sm.runtime.compiled,
                "device": str(getattr(sm.runtime, "device", "cpu")),
                "version": sm.runtime.version,
                "source": getattr(sm.runtime, "source", None),
                "canary_version": canary.version
                if canary is not None else None,
                "reload": dict(sm.reload_state),
                "reload_phase": "canary" if canary is not None
                else sm.reload_state.get("state", "idle"),
            }
            if getattr(sm, "is_generator", False):
                out[name]["kv"] = sm.runtime.kv.stats()
                out[name]["tokens_out"] = sm.runtime.engine.tokens_out
                out[name]["prefill_batches"] = \
                    sm.runtime.engine.prefill_batches
        return out

    # -- metrics feeds (all guarded: telemetry never fails serving) ----
    def _count_rejected(self, reason: str) -> None:
        try:
            from .. import diagnostics as _diag

            _diag.metrics.counter(
                "mxnet_serve_rejected_total",
                help="requests shed before admission or fast-failed",
                labels={"reason": reason}).inc()
        except Exception:
            pass

    def _version_of(self, model: str) -> Optional[int]:
        with self._lock:
            sm = self._models.get(model)
        return sm.runtime.version if sm is not None else None

    def _count_outcome(self, model: str, outcome: str,
                       version: Optional[int] = None) -> None:
        try:
            from .. import diagnostics as _diag

            _diag.metrics.counter(
                "mxnet_serve_requests_total",
                help="admitted requests by final outcome",
                labels={"model": model, "outcome": outcome,
                        "version": "v%d" % version if version
                        else "unknown"}).inc()
        except Exception:
            pass

    def _observe_latency(self, r: Request) -> None:
        try:
            from .. import diagnostics as _diag

            lat = r.latency_s()
            if lat is not None:
                _diag.metrics.histogram(
                    "mxnet_serve_latency_seconds",
                    help="admitted-request latency (enqueue to reply)",
                    labels={"model": r.model}).observe(lat)
        except Exception:
            pass

    def _observe_batch(self, sm: _ServedModel, live: List[Request],
                       total: int, batch_s: float,
                       version: Optional[int] = None) -> None:
        try:
            from .. import diagnostics as _diag

            name = sm.runtime.name
            bucket = sm.runtime.bucket_for(total) \
                if hasattr(sm.runtime, "bucket_for") else total
            _diag.metrics.counter(
                "mxnet_serve_batches_total",
                help="dispatched batches",
                labels={"model": name,
                        "version": "v%d" % version if version
                        else "unknown"}).inc()
            _diag.metrics.histogram(
                "mxnet_serve_batch_size",
                help="samples per dispatched batch",
                labels={"model": name},
                buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256)).observe(total)
            _diag.metrics.counter(
                "mxnet_serve_padded_samples_total",
                help="bucket padding waste (samples)",
                labels={"model": name}).inc(max(bucket - total, 0))
            _diag.metrics.histogram(
                "mxnet_serve_batch_seconds",
                help="executor wall time per batch",
                labels={"model": name}).observe(batch_s)
            _diag.metrics.maybe_flush()
        except Exception:
            pass

    def _gauge_depth(self, sm: _ServedModel) -> None:
        try:
            from .. import diagnostics as _diag

            _diag.metrics.gauge(
                "mxnet_serve_queue_depth",
                help="admitted requests waiting to be batched",
                labels={"model": sm.runtime.name}).set(sm.queue.depth())
        except Exception:
            pass

    def _gauge_inflight(self, sm: _ServedModel) -> None:
        try:
            from .. import diagnostics as _diag

            _diag.metrics.gauge(
                "mxnet_serve_inflight_samples",
                help="samples dispatched, not yet answered",
                labels={"model": sm.runtime.name}).set(sm.inflight)
        except Exception:
            pass

    def _gauge_breaker(self, sm: _ServedModel) -> None:
        try:
            from .. import diagnostics as _diag

            _diag.metrics.gauge(
                "mxnet_serve_breaker_open",
                help="1 while the model's circuit breaker is open",
                labels={"model": sm.runtime.name}).set(
                    0 if sm.breaker.state() == "closed" else 1)
        except Exception:
            pass
