"""Env-driven fault injection for the port's serving tier and its
transformer training loop.

Counterpart: ``mxnet_tpu/chaos.py``, the serving and training-loop
subset: the same
``MXNET_CHAOS`` grammar (semicolon-separated rules, each
``kind:key=val,key=val``; every rule fires ``count`` times, default 1,
once its match conditions hold, skipping the first ``nth``-1 candidate
events), the same seeded, deterministic firing, and the same
``mxnet_chaos_injected_total{kind=...}`` counter.  Kinds the port
injects:

  * ``slow_request``      — sleep ``ms`` (default 50) at the predictor
    batcher's dispatch point.  Match keys: ``model``, ``nth``,
    ``count``, ``ms``.
  * ``fail_execute``      — a model runtime's ``execute()`` (or a
    generator's prefill/decode tick) raises.  Match keys: ``model``,
    ``nth``, ``count``.
  * ``bad_version``       — the new version brought up by
    ``ModelServer.reload`` fails at its canary dispatch.  Match keys:
    ``model``, ``version``, ``nth``, ``count``.
  * ``cancel_request``    — a generation engine marks an active
    sequence cancelled at its next tick (candidate events are engine
    tick x active sequence).  Match keys: ``model``, ``nth``,
    ``count``.
  * ``stall_decode_tick`` — sleep ``ms`` (default 50) inside a decode
    tick; the request recorder tags the stalled spans injected.
    Match keys: ``model``, ``nth``, ``count``, ``ms``.

  * ``delay_collective``  — sleep ``ms`` (default 200) before a
    transformer ``fit`` step (the op is ``transformer_step``).  Match
    keys: ``op``, ``step``, ``nth``, ``count``, ``ms``.
  * ``kill``              — ``TransformerTrainStep.fit`` exits the
    process with :data:`KILL_EXIT_CODE` after step ``step`` (1-based),
    mid-run, like a preemption that did not say goodbye.  Match keys:
    ``step``, ``rank``, ``nth``, ``count``.

  * ``slow_decode``       — sleep ``ms`` (default 100) in the matching
    decode-pool worker after it decodes a batch (``io_pipeline``): a
    seeded straggler the pool absorbs as degraded throughput, never a
    deadlock.  Match keys: ``worker``, ``nth``, ``count``, ``ms``.

  * ``drop_push``         — a parameter-server push (``_ps.Client``)
    loses its response (``mode=response``, the default: the server got
    it, the retry resends it and the server drops the duplicate) or its
    request (``mode=request``).  Match keys: ``rank``, ``key``, ``nth``,
    ``count``, ``mode``.

  * ``drop_sparse_pull``  — the same fault against a parameter-server
    ``row_sparse_pull`` (the ``pull_rows`` exchange): a read, so the
    retry reads again and the pulled values stay bitwise those of a
    clean run.  Match keys: ``rank``, ``key``, ``nth``, ``count``,
    ``mode``.

The other training-side kinds of the JAX package (nan_grad,
corrupt_shard, bitflip_param, ...) parse here too but nothing in the
port injects them yet (``bitflip_param`` waits for the SDC defense,
ROADMAP A11).
"""
from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Rule", "parse_spec", "rules", "enabled", "fault",
           "maybe_slow_request", "should_fail_execute",
           "should_cancel_request", "maybe_stall_decode_tick",
           "should_fail_version", "maybe_delay", "should_kill",
           "maybe_slow_decode",
           "KILL_EXIT_CODE", "injected_total", "reset"]

_log = logging.getLogger(__name__)

#: exit code of a ``kill`` injection (what SIGKILL gives a shell)
KILL_EXIT_CODE = 137

_INT_KEYS = ("rank", "nth", "count", "step", "version", "nbytes",
             "worker", "tick", "ckpt_step", "bit")
_FLOAT_KEYS = ("ms",)


class Rule:
    """One parsed fault rule + its firing state."""

    def __init__(self, kind: str, params: Dict[str, Any]):
        self.kind = kind
        self.params = params
        self.nth = int(params.get("nth", 1))
        self.count = int(params.get("count", 1))
        self.seen = 0    # matching candidate events observed
        self.fired = 0   # faults actually injected
        self._lock = threading.Lock()

    def matches(self, ctx: Dict[str, Any]) -> bool:
        """Every match key present in the rule must equal the context's
        value (string-compared for non-numeric keys like ``key``/``op``;
        a context that omits the key does not match)."""
        for k, want in self.params.items():
            if k in ("nth", "count", "ms", "mode", "nbytes", "param",
                     "bit"):
                continue  # selectors/parameters, not match conditions
            if k not in ctx:
                return False
            have = ctx[k]
            if isinstance(want, (int, float)):
                try:
                    if int(have) != int(want):
                        return False
                except (TypeError, ValueError):
                    return False
            elif str(have) != str(want):
                return False
        return True

    def try_fire(self, ctx: Dict[str, Any]) -> bool:
        """Candidate event -> does this rule inject now?  (nth-windowed,
        count-limited, thread-safe.)"""
        if not self.matches(ctx):
            return False
        with self._lock:
            self.seen += 1
            if self.seen < self.nth or self.fired >= self.count:
                return False
            self.fired += 1
            return True

    def describe(self) -> str:
        return "%s:%s" % (self.kind, ",".join(
            "%s=%s" % (k, v) for k, v in sorted(self.params.items())))


def parse_spec(spec: str) -> List[Rule]:
    out: List[Rule] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition(":")
        kind = kind.strip()
        params: Dict[str, Any] = {}
        for kv in rest.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            k, v = k.strip(), v.strip()
            if k in _INT_KEYS:
                params[k] = int(v)
            elif k in _FLOAT_KEYS:
                params[k] = float(v)
            else:
                params[k] = v
        out.append(Rule(kind, params))
    return out


_lock = threading.Lock()
_cached_spec: Optional[str] = None
_cached_rules: List[Rule] = []


def rules() -> List[Rule]:
    """Rules parsed from MXNET_CHAOS, cached per spec value (firing
    state lives on the Rule objects, so re-reads must not reparse while
    the spec is unchanged)."""
    global _cached_spec, _cached_rules
    from . import env as _env

    spec = _env.get_str("MXNET_CHAOS") or ""
    with _lock:
        if spec != _cached_spec:
            _cached_spec = spec
            _cached_rules = parse_spec(spec)
            if _cached_rules:
                _log.warning(
                    "CHAOS INJECTION ACTIVE: %s",
                    "; ".join(r.describe() for r in _cached_rules))
        return list(_cached_rules)


def reset() -> None:
    """Forget parsed rules + firing state (tests)."""
    global _cached_spec, _cached_rules
    with _lock:
        _cached_spec = None
        _cached_rules = []


def enabled() -> bool:
    """Hot-path guard (called per PS request / per recorded
    collective): when MXNET_CHAOS is unset this is one env lookup, no
    lock, no parse — production runs pay nothing for the harness."""
    from . import env as _env

    if not _env.get_str("MXNET_CHAOS"):
        return False
    return bool(rules())


def _default_rank(ctx: Dict[str, Any]) -> Dict[str, Any]:
    if "rank" not in ctx:
        try:
            # the profiler's rank: a dist store's scheduler-assigned
            # rank (set_rank) wins over the launcher env
            from . import profiler as _profiler

            ctx = dict(ctx, rank=_profiler._dist_info()[0])
        except Exception:
            pass
    return ctx


def _count_injection(kind: str) -> None:
    try:
        from . import diagnostics as _diag

        _diag.metrics.counter(
            "mxnet_chaos_injected_total",
            help="faults injected by the chaos harness",
            labels={"kind": kind}).inc()
    except Exception:
        pass


def fault(kind: str, **ctx) -> Optional[Rule]:
    """The injection points' one question: should a ``kind`` fault fire
    for this event?  Returns the firing rule (params carry ``ms``/
    ``mode``/... for the caller to act on) or None.  ``rank`` defaults
    to this process's rank.  Never raises — a broken chaos spec must
    not take down a healthy run."""
    try:
        rs = rules()
        if not rs:
            return None
        ctx = _default_rank(ctx)
        for r in rs:
            if r.kind == kind and r.try_fire(ctx):
                # first firing per rule is loud; the rest (a serving
                # rule can fire thousands of times a second) are debug
                log = _log.warning if r.fired == 1 else _log.debug
                log("chaos: injecting %s (%s) at %s",
                    kind, r.describe(), ctx)
                _count_injection(kind)
                return r
        return None
    except Exception:
        return None


def maybe_delay(op: str, **ctx) -> Optional[dict]:
    """delay_collective hook (the transformer fit loop, before each
    step): sleep ms when a rule fires.  Returns ``{"kind", "ms"}`` when
    it fired (None otherwise)."""
    r = fault("delay_collective", op=op, **ctx)
    if r is None:
        return None
    ms = float(r.params.get("ms", 200.0))
    time.sleep(ms / 1e3)
    return {"kind": "delay_collective", "ms": ms}


def should_kill(step: int, **ctx) -> None:
    """kill hook (fit's step loop): exits the process with
    :data:`KILL_EXIT_CODE` when a rule fires — mid-step, like a real
    preemption that didn't say goodbye."""
    r = fault("kill", step=step, **ctx)
    if r is not None:
        _log.warning("chaos: killing this worker at step %d (exit %d)",
                     step, KILL_EXIT_CODE)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(KILL_EXIT_CODE)


def maybe_slow_request(model: str, **ctx) -> Optional[dict]:
    """slow_request hook (serving batcher dispatch): sleep ms when a
    rule fires — the seeded straggler executor the overload e2e test
    drives load against.  Returns ``{"kind", "ms"}`` when it fired
    (None otherwise) so the dispatcher can tag the batch's reqtrace
    spans ``injected=true`` — same contract as maybe_delay."""
    r = fault("slow_request", model=model, **ctx)
    if r is None:
        return None
    ms = float(r.params.get("ms", 50.0))
    time.sleep(ms / 1e3)
    return {"kind": "slow_request", "ms": ms}


def maybe_stall_decode_tick(model: str, **ctx) -> Optional[dict]:
    """stall_decode_tick hook (generation engine, once per decode
    tick, BEFORE the compiled decode step): sleep ms when a rule
    matches the model — a seeded tick-wide stall that every rider of
    the tick absorbs.  Returns ``{"kind", "ms"}`` when it fired so
    the engine tags the stalled reqtrace spans ``injected=true``
    (the tail autopsy must report it as chaos, never organic)."""
    r = fault("stall_decode_tick", model=model, **ctx)
    if r is None:
        return None
    ms = float(r.params.get("ms", 50.0))
    time.sleep(ms / 1e3)
    return {"kind": "stall_decode_tick", "ms": ms}


def maybe_slow_decode(worker: int, **ctx) -> Optional[dict]:
    """slow_decode hook (an io_pipeline decode worker, after it decoded
    one batch): sleep ms when a rule matches this worker.  Runs inside
    the worker process (rules parsed there from the inherited
    MXNET_CHAOS).  Returns ``{"kind", "ms"}`` when it fired."""
    r = fault("slow_decode", worker=worker, **ctx)
    if r is None:
        return None
    ms = float(r.params.get("ms", 100.0))
    time.sleep(ms / 1e3)
    return {"kind": "slow_decode", "ms": ms}


def should_fail_execute(model: str, **ctx) -> bool:
    """fail_execute hook (serving model runtime): True when the matching
    model's execute() should raise — what must trip the circuit
    breaker after MXNET_SERVE_BREAKER_N consecutive hits."""
    return fault("fail_execute", model=model, **ctx) is not None


def should_cancel_request(model: str, **ctx) -> bool:
    """cancel_request hook (generation engine, per tick × active
    sequence): True when the matching model's sequence should be
    treated as a mid-stream client disconnect — its slot and cache
    blocks must be reclaimed on this tick, co-riders untouched."""
    return fault("cancel_request", model=model, **ctx) is not None


def should_fail_version(model: str, version: int, **ctx) -> bool:
    """bad_version hook (ModelServer canary dispatch): True when the
    matching model's NEW version must fail its canary batch — what
    drives the auto-rollback (the batch re-executes on the stable
    version, so callers never see the failure)."""
    return fault("bad_version", model=model, version=version,
                 **ctx) is not None


def injected_total(kind: Optional[str] = None) -> int:
    """Faults injected so far (per kind, or all kinds)."""
    total = 0
    for r in rules():
        if kind is None or r.kind == kind:
            total += r.fired
    return total


# ---------------------------------------------------------------------------
# CLI: python -m mxnet_tpu.chaos --self-test
# ---------------------------------------------------------------------------
