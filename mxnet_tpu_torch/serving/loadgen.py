"""Load generator: open-loop offered load against an in-process
:class:`ModelServer`, with the outcome accounting the overload tests
and the serving smoke assert on.

Counterpart: ``mxnet_tpu/serving/loadgen.py`` (a copy: the same pacing,
the same seeded request sizes and prompts, the same report keys).

Open-loop matters: a closed-loop client slows down when the server
slows down, which HIDES overload — the whole point here is to offer
MORE than capacity and prove the server sheds the excess while keeping
admitted p99 bounded.  The pacer fires submits on schedule regardless
of outcomes; every Request future is collected at the end.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from .errors import Rejected

__all__ = ["run_load", "qps_at_slo", "run_generation_load",
           "gen_tokens_at_slo", "BackgroundLoad"]


def _pct(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


def run_load(server, model: str, *, qps: float, duration_s: float,
             deadline_ms: Any = "default", batch_n: int = 1,
             data_fn=None) -> Dict[str, Any]:
    """Offer ``qps`` requests/s (each ``batch_n`` samples) for
    ``duration_s``; returns the accounting dict: offered/admitted/ok/
    shed-by-reason/expired/errors + admitted-latency p50/p99/max (ms)
    and achieved throughput."""
    import numpy as np

    sm_shape = None
    with server._lock:
        rt = server._models[model].runtime
        sm_shape = tuple(rt.sample_shape)
    if data_fn is None:
        fixed = np.zeros((batch_n,) + sm_shape, dtype="float32")

        def data_fn(i):
            return fixed

    interval = 1.0 / max(float(qps), 1e-6)
    n_total = max(int(qps * duration_s), 1)
    admitted: List[Any] = []
    shed: Dict[str, int] = {}
    t0 = time.monotonic()
    for i in range(n_total):
        target = t0 + i * interval
        now = time.monotonic()
        if target > now:
            time.sleep(target - now)
        try:
            admitted.append(server.submit(model, data_fn(i),
                                          deadline_ms=deadline_ms))
        except Rejected as e:
            shed[e.reason] = shed.get(e.reason, 0) + 1
    offered_s = time.monotonic() - t0

    # collect: every admitted request resolves (ok / expired / error) —
    # drain-under-load asserts zero futures are left hanging
    grace = max((server.default_deadline_s
                 if deadline_ms == "default" else
                 (deadline_ms or 0) / 1e3), 0.1) + 5.0
    deadline = time.monotonic() + grace
    lat_ms: List[float] = []
    n_ok = n_expired = n_error = n_hung = n_rejected_after = 0
    for r in admitted:
        r._event.wait(max(deadline - time.monotonic(), 0.0))
        if not r.done():
            n_hung += 1
        elif r.error is None:
            n_ok += 1
            lat_ms.append(r.latency_s() * 1e3)
        elif isinstance(r.error, Rejected):
            # admitted, then fast-failed (breaker flush) — NOT an
            # admission shed: offered == admitted + shed must hold
            n_rejected_after += 1
        elif "Deadline" in type(r.error).__name__:
            n_expired += 1
        else:
            n_error += 1
    lat_ms.sort()
    return {
        "model": model, "offered_qps": round(qps, 1),
        "batch_n": batch_n, "duration_s": round(offered_s, 3),
        "offered": n_total, "admitted": len(admitted),
        "ok": n_ok, "expired": n_expired, "errors": n_error,
        "hung": n_hung, "rejected_after_admit": n_rejected_after,
        "shed": shed,
        "shed_total": sum(shed.values()),
        "achieved_qps": round(n_ok / max(offered_s, 1e-9), 1),
        "p50_ms": round(_pct(lat_ms, 0.50) or 0.0, 3),
        "p99_ms": round(_pct(lat_ms, 0.99) or 0.0, 3),
        "max_ms": round(lat_ms[-1], 3) if lat_ms else 0.0,
    }


def qps_at_slo(server, model: str, *, slo_p99_ms: float,
               start_qps: float = 50.0, max_qps: float = 5000.0,
               window_s: float = 1.5, deadline_ms: Any = "default",
               growth: float = 2.0) -> Dict[str, Any]:
    """The BENCH serving row: ramp offered load geometrically until
    admitted p99 breaks the SLO or >2%% of traffic is shed; report the
    last rate that held.  (Coarse by design — one compile-cached
    in-process server, a few seconds total.)"""
    best: Optional[Dict[str, Any]] = None
    qps = float(start_qps)
    steps: List[Dict[str, Any]] = []
    while qps <= max_qps:
        st = run_load(server, model, qps=qps, duration_s=window_s,
                      deadline_ms=deadline_ms)
        # admitted requests that expired or errored ARE SLO violations:
        # p99 over ok-only latencies would otherwise hide a rate where
        # the queue eats deadlines while survivors look fast
        st["met_slo"] = bool(
            st["ok"] and st["p99_ms"] <= slo_p99_ms
            and st["shed_total"] <= 0.02 * st["offered"]
            and not st["hung"] and not st["expired"]
            and not st["errors"] and not st["rejected_after_admit"])
        steps.append({k: st[k] for k in
                      ("offered_qps", "achieved_qps", "p50_ms", "p99_ms",
                       "shed_total", "met_slo")})
        if not st["met_slo"]:
            break
        best = st
        qps *= growth
    return {
        "slo_p99_ms": slo_p99_ms,
        "qps_at_slo": best["achieved_qps"] if best else 0.0,
        "p99_ms_at_slo": best["p99_ms"] if best else None,
        "p50_ms_at_slo": best["p50_ms"] if best else None,
        "ramp": steps,
    }


def run_generation_load(server, model: str, *, qps: float,
                        duration_s: float,
                        deadline_ms: Any = "default",
                        prompt_fn=None, max_new_fn=None,
                        seed: int = 0) -> Dict[str, Any]:
    """Open-loop generation load: offer ``qps`` generation requests/s
    with MIXED prompt/output lengths (the workload continuous batching
    exists for), collect every future, and report the generation SLO
    surface — TTFT p50/p99 (enqueue to first streamed token), TPOT
    p50/p99 (interval between consecutive streamed tokens), and
    aggregate tokens/s — alongside the run_load-style outcome ledger."""
    import numpy as np

    rt = None
    with server._lock:
        rt = server._models[model].runtime
    rng = np.random.RandomState(seed)
    if prompt_fn is None:
        def prompt_fn(i):
            n = int(rng.randint(1, rt.max_prompt + 1))
            return rng.randint(1, rt.cfg.vocab_size, size=n)
    if max_new_fn is None:
        def max_new_fn(i):
            return int(rng.randint(1, rt.max_new + 1))

    interval = 1.0 / max(float(qps), 1e-6)
    n_total = max(int(qps * duration_s), 1)
    admitted: List[Any] = []
    shed: Dict[str, int] = {}
    t0 = time.monotonic()
    for i in range(n_total):
        target = t0 + i * interval
        now = time.monotonic()
        if target > now:
            time.sleep(target - now)
        try:
            admitted.append(server.submit_generation(
                model, prompt_fn(i), max_new=max_new_fn(i),
                deadline_ms=deadline_ms))
        except Rejected as e:
            shed[e.reason] = shed.get(e.reason, 0) + 1
    offered_s = time.monotonic() - t0

    grace = max((server.default_deadline_s
                 if deadline_ms == "default" else
                 (deadline_ms or 0) / 1e3), 0.1) + 10.0
    deadline = time.monotonic() + grace
    ttft_ms: List[float] = []
    tpot_ms: List[float] = []
    n_ok = n_expired = n_error = n_hung = n_cancelled = 0
    n_rejected_after = 0
    tokens_out = 0
    first_enq = last_done = None
    for r in admitted:
        r._event.wait(max(deadline - time.monotonic(), 0.0))
        if not r.done():
            n_hung += 1
            continue
        tokens_out += len(r.tokens)
        if r.ttft_s() is not None:
            ttft_ms.append(r.ttft_s() * 1e3)
        tpot_ms.extend(d * 1e3 for d in r.tpot_s())
        if first_enq is None or r.enqueue_ts < first_enq:
            first_enq = r.enqueue_ts
        if last_done is None or (r.done_ts or 0) > last_done:
            last_done = r.done_ts
        if r.error is None:
            n_ok += 1
        elif isinstance(r.error, Rejected):
            n_rejected_after += 1
        elif "Cancelled" in type(r.error).__name__:
            n_cancelled += 1
        elif "Deadline" in type(r.error).__name__:
            n_expired += 1
        else:
            n_error += 1
    ttft_ms.sort()
    tpot_ms.sort()
    span_s = max((last_done or 0) - (first_enq or 0), 1e-9)
    # when the request recorder is live, the load report carries its
    # own tail autopsy: the window's slowest request with per-phase
    # attribution, so a failed SLO step points at dumpable evidence
    # instead of a bare percentile
    from . import reqtrace as _reqtrace

    trace_block = None
    if _reqtrace.recorder.enabled:
        slow = _reqtrace.top_slowest(3)
        if slow:
            trace_block = {
                "p99_attribution": _reqtrace.attribution_shares(slow),
                "slowest": _reqtrace.attribution(slow[0]),
            }
    out = {
        "model": model, "offered_qps": round(qps, 1),
        "duration_s": round(offered_s, 3),
        "offered": n_total, "admitted": len(admitted),
        "ok": n_ok, "expired": n_expired, "errors": n_error,
        "cancelled": n_cancelled, "hung": n_hung,
        "rejected_after_admit": n_rejected_after,
        "shed": shed, "shed_total": sum(shed.values()),
        "tokens_out": tokens_out,
        "tokens_per_s": round(tokens_out / span_s, 1),
        "ttft_p50_ms": round(_pct(ttft_ms, 0.50) or 0.0, 3),
        "ttft_p99_ms": round(_pct(ttft_ms, 0.99) or 0.0, 3),
        "tpot_p50_ms": round(_pct(tpot_ms, 0.50) or 0.0, 3),
        "tpot_p99_ms": round(_pct(tpot_ms, 0.99) or 0.0, 3),
    }
    if trace_block is not None:
        out["reqtrace"] = trace_block
    return out


def gen_tokens_at_slo(server, model: str, *, slo_p99_tpot_ms: float,
                      start_qps: float = 2.0, max_qps: float = 500.0,
                      window_s: float = 2.0,
                      deadline_ms: Any = "default",
                      growth: float = 2.0, seed: int = 0,
                      prompt_fn=None, max_new_fn=None
                      ) -> Dict[str, Any]:
    """The BENCH generation row: ramp offered generation load
    geometrically until p99 TPOT breaks the SLO (or outcomes degrade);
    report the tokens/s of the last rate that held, plus its TTFT
    percentiles.  The TPOT SLO is the right knee metric for decode:
    under continuous batching, overload shows up as stretched
    inter-token gaps before anything is shed."""
    best: Optional[Dict[str, Any]] = None
    qps = float(start_qps)
    steps: List[Dict[str, Any]] = []
    while qps <= max_qps:
        st = run_generation_load(
            server, model, qps=qps, duration_s=window_s,
            deadline_ms=deadline_ms, seed=seed,
            prompt_fn=prompt_fn, max_new_fn=max_new_fn)
        st["met_slo"] = bool(
            st["ok"] and st["tpot_p99_ms"] <= slo_p99_tpot_ms
            and st["shed_total"] <= 0.02 * st["offered"]
            and not st["hung"] and not st["expired"]
            and not st["errors"] and not st["rejected_after_admit"])
        steps.append({k: st[k] for k in
                      ("offered_qps", "tokens_per_s", "ttft_p50_ms",
                       "ttft_p99_ms", "tpot_p99_ms", "shed_total",
                       "met_slo")})
        if not st["met_slo"]:
            break
        best = st
        qps *= growth
    return {
        "slo_p99_tpot_ms": slo_p99_tpot_ms,
        "tokens_per_s_at_slo": best["tokens_per_s"] if best else 0.0,
        "tpot_p99_ms_at_slo": best["tpot_p99_ms"] if best else None,
        "ttft_p50_ms_at_slo": best["ttft_p50_ms"] if best else None,
        "ttft_p99_ms_at_slo": best["ttft_p99_ms"] if best else None,
        "reqtrace_at_slo": (best or {}).get("reqtrace"),
        "ramp": steps,
    }


class BackgroundLoad:
    """Drive run_load on a thread (the drain-under-load test needs the
    server drained WHILE offers are still arriving)."""

    def __init__(self, server, model: str, **kw):
        self._kw = dict(kw, model=model)
        self._server = server
        self.result: Optional[Dict[str, Any]] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mx-serve-loadgen")

    def _run(self) -> None:
        self.result = run_load(self._server, **self._kw)

    def start(self) -> "BackgroundLoad":
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None
             ) -> Optional[Dict[str, Any]]:
        self._thread.join(timeout)
        return self.result
