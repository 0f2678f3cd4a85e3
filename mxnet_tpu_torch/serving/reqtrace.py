"""Per-request serving traces: every request's lifecycle as
monotonic-clock spans in a ring.

Counterpart: ``mxnet_tpu/serving/reqtrace.py`` (a copy: the same ring,
spans, top-K slowest, exemplars, slot timeline, attribution strings,
snapshot and dump format, so ``tools/merge_traces.py --health`` reads
either package's ``reqtrace_rank{K}.json``).  The dump rides the
port's ``diagnostics`` dump hooks (SIGUSR1/SIGTERM).

Recorded per request: admit/reject with reason, queue residency, batch
formation (bucket + co-riders), prefill, decode-tick slot residency,
KV-block allocation/eviction, canary routing, streaming flush,
cancellation (499), completion/expiry — into a preallocated ring
(``MXNET_SERVE_REQTRACE_SIZE``, default 256; 0 disables, and the
disabled path allocates nothing per token).  On top of the ring:

  * **tail-latency autopsy** — the top-K (``MXNET_SERVE_REQTRACE_
    TOPK``) slowest completed requests per sliding window
    (``MXNET_SERVE_REQTRACE_WINDOW_S``), each with per-phase
    attribution ("request r7: 2ms queue, 180ms stall:cache_exhausted,
    3 evictions") and chaos-injected spans tagged ``injected=true``;
  * **continuous-batching slot timeline** — one trace-event lane per
    generation slot (spans = sequence occupancy);
  * **exemplars** — the request id of the worst latency/TPOT sample
    per window, in ``/stats`` and as ``# exemplar`` comment lines in
    the prom exposition.

Every recording entry point is never-raise and begins with one
``enabled`` check.  All durations use ``time.monotonic()``; the only
wall-clock read is the dump timestamp.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "RequestTraceRecorder", "recorder", "enabled", "begin", "phase",
    "event", "cache_wait", "tick", "slot_acquire", "slot_release",
    "reject", "finish", "set_slots", "attribution", "dominant_phase",
    "top_slowest", "snapshot", "dump", "dump_path", "exemplars",
    "exemplar_prom_lines", "stats_summary", "attribution_shares",
    "parse_traceparent", "make_traceparent", "reset",
    "REQTRACE_FORMAT",
]

#: payload self-identification marker — merge_traces.py classifies
#: reqtrace dumps by this before its unknown->chrome-trace fallback
REQTRACE_FORMAT = "mxnet-tpu-reqtrace"

DEFAULT_RING_SIZE = 256
#: spans kept verbatim per request; later spans fold into the phase
#: totals only (the attribution never loses time, just span detail)
MAX_SPANS_PER_REQUEST = 64
#: recent queue-wait samples kept per model for the --health p99
MAX_QUEUE_SAMPLES = 512

_TERMINAL_OUTCOMES = ("ok", "error", "expired", "cancelled", "rejected")


# ---------------------------------------------------------------------------
# W3C traceparent (https://www.w3.org/TR/trace-context/): the http
# front-end accepts one, derives the request id from its trace-id, and
# echoes a traceparent carrying the same trace-id back.
# ---------------------------------------------------------------------------
def parse_traceparent(header: Optional[str]) -> Optional[str]:
    """The trace-id of a well-formed ``traceparent`` header (None for
    absent/malformed — a bad header must not reject the request)."""
    if not header:
        return None
    parts = str(header).strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32:
        return None
    return trace_id.lower()


def make_traceparent(trace_id: Optional[str] = None) -> Tuple[str, str]:
    """``(header, trace_id)`` — a fresh span-id under the given (or a
    fresh) trace-id, sampled flag set."""
    if not trace_id:
        trace_id = os.urandom(16).hex()
    return "00-%s-%s-01" % (trace_id, os.urandom(8).hex()), trace_id


def _knob_int(name: str, default: int) -> int:
    try:
        from .. import env as _envmod

        v = _envmod.get_int(name)
        return default if v is None else int(v)
    except Exception:
        return default


def _knob_float(name: str, default: float) -> float:
    try:
        from .. import env as _envmod

        v = _envmod.get_float(name)
        return default if v is None else float(v)
    except Exception:
        return default


class RequestTraceRecorder:
    """Ring-buffered per-request lifecycle recorder (one per process;
    tests build private instances).  All public methods are safe to
    call from any serving thread and never raise."""

    def __init__(self, capacity: Optional[int] = None,
                 topk: Optional[int] = None,
                 window_s: Optional[float] = None):
        if capacity is None:
            capacity = _knob_int("MXNET_SERVE_REQTRACE_SIZE",
                                 DEFAULT_RING_SIZE)
        self.capacity = max(int(capacity), 0)
        self.topk = max(int(topk if topk is not None else
                            _knob_int("MXNET_SERVE_REQTRACE_TOPK", 8)), 1)
        self.window_s = float(
            window_s if window_s is not None else
            _knob_float("MXNET_SERVE_REQTRACE_WINDOW_S", 60.0))
        # reentrant: a dump hook may fire (signal) while a recording
        # call holds the lock on the main thread
        self._lock = threading.RLock()
        self._open: Dict[str, dict] = {}           # id -> live record
        self._ring: deque = deque(maxlen=max(self.capacity, 1))
        self._slowest: List[dict] = []             # window top-K pool
        self._slot_spans: deque = deque(maxlen=max(self.capacity, 1))
        self._open_slots: Dict[Tuple[str, int], Tuple[str, float]] = {}
        self._models: Dict[str, dict] = {}
        self._exemplars: Dict[str, dict] = {}      # model -> worst/window
        self._n_begun = 0
        self._n_finished = 0
        self._n_dropped_spans = 0
        self._last_deadline_dump = float("-inf")
        self._hook_registered = False

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    # -- internals ----------------------------------------------------
    def _model(self, model: str) -> dict:
        m = self._models.get(model)
        if m is None:
            m = {"completed": 0, "rejected": 0, "died_waiting": 0,
                 "died_executing": 0, "cancelled": 0,
                 "queue_wait_s": deque(maxlen=MAX_QUEUE_SAMPLES),
                 "slots": 0, "slot_busy_s": 0.0,
                 "first_activity": None, "last_activity": None}
            self._models[model] = m
        return m

    def _touch(self, m: dict, now: float) -> None:
        if m["first_activity"] is None:
            m["first_activity"] = now
        m["last_activity"] = now

    def _close_wait(self, rec: dict, now: float) -> None:
        t0 = rec.pop("_wait_t0", None)
        if t0 is not None:
            dur = max(now - t0, 0.0)
            p = rec["phases"]
            p["stall:cache_exhausted"] = \
                p.get("stall:cache_exhausted", 0.0) + dur
            self._span(rec, "stall:cache_exhausted", t0, dur)

    def _span(self, rec: dict, phase: str, start: float, dur: float,
              injected: bool = False, meta: Optional[dict] = None
              ) -> None:
        if len(rec["spans"]) < MAX_SPANS_PER_REQUEST:
            s = {"phase": phase, "t": round(start - rec["t0"], 6),
                 "dur_s": round(dur, 6)}
            if injected:
                s["injected"] = True
            if meta:
                s["meta"] = meta
            rec["spans"].append(s)
        else:
            rec["spans_dropped"] += 1
            self._n_dropped_spans += 1

    # -- lifecycle ----------------------------------------------------
    def begin(self, req_id: str, model: str,
              trace_id: Optional[str] = None, kind: str = "request"
              ) -> None:
        if not self.enabled:
            return
        try:
            now = time.monotonic()
            with self._lock:
                if req_id in self._open:
                    return
                rec = {"id": str(req_id), "model": str(model),
                       "kind": kind, "t0": now, "phases": {},
                       "events": {}, "spans": [], "spans_dropped": 0,
                       "outcome": None, "injected_any": False}
                if trace_id:
                    rec["trace_id"] = trace_id
                self._open[str(req_id)] = rec
                self._n_begun += 1
                self._touch(self._model(str(model)), now)
            if not self._hook_registered:
                self._register_dump_hook()
        except Exception:
            pass

    def phase(self, req_id: str, name: str, dur_s: float,
              injected: bool = False, **meta) -> None:
        """Accumulate ``dur_s`` into the request's ``name`` phase (and
        keep the span verbatim while the per-request cap allows)."""
        if not self.enabled:
            return
        try:
            now = time.monotonic()
            with self._lock:
                rec = self._open.get(str(req_id))
                if rec is None:
                    return
                if name in ("prefill", "decode"):
                    self._close_wait(rec, now - max(dur_s, 0.0))
                p = rec["phases"]
                p[name] = p.get(name, 0.0) + max(float(dur_s), 0.0)
                if injected:
                    rec["injected_any"] = True
                self._span(rec, name, now - max(dur_s, 0.0),
                           max(float(dur_s), 0.0), injected=injected,
                           meta=meta or None)
        except Exception:
            pass

    def event(self, req_id: str, name: str, n: int = 1, **meta) -> None:
        """Point event: bump the per-request counter by ``n``
        (evictions, stream flushes, batched decode-tick flushes...)
        and keep the newest meta."""
        if not self.enabled:
            return
        try:
            with self._lock:
                rec = self._open.get(str(req_id))
                if rec is None:
                    return
                ev = rec["events"]
                ev[name] = ev.get(name, 0) + int(n)
                if meta:
                    rec.setdefault("event_meta", {})[name] = meta
        except Exception:
            pass

    def cache_wait(self, req_id: str) -> None:
        """The request is admitted-blocked on CacheExhausted: start (or
        keep) its wait marker — closed into ``stall:cache_exhausted``
        at prefill/terminal time, so "180ms waiting on CacheExhausted"
        is a first-class phase."""
        if not self.enabled:
            return
        try:
            with self._lock:
                rec = self._open.get(str(req_id))
                if rec is None or rec.get("_wait_t0") is not None:
                    return
                rec["_wait_t0"] = time.monotonic()
                ev = rec["events"]
                ev["cache_exhausted"] = ev.get("cache_exhausted", 0) + 1
        except Exception:
            pass

    def tick(self, model: str, dur_s: float, riders,
             injected: Optional[dict] = None) -> None:
        """One decode tick: ``dur_s`` of slot residency for every
        rider.  Accumulates into each rider's ``decode`` phase (no
        per-token span allocation — the span cap is for the
        interesting spans); an ``injected`` chaos stall
        ({"kind", "ms"}) lands as its own tagged phase."""
        if not self.enabled:
            return
        try:
            dur = max(float(dur_s), 0.0)
            inj_s = 0.0
            inj_name = None
            now = 0.0
            if injected:
                inj_s = float(injected.get("ms", 0.0)) / 1e3
                inj_name = "stall:injected:%s" % injected.get(
                    "kind", "chaos")
                now = time.monotonic()
            with self._lock:
                for rid in riders:
                    rec = self._open.get(str(rid))
                    if rec is None:
                        continue
                    p = rec["phases"]
                    p["decode"] = p.get("decode", 0.0) + max(
                        dur - inj_s, 0.0)
                    ev = rec["events"]
                    ev["decode_ticks"] = ev.get("decode_ticks", 0) + 1
                    if inj_name:
                        p[inj_name] = p.get(inj_name, 0.0) + inj_s
                        rec["injected_any"] = True
                        self._span(rec, inj_name, now - dur, inj_s,
                                   injected=True)
        except Exception:
            pass

    def slot_acquire(self, model: str, slot: int, req_id: str) -> None:
        if not self.enabled:
            return
        try:
            with self._lock:
                self._open_slots[(str(model), int(slot))] = (
                    str(req_id), time.monotonic())
        except Exception:
            pass

    def slot_release(self, model: str, slot: int) -> None:
        if not self.enabled:
            return
        try:
            now = time.monotonic()
            with self._lock:
                held = self._open_slots.pop((str(model), int(slot)),
                                            None)
                if held is None:
                    return
                seq, t0 = held
                self._slot_spans.append(
                    {"model": str(model), "slot": int(slot),
                     "seq": seq, "t0": t0, "t1": now})
                m = self._model(str(model))
                m["slot_busy_s"] += max(now - t0, 0.0)
                self._touch(m, now)
        except Exception:
            pass

    def set_slots(self, model: str, n: int) -> None:
        """Declare the model's generation slot count (the denominator
        of the --health slot-utilization figure)."""
        if not self.enabled:
            return
        try:
            with self._lock:
                self._model(str(model))["slots"] = int(n)
        except Exception:
            pass

    def reject(self, req_id: Optional[str], model: str, reason: str
               ) -> None:
        """Admission rejection: a compact terminal record straight into
        the ring (there is no lifecycle to trace)."""
        if not self.enabled:
            return
        try:
            now = time.monotonic()
            with self._lock:
                # a request begun and then shed at offer() has an open
                # record: drop it, the compact reject entry replaces it
                if req_id is not None:
                    self._open.pop(str(req_id), None)
                m = self._model(str(model))
                m["rejected"] += 1
                self._touch(m, now)
                self._ring.append(
                    {"id": str(req_id) if req_id else "-",
                     "model": str(model),
                     "outcome": "rejected:%s" % reason,
                     "total_s": 0.0, "phases": {}, "events": {},
                     "done_mono": now})
        except Exception:
            pass

    def finish(self, req) -> None:
        """Terminal span — called from Request.set_result/set_error
        (the one choke point every predict/generate outcome passes
        through).  Classifies the outcome, folds the record into the
        ring + sliding-window top-K + per-model aggregates +
        exemplars, and rate-limit-dumps on a blown deadline."""
        if not self.enabled:
            return
        try:
            now = time.monotonic()
            rid = str(getattr(req, "id", ""))
            err = getattr(req, "error", None)
            outcome = "ok"
            if err is not None:
                ename = type(err).__name__
                outcome = {"DeadlineExceeded": "expired",
                           "Cancelled": "cancelled",
                           "Rejected": "rejected"}.get(ename, "error")
            deadline_dump = False
            with self._lock:
                rec = self._open.pop(rid, None)
                if rec is None:
                    return
                self._close_wait(rec, now)
                rec["outcome"] = outcome
                rec["total_s"] = max(now - rec["t0"], 0.0)
                rec["done_mono"] = now
                toks = getattr(req, "tokens", None)
                if isinstance(toks, list):
                    rec["kind"] = "generate"
                    rec["tokens_out"] = len(toks)
                    for attr in ("ttft_s", "tpot_s"):
                        try:
                            v = getattr(req, attr)()
                            if v is not None:
                                rec[attr] = round(float(v), 6)
                        except Exception:
                            pass
                rec.pop("_wait_t0", None)
                self._ring.append(rec)
                self._n_finished += 1
                m = self._model(rec["model"])
                self._touch(m, now)
                q = rec["phases"].get("queue")
                if q is not None:
                    m["queue_wait_s"].append(q)
                executed = any(
                    k in rec["phases"]
                    for k in ("execute", "prefill", "decode"))
                if outcome == "ok":
                    m["completed"] += 1
                elif outcome == "cancelled":
                    m["cancelled"] += 1
                elif outcome == "rejected":
                    m["rejected"] += 1
                elif executed:
                    m["died_executing"] += 1
                else:
                    m["died_waiting"] += 1
                if outcome in ("ok", "expired", "error"):
                    self._note_window(rec, now)
                    self._note_exemplar(rec, now)
                if outcome == "expired" and \
                        now - self._last_deadline_dump >= self.window_s:
                    self._last_deadline_dump = now
                    deadline_dump = True
            if deadline_dump:
                self.dump(reason="deadline")
        except Exception:
            pass

    # -- sliding-window top-K + exemplars ------------------------------
    def _note_window(self, rec: dict, now: float) -> None:
        pool = [r for r in self._slowest
                if now - r["done_mono"] <= self.window_s]
        pool.append(rec)
        pool.sort(key=lambda r: r["total_s"], reverse=True)
        self._slowest = pool[:max(self.topk, 1)]

    def _note_exemplar(self, rec: dict, now: float) -> None:
        ex = self._exemplars.setdefault(rec["model"], {})
        for key, value in (("latency_s", rec["total_s"]),
                           ("tpot_s", rec.get("tpot_s"))):
            if value is None:
                continue
            cur = ex.get(key)
            if cur is None or now - cur["ts"] > self.window_s or \
                    value > cur["value"]:
                ex[key] = {"request_id": rec["id"],
                           "value": round(float(value), 6), "ts": now}

    def top_slowest(self, k: Optional[int] = None) -> List[dict]:
        """The current window's slowest completed requests, slowest
        first (the autopsy work list)."""
        now = time.monotonic()
        with self._lock:
            pool = [dict(r) for r in self._slowest
                    if now - r["done_mono"] <= self.window_s]
        pool.sort(key=lambda r: r["total_s"], reverse=True)
        return pool[:k or self.topk]

    def exemplars(self) -> Dict[str, dict]:
        """{model: {latency_s|tpot_s: {request_id, value, ts_age_s}}}
        for the current window — what /stats and the prom comment
        lines surface."""
        now = time.monotonic()
        out: Dict[str, dict] = {}
        with self._lock:
            for model, ex in self._exemplars.items():
                kept = {}
                for key, cur in ex.items():
                    if now - cur["ts"] <= self.window_s:
                        kept[key] = {"request_id": cur["request_id"],
                                     "value": cur["value"],
                                     "age_s": round(now - cur["ts"], 3)}
                if kept:
                    out[model] = kept
        return out

    def exemplar_prom_lines(self) -> List[str]:
        """``# exemplar`` comment lines for the prom exposition —
        comments pass ``validate_prom_text`` untouched, and scrapers
        that don't understand them ignore them."""
        lines = []
        for model, ex in sorted(self.exemplars().items()):
            for key in sorted(ex):
                cur = ex[key]
                metric = ("mxnet_serve_latency_seconds"
                          if key == "latency_s"
                          else "mxnet_serve_gen_tpot_seconds")
                lines.append(
                    '# exemplar %s{model="%s"} request_id=%s value=%s'
                    % (metric, model, cur["request_id"], cur["value"]))
        return lines

    # -- reporting ----------------------------------------------------
    def model_summary(self) -> Dict[str, dict]:
        now = time.monotonic()
        out: Dict[str, dict] = {}
        with self._lock:
            for model, m in self._models.items():
                waits = sorted(m["queue_wait_s"])
                p99 = None
                if waits:
                    p99 = waits[min(int(0.99 * len(waits)),
                                    len(waits) - 1)]
                util = None
                if m["slots"] and m["first_activity"] is not None:
                    elapsed = max(
                        (m["last_activity"] or now)
                        - m["first_activity"], 1e-9)
                    util = min(m["slot_busy_s"]
                               / (m["slots"] * elapsed), 1.0)
                out[model] = {
                    "completed": m["completed"],
                    "rejected": m["rejected"],
                    "cancelled": m["cancelled"],
                    "died_waiting": m["died_waiting"],
                    "died_executing": m["died_executing"],
                    "queue_wait_p99_ms": None if p99 is None
                    else round(p99 * 1e3, 3),
                    "slot_utilization": None if util is None
                    else round(util, 4),
                    "slots": m["slots"] or None,
                }
        return out

    def slot_timeline(self) -> dict:
        """Chrome trace-event export: one lane per (model, slot), one
        ``X`` span per sequence occupancy — the shape merge_traces.py
        merges next to training lanes."""
        with self._lock:
            spans = [dict(s) for s in self._slot_spans]
            open_slots = {k: v for k, v in self._open_slots.items()}
            base = min([s["t0"] for s in spans]
                       + [t0 for _, t0 in open_slots.values()]
                       + [time.monotonic()])
        events: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": "serving"}}]
        tids = {}
        now = time.monotonic()
        for s in spans + [
                {"model": k[0], "slot": k[1], "seq": v[0],
                 "t0": v[1], "t1": now, "open": True}
                for k, v in open_slots.items()]:
            tid = tids.setdefault((s["model"], s["slot"]),
                                  len(tids) + 1)
            ev = {"ph": "X", "pid": 0, "tid": tid,
                  "name": "seq:%s" % s["seq"],
                  "cat": "serving_slot",
                  "ts": round((s["t0"] - base) * 1e6, 1),
                  "dur": round((s["t1"] - s["t0"]) * 1e6, 1),
                  "args": {"model": s["model"], "slot": s["slot"]}}
            if s.get("open"):
                ev["args"]["open"] = True
            events.append(ev)
        for (model, slot), tid in sorted(tids.items(),
                                         key=lambda kv: kv[1]):
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": tid,
                           "args": {"name": "%s/slot%d"
                                    % (model, slot)}})
        return {"traceEvents": events}

    def snapshot(self) -> dict:
        """The dump payload (self-identifying via REQTRACE_FORMAT)."""
        from .. import diagnostics as _diag

        rank, num_workers = _diag._rank_info()
        slow = self.top_slowest()
        with self._lock:
            recent = [dict(r) for r in self._ring]
            open_recs = [dict(r) for r in self._open.values()]
            header = {
                "format": REQTRACE_FORMAT,
                "rank": rank, "num_workers": num_workers,
                "capacity": self.capacity, "topk": self.topk,
                "window_s": self.window_s,
                "begun": self._n_begun, "finished": self._n_finished,
                "spans_dropped": self._n_dropped_spans,
                "pid": os.getpid(),
                # dump timestamps are the ONE sanctioned wall-clock
                # read in the serving tier (correlating artifacts
                # across processes needs an absolute epoch)
                "dump_ts": time.time(),
            }
        for r in open_recs:
            r.pop("_wait_t0", None)
            r["outcome"] = "open"
        return {
            "header": header,
            "slowest": [dict(r, attribution=attribution(r))
                        for r in slow],
            "recent": recent,
            "open": open_recs,
            "models": self.model_summary(),
            "exemplars": self.exemplars(),
            "slot_timeline": self.slot_timeline(),
        }

    def n_recorded(self) -> int:
        with self._lock:
            return self._n_begun + sum(
                1 for r in self._ring if str(
                    r.get("outcome", "")).startswith("rejected"))

    def dump_path(self, base: Optional[str] = None) -> str:
        """``reqtrace_rank{K}.json`` under MXNET_DUMP_DIR — rank
        suffix always present, same contract as the flight recorder."""
        from .. import diagnostics as _diag

        rank, _ = _diag._rank_info()
        root, ext = os.path.splitext(base or "reqtrace.json")
        return _diag._dump_dir_path(
            "%s_rank%d%s" % (root, rank, ext or ".json"))

    def dump(self, path: Optional[str] = None,
             reason: str = "on_demand") -> Optional[str]:
        """Persist the recorder to JSON; returns the path (None when
        disabled/empty).  Signal-handler and atexit safe."""
        if not self.enabled:
            return None
        try:
            if not self.n_recorded():
                # artifact hygiene (the flight-recorder contract): a
                # process that never served a request dumps nothing
                return None
            payload = self.snapshot()
            payload["header"]["reason"] = reason
            fname = path if path is not None else self.dump_path()
            with open(fname, "w") as f:
                json.dump(payload, f)
            return fname
        except Exception:
            return None

    def _register_dump_hook(self) -> None:
        """First-record arming: ride the diagnostics SIGUSR1/SIGTERM
        dump path so a serving incident leaves its autopsy behind the
        same way a desync leaves flightrecorder_rank{K}.json."""
        self._hook_registered = True
        try:
            from .. import diagnostics as _diag

            _diag.register_dump_hook(
                lambda reason: recorder.dump(reason=reason),
                key="serving_reqtrace")
        except Exception:
            pass

    def clear(self) -> None:
        with self._lock:
            self._open.clear()
            self._ring.clear()
            self._slowest = []
            self._slot_spans.clear()
            self._open_slots.clear()
            self._models.clear()
            self._exemplars.clear()
            self._n_begun = 0
            self._n_finished = 0
            self._n_dropped_spans = 0
            self._last_deadline_dump = float("-inf")


# ---------------------------------------------------------------------------
# attribution helpers (pure functions over dumped/snapshotted records)
# ---------------------------------------------------------------------------
def attribution(record: dict) -> str:
    """One-line per-phase autopsy: "request r7: 2.0ms queue, 180.0ms
    stall:cache_exhausted, 3 evictions" — injected phases flagged."""
    try:
        total = float(record.get("total_s") or 0.0)
        phases = sorted((record.get("phases") or {}).items(),
                        key=lambda kv: kv[1], reverse=True)
        parts = []
        for name, dur in phases:
            share = (" (%d%%)" % round(100.0 * dur / total)) \
                if total > 0 else ""
            inj = " [injected]" if name.startswith("stall:injected") \
                else ""
            parts.append("%.1fms %s%s%s" % (dur * 1e3, name, share,
                                            inj))
        ev = record.get("events") or {}
        if ev.get("evicted"):
            parts.append("%d eviction(s)" % ev["evicted"])
        if ev.get("cache_exhausted"):
            parts.append("cache-exhausted x%d" % ev["cache_exhausted"])
        return "request %s [%s, %.1fms total]: %s" % (
            record.get("id"), record.get("outcome"), total * 1e3,
            ", ".join(parts) or "no recorded phases")
    except Exception:
        return "request %s: <unattributable>" % record.get("id")


def dominant_phase(record: dict) -> Tuple[Optional[str], float, bool]:
    """``(phase, share_of_total, injected)`` for the record's largest
    phase — what the E2E attribution pin asserts on."""
    phases = record.get("phases") or {}
    if not phases:
        return None, 0.0, False
    name = max(phases, key=lambda k: phases[k])
    total = float(record.get("total_s") or 0.0) or \
        sum(phases.values()) or 1.0
    return (name, phases[name] / total,
            name.startswith("stall:injected"))


def attribution_shares(records: Optional[List[dict]] = None
                       ) -> Dict[str, float]:
    """Aggregate phase shares over the window's slowest requests (the
    bench row's ``reqtrace.p99_attribution`` block): phase -> fraction
    of the summed wall time."""
    if records is None:
        records = top_slowest()
    totals: Dict[str, float] = {}
    for r in records:
        for name, dur in (r.get("phases") or {}).items():
            totals[name] = totals.get(name, 0.0) + float(dur)
    s = sum(totals.values())
    if s <= 0:
        return {}
    return {k: round(v / s, 4)
            for k, v in sorted(totals.items(),
                               key=lambda kv: kv[1], reverse=True)}


#: process-wide recorder (capacity from MXNET_SERVE_REQTRACE_SIZE)
recorder = RequestTraceRecorder()


def reset(capacity: Optional[int] = None, topk: Optional[int] = None,
          window_s: Optional[float] = None) -> "RequestTraceRecorder":
    """Rebuild the process-wide recorder (tests / env changes)."""
    global recorder
    recorder = RequestTraceRecorder(capacity=capacity, topk=topk,
                                    window_s=window_s)
    return recorder


def enabled() -> bool:
    return recorder.enabled


def begin(req_id: str, model: str, trace_id: Optional[str] = None,
          kind: str = "request") -> None:
    recorder.begin(req_id, model, trace_id=trace_id, kind=kind)


def phase(req_id: str, name: str, dur_s: float,
          injected: bool = False, **meta) -> None:
    recorder.phase(req_id, name, dur_s, injected=injected, **meta)


def event(req_id: str, name: str, n: int = 1, **meta) -> None:
    recorder.event(req_id, name, n=n, **meta)


def cache_wait(req_id: str) -> None:
    recorder.cache_wait(req_id)


def tick(model: str, dur_s: float, riders,
         injected: Optional[dict] = None) -> None:
    recorder.tick(model, dur_s, riders, injected=injected)


def slot_acquire(model: str, slot: int, req_id: str) -> None:
    recorder.slot_acquire(model, slot, req_id)


def slot_release(model: str, slot: int) -> None:
    recorder.slot_release(model, slot)


def set_slots(model: str, n: int) -> None:
    recorder.set_slots(model, n)


def reject(req_id: Optional[str], model: str, reason: str) -> None:
    recorder.reject(req_id, model, reason)


def finish(req) -> None:
    recorder.finish(req)


def top_slowest(k: Optional[int] = None) -> List[dict]:
    return recorder.top_slowest(k)


def snapshot() -> dict:
    return recorder.snapshot()


def dump(path: Optional[str] = None, reason: str = "on_demand"
         ) -> Optional[str]:
    return recorder.dump(path=path, reason=reason)


def dump_path(base: Optional[str] = None) -> str:
    return recorder.dump_path(base)


def exemplars() -> Dict[str, dict]:
    return recorder.exemplars()


def exemplar_prom_lines() -> List[str]:
    return recorder.exemplar_prom_lines()


def stats_summary() -> Dict[str, Any]:
    """The /stats ``reqtrace`` block: per-model aggregates + window
    exemplars + the slowest request's one-line autopsy."""
    if not recorder.enabled:
        return {"enabled": False}
    slow = recorder.top_slowest(1)
    return {
        "enabled": True,
        "capacity": recorder.capacity,
        "window_s": recorder.window_s,
        "models": recorder.model_summary(),
        "exemplars": recorder.exemplars(),
        "slowest": attribution(slow[0]) if slow else None,
    }
