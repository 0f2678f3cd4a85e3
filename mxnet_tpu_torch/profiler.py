"""mx.profiler — the runtime telemetry subsystem.

Counterpart: ``mxnet_tpu/profiler.py`` (ref: python/mxnet/profiler.py
set_config/set_state/dump_profile, src/engine/profiler.{h,cc}, the 1.x
aggregate-stats surface and the Counter/Marker/Domain object API).  The
events, their names and categories, the chrome ``traceEvents`` JSON,
``dumps()`` and ``summary()`` are the JAX package's, so a dashboard or
``tools/merge_traces.py`` reads a dump of either package.

Four layers:
  * **Python-side op events**: ``mx.nd`` invokes, executor
    forward/backward spans, kvstore comms, data-IO fetches and
    optimizer updates are stamped here.  CUDA launches return before
    the card finishes, so accurate per-op durations need a
    synchronisation after each op; ``set_config(profile_sync=True)``
    (the default) synchronises the current stream after every op while
    the profiler runs.  While it is stopped the per-op hook is one read
    of a module flag: no synchronisation, no allocation.
  * **Aggregate stats**: every span/counter also folds into per-name
    count/total/min/max accumulators; ``dumps()`` renders the
    reference-style table, ``summary()`` the machine-readable dict.
  * **Memory + comms counters**: ``set_config(profile_memory=True)``
    samples ``torch.cuda.memory_allocated`` / ``max_memory_allocated``
    on the card (on the CPU: the bytes of the live NDArrays' tensors,
    the peak tracked per session) into chrome ``ph:"C"`` counter
    tracks; kvstore and io stamp cumulative bytes-on-the-wire counters.
  * **Device traces**: ``set_config(profile_xla=True)`` (the reference's
    name, kept for API parity: here it means the device trace) starts
    and stops a torch.profiler (kineto) capture through
    ``traceview.capture`` next to the chrome trace.

Multi-worker runs: each rank dumps ``<base>_rank{K}.json`` with
``pid = rank`` (merge with ``tools/merge_traces.py``), and
``MXNET_PROFILER_AUTOSTART=1`` makes worker subprocesses self-start
tracing at import and dump at exit.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["set_config", "profiler_set_config", "set_state",
           "profiler_set_state", "dump", "dump_profile", "dumps",
           "summary", "pause", "resume", "is_running", "record_span",
           "record_counter", "record_marker", "record_bytes", "span",
           "Domain", "Counter", "Marker", "set_rank", "sample_memory"]

# an RLock: the stamping helpers call each other (record_bytes ->
# record_counter, record_span -> _tid) while holding it
_lock = threading.RLock()
_events: List[dict] = []
_state = "stop"
_paused = False
#: ``_state == "run" and not _paused``, kept in step under the lock:
#: the one read the per-op hook makes while the profiler is stopped
_active = False
_filename = "profile.json"
_sync = True
_xla = False
_xla_dir: Optional[str] = None
_memory = False
_t0 = None
# aggregate accumulators: (cat, name) -> [count, total, min, max]
# (span durations in us; counter/byte values in their own units)
_span_stats: Dict[Tuple[str, str], List[float]] = {}
_counter_stats: Dict[Tuple[str, str], List[float]] = {}
# cumulative byte tallies for record_bytes counters
_byte_totals: Dict[str, int] = {}
# python thread ident -> small sequential tid (+ name for metadata)
_tids: Dict[int, int] = {}
_tid_names: Dict[int, str] = {}
# explicit rank override (set by dist kvstore creation; env otherwise)
_rank_override: Optional[Tuple[int, int]] = None
# peak tracker for the live-NDArray memory fallback (CPU)
_mem_peak = 0


def _set_active() -> None:
    global _active
    _active = _state == "run" and not _paused


def is_running() -> bool:
    return _active


def profiling_state() -> Tuple[bool, bool]:
    """(running, sync) read under one lock acquisition — callers that
    stamp an op span need both decisions from the same config
    snapshot."""
    with _lock:
        return (_state == "run" and not _paused, _sync)


def sync_enabled() -> bool:
    with _lock:
        return _state == "run" and not _paused and _sync


def memory_enabled() -> bool:
    with _lock:
        return _state == "run" and not _paused and _memory


def set_config(profile_all=False, profile_symbolic=False,
               profile_imperative=False, profile_memory=False,
               profile_api=False, filename="profile.json",
               profile_sync=True, profile_xla=False, xla_trace_dir=None,
               aggregate_stats=True, **kwargs):
    """ref: profiler.py:27 set_config.  Symbolic and imperative events
    are both python-side and always stamped; the mode flags and
    ``aggregate_stats`` are accepted for API compatibility.

    ``profile_memory=True`` samples the allocator's bytes in use / peak
    into counter tracks around executor forward/backward.

    The device trace is opt-in: it starts only with ``profile_xla=True``,
    or with ``profile_all=True`` when an ``xla_trace_dir`` is also
    given."""
    global _filename, _sync, _xla, _xla_dir, _memory
    with _lock:
        _filename = filename
        _sync = bool(profile_sync)
        _memory = bool(profile_memory)
        _xla = bool(profile_xla or (profile_all and xla_trace_dir is not None))
        _xla_dir = xla_trace_dir


profiler_set_config = set_config  # legacy alias (ref: profiler.py:27)


def set_state(state="stop"):
    """'run' | 'stop' (ref: profiler.py:42 set_state)."""
    global _state, _t0, _mem_peak
    if state not in ("run", "stop"):
        raise ValueError("profiler state must be 'run' or 'stop', got %r"
                         % (state,))
    stopped_run = False
    with _lock:
        if state == "run" and _state != "run":
            _events.clear()
            _span_stats.clear()
            _counter_stats.clear()
            _byte_totals.clear()
            _mem_peak = 0
            _t0 = time.perf_counter_ns()
            if _xla:
                from .traceview import capture as _tvcap

                _tvcap.start_device_trace(
                    _xla_dir or os.path.splitext(_filename)[0] + "_xla")
        elif state == "stop" and _state == "run":
            if _xla:
                from .traceview import capture as _tvcap

                _tvcap.stop_device_trace()
            stopped_run = True
        _state = state
        _set_active()
    if stopped_run:
        # the 1.x profiler persisted the trace on stop; only the
        # run->stop transition dumps, so a redundant stop never
        # clobbers a dumped trace with an empty one
        dump(finished=False)


profiler_set_state = set_state


def pause():
    """Suspend event collection without ending the session
    (ref: MXProfilePause)."""
    global _paused
    with _lock:
        _paused = True
        _set_active()


def resume():
    global _paused
    with _lock:
        _paused = False
        _set_active()


def set_rank(rank: Optional[int], num_workers: int = 1) -> None:
    """Pin this process's worker rank for trace dumps (the dist kvstore
    calls it once the scheduler assigns a rank).  The pin outlives the
    store: a process that was rank K keeps dumping rank-K traces; pass
    ``rank=None`` to clear it."""
    global _rank_override
    with _lock:
        _rank_override = None if rank is None else \
            (int(rank), int(num_workers))


def _dist_info() -> Tuple[int, int]:
    """(rank, num_workers): an explicit :func:`set_rank` wins, then the
    launcher env (DMLC_WORKER_ID), the process group once
    ``dist.initialize()`` ran, then MXNET_PROCESS_ID."""
    if _rank_override is not None:
        return _rank_override
    from . import diagnostics as _diag

    return _diag._rank_info()


def _now_us() -> float:
    return (time.perf_counter_ns() - (_t0 or time.perf_counter_ns())) / 1e3


def _tid() -> int:
    """Small sequential id for the calling thread (the chrome trace's
    tid lane); names are kept for dump-time thread_name metadata."""
    ident = threading.get_ident()
    tid = _tids.get(ident)
    if tid is None:
        with _lock:
            tid = _tids.setdefault(ident, len(_tids))
            _tid_names.setdefault(tid, threading.current_thread().name)
    return tid


def register_tid_name(tid: int, name: str) -> None:
    """Claim a trace lane for an external actor (a decode-pool worker
    process stamping through the parent, io_pipeline.py).  Callers pick
    tids >= io_pipeline.IO_WORKER_TID_BASE so the sequential thread ids
    never collide with them."""
    with _lock:
        _tid_names.setdefault(int(tid), str(name))


def _fold(stats: Dict[Tuple[str, str], List[float]], key: Tuple[str, str],
          value: float) -> None:
    st = stats.get(key)
    if st is None:
        stats[key] = [1, value, value, value]
    else:
        st[0] += 1
        st[1] += value
        if value < st[2]:
            st[2] = value
        if value > st[3]:
            st[3] = value


def record_span(name: str, start_us: float, dur_us: float,
                cat: str = "operator", tid: Optional[int] = None,
                args: Optional[dict] = None):
    """Stamp one complete ('ph':'X') event and fold it into the
    aggregate accumulators.  The state check happens under the same
    lock as the append."""
    with _lock:
        if _state != "run" or _paused:
            return
        ev = {"name": name, "cat": cat, "ph": "X", "ts": start_us,
              "dur": dur_us, "pid": 0,
              "tid": _tid() if tid is None else tid}
        if args:
            ev["args"] = dict(args)
        _events.append(ev)
        _fold(_span_stats, (cat, name), dur_us)


def record_counter(name: str, value, cat: str = "counter",
                   tid: Optional[int] = None):
    """Stamp a chrome counter sample ('ph':'C')."""
    with _lock:
        if _state != "run" or _paused:
            return
        _events.append({"name": name, "cat": cat, "ph": "C",
                        "ts": _now_us(), "pid": 0,
                        "tid": _tid() if tid is None else tid,
                        "args": {name: value}})
        _fold(_counter_stats, (cat, name), float(value))


def record_marker(name: str, cat: str = "marker", scope: str = "process"):
    """Stamp an instant event ('ph':'i'; ref: profiler.py Marker.mark).
    scope: 'global' | 'process' | 'thread'."""
    with _lock:
        if _state != "run" or _paused:
            return
        _events.append({"name": name, "cat": cat, "ph": "i",
                        "ts": _now_us(), "pid": 0, "tid": _tid(),
                        "s": {"global": "g", "process": "p",
                              "thread": "t"}.get(scope, "p")})


def record_bytes(name: str, nbytes: int, cat: str = "comms"):
    """Cumulative byte tally as a counter track — kvstore push/pull and
    io batch fetches report bytes-on-the-wire through this."""
    with _lock:
        if _state != "run" or _paused:
            return
        total = _byte_totals.get(name, 0) + int(nbytes)
        _byte_totals[name] = total
        record_counter(name, total, cat=cat)


# ---------------------------------------------------------------------------
# object API (ref: python/mxnet/profiler.py Domain/Counter/Marker)
# ---------------------------------------------------------------------------
class Domain:
    """Named grouping for Counter/Marker tracks; becomes the chrome
    'cat'."""

    def __init__(self, name: str):
        self.name = name

    def new_counter(self, name, value=None) -> "Counter":
        return Counter(self, name, value)

    def new_marker(self, name) -> "Marker":
        return Marker(self, name)

    def __str__(self):
        return self.name


def _domain_name(domain) -> str:
    if domain is None:
        return "counter"
    return domain.name if isinstance(domain, Domain) else str(domain)


class Counter:
    """Value-tracking counter stamping 'ph':'C' events on every
    change."""

    def __init__(self, domain=None, name: str = "counter", value=None):
        self._cat = _domain_name(domain)
        self._name = name
        self._value = 0
        if value is not None:
            self.set_value(value)

    def set_value(self, value):
        # stamp inside the same lock hold: two racing updates land in
        # the trace in value order (the lock is re-entrant)
        with _lock:
            self._value = value
            record_counter(self._name, value, cat=self._cat)

    def increment(self, delta=1):
        with _lock:
            self._value += delta
            record_counter(self._name, self._value, cat=self._cat)

    def decrement(self, delta=1):
        self.increment(-delta)

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.increment(-delta)
        return self

    @property
    def value(self):
        return self._value


class Marker:
    """Instant-event marker (ref: profiler.py Marker / mark())."""

    def __init__(self, domain=None, name: str = "marker"):
        self._cat = _domain_name(domain)
        self._name = name

    def mark(self, scope: str = "process"):
        record_marker(self._name, cat=self._cat, scope=scope)


class span:
    """Context manager stamping a span around a python-side region."""

    def __init__(self, name: str, cat: str = "operator",
                 args: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self.start = _now_us()
        return self

    def __exit__(self, *exc):
        record_span(self.name, self.start, _now_us() - self.start,
                    self.cat, args=self.args)
        return False


def sync_device(tensors) -> None:
    """Block until the current CUDA stream finished the work behind
    ``tensors`` (any of them on the card); host tensors need nothing."""
    import torch

    for t in tensors:
        t = getattr(t, "_data", t)
        if isinstance(t, torch.Tensor) and t.is_cuda:
            with torch.cuda.device(t.device):
                torch.cuda.current_stream().synchronize()
            return


# ---------------------------------------------------------------------------
# memory profiling (set_config(profile_memory=True))
# ---------------------------------------------------------------------------
def _live_ndarray_bytes() -> int:
    """Bytes of the distinct tensors the live NDArrays hold (the CPU
    fallback; the JAX package sums ``jax.live_arrays()`` the same
    way)."""
    import gc

    from .ndarray.ndarray import NDArray

    seen, total = set(), 0
    for obj in gc.get_objects():
        # type(), not isinstance: isinstance reads __class__, which
        # some lazily deprecated module attributes warn on
        if issubclass(type(obj), NDArray):
            t = obj._data
            try:
                key = t.untyped_storage().data_ptr()
            except RuntimeError:
                continue
            if key in seen:
                continue
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def _memory_bytes() -> Optional[Tuple[int, int]]:
    """(bytes_in_use, peak_bytes_in_use): the CUDA caching allocator's
    on the card; on the CPU the live NDArrays' bytes, the peak tracked
    per profiling session."""
    global _mem_peak
    import torch

    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return (int(torch.cuda.memory_allocated()),
                    int(torch.cuda.max_memory_allocated()))
        in_use = _live_ndarray_bytes()
        with _lock:
            _mem_peak = max(_mem_peak, in_use)
            peak = _mem_peak
        return in_use, peak
    except Exception:
        return None  # a telemetry sample must never fail the caller


def sample_memory():
    """Stamp the allocator's bytes-in-use / peak as counter events —
    called by the executor around forward/backward spans when
    profile_memory is enabled."""
    if not memory_enabled():
        return
    m = _memory_bytes()
    if m is None:
        return
    in_use, peak = m
    record_counter("memory:bytes_in_use", in_use, cat="memory")
    record_counter("memory:peak_bytes_in_use", peak, cat="memory")


# ---------------------------------------------------------------------------
# dumps
# ---------------------------------------------------------------------------
def _dump_name() -> str:
    """The file :func:`dump` writes: ``<base>_rank{K}<ext>`` in a
    multi-worker run, under MXNET_DUMP_DIR when relative."""
    rank, num_workers = _dist_info()
    fname = _filename
    if num_workers > 1:
        base, ext = os.path.splitext(fname)
        fname = "%s_rank%d%s" % (base, rank, ext or ".json")
    if not os.path.isabs(fname):
        from . import diagnostics as _diag

        fname = _diag._dump_dir_path(fname)
    return fname


def dump(finished=True):
    """Write the chrome://tracing JSON (ref: profiler.py:53
    dump_profile).  Multi-worker runs write ``<base>_rank{K}<ext>`` with
    every event's pid set to the rank."""
    rank, _ = _dist_info()
    with _lock:
        fname = _dump_name()
        events = [dict(e, pid=rank) for e in _events]
        meta = [{"name": "process_name", "ph": "M", "pid": rank, "tid": 0,
                 "args": {"name": "rank %d" % rank}}]
        meta += [{"name": "thread_name", "ph": "M", "pid": rank, "tid": t,
                  "args": {"name": n}} for t, n in sorted(_tid_names.items())]
        payload = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        with open(fname, "w") as f:
            json.dump(payload, f)
        if finished:
            _events.clear()
    return fname


dump_profile = dump


def summary(reset: bool = False) -> dict:
    """Machine-readable aggregate stats: ``{"spans": {cat: {name:
    {count,total_ms,min_ms,max_ms,avg_ms}}}, "counters": {cat: {name:
    {count,min,max,avg}}}, "phases": [...]}`` — the dict behind
    :func:`dumps`."""
    with _lock:
        spans = {k: list(v) for k, v in _span_stats.items()}
        counters = {k: list(v) for k, v in _counter_stats.items()}
        if reset:
            # aggregates only: _byte_totals is the live baseline of the
            # still-recording counter tracks
            _span_stats.clear()
            _counter_stats.clear()
    out: dict = {"spans": {}, "counters": {}}
    for (cat, name), (count, total, mn, mx) in spans.items():
        out["spans"].setdefault(cat, {})[name] = {
            "count": int(count), "total_ms": total / 1e3,
            "min_ms": mn / 1e3, "max_ms": mx / 1e3,
            "avg_ms": total / count / 1e3}
    for (cat, name), (count, total, mn, mx) in counters.items():
        out["counters"].setdefault(cat, {})[name] = {
            "count": int(count), "min": mn, "max": mx,
            "avg": total / count}
    out["phases"] = _phase_table(out["spans"])
    return out


def _phase_table(spans: dict) -> list:
    """Per-phase rows [{phase, total_s, pct_of_step, p50_s, p99_s,
    source}] — from traceview's measured device attribution when this
    process completed a capture, else plain span aggregation (one row
    per span category, host-side wall)."""
    from .traceview import capture as _tvcap

    tvs = _tvcap.last_summary()
    if tvs:
        rows = []
        for phase, v in (tvs.get("phases") or {}).items():
            rows.append({
                "phase": phase, "total_s": v.get("total_s"),
                "pct_of_step": v.get("pct_of_step"),
                "p50_s": v.get("p50_s"), "p99_s": v.get("p99_s"),
                "source": "trace"})
        rows.sort(key=lambda r: -(r["total_s"] or 0.0))
        return rows
    step_total = sum(s["total_ms"]
                     for s in (spans.get("step") or {}).values())
    rows = []
    for cat, names in spans.items():
        tot_ms = sum(s["total_ms"] for s in names.values())
        rows.append({
            "phase": cat, "total_s": tot_ms / 1e3,
            "pct_of_step": (tot_ms / step_total * 100.0)
            if step_total else None,
            "p50_s": None, "p99_s": None, "source": "spans"})
    rows.sort(key=lambda r: -(r["total_s"] or 0.0))
    return rows


def dumps(reset: bool = False) -> str:
    """Aggregate per-op stats table (ref: profiler.py dumps; format per
    src/profiler/aggregate_stats.cc DumpTable)."""
    stats = summary(reset=reset)
    lines = ["Profile Statistics.",
             "\tNote that counter items are counter values "
             "and not time units."]
    hdr = ("%-40s %12s %16s %16s %16s %16s"
           % ("Name", "Total Count", "Time (ms)", "Min Time (ms)",
              "Max Time (ms)", "Avg Time (ms)"))
    rule = ("%-40s %12s %16s %16s %16s %16s"
            % ("----", "-----------", "---------", "-------------",
               "-------------", "-------------"))
    for cat in sorted(stats["spans"]):
        lines += ["", cat, "=" * 17, hdr, rule]
        for name in sorted(stats["spans"][cat]):
            s = stats["spans"][cat][name]
            lines.append("%-40s %12d %16.4f %16.4f %16.4f %16.4f"
                         % (name[:40], s["count"], s["total_ms"],
                            s["min_ms"], s["max_ms"], s["avg_ms"]))
    chdr = ("%-40s %12s %16s %16s %16s"
            % ("Name", "Total Count", "Min Value", "Max Value",
               "Avg Value"))
    crule = ("%-40s %12s %16s %16s %16s"
             % ("----", "-----------", "---------", "---------",
                "---------"))
    for cat in sorted(stats["counters"]):
        lines += ["", cat + " (counters)", "=" * 17, chdr, crule]
        for name in sorted(stats["counters"][cat]):
            s = stats["counters"][cat][name]
            lines.append("%-40s %12d %16.1f %16.1f %16.1f"
                         % (name[:40], s["count"], s["min"], s["max"],
                            s["avg"]))
    return "\n".join(lines) + "\n"


def _shutdown():
    """The atexit hook: a session still running at exit persists its
    trace (the run->stop transition dumps)."""
    try:
        if _state == "run":
            set_state("stop")
    except Exception:
        pass  # e.g. the configured dump dir is already gone at exit


atexit.register(_shutdown)


def _autostart():
    """MXNET_PROFILER_AUTOSTART: worker subprocesses self-start tracing
    at import and persist their rank trace at exit (the autostart
    contract is an import-time read, as in the JAX package)."""
    from . import env as _env

    if not _env.get_bool("MXNET_PROFILER_AUTOSTART"):
        return
    set_config(profile_all=True,
               filename=_env.get_str("MXNET_PROFILER_FILENAME"))
    set_state("run")


_autostart()
