"""The replayable per-bucket timing model the cap search reads.

Counterpart: ``mxnet_tpu/autotune/timing.py``, the same loaders over the
same payloads, so one payload gives one model in both packages.  The
evidence:

  * a traceview summary (``traceview_summary_rank{K}.json``, format
    ``mxnet-tpu-traceview-summary`` v1, which the port's
    ``traceview.capture`` writes from a torch.profiler trace):
    :func:`from_trace` — the only input whose bandwidth and step time
    are both device measurements of one capture;
  * the JAX package's flight-recorder dumps and ``merge_traces
    --bucket-timings`` exports (:func:`from_flight_dump`,
    :func:`from_bucket_timings`; the port has no flight recorder of its
    own yet, ROADMAP A11b);
  * a SCALING report (:func:`from_scaling_json`) or a model's raw
    gradient leaves (:func:`from_leaf_bytes`, e.g.
    ``parallel.scaling.resnet50_grad_leaf_bytes``).

``units`` are the reduction payloads in issue order (bucket 0, the
deepest layers, first): per-gradient leaves (``granularity='leaf'``,
repartitioned exactly through ``buckets.partition``) or recorded bucket
sums (``'bucket'``, repartitioned virtually).  ``step_time_s`` is the
measured one-device step; ``measured_GBps`` the link bandwidth derived
from entries with real durations (issue stamps of in-graph reductions
are excluded).  What cannot be extracted stays None: ``search.tune``
then needs it from the caller, and never assumes a figure.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "TimingModel", "from_flight_dump", "from_bucket_timings",
    "from_scaling_json", "from_leaf_bytes", "from_trace", "load_any",
]

#: durations shorter than this are issue-stamp overhead, not wire time
_MIN_WIRE_DURATION_S = 1e-4


class TimingModel:
    """Normalized replay input for the bucket-cap search."""

    def __init__(self, units: Sequence[Tuple[int, str]], granularity: str,
                 step_time_s: Optional[float] = None,
                 measured_GBps: Optional[float] = None,
                 recorded_cap_bytes: Optional[int] = None,
                 dtype: Optional[str] = None,
                 source: Optional[dict] = None):
        if granularity not in ("leaf", "bucket"):
            raise ValueError("granularity must be 'leaf' or 'bucket', "
                             "got %r" % (granularity,))
        self.units = [(int(b), str(dt)) for b, dt in units]
        if not self.units:
            raise ValueError("timing model has no reduction units "
                             "(nothing to tune)")
        self.granularity = granularity
        self.step_time_s = None if step_time_s is None \
            else float(step_time_s)
        self.measured_GBps = None if measured_GBps is None \
            else float(measured_GBps)
        self.recorded_cap_bytes = None if recorded_cap_bytes is None \
            else int(recorded_cap_bytes)
        self.dtype = dtype or (self.units[0][1] if self.units else None)
        self.source = dict(source or {})

    @property
    def total_bytes(self) -> int:
        return sum(b for b, _dt in self.units)

    @property
    def n_units(self) -> int:
        return len(self.units)

    def fingerprint(self) -> dict:
        """What a tuned plan records so buckets.plan_with_tuning can
        match it against the model being built."""
        return {"total_bytes": self.total_bytes, "n_units": self.n_units,
                "granularity": self.granularity, "dtype": self.dtype}

    def to_dict(self) -> dict:
        return {"units": [[b, dt] for b, dt in self.units],
                "granularity": self.granularity,
                "step_time_s": self.step_time_s,
                "measured_GBps": self.measured_GBps,
                "recorded_cap_bytes": self.recorded_cap_bytes,
                "dtype": self.dtype, "source": self.source}


def _median(vals: List[float]) -> Optional[float]:
    import statistics

    return statistics.median(vals) if vals else None


def _wire_bandwidth(rows: Sequence[dict]) -> Optional[float]:
    """Median effective GB/s over entries carrying REAL wire durations.
    ``rows`` are flight entries or --bucket-timings rows; in-graph
    issue stamps are excluded (see module docstring)."""
    rates = []
    for e in rows:
        if (e.get("args") or {}).get("in_graph") or e.get("in_graph"):
            continue
        enq, comp = e.get("enqueue_ts"), e.get("complete_ts")
        dur = e.get("duration_s")
        if dur is None and enq is not None and comp is not None:
            dur = float(comp) - float(enq)
        nbytes = int(e.get("bytes") or 0)
        if dur is None or dur < _MIN_WIRE_DURATION_S or nbytes <= 0:
            continue
        rates.append(nbytes / float(dur) / 1e9)
    return _median(rates)


def _units_from_plan(plan: Optional[dict]) -> Optional[List[Tuple[int, str]]]:
    """The header's stamped plan accounting (buckets.plan_meta) IS the
    recorded bucket stream, already in issue order."""
    rows = (plan or {}).get("buckets") or None
    if not rows:
        return None
    rows = sorted(rows, key=lambda r: int(r.get("bucket", 0)))
    return [(int(r["bytes"]), str(r.get("dtype") or "float32"))
            for r in rows]


def _units_from_entries(entries: Sequence[dict]
                        ) -> Optional[List[Tuple[int, str]]]:
    """Fallback when no plan header landed: first-seen bytes per bucket
    id over the recorded ``bucket_reduce`` stream."""
    seen: Dict[int, Tuple[int, str]] = {}
    for e in entries:
        if e.get("op") != "bucket_reduce" or e.get("bucket") is None:
            continue
        b = int(e["bucket"])
        if b not in seen:
            seen[b] = (int(e.get("bytes") or 0),
                       str(e.get("dtype") or "float32"))
    if not seen:
        return None
    return [seen[b] for b in sorted(seen)]


def from_flight_dump(payload: dict, path: Optional[str] = None,
                     step_time_s: Optional[float] = None) -> TimingModel:
    """Extract the timing model from one ``flightrecorder_rank{K}.json``
    dump (the JAX package's ``diagnostics.FlightRecorder.dump``
    payload)."""
    header = payload.get("header") or {}
    entries = payload.get("entries") or []
    plan = header.get("bucket_plan")
    units = _units_from_plan(plan) or _units_from_entries(entries)
    if units is None:
        raise ValueError(
            "flight dump%s has no bucket plan and no bucket_reduce "
            "entries — run the workload with bucketing enabled "
            "(MXNET_KVSTORE_BUCKET_BYTES != 0) so the recorder sees the "
            "reduction schedule" % (" %r" % path if path else ""))
    return TimingModel(
        units, "bucket", step_time_s=step_time_s,
        measured_GBps=_wire_bandwidth(entries),
        recorded_cap_bytes=(plan or {}).get("cap_bytes"),
        source={"kind": "flight", "path": path,
                "rank": header.get("rank"),
                "n_entries": len(entries)})


def from_bucket_timings(payload: dict, path: Optional[str] = None,
                        step_time_s: Optional[float] = None,
                        rank: Optional[int] = None) -> TimingModel:
    """Extract from a ``tools/merge_traces.py --bucket-timings`` export
    (the autotuner's offline multi-rank input).  ``rank`` picks one
    rank's stream; default is the rank with the most recorded rows
    (bandwidth is still derived from EVERY rank's real durations)."""
    ranks = payload.get("ranks") or {}
    if not ranks:
        raise ValueError("bucket-timings export has no ranks")
    all_rows = [r for info in ranks.values()
                for r in info.get("timings") or []]
    key = str(rank) if rank is not None else \
        max(ranks, key=lambda k: len(ranks[k].get("timings") or []))
    if key not in ranks:
        raise ValueError("rank %s not present in bucket-timings export "
                         "(have %s)" % (key, sorted(ranks)))
    info = ranks[key]
    units = _units_from_plan(info.get("bucket_plan")) or \
        _units_from_entries(info.get("timings") or [])
    if units is None:
        raise ValueError("rank %s carries no bucket plan or "
                         "bucket_reduce rows" % key)
    return TimingModel(
        units, "bucket", step_time_s=step_time_s,
        measured_GBps=_wire_bandwidth(all_rows),
        recorded_cap_bytes=(info.get("bucket_plan") or {}).get("cap_bytes"),
        source={"kind": "bucket-timings", "path": path, "rank": int(key),
                "n_ranks": len(ranks)})


def from_scaling_json(payload: dict, path: Optional[str] = None,
                      dtype: Optional[str] = None) -> TimingModel:
    """Extract from a SCALING_r* report: the
    ``projection_bucket_pipeline`` block carries both the measured
    bucket plan (``bucket_bytes``) and the benched step time."""
    block = payload.get("projection_bucket_pipeline") or {}
    if dtype is None:
        dtype = "bfloat16" if "bfloat16" in block else "float32"
    sub = block.get(dtype)
    if not isinstance(sub, dict) or not sub.get("bucket_bytes"):
        raise ValueError(
            "SCALING report%s has no projection_bucket_pipeline[%r] "
            "bucket_bytes block" % (" %r" % path if path else "", dtype))
    return TimingModel(
        [(int(b), dtype) for b in sub["bucket_bytes"]], "bucket",
        step_time_s=sub.get("step_time_s"),
        source={"kind": "scaling", "path": path, "dtype": dtype})


def from_leaf_bytes(leaf_bytes: Sequence[int], dtype: str = "float32",
                    step_time_s: Optional[float] = None,
                    source: Optional[dict] = None) -> TimingModel:
    """Exact-granularity model from per-gradient leaf byte sizes in
    LAYER (forward) order — e.g. ``scaling.resnet50_grad_leaf_bytes``.
    Units flip to issue order (reverse layer order), matching what
    buckets.partition will do when the tuned caps are applied."""
    units = [(int(b), dtype) for b in reversed(list(leaf_bytes))]
    return TimingModel(units, "leaf", step_time_s=step_time_s,
                       dtype=dtype,
                       source=dict(source or {"kind": "leaf-bytes"}))


def from_trace(payload: dict, path: Optional[str] = None,
               step_time_s: Optional[float] = None) -> TimingModel:
    """Extract from a traceview summary
    (``traceview_summary_rank{K}.json`` — ``traceview.parse.attribute``
    over a torch.profiler trace, or the JAX package's over an XLA one):
    the only input whose bandwidth AND step time are both device
    measurements from one capture.  The returned model additionally
    carries ``measured_overlap_frac`` / ``bucket_occupancy`` so the
    cap search can CALIBRATE its simulator against the measured
    schedule instead of trusting the analytic overlap."""
    if payload.get("format") != "mxnet-tpu-traceview-summary":
        raise ValueError("not a traceview summary%s"
                         % (" %r" % path if path else ""))
    plan = payload.get("bucket_plan")
    units = _units_from_plan(plan)
    buckets = payload.get("buckets") or []
    if units is None:
        rows = [b for b in buckets if b.get("bytes")]
        units = [(int(b["bytes"]), str(b.get("dtype") or "float32"))
                 for b in rows] or None
    if units is None:
        raise ValueError(
            "traceview summary%s carries no bucket plan — capture with "
            "bucketing enabled (MXNET_KVSTORE_BUCKET_BYTES != 0) so "
            "per-bucket reductions appear in the device timeline"
            % (" %r" % path if path else ""))
    steps = payload.get("steps") or {}
    if step_time_s is None:
        step_time_s = steps.get("mean_s")
    # effective wire bandwidth from MEASURED device occupancy: bucket
    # bytes over that bucket's collective device time (median over
    # buckets); falls back to plan-total / comm-total
    rates = [float(b["measured_GBps"]) for b in buckets
             if b.get("measured_GBps")]
    overlap = payload.get("overlap") or {}
    if not rates:
        comm_s = overlap.get("comm_s_per_step")
        tot = sum(b for b, _dt in units)
        if comm_s and tot:
            rates = [tot / float(comm_s) / 1e9]
    capture = payload.get("capture") or {}
    model = TimingModel(
        units, "bucket", step_time_s=step_time_s,
        measured_GBps=_median(rates),
        recorded_cap_bytes=(plan or {}).get("cap_bytes"),
        source={"kind": "trace", "path": path,
                "workload": payload.get("workload"),
                "rank": payload.get("rank"),
                "n_steps": steps.get("n"),
                "trace_path": capture.get("trace_path")})
    model.measured_overlap_frac = overlap.get("overlap_frac")
    model.bucket_occupancy = [
        {"bucket": int(b.get("bucket", i)),
         "occupancy": b.get("occupancy"),
         "device_s_per_step": b.get("device_s_per_step")}
        for i, b in enumerate(buckets)]
    return model


def load_any(path: str, step_time_s: Optional[float] = None,
             dtype: Optional[str] = None) -> TimingModel:
    """Content-sniffing loader for the CLI's ``--tune`` input: a flight
    dump, a ``--bucket-timings`` export, a SCALING report, or a
    traceview device-timeline summary."""
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict):
        if (payload.get("header") or {}).get("flight_recorder"):
            return from_flight_dump(payload, path=path,
                                    step_time_s=step_time_s)
        if payload.get("format") == "bucket-timings":
            return from_bucket_timings(payload, path=path,
                                       step_time_s=step_time_s)
        if payload.get("format") == "mxnet-tpu-traceview-summary":
            return from_trace(payload, path=path,
                              step_time_s=step_time_s)
        if "projection_bucket_pipeline" in payload:
            return from_scaling_json(payload, path=path, dtype=dtype)
    raise ValueError(
        "%r is not a flight-recorder dump, a merge_traces "
        "--bucket-timings export, a SCALING report, or a traceview "
        "summary" % path)
