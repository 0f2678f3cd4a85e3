"""Walker over a chrome trace-event export: phase + bucket attribution
of the device timeline.

Counterpart: ``mxnet_tpu/traceview/parse.py``.  The walker, its phase
rules and its summary (``mxnet-tpu-traceview-summary`` v1) are the JAX
package's, so the JAX package's consumers (``autotune.timing``,
``merge_traces --health``) read a port summary, and an XLA trace the JAX
package captured attributes here exactly as there.  This copy also
reads what a torch.profiler (kineto) chrome export holds:

  * device lanes — kineto's ``kernel`` / ``gpu_memcpy`` / ``gpu_memset``
    events (``pid`` the device, ``tid`` the stream; overlap is measured
    across a device's streams), besides XLA's ``args.hlo_op`` thunk
    events and ``/device:`` processes.  A capture without device events
    (a CPU run) uses its leaf ``cpu_op`` events, one lane per host
    thread, the part XLA:CPU's thunks play in the JAX package;
  * collectives — NCCL's ``ncclDevKernel_*`` / ``ncclKernel_*`` kernels
    besides XLA's collective names; copies — ``Memcpy HtoD`` / ``DtoH``;
  * step windows — the ``mxnet:step:<i>:k=<k>`` annotations
    (``record_function`` ranges, ``user_annotation`` events);
  * phases and buckets — each device event is linked to the host call
    that launched it through kineto's correlation id (the ``ac2g``
    flows), and takes the ``mxnet-fwd`` / ``mxnet-bwd`` / ``mxnet-opt``
    and ``mxbkt%03d`` scopes (``record_function`` ranges) open around
    that launch.  The backward's kernels are launched from autograd's
    device thread, not the caller's: a launch finds its scope on its own
    thread first, then on any thread of its process.  The ``mxbkt``
    scope is what tells a bucket's gradient all-reduce from sync
    BatchNorm's all-reduces, which share the kernel; only collectives
    launched under an ``mxbkt`` scope are bucket reduces.

The JAX package reads that scope from the ``*.xplane.pb`` sidecar
(``find_xplane_file`` / ``load_op_index``); a kineto export carries it
in the trace itself, so those two have no counterpart here.  Without a
scope (an XLA trace) the bucket map falls back to the JAX package's
distinct-name issue order.

Stdlib only: the walker runs wherever the dumps land.
"""
from __future__ import annotations

import glob
import gzip
import io
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "SUMMARY_FORMAT", "SUMMARY_VERSION", "load_trace", "find_trace_file",
    "attribute", "classify_op", "is_traceview_summary",
    "device_op_counts", "lost_launches",
]

SUMMARY_FORMAT = "mxnet-tpu-traceview-summary"
SUMMARY_VERSION = 1

#: the capture annotation: mxnet:step:<idx>[:k=<n>] (serve windows use
#: the same grammar with a different verb)
STEP_RE = re.compile(r"^mxnet:(step|serve):(\d+)(?::k=(\d+))?$")

COMM_RE = re.compile(
    r"(all-reduce|reduce-scatter|all-gather|collective-permute|"
    r"all-to-all|ncclAllReduce|cross-replica-sum|ncclDevKernel_|"
    r"ncclKernel_)", re.IGNORECASE)
H2D_RE = re.compile(
    r"(TransferToDevice|CopyToDevice|DevicePut|BufferFromHost|"
    r"infeed|h2d|HtoD)", re.IGNORECASE)
D2H_RE = re.compile(
    r"(TransferFromDevice|CopyFromDevice|TransferLiteral|"
    r"BufferToHost|outfeed|d2h|DtoH)", re.IGNORECASE)
#: explicit scope tokens win over the timeline split
SCOPE_TOKENS = (("mxnet-fwd", "forward"), ("mxnet-bwd", "backward"),
                ("mxnet-opt", "optimizer"))

PHASES = ("h2d", "forward", "backward", "bucket_reduce", "optimizer",
          "d2h")

#: bucket identity scope (``traceview.annotation("mxbkt%03d" % i)``
#: around each bucket's pack and collective)
BUCKET_SCOPE_RE = re.compile(r"mxbkt(\d+)")

#: kineto categories of device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: kineto categories of the host calls that launch it
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the host calls of LAUNCH_CATS that launch one kernel
KERNEL_LAUNCH_RE = re.compile(r"^cu(da)?Launch(Cooperative)?Kernel")


def is_traceview_summary(payload) -> bool:
    return isinstance(payload, dict) and \
        payload.get("format") == SUMMARY_FORMAT


def find_trace_file(dirpath: str) -> Optional[str]:
    """Newest trace-event file under ``dirpath``: a torch.profiler
    export (``*.pt.trace.json``) or a jax profiler dump
    (``plugins/profile/<ts>/<host>.trace.json.gz``)."""
    pats = [os.path.join(dirpath, "plugins", "profile", "*",
                         "*.trace.json.gz"),
            os.path.join(dirpath, "plugins", "profile", "*",
                         "*.trace.json"),
            os.path.join(dirpath, "*.trace.json.gz"),
            os.path.join(dirpath, "*.trace.json")]
    hits: List[str] = []
    for p in pats:
        hits.extend(glob.glob(p))
    return max(hits, key=os.path.getmtime) if hits else None


def load_trace(path: str) -> dict:
    """Trace-event payload from a ``.json``/``.json.gz`` file or a dump
    directory."""
    if os.path.isdir(path):
        found = find_trace_file(path)
        if found is None:
            raise FileNotFoundError(
                "no *.trace.json(.gz) under %r" % path)
        path = found
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return json.load(io.TextIOWrapper(f, encoding="utf-8"))
    with open(path) as f:
        return json.load(f)


def classify_op(name: str) -> str:
    """'h2d' | 'd2h' | 'comm' | 'compute' for one device-op name; the
    forward/backward/optimizer split of 'compute' needs the timeline
    context and happens in attribute()."""
    if COMM_RE.search(name):
        return "comm"
    if H2D_RE.search(name):
        return "h2d"
    if D2H_RE.search(name):
        return "d2h"
    return "compute"


def _scope_phase(name: str) -> Optional[str]:
    for token, phase in SCOPE_TOKENS:
        if token in name:
            return phase
    return None


def _comm_base(name: str) -> str:
    """Normalize async pairs: ``all-reduce-start.1``/``-done.1`` fold
    onto one logical collective."""
    return name.replace("-start.", ".").replace("-done.", ".")


def _percentile(vals: Sequence[float], q: float) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    idx = min(int(round(q * (len(s) - 1))), len(s) - 1)
    return s[idx]


def _union(intervals: List[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _intersect_total(a: List[Tuple[float, float]],
                     b: List[Tuple[float, float]]) -> float:
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def _leaf_cpu_ops(events: Sequence[dict]) -> List[dict]:
    """kineto ``cpu_op`` events that enclose no other ``cpu_op`` of
    their thread (the ops that did the work, not their callers)."""
    by_thread: Dict[tuple, List[dict]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op" \
                and e.get("dur") is not None:
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    leaves = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        for i, e in enumerate(evs):
            end = float(e["ts"]) + float(e["dur"])
            nxt = evs[i + 1] if i + 1 < len(evs) else None
            if nxt is None or float(nxt["ts"]) >= end:
                leaves.append(e)
    return leaves


class _Scopes:
    """The ``mxnet-*`` / ``mxbkt*`` annotation ranges of a kineto
    capture, and the host launch of each device event."""

    def __init__(self, events: Sequence[dict]):
        self.by_thread: Dict[tuple, List[Tuple[float, float, str]]] = {}
        self.launch: Dict[int, Tuple[object, object, float]] = {}
        for e in events:
            if e.get("ph") != "X" or e.get("dur") is None:
                continue
            cat = e.get("cat")
            if cat == "user_annotation":
                name = str(e.get("name") or "")
                if _scope_phase(name) or BUCKET_SCOPE_RE.search(name):
                    t0 = float(e["ts"])
                    self.by_thread.setdefault(
                        (e.get("pid"), e.get("tid")), []).append(
                        (t0, t0 + float(e["dur"]), name))
            elif cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = (e.get("pid"), e.get("tid"),
                                         float(e["ts"]))
        for v in self.by_thread.values():
            v.sort()

    def _containing(self, key, t: float) -> List[Tuple[float, float, str]]:
        return [s for s in self.by_thread.get(key, ())
                if s[0] <= t < s[1]]

    def scope_of(self, e: dict, host: bool) -> str:
        """The scope names open around ``e``'s launch (outermost
        first), joined by '/'; '' when none.  ``host``: ``e`` is itself
        a host op (a CPU capture's leaf op)."""
        if host:
            pid, tid, t = e.get("pid"), e.get("tid"), float(e["ts"])
        else:
            corr = (e.get("args") or {}).get("correlation")
            pid, tid, t = self.launch.get(corr, (None, None,
                                                 float(e["ts"])))
        hits = self._containing((pid, tid), t)
        if not hits:
            # a launch from autograd's device thread: the caller's
            # thread holds the phase scope
            for key in self.by_thread:
                if pid is None or key[0] == pid:
                    hits += self._containing(key, t)
        hits.sort()
        return "/".join(name for _a, _b, name in hits)


def _device_lanes(events: Sequence[dict]) -> Tuple[Dict[tuple, List[dict]],
                                                    bool]:
    """Group device-op events into lanes; returns (lanes, kineto).

    A device op is a kineto ``kernel`` / ``gpu_memcpy`` / ``gpu_memset``
    event (lane: its device pid, across streams), an 'X' event stamped
    with ``args.hlo_op`` / ``args.hlo_module`` (XLA:CPU thunks; lane:
    (pid, tid)), or an 'X' event on a ``/device:`` process (TPU stream
    lanes; lane: the pid).  A kineto capture with no device activity
    (a CPU run) uses its leaf ``cpu_op`` events, one lane per thread.
    Kineto events carry their launch scope under ``_scope``."""
    proc_names: Dict[int, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            proc_names[e.get("pid")] = str(
                (e.get("args") or {}).get("name", ""))
    lanes: Dict[tuple, List[dict]] = {}
    kineto_dev: List[dict] = []
    for e in events:
        if e.get("ph") != "X" or e.get("dur") is None:
            continue
        if e.get("cat") in DEVICE_CATS:
            kineto_dev.append(e)
            continue
        args = e.get("args") or {}
        pname = proc_names.get(e.get("pid"), "")
        is_device_proc = "/device:" in pname
        if not (is_device_proc or "hlo_op" in args
                or "hlo_module" in args):
            continue
        key = (e.get("pid"),) if is_device_proc \
            else (e.get("pid"), e.get("tid"))
        lanes.setdefault(key, []).append(e)
    kineto = False
    if not lanes:
        host = not kineto_dev
        picked = kineto_dev or _leaf_cpu_ops(events)
        if picked:
            kineto = True
            scopes = _Scopes(events)
            for e in picked:
                key = (e.get("pid"),) if not host \
                    else (e.get("pid"), e.get("tid"))
                lanes.setdefault(key, []).append(
                    dict(e, _scope=scopes.scope_of(e, host)))
    for evs in lanes.values():
        evs.sort(key=lambda e: float(e["ts"]))
    return lanes, kineto


def _step_windows(events: Sequence[dict]
                  ) -> List[Tuple[float, float, int, int]]:
    """(t0, t1, idx, k) per capture annotation, time-ordered (kineto's
    device-side copies of the annotations are skipped)."""
    wins = []
    for e in events:
        if e.get("ph") != "X" or e.get("dur") is None \
                or e.get("cat") == "gpu_user_annotation":
            continue
        m = STEP_RE.match(str(e.get("name", "")))
        if m:
            t0 = float(e["ts"])
            wins.append((t0, t0 + float(e["dur"]), int(m.group(2)),
                         int(m.group(3) or 1)))
    wins.sort()
    return wins


def _op_name(e: dict) -> str:
    args = e.get("args") or {}
    return str(args.get("hlo_op") or e.get("name") or "")


def _scope_bucket(scope: Optional[str]) -> Optional[int]:
    m = BUCKET_SCOPE_RE.search(scope or "")
    return int(m.group(1)) if m else None


def device_op_counts(trace: dict) -> Dict[str, dict]:
    """Per device-op name: launches and device seconds per step window,
    over the windows the trace holds (the whole capture as one window
    when it holds none) — what a kernel count read from the trace is
    checked against.  A kineto event belongs to the window its host
    launch fell in (its correlation id), so a device clock that reads a
    little early or late moves no launch across a window's edge."""
    events = trace.get("traceEvents") or []
    lanes, _ = _device_lanes(events)
    windows = _step_windows(events) or [(float("-inf"), float("inf"),
                                         0, 1)]
    launch = _Scopes(events).launch
    out: Dict[str, dict] = {}
    for evs in lanes.values():
        for e in evs:
            corr = (e.get("args") or {}).get("correlation")
            t = launch[corr][2] if corr in launch else float(e["ts"])
            if any(t0 <= t < t1 for t0, t1, _i, _k in windows):
                row = out.setdefault(_op_name(e), {"count": 0, "s": 0.0})
                row["count"] += 1
                row["s"] += float(e["dur"]) * 1e-6
    n = len(windows)
    return {k: {"count": v["count"] / n, "s": v["s"] / n}
            for k, v in out.items()}


def lost_launches(trace: dict) -> List[int]:
    """Per step window (time-ordered): the kernel launches made in it
    whose kernel the trace does not hold (no device event carries the
    launch's correlation id).  Kineto can lose device records; a window
    that lost any has short counts and device time.  Empty for a trace
    without windows; all zeros for a trace without launch events (a CPU
    capture, an XLA trace)."""
    events = trace.get("traceEvents") or []
    have = {(e.get("args") or {}).get("correlation") for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS}
    lost = [float(e["ts"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
            and KERNEL_LAUNCH_RE.match(str(e.get("name", "")))
            and (e.get("args") or {}).get("correlation") not in have]
    return [sum(1 for t in lost if t0 <= t < t1)
            for t0, t1, _i, _k in _step_windows(events)]


def attribute(trace: dict, plan_meta: Optional[dict] = None,
              flight_entries: Optional[Sequence[dict]] = None,
              workload: Optional[str] = None) -> dict:
    """Walk one rank's trace-event payload into the traceview summary
    dict (format ``mxnet-tpu-traceview-summary`` v1).

    ``plan_meta`` is the stamped bucket plan (buckets.plan_meta) the
    collectives are matched against; ``flight_entries`` flight-recorder
    entries for the seq-order cross-check and the chaos ``injected``
    tagging (the port records none; a JAX package dump's may be given).
    A kineto capture maps each collective to its bucket by the
    ``mxbkt<i>`` scope it was launched under (exact, and it separates
    gradient reduces from sync BatchNorm's all-reduces); otherwise
    distinct-comm-name issue order is the mapping."""
    events = trace.get("traceEvents") or []
    lanes, kineto = _device_lanes(events)
    windows = _step_windows(events)
    if not windows:
        # no annotations (a raw capture): the whole device-event span
        # is one window
        all_ts = [float(e["ts"]) for evs in lanes.values() for e in evs]
        all_te = [float(e["ts"]) + float(e["dur"])
                  for evs in lanes.values() for e in evs]
        if all_ts:
            windows = [(min(all_ts), max(all_te), 0, 1)]

    plan_buckets = sorted((plan_meta or {}).get("buckets") or [],
                          key=lambda r: int(r.get("bucket", 0)))
    n_plan = len(plan_buckets)

    # bucket mapping:
    #   scope — a kineto capture names each launch's scope; only
    #           mxbkt<i>-scoped collectives are bucket reduces, the
    #           rest (sync BatchNorm, the loss mean) are other-comm;
    #   order — distinct comm op names in first-issue order across the
    #           whole capture; only sound when nothing but the bucket
    #           reduces is a collective
    bucket_of: Dict[str, int] = {}
    if kineto:
        bucket_map = "scope"
        seen = sorted({_scope_bucket(e.get("_scope"))
                       for evs in lanes.values() for e in evs
                       if classify_op(_op_name(e)) == "comm"
                       and _scope_bucket(e.get("_scope")) is not None})
        plan_match = bool(n_plan) and seen == list(range(n_plan))
    else:
        bucket_map = "issue-order"
        comm_order: List[str] = []
        for evs in lanes.values():
            for e in evs:
                name = _op_name(e)
                if classify_op(name) == "comm":
                    base = _comm_base(name)
                    if base not in comm_order:
                        comm_order.append(base)
            if comm_order:
                break
        bucket_of = {base: i for i, base in enumerate(comm_order)}
        plan_match = bool(n_plan) and len(comm_order) == n_plan

    def _bucket(n: str, scope: Optional[str]) -> Optional[int]:
        if bucket_map == "scope":
            return _scope_bucket(scope)
        return bucket_of.get(_comm_base(n))

    def _is_bucket_comm(n: str, scope: Optional[str]) -> bool:
        # in scope mode only mxbkt-scoped collectives are the gradient
        # exchange; sync BatchNorm's all-reduces / the loss mean are
        # computation that happens to be collective — they ride the
        # compute side of the overlap measurement and the phase split
        return classify_op(n) == "comm" and \
            (bucket_map != "scope" or _scope_bucket(scope) is not None)

    # per-step accumulators, lane-meaned
    phase_steps: Dict[str, List[float]] = {p: [] for p in PHASES}
    bucket_steps: Dict[int, List[float]] = {}
    wall_s: List[float] = []
    comm_ps: List[float] = []
    comp_ps: List[float] = []
    ovl_ps: List[float] = []

    for (t0, t1, _idx, k) in windows:
        k = max(int(k), 1)
        per_lane: List[Dict[str, float]] = []
        per_lane_b: List[Dict[int, float]] = []
        per_lane_ovl: List[Tuple[float, float, float]] = []
        for evs in lanes.values():
            win = []
            for e in evs:
                ts = float(e["ts"])
                te = ts + float(e["dur"])
                lo, hi = max(ts, t0), min(te, t1)
                if hi > lo:
                    win.append((lo, hi, _op_name(e),
                                str(e.get("name") or ""),
                                e.get("_scope")))
            if not win:
                continue
            comm = [(a, b, n) for a, b, n, _d, s in win
                    if _is_bucket_comm(n, s)]
            first_comm = min((a for a, _b, _n in comm), default=None)
            last_comm = max((b for _a, b, _n in comm), default=None)
            ph: Dict[str, float] = {p: 0.0 for p in PHASES}
            bk: Dict[int, float] = {}
            comp_iv: List[Tuple[float, float]] = []
            for a, b, name, display, scope in win:
                kind = classify_op(name)
                dur = b - a
                if kind == "comm" and _is_bucket_comm(name, scope):
                    ph["bucket_reduce"] += dur
                    j = _bucket(name, scope)
                    if j is not None:
                        bk[j] = bk.get(j, 0.0) + dur
                    continue
                if kind in ("h2d", "d2h"):
                    ph[kind] += dur
                    continue
                comp_iv.append((a, b))
                # the display name carries scope tokens where the
                # runtime surfaces them (XLA); a kineto event's launch
                # scope does the same
                phase = _scope_phase(display) or _scope_phase(name)
                if phase is None and scope:
                    # a bucket's pack/unpack: exchange machinery,
                    # charged to bucket_reduce, but still a compute
                    # interval for the overlap measurement
                    phase = "bucket_reduce" \
                        if _scope_bucket(scope) is not None \
                        else _scope_phase(scope)
                if phase is None:
                    if first_comm is None or b <= first_comm:
                        phase = "forward"
                    elif a >= last_comm:
                        phase = "optimizer"
                    else:
                        phase = "backward"
                ph[phase] += dur
            per_lane.append(ph)
            per_lane_b.append(bk)
            comm_u = _union([(a, b) for a, b, _n in comm])
            comp_u = _union(comp_iv)
            per_lane_ovl.append((
                sum(b - a for a, b in comm_u),
                sum(b - a for a, b in comp_u),
                _intersect_total(comm_u, comp_u)))
        if not per_lane:
            continue
        n_lanes = len(per_lane)
        us = 1e-6 / k  # µs -> s, normalized per micro-step
        for p in PHASES:
            phase_steps[p].append(
                sum(ph[p] for ph in per_lane) / n_lanes * us)
        for j in set().union(*per_lane_b) if per_lane_b else set():
            bucket_steps.setdefault(j, []).append(
                sum(bk.get(j, 0.0) for bk in per_lane_b) / n_lanes * us)
        wall_s.append((t1 - t0) * 1e-6 / k)
        comm_ps.append(sum(o[0] for o in per_lane_ovl) / n_lanes * us)
        comp_ps.append(sum(o[1] for o in per_lane_ovl) / n_lanes * us)
        ovl_ps.append(sum(o[2] for o in per_lane_ovl) / n_lanes * us)

    n_steps = len(wall_s)
    mean_wall = sum(wall_s) / n_steps if n_steps else None

    phases_out = {}
    for p in PHASES:
        vals = phase_steps[p]
        tot = sum(vals)
        phases_out[p] = {
            "total_s": tot,
            "per_step_s": vals,
            "mean_s": tot / len(vals) if vals else None,
            "pct_of_step": (tot / sum(wall_s) * 100.0)
            if wall_s and sum(wall_s) else None,
            "p50_s": _percentile(vals, 0.50),
            "p99_s": _percentile(vals, 0.99),
        }

    buckets_out = []
    injected_buckets = set()
    inj_kinds: List[str] = []
    n_inj = 0
    for e in flight_entries or ():
        if e.get("injected"):
            n_inj += 1
            kind = str(e.get("injected_kind") or "unknown")
            if kind not in inj_kinds:
                inj_kinds.append(kind)
            if e.get("bucket") is not None:
                injected_buckets.add(int(e["bucket"]))
    for j in sorted(bucket_steps):
        vals = bucket_steps[j]
        dps = sum(vals) / len(vals)
        row = {"bucket": j, "device_s_per_step": dps,
               "occupancy": dps / mean_wall if mean_wall else None,
               "injected_stall": j in injected_buckets}
        if j < n_plan:
            nbytes = int(plan_buckets[j].get("bytes") or 0)
            row["bytes"] = nbytes
            row["dtype"] = plan_buckets[j].get("dtype")
            if nbytes and dps > 0:
                row["measured_GBps"] = nbytes / dps / 1e9
        buckets_out.append(row)

    comm_mean = sum(comm_ps) / n_steps if n_steps else 0.0
    comp_mean = sum(comp_ps) / n_steps if n_steps else 0.0
    ovl_mean = sum(ovl_ps) / n_steps if n_steps else 0.0

    # flight cross-check: the recorder's bucket_reduce seq order must
    # walk buckets 0..B-1 ascending
    flight_check: dict = {"checked": False}
    br = [e for e in (flight_entries or ())
          if e.get("op") == "bucket_reduce" and e.get("bucket") is not None]
    if br:
        br.sort(key=lambda e: e.get("seq", 0))
        first_cycle = [int(e["bucket"]) for e in br[:max(n_plan, 1)]]
        flight_check = {
            "checked": True,
            "n_entries": len(br),
            "issue_order_ascending": first_cycle ==
            sorted(first_cycle),
            "trace_order_matches_plan": plan_match,
        }

    return {
        "format": SUMMARY_FORMAT, "version": SUMMARY_VERSION,
        "workload": workload,
        "bucket_plan": dict(plan_meta) if plan_meta else None,
        "plan_match": plan_match,
        "bucket_map": bucket_map,
        "steps": {"n": n_steps, "wall_s": wall_s, "mean_s": mean_wall,
                  "p50_s": _percentile(wall_s, 0.50),
                  "p99_s": _percentile(wall_s, 0.99)},
        "phases": phases_out,
        "buckets": buckets_out,
        "overlap": {"comm_s_per_step": comm_mean,
                    "compute_s_per_step": comp_mean,
                    "overlapped_s_per_step": ovl_mean,
                    "overlap_frac": (ovl_mean / comm_mean)
                    if comm_mean > 0 else None,
                    "source": "trace"},
        "injected": {"events": n_inj, "kinds": inj_kinds},
        "flight_cross_check": flight_check,
        "n_device_events": sum(len(v) for v in lanes.values()),
        "n_lanes": len(lanes),
    }
