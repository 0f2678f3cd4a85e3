"""CLI: attribute a captured trace, or replay the committed fixtures.

  python -m mxnet_tpu_torch.traceview --self-test
  python -m mxnet_tpu_torch.traceview --summary TRACE [--plan plan.json]
                                      [--flight dump.json] [-o summary.json]

TRACE is a trace-event ``.json``/``.json.gz`` (a torch.profiler export,
or an XLA trace the JAX package captured) or a directory holding one.
Stdlib only: runs anywhere the dumps land.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import parse

HERE = os.path.dirname(os.path.abspath(__file__))
#: the JAX package's fixture (an XLA trace, 2 devices, 2 steps)
FIXTURE = os.path.join(HERE, "fixture_trace.json")
#: the port's own: a kineto-shaped trace of one card
FIXTURE_KINETO = os.path.join(HERE, "fixture_kineto.json")


def _close(a, b, rel=1e-6) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-12)


def _check_golden(ok, path: str, extra: bool) -> None:
    """One fixture through ``attribute`` against its goldens."""
    with open(path) as f:
        fx = json.load(f)
    s = parse.attribute(fx["trace"], plan_meta=fx["plan_meta"],
                        workload="fixture")
    g = fx["golden"]
    tag = os.path.basename(path)
    ok(s["format"] == parse.SUMMARY_FORMAT, "%s: summary format" % tag)
    ok(s["steps"]["n"] == g["n_steps"], "%s: step count" % tag)
    ok(_close(s["steps"]["mean_s"], g["step_mean_s"]), "%s: wall" % tag)
    for phase, want in g["phases_mean_s"].items():
        got = s["phases"][phase]["mean_s"]
        ok(_close(got, want), "%s: phase %s mean %r != golden %r"
           % (tag, phase, got, want))
    ok(_close(s["phases"]["bucket_reduce"]["pct_of_step"],
              g["pct_bucket_reduce"]), "%s: bucket_reduce pct" % tag)
    for key in ("overlap_frac", "comm_s_per_step",
                "overlapped_s_per_step"):
        ok(_close(s["overlap"][key], g[key]), "%s: %s %r != %r"
           % (tag, key, s["overlap"][key], g[key]))
    ok(len(s["buckets"]) == len(g["buckets"]), "%s: bucket count" % tag)
    for got, want in zip(s["buckets"], g["buckets"]):
        ok(got["bucket"] == want["bucket"], "%s: bucket id" % tag)
        for key in ("device_s_per_step", "occupancy", "measured_GBps"):
            ok(_close(got[key], want[key]), "%s: bucket %d %s %r != %r"
               % (tag, want["bucket"], key, got[key], want[key]))
    ok(s["plan_match"] is True, "%s: plan_match" % tag)
    ok(s["phases"]["forward"]["p50_s"] is not None, "%s: p50" % tag)
    if extra:
        for key in ("bucket_map", "n_lanes", "n_device_events"):
            ok(s[key] == g[key], "%s: %s %r != %r"
               % (tag, key, s[key], g[key]))
        counts = parse.device_op_counts(fx["trace"])
        nccl = sum(v["count"] for k, v in counts.items()
                   if parse.classify_op(k) == "comm")
        ok(nccl == g["nccl_launches_per_step"],
           "%s: %r collectives a step" % (tag, nccl))
    return fx


def self_test() -> int:
    """Both fixtures against their goldens, plus the CPU-lane,
    no-annotation and flight-entry paths on synthetic events."""
    n_ok = [0]

    def ok(cond, what):
        n_ok[0] += 1
        if not cond:
            print("traceview self-test FAILED: %s" % what)
            raise SystemExit(1)

    fx = _check_golden(ok, FIXTURE, extra=False)
    _check_golden(ok, FIXTURE_KINETO, extra=True)

    # XLA:CPU-shaped lanes: thunk events keyed by (pid, tid), hlo_op
    # args, no /device: process — and no step annotation
    cpu = {"traceEvents": [
        {"name": "process_name", "ph": "M", "pid": 7, "tid": 0,
         "args": {"name": "/host:CPU"}},
        {"name": "fusion.1", "ph": "X", "pid": 7, "tid": 31,
         "ts": 100.0, "dur": 50.0,
         "args": {"hlo_op": "fusion.1", "hlo_module": "jit_f"}},
        {"name": "all-reduce.1", "ph": "X", "pid": 7, "tid": 31,
         "ts": 160.0, "dur": 40.0,
         "args": {"hlo_op": "all-reduce.1", "hlo_module": "jit_f"}},
        {"name": "fusion.1", "ph": "X", "pid": 7, "tid": 32,
         "ts": 100.0, "dur": 50.0,
         "args": {"hlo_op": "fusion.1", "hlo_module": "jit_f"}},
        {"name": "all-reduce.1", "ph": "X", "pid": 7, "tid": 32,
         "ts": 160.0, "dur": 40.0,
         "args": {"hlo_op": "all-reduce.1", "hlo_module": "jit_f"}},
    ]}
    c = parse.attribute(cpu)
    ok(c["n_lanes"] == 2, "CPU executor threads are distinct lanes")
    ok(c["steps"]["n"] == 1, "fallback single window")
    ok(_close(c["phases"]["bucket_reduce"]["mean_s"], 40e-6),
       "CPU comm attribution")
    ok(_close(c["phases"]["forward"]["mean_s"], 50e-6),
       "CPU compute attribution (pre-comm -> forward)")
    ok(_close(c["overlap"]["overlap_frac"], 0.0), "CPU overlap 0")

    # a kineto capture of the host only: its leaf cpu_ops are the lanes
    host = {"traceEvents": [
        {"name": "mxnet:step:0:k=1", "cat": "user_annotation", "ph": "X",
         "pid": 9, "tid": 1, "ts": 0.0, "dur": 100.0},
        {"name": "mxnet-fwd", "cat": "user_annotation", "ph": "X",
         "pid": 9, "tid": 1, "ts": 0.0, "dur": 50.0},
        {"name": "aten::linear", "cat": "cpu_op", "ph": "X", "pid": 9,
         "tid": 1, "ts": 5.0, "dur": 30.0},
        {"name": "aten::mm", "cat": "cpu_op", "ph": "X", "pid": 9,
         "tid": 1, "ts": 10.0, "dur": 20.0},
        {"name": "mxnet-opt", "cat": "user_annotation", "ph": "X",
         "pid": 9, "tid": 1, "ts": 60.0, "dur": 30.0},
        {"name": "aten::add_", "cat": "cpu_op", "ph": "X", "pid": 9,
         "tid": 1, "ts": 65.0, "dur": 10.0},
    ]}
    h = parse.attribute(host)
    ok(h["n_lanes"] == 1 and h["n_device_events"] == 2,
       "host capture: leaf cpu_ops only")
    ok(_close(h["phases"]["forward"]["mean_s"], 20e-6),
       "host capture: forward scope")
    ok(_close(h["phases"]["optimizer"]["mean_s"], 10e-6),
       "host capture: optimizer scope")

    # injected-stall tagging from flight entries rides into the summary
    inj = parse.attribute(
        fx["trace"], plan_meta=fx["plan_meta"],
        flight_entries=[
            {"op": "bucket_reduce", "seq": 0, "bucket": 0},
            {"op": "bucket_reduce", "seq": 1, "bucket": 1,
             "injected": True, "injected_kind": "delay_collective"}])
    ok(inj["injected"]["events"] == 1, "injected count")
    ok(inj["injected"]["kinds"] == ["delay_collective"], "injected kind")
    ok(inj["buckets"][1]["injected_stall"] is True, "bucket tagged")
    ok(inj["buckets"][0]["injected_stall"] is False, "bucket 0 clean")
    ok(inj["flight_cross_check"]["issue_order_ascending"] is True,
       "flight seq cross-check")

    print("traceview self-test OK: %d check(s) over the fixtures + "
          "synthetic lanes" % n_ok[0])
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.traceview",
        description="attribute a device trace into step phases and "
                    "per-bucket occupancy")
    ap.add_argument("trace", nargs="?",
                    help="trace-event json(.gz), or a dir holding one")
    ap.add_argument("--summary", metavar="TRACE",
                    help="the trace to attribute (same as the "
                         "positional argument)")
    ap.add_argument("--plan", help="bucket plan_meta JSON to match "
                                   "collectives against")
    ap.add_argument("--flight", help="flightrecorder_rank*.json dump "
                                     "for the seq cross-check")
    ap.add_argument("-o", "--out", help="write the summary JSON here "
                                        "(default: stdout)")
    ap.add_argument("--self-test", action="store_true")
    args = ap.parse_args(argv)
    if args.self_test:
        return self_test()
    path = args.summary or args.trace
    if not path:
        ap.error("a trace path is required (or --self-test)")
    trace = parse.load_trace(path)
    plan = None
    if args.plan:
        with open(args.plan) as f:
            plan = json.load(f)
    entries = None
    if args.flight:
        with open(args.flight) as f:
            payload = json.load(f)
        entries = payload.get("entries") or []
        if plan is None:
            plan = (payload.get("header") or {}).get("bucket_plan")
    summary = parse.attribute(trace, plan_meta=plan,
                              flight_entries=entries)
    text = json.dumps(summary, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print("traceview: summary -> %s (%d device events, %d steps)"
              % (args.out, summary["n_device_events"],
                 summary["steps"]["n"]))
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
