"""python -m mxnet_tpu_torch.autotune — tune the bucket plan offline.

Counterpart: ``mxnet_tpu/autotune/__main__.py`` (its checks, and a
kineto-derived summary of the port's own).  Modes:
  --self-test            synthetic end-to-end check: extraction →
                         sweep → plan → apply through the buckets;
                         needs no card.
  --tune PATH            extract a timing model from PATH (a traceview
                         summary, a flightrecorder_rank{K}.json dump, a
                         merge_traces --bucket-timings export or a
                         SCALING report) and search the cap ladder.
                         Flight inputs need --step-time; inputs that
                         measured no bandwidth need --ici-gbps.
  --apply                with --tune: persist the winning plan (to
                         --out, else into MXNET_AUTOTUNE_DIR under its
                         fingerprinted name) and print the env line
                         that activates it.
  --coll-latency S       with --tune: the cost of one collective the
                         search charges each bucket (default the stated
                         5 µs; a card's is measured by
                         tools/torch_autotune_scale.py).
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def self_test() -> int:
    import tempfile

    from . import plan as _plan
    from . import search as _search
    from . import timing as _timing
    from ..parallel import buckets as _buckets

    checks = 0

    def ok(cond, what):
        nonlocal checks
        assert cond, "autotune self-test FAILED: %s" % what
        checks += 1
        print("  ok: %s" % what)

    MIB = 1024 * 1024
    BW = 100.0   # GB/s, an explicit link figure for the synthetic models

    # -- extraction: synthetic flight dump with a stamped plan, real
    #    wire durations on the dist pushes, issue-stamp (~0s) durations
    #    on the in-graph bucket reductions
    plan_hdr = {"n_buckets": 4, "total_bytes": 10 * MIB,
                "cap_bytes": 4 * MIB, "impl": "psum", "chained": True,
                "buckets": [
                    {"bucket": 0, "n_grads": 3, "bytes": 4 * MIB,
                     "dtype": "float32"},
                    {"bucket": 1, "n_grads": 2, "bytes": 3 * MIB,
                     "dtype": "float32"},
                    {"bucket": 2, "n_grads": 4, "bytes": 2 * MIB,
                     "dtype": "float32"},
                    {"bucket": 3, "n_grads": 1, "bytes": 1 * MIB,
                     "dtype": "float32"}]}
    entries = []
    for s in range(4):
        entries.append({  # in-graph issue stamp: near-zero duration
            "seq": s, "op": "bucket_reduce", "bucket": s,
            "bytes": plan_hdr["buckets"][s]["bytes"], "dtype": "float32",
            "enqueue_ts": 100.0 + s, "complete_ts": 100.0 + s + 2e-6,
            "state": "completed", "args": {"in_graph": True}})
    # dist pushes with REAL durations: 1 MiB in 1 ms → ~1.05 GB/s
    for s in range(4, 7):
        entries.append({
            "seq": s, "op": "push", "bucket": None, "bytes": MIB,
            "dtype": "float32", "enqueue_ts": 200.0 + s,
            "complete_ts": 200.0 + s + 1e-3, "state": "completed"})
    dump = {"header": {"flight_recorder": True, "rank": 0,
                       "num_workers": 2, "bucket_plan": plan_hdr},
            "entries": entries}
    tm = _timing.from_flight_dump(dump, path="<synthetic>")
    ok(tm.granularity == "bucket" and tm.n_units == 4,
       "flight extraction: 4 recorded bucket units")
    ok(tm.total_bytes == 10 * MIB, "flight extraction: payload bytes")
    ok(tm.recorded_cap_bytes == 4 * MIB, "flight extraction: recorded cap")
    ok(tm.measured_GBps is not None and 0.9 < tm.measured_GBps < 1.2,
       "wire bandwidth from real push durations (~1.05 GB/s)")
    # the in-graph stamps alone must NOT fabricate a bandwidth
    tm_stamps = _timing.from_flight_dump(
        {"header": dump["header"], "entries": entries[:4]})
    ok(tm_stamps.measured_GBps is None,
       "in-graph issue stamps excluded from bandwidth")

    # -- virtual repartition invariants
    units = [(3 * MIB, "float32"), (3 * MIB, "float32"),
             (9 * MIB, "float32"), (1 * MIB, "bfloat16")]
    bb = _search._virtual_partition(units, 4 * MIB)
    ok(sum(bb) == 16 * MIB, "virtual repartition conserves bytes")
    ok(max(bb) <= 4 * MIB + 1, "virtual repartition respects the cap")
    ok(len(_search._virtual_partition(units, 32 * MIB)) == 2,
       "dtype boundary survives merging (bf16 tail stays separate)")
    asym = _search._virtual_partition(
        [(MIB, "f32")] * 8, 4 * MIB, first_cap=MIB, last_cap=8 * MIB)
    ok(asym[0] == MIB and sum(asym) == 8 * MIB,
       "first-bucket asymmetry honored")
    fold = _search._virtual_partition(
        [(3 * MIB, "float32"), (3 * MIB, "float32"), (MIB, "bfloat16")],
        4 * MIB, last_cap=8 * MIB)
    ok(fold == [3 * MIB, 3 * MIB, MIB],
       "tail fold never crosses a dtype boundary")

    # -- search: tuned plan scores at least the 4 MiB default, sweep
    #    covers the 1-32 MiB ladder with asymmetry
    big = _timing.TimingModel([(4 * MIB, "float32")] * 25, "bucket",
                              step_time_s=0.015,
                              source={"kind": "self-test"})
    # the port assumes no link: a model without a measured bandwidth
    # and no ici_GBps raises
    try:
        _search.tune(big, chips=256)
        ok(False, "tune without a bandwidth raises")
    except ValueError:
        ok(True, "tune without a bandwidth raises")
    tuned = _search.tune(big, chips=256, ici_GBps=BW)
    ok(tuned["score"]["beats_default"]
       and tuned["score"]["eff"] >= tuned["score"]["default_eff"],
       "tuned plan >= 4 MiB default under the stated model")
    ok(tuned["score"]["n_candidates"] ==
       len(_search.CAPS_MIB) * len(_search.FIRST_FRACS)
       * len(_search.LAST_MULTS), "full cap x asymmetry sweep ran")
    ok(tuned["assumptions"]["readiness"] == "bytes"
       and tuned["assumptions"]["coll_latency_s"] > 0,
       "assumptions stamped into the plan")
    # degenerate single-unit model still tunes (1-bucket plan)
    one = _search.tune(_timing.TimingModel(
        [(2 * MIB, "float32")], "bucket", step_time_s=0.01), chips=8,
        ici_GBps=BW)
    ok(one["n_buckets"] >= 1, "degenerate 1-unit model tunes")

    # -- persistence + resolution + apply-through-buckets
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "plan.json")
        _plan.save_plan(tuned, path)
        loaded = _plan.load_plan(path)
        ok(loaded["cap_bytes"] == tuned["cap_bytes"],
           "plan JSON roundtrip")
        try:
            _plan.load_plan(__file__)
            ok(False, "non-plan file rejected")
        except ValueError:
            ok(True, "non-plan file rejected")

        prev_plan = os.environ.pop("MXNET_AUTOTUNE_PLAN", None)
        prev_dir = os.environ.pop("MXNET_AUTOTUNE_DIR", None)
        try:
            caps, src = _plan.resolve_caps(total_bytes=123)
            ok(caps is None and src is None,
               "no env set -> no tuned caps")
            # the self-test deliberately exercises the raw knob; the
            # READ path under test goes through the env accessors
            os.environ["MXNET_AUTOTUNE_DIR"] = d
            caps, src = _plan.resolve_caps(
                total_bytes=tuned["fingerprint"]["total_bytes"])
            ok(caps is not None and src == path,
               "MXNET_AUTOTUNE_DIR fingerprint match")
            caps, src = _plan.resolve_caps(total_bytes=999)
            ok(caps is None, "fingerprint mismatch -> no match")
            os.environ["MXNET_AUTOTUNE_PLAN"] = path
            caps, src = _plan.resolve_caps(total_bytes=999)
            ok(caps is not None and src == path,
               "explicit MXNET_AUTOTUNE_PLAN wins regardless")

            # the applied caps drive the real partitioner
            entries = [("w%d" % i, (256,), "float32")
                       for i in range(40)]  # 1 KiB leaves
            small = dict(tuned)
            small.update(cap_bytes=4096, first_cap_bytes=1024,
                         last_cap_bytes=8192)
            _plan.save_plan(small, path)
            bplan, tuning = _buckets.plan_with_tuning(entries)
            ok(tuning is not None and tuning["plan_path"] == path,
               "plan_with_tuning consumed the tuned plan")
            ok(bplan[0].nbytes <= 1024,
               "first-bucket cap applied by the partitioner")
            seen = [k for b in bplan for k in b.keys]
            ok(sorted(seen) == sorted(e[0] for e in entries)
               and len(seen) == len(set(seen)),
               "tuned partition covers every gradient exactly once")
        finally:
            for k, v in (("MXNET_AUTOTUNE_PLAN", prev_plan),
                         ("MXNET_AUTOTUNE_DIR", prev_dir)):
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

        # -- CLI --tune on a synthetic SCALING report
        scaling_path = os.path.join(d, "SCALING_test.json")
        with open(scaling_path, "w") as f:
            json.dump({"projection_bucket_pipeline": {"bfloat16": {
                "bucket_bytes": [4 * MIB] * 12,
                "step_time_s": 0.0138}}}, f)
        out_path = os.path.join(d, "tuned.json")
        rc = main(["--tune", scaling_path, "--apply", "--out", out_path,
                   "--ici-gbps", str(BW), "--json"])
        ok(rc == 0 and os.path.exists(out_path),
           "--tune SCALING json --apply writes the plan")
        applied = _plan.load_plan(out_path)
        ok(applied["score"]["chips"] == 256, "applied plan scored @256")

        # -- the port's own evidence: a kineto-shaped capture (NCCL
        #    kernels under mxbkt scopes) attributed by traceview, then
        #    tuned on the bandwidth it measured
        from ..traceview import parse as _parse

        fx_path = os.path.join(os.path.dirname(_parse.__file__),
                               "fixture_kineto.json")
        with open(fx_path) as f:
            fx = json.load(f)
        summ = _parse.attribute(fx["trace"], plan_meta=fx["plan_meta"],
                                workload="fixture_kineto")
        summ_path = os.path.join(d, "traceview_summary_rank0.json")
        with open(summ_path, "w") as f:
            json.dump(summ, f)
        tm_k = _timing.load_any(summ_path)
        ok(tm_k.source.get("kind") == "trace" and tm_k.n_units == 2
           and tm_k.total_bytes == fx["plan_meta"]["total_bytes"],
           "kineto summary: the plan's 2 buckets are the units")
        ok(tm_k.step_time_s is not None and tm_k.measured_GBps
           and tm_k.measured_overlap_frac is not None,
           "kineto summary: step time, bandwidth and overlap measured")
        tuned_k = _search.tune(tm_k, chips=8)
        ok(tuned_k["assumptions"]["bandwidth_source"] == "trace",
           "kineto summary: tuned on the traced bandwidth")
        ok("overlap_calibration" in tuned_k["assumptions"]
           or tm_k.measured_overlap_frac >= 1.0,
           "kineto summary: the measured overlap calibrates the model")

    print("autotune self-test OK (%d checks)" % checks)
    return 0


def _run_tune(args) -> int:
    from . import plan as _plan
    from . import search as _search
    from . import timing as _timing

    model = _timing.load_any(args.tune, step_time_s=args.step_time,
                             dtype=args.dtype)
    tuned = _search.tune(model, chips=args.chips,
                         step_time_s=args.step_time,
                         ici_GBps=args.ici_gbps,
                         coll_latency_s=args.coll_latency)
    score = tuned["score"]
    if args.json:
        print(json.dumps(tuned))
    else:
        print("tuned plan over %d unit(s), %.1f MiB total (%s):"
              % (model.n_units, model.total_bytes / 1048576.0,
                 model.source.get("kind")))
        print("  caps: first %d B / mid %d B / last %d B -> %d bucket(s)"
              % (tuned["first_cap_bytes"], tuned["cap_bytes"],
                 tuned["last_cap_bytes"], tuned["n_buckets"]))
        print("  eff@%d: tuned %.4f vs 4 MiB default %.4f (%s)"
              % (score["chips"], score["eff"], score["default_eff"],
                 "beats default" if score["beats_default"]
                 else "DOES NOT beat default"))
        print("  assumptions: %s" % json.dumps(tuned["assumptions"]))
    if args.apply:
        from .. import env as _env

        out = args.out
        if out is None:
            d = _env.get_str("MXNET_AUTOTUNE_DIR")
            if not d:
                print("--apply needs --out or MXNET_AUTOTUNE_DIR",
                      file=sys.stderr)
                return 2
            out = _plan.default_plan_path(tuned, d)
        _plan.save_plan(tuned, out)
        print("plan -> %s" % out)
        print("activate with: export MXNET_AUTOTUNE_PLAN=%s" % out)
    return 0


def main(argv=None) -> int:
    from . import search as _search

    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.autotune",
        description=__doc__.splitlines()[0])
    ap.add_argument("--self-test", action="store_true",
                    help="synthetic end-to-end check")
    ap.add_argument("--tune", metavar="PATH",
                    help="traceview summary / flight dump / "
                         "--bucket-timings export / SCALING report to "
                         "tune from")
    ap.add_argument("--apply", action="store_true",
                    help="persist the tuned plan (with --tune)")
    ap.add_argument("--out", default=None,
                    help="plan output path for --apply (default: "
                         "MXNET_AUTOTUNE_DIR fingerprinted name)")
    ap.add_argument("--step-time", type=float, default=None,
                    help="measured single-chip step time in seconds "
                         "(required for flight-dump inputs)")
    ap.add_argument("--chips", type=int, default=256,
                    help="target chip count the sweep scores at")
    ap.add_argument("--ici-gbps", type=float, default=None,
                    help="the link bandwidth in GB/s (required when the "
                         "input measured none)")
    ap.add_argument("--coll-latency", type=float,
                    default=_search.DEFAULT_COLL_LATENCY_S,
                    help="the cost of one collective in seconds (default "
                         "the stated %g; tools/torch_autotune_scale.py "
                         "measures the card's)"
                         % _search.DEFAULT_COLL_LATENCY_S)
    ap.add_argument("--dtype", default=None,
                    help="which dtype block to read from a SCALING "
                         "report (default: bfloat16 if present)")
    ap.add_argument("--json", action="store_true",
                    help="emit the full plan JSON on stdout")
    args = ap.parse_args(argv)
    if args.self_test:
        return self_test()
    if args.tune:
        return _run_tune(args)
    ap.error("one of --self-test / --tune is required")
    return 2


if __name__ == "__main__":
    sys.exit(main())
