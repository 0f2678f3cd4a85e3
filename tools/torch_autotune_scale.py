"""The bucket autotuner's loop on a four-card NVLinked machine.

    python3 tools/torch_autotune_scale.py [--ranks N] [--steps S] [--out DIR]

Trains ResNet-50 v1 bf16 at batch 32 a card through the data-parallel
``FusedTrainStep`` over NCCL, one process a card (default: every
visible card), first under the default 4 MiB bucket caps, then under
the plan that ``python -m mxnet_tpu_torch.autotune --tune`` makes from
the first run's traceview summary (its measured link bandwidth, scored
at N ranks), with the stated 5 µs a collective and then with the
launch cost the first run measured (``--coll-latency``).  Before them,
the same step on one card: the time the efficiency is taken against.
For each plan, rank 0 reports:

  * step ms (S timed steps after 2 warm-ups, the card synchronized);
  * efficiency: one card's step ms over this step's (the same batch a
    card);
  * measured and schedulable overlap of the bucket exchange
    (``parallel.overlap`` on a trace of 3 windows), traceview's
    ``overlap_frac`` beside;
  * exposed NCCL ms a step: NCCL kernel time no compute kernel covers
    (bucket reduces and sync BatchNorm's collectives alike);
  * ``scaling.project_efficiency_bucketed``'s prediction for the plan's
    buckets (and the default's) at N ranks, from one card's step time,
    the measured bandwidth and the plan's collective cost;
  * and, once, the cost of one small NCCL all-reduce (4 floats) over the
    N ranks: host microseconds to issue it, and microseconds a call
    with the card synchronized after each.

One JSON line a run, the card's name and power limit first; the
summaries and plans land in ``--out`` (default: a new temporary
directory, printed).  Needs CUDA devices; a dp run needs at least
two.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

BATCH = 32
WINDOWS = 3


def _exposed_nccl_ms(trace) -> float:
    """NCCL kernel ms a step that no other kernel overlaps."""
    from mxnet_tpu_torch.traceview import parse

    events = trace["traceEvents"]
    lanes, _ = parse._device_lanes(events)
    wins = parse._step_windows(events)
    tot = 0.0
    for t0, t1, _i, k in wins:
        for evs in lanes.values():
            nccl, comp = [], []
            for e in evs:
                a = max(float(e["ts"]), t0)
                b = min(float(e["ts"]) + float(e["dur"]), t1)
                if b <= a or e.get("cat") != "kernel":
                    continue
                (nccl if "nccl" in str(e["name"]).lower()
                 else comp).append((a, b))
            nu, cu = parse._union(nccl), parse._union(comp)
            tot += (sum(b - a for a, b in nu)
                    - parse._intersect_total(nu, cu)) / 1e3 / max(k, 1)
    return tot / max(len(wins), 1)


def _per_call_us(fn, n=200, sync_each=False):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        if sync_each:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def _rank(spec):
    import torch.distributed as tdist

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist, gluon
    from mxnet_tpu_torch.parallel import overlap
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh
    from mxnet_tpu_torch.traceview import parse

    if spec["plan"]:
        os.environ["MXNET_AUTOTUNE_PLAN"] = spec["plan"]
    mesh = data_parallel_mesh()
    ctx = mx.gpu(dist.device().index)
    data, label = cs.train_batch(BATCH * mesh.size, ctx)
    step = FusedTrainStep(cs.resnet50(ctx),
                          gluon.loss.SoftmaxCrossEntropyLoss(), mesh=mesh,
                          learning_rate=cs.TRAIN_LR,
                          momentum=cs.TRAIN_MOMENTUM, dtype="bfloat16")
    for _ in range(2):
        step.run_steps(data, label, steps=1).asnumpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(spec["steps"]):
        step.run_steps(data, label, steps=1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / spec["steps"] * 1e3
    tdir = Path(spec["out"]) / spec["tag"] / ("rank%d" % dist.rank())
    with cs._trace_armed(tdir, WINDOWS) as capture:
        for _ in range(WINDOWS + 1):
            step.run_steps(data, label, steps=1).asnumpy()
        summ, _wins = cs._captured(capture, spec["tag"])
    trace = parse.load_trace(summ["capture"]["trace_path"])
    meta = step.bucket_plan_meta()
    out = {"tag": spec["tag"], "ranks": mesh.size, "rank": dist.rank(),
           "step_ms": step_ms, "images_per_s": BATCH * mesh.size /
           step_ms * 1e3,
           "n_buckets": meta["n_buckets"] if meta else None,
           "bucket_bytes": [b["bytes"] for b in meta["buckets"]]
           if meta else None,
           "autotune": (meta or {}).get("autotune"),
           "lost_launches": summ["capture"]["lost_launches"],
           "traced_step_ms": summ["steps"]["mean_s"] * 1e3,
           "busy_ms": cs._busy_ms(summ),
           "exposed_nccl_ms": _exposed_nccl_ms(trace),
           "summary_path": str(tdir / ("traceview_summary_rank%d.json"
                                       % dist.rank()))}
    if meta:
        m = overlap.schedule_overlap_from_trace(trace, meta)
        b = overlap.schedulable_overlap_from_trace(trace, meta)
        out.update(overlap_measured=m["overlap_measured"],
                   overlap_schedulable=b["overlap_schedulable"],
                   traceview_overlap_frac=summ["overlap"]["overlap_frac"],
                   bucket_comm_ms=m["comm_s_per_step"] * 1e3,
                   bucket_hidden_ms=m["hidden_s_per_step"] * 1e3,
                   measured_GBps=[r.get("measured_GBps")
                                  for r in summ["buckets"]],
                   reason=m.get("reason"))
    # the raw trace is large; the summary stays beside the plan
    os.remove(summ["capture"]["trace_path"])
    if spec["launch_cost"] and mesh.size > 1:
        x = torch.zeros(4, device=dist.device())
        out["nccl_allreduce_4floats"] = {
            "host_issue_us": _per_call_us(
                lambda: tdist.all_reduce(x, async_op=True)),
            "synchronized_us": _per_call_us(
                lambda: tdist.all_reduce(x), sync_each=True)}
    return out


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="directory for the summaries and plans")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_autotune_scale: no CUDA device")
    n = args.ranks or torch.cuda.device_count()
    if n < 2 or n > torch.cuda.device_count():
        raise SystemExit("torch_autotune_scale: %d ranks on %d card(s): "
                         "needs 2 or more, one a card"
                         % (n, torch.cuda.device_count()))
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.autotune import load_plan
    from mxnet_tpu_torch.parallel import scaling

    print(_card(), flush=True)
    out = Path(args.out or tempfile.mkdtemp(prefix="autotune_scale_"))
    out.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"out": str(out)}), flush=True)
    spec = {"steps": args.steps, "out": str(out), "plan": None,
            "launch_cost": False}
    one = dist.launch(_rank, 1, (dict(spec, tag="one_card"),),
                      backend="nccl", timeout_s=900)[0]
    print(json.dumps(one), flush=True)
    default = dist.launch(_rank, n, (dict(spec, tag="default",
                                          launch_cost=True),),
                          backend="nccl", timeout_s=900)[0]
    default["efficiency_vs_one_card"] = one["step_ms"] / default["step_ms"]
    print(json.dumps(default), flush=True)
    measured_s = default["nccl_allreduce_4floats"]["synchronized_us"] * 1e-6
    for tag, latency in (("tuned", None), ("tuned_measured_latency",
                                           measured_s)):
        plan_path = out / (tag + ".json")
        cmd = [sys.executable, "-m", "mxnet_tpu_torch.autotune", "--tune",
               default["summary_path"], "--apply", "--out", str(plan_path),
               "--chips", str(n)]
        if latency is not None:
            cmd += ["--coll-latency", repr(latency)]
        tune = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, cwd=str(ROOT))
        if tune.returncode != 0:
            raise SystemExit("autotune --tune failed:\n" + tune.stdout +
                             tune.stderr)
        plan = load_plan(str(plan_path))
        run = dist.launch(_rank, n, (dict(spec, tag=tag,
                                          plan=str(plan_path)),),
                          backend="nccl", timeout_s=900)[0]
        run["efficiency_vs_one_card"] = one["step_ms"] / run["step_ms"]
        kw = dict(chips=(n,), ici_GBps=plan["assumptions"]["ici_GBps"],
                  readiness="bytes",
                  coll_latency_s=plan["assumptions"]["coll_latency_s"])
        run["predicted"] = scaling.project_efficiency_bucketed(
            run["bucket_bytes"], one["step_ms"] / 1e3,
            **kw)["projected_efficiency"][str(n)]
        run["predicted_default"] = scaling.project_efficiency_bucketed(
            default["bucket_bytes"], one["step_ms"] / 1e3,
            **kw)["projected_efficiency"][str(n)]
        run["plan"] = {k: plan[k] for k in (
            "cap_bytes", "first_cap_bytes", "last_cap_bytes", "n_buckets",
            "assumptions")}
        run["plan"]["score"] = {k: v for k, v in plan["score"].items()
                                if k != "measured"}
        print(json.dumps(run), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
