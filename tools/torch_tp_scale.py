"""Tensor-parallel scaling on a four-card machine (NCCL, one rank a card).

    python3 tools/torch_tp_scale.py

ResNet-50 v1 bf16 at batch 128 a dp rank, 224², SGD lr 0.05 momentum
0.9 (``chip_smoke``'s ``train`` cell) through ``FusedTrainStep`` over a
("dp", "mp") mesh of the four cards at dp=4, dp=2 x mp=2 and mp=4, with
``chip_smoke.tp_resnet_spec`` over mp (the classifier and every conv of
at least 256 output channels).  Prints one JSON line a mesh: img/s, the
efficiency against the cards times the one-card rate of the same step
(measured first, in this process), the parameter + momenta bytes a
rank, and from rank 0's trace of two steps the NCCL device ms a step and
the part of it no compute kernel overlaps (exposed), split into the mp
and the dp collectives by the stream they ran on (each process group
has its own: the mp group's stream is the one with all-gathers).
Needs four cards.
"""
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

MESHES = ((4, 1), (2, 2), (1, 4))
BATCH, WARMUP, STEPS, PROFILE = 128, 2, 5, 2


def _exposed(kernels, mine):
    """Device ms of the kernels ``mine`` and the part of it that no other
    kernel of ``kernels`` overlaps."""
    import bisect

    others = sorted((s, e) for s, e, n, _ in kernels
                    if (s, e, n, _) not in mine)
    merged = []
    for s, e in others:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [m[0] for m in merged]
    busy = exposed = 0.0
    for s, e, _, _ in mine:
        hidden = 0.0
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(merged) and merged[i][0] < e:
            hidden += max(0.0, min(e, merged[i][1]) - max(s, merged[i][0]))
            i += 1
        busy += e - s
        exposed += (e - s) - hidden
    return busy / 1e3, exposed / 1e3


def trace_split(path, steps):
    """NCCL ms a step from a chrome trace, by group (mp: the streams
    with all-gathers; dp: the other NCCL streams)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e.get("args", {}).get("stream"))
            for e in events if e.get("cat") == "kernel"]
    nccl = [k for k in kern if "nccl" in k[2].lower()]
    mp_streams = {k[3] for k in nccl if "AllGather" in k[2]}
    out = {}
    compute = [k for k in kern if k not in nccl]
    for group, ks in (("mp", [k for k in nccl if k[3] in mp_streams]),
                      ("dp", [k for k in nccl if k[3] not in mp_streams])):
        busy, exposed = _exposed(compute + ks, ks)
        out[group] = {"launches_per_step": len(ks) / steps,
                      "device_ms_per_step": busy / steps,
                      "exposed_ms_per_step": exposed / steps,
                      "kernels": sorted({k[2][:48] for k in ks})}
    out["device_busy_ms_per_step"] = sum(e - s for s, e, _, _ in kern) \
        / 1e3 / steps
    return out


def _step(mesh, mp):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist, gluon
    from mxnet_tpu_torch.parallel import tensor
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    ctx = mx.gpu(dist.device().index if mesh is not None else 0)
    net = cs.resnet50(ctx)
    n_dp = mesh.axis_size("dp") if mesh is not None else 1
    data, label = cs.train_batch(BATCH * n_dp, ctx)
    spec = cs.tp_resnet_spec(tensor.P, mp) if mp > 1 else None
    step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                          mesh=mesh, learning_rate=cs.TRAIN_LR,
                          momentum=cs.TRAIN_MOMENTUM, dtype="bfloat16",
                          param_spec_fn=spec)
    return step, data, label


def _timed(step, data, label):
    warm = step.run_steps(data, label, steps=WARMUP).asnumpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = step.run_steps(data, label, steps=STEPS).asnumpy()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / STEPS * 1e3, warm, losses


def _rank(shape, trace_dir):
    """One rank of a mesh: warm-up, timed steps, then two steps that
    rank 0 traces."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.parallel.mesh import make_mesh

    cs._rank_setup()
    mesh = make_mesh(shape, ("dp", "mp"))
    step, data, label = _step(mesh, shape[1])
    torch.cuda.reset_peak_memory_stats()
    step_ms, warm, losses = _timed(step, data, label)
    row = {"step_ms": step_ms, "first_loss": float(warm[0]),
           "last_loss": float(losses[-1]),
           "param_bytes": step.param_bytes_per_rank(),
           "momenta_bytes": step.optimizer_state_bytes_per_rank(),
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    rec = mesh.rank == 0
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) if rec else None
    if rec:
        prof.__enter__()
    step.run_steps(data, label, steps=PROFILE)
    torch.cuda.synchronize()
    if rec:
        prof.__exit__(None, None, None)
        path = os.path.join(trace_dir, "dp%d_mp%d.json" % shape)
        prof.export_chrome_trace(path)
        try:
            row["profile"] = trace_split(path, PROFILE)
        except (KeyError, ValueError, TypeError) as e:
            # the timed numbers above stand without the split
            row["profile"] = {"error": repr(e)}
    return row


def main() -> int:
    if torch.cuda.device_count() < 4:
        raise SystemExit("torch_tp_scale: needs four cards, found %d"
                         % torch.cuda.device_count())
    from mxnet_tpu_torch import dist

    cs.phase_device()
    step, data, label = _step(None, 1)
    one_ms, _, _ = _timed(step, data, label)
    one = BATCH / one_ms * 1e3
    del step, data, label
    torch.cuda.empty_cache()
    cs.emit({"phase": "tp_scale_one_card", "step_ms": one_ms,
             "images_per_s": one})
    trace_dir = tempfile.mkdtemp(prefix="tp_scale_")
    for shape in MESHES:
        t0 = time.perf_counter()
        ranks = dist.launch(_rank, 4, (shape, trace_dir), backend="nccl",
                            timeout_s=900)
        r0 = ranks[0]
        step_ms = statistics.median(r["step_ms"] for r in ranks)
        ips = BATCH * shape[0] / step_ms * 1e3
        row = {"phase": "tp_scale", "mesh": {"dp": shape[0],
                                             "mp": shape[1]},
               "model": "resnet50_v1", "dtype": "bfloat16",
               "batch_per_dp_rank": BATCH, "images_per_s": ips,
               "step_ms": step_ms,
               "efficiency": ips / (4 * one),
               "state_bytes_per_rank": r0["param_bytes"] +
               r0["momenta_bytes"],
               "ranks": ranks, "wall_s": time.perf_counter() - t0}
        cs.emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
