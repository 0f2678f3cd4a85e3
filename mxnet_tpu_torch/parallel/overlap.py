"""Measured overlap of the gradient exchange with compute, from a device
trace.

Counterpart: ``mxnet_tpu/parallel/overlap.py``.  The JAX package
AOT-compiles its step for an abstract TPU topology and walks the
scheduled HLO: FLOPs scheduled between each ``all-reduce-start`` /
``-done`` pair, converted to time at an assumed rate, against the
collective's time at an assumed bandwidth.  None of that exists in an
eager PyTorch step, so the HLO helpers (``hlo_bytes_in``,
``_conv_flops``, ``_dot_flops``, the computation parser) have no
counterpart here.  The port measures both quantities directly on a
torch.profiler (kineto) trace of its data-parallel step, where every
kernel has a device interval and, through kineto's correlation id, the
host launch and the ``mxbkt%03d`` / ``mxnet-*`` scopes around it
(``traceview.parse``):

  * :func:`schedule_overlap_from_trace` — for each bucket reduce (an
    NCCL kernel launched under an ``mxbkt`` scope; sync BatchNorm's and
    the loss mean's collectives are compute here, as in traceview), its
    device time ``t_comm_i`` and the part ``t_hidden_i`` of it that
    compute kernels cover: overlap = Σ min(t_comm_i, t_hidden_i) /
    Σ t_comm_i, the JAX package's formula.  It is the accounting of
    ``traceview.parse``'s ``overlap.overlap_frac`` (lanes and windows
    weighted alike), so on one trace the two give one number.
  * :func:`schedulable_overlap_from_trace` — the dataflow bound: bucket
    k could issue once the backward kernels producing its gradients
    have run (the start of its pack, the first kernel under its
    ``mxbkt`` scope) and must finish before the update (the first
    ``mxnet-opt`` kernel after it).  The compute time between the two,
    assigned earliest-first to the reductions in issue order without
    counting any time twice, is the most a schedule could hide; this
    one hides the measured figure.

:func:`measure_overlap` captures the port's data-parallel
``FusedTrainStep`` (ResNet-50 by default) through ``traceview.capture``
and returns both.  A one-rank group issues no bucket collective: the
result then says so, with a null overlap, and fabricates nothing.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

__all__ = ["schedule_overlap_from_trace", "schedulable_overlap_from_trace",
           "measure_overlap", "main"]


def _walk(trace: dict):
    """Per step window: ``(k, lanes)`` where each lane is ``(comm,
    comp, opt)`` — the window's bucket reduces ``(t0, t1, bucket)``,
    its compute intervals ``(t0, t1, bucket scope or None)`` and the
    starts of its optimizer kernels — clipped to the window as
    ``traceview.parse.attribute`` clips them (copies are neither)."""
    from ..traceview import parse as _parse

    events = trace.get("traceEvents") or []
    lanes, kineto = _parse._device_lanes(events)
    windows = _parse._step_windows(events)
    if not windows:
        ts = [float(e["ts"]) for evs in lanes.values() for e in evs]
        te = [float(e["ts"]) + float(e["dur"])
              for evs in lanes.values() for e in evs]
        windows = [(min(ts), max(te), 0, 1)] if ts else []
    out = []
    for t0, t1, _idx, k in windows:
        per_lane = []
        for evs in lanes.values():
            comm, comp, opt = [], [], []
            for e in evs:
                ts = float(e["ts"])
                lo, hi = max(ts, t0), min(ts + float(e["dur"]), t1)
                if hi <= lo:
                    continue
                name, scope = _parse._op_name(e), e.get("_scope")
                bucket = _parse._scope_bucket(scope)
                kind = _parse.classify_op(name)
                if kind == "comm" and (bucket is not None or not kineto):
                    comm.append((lo, hi, bucket))
                elif kind not in ("h2d", "d2h"):
                    comp.append((lo, hi, bucket))
                    phase = _parse._scope_phase(str(e.get("name") or "")) \
                        or _parse._scope_phase(scope or "")
                    if phase == "optimizer" and bucket is None:
                        opt.append(lo)
            if comm or comp:
                per_lane.append((comm, comp, opt))
        if per_lane:
            out.append((max(int(k), 1), per_lane))
    return out


def _covered(a: float, b: float, union: List[Tuple[float, float]]) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in union)


def _rows(per_bucket: Dict, plan_meta: Optional[dict]) -> List[dict]:
    plan = {int(r["bucket"]): r for r in (plan_meta or {}).get("buckets")
            or []}
    rows = []
    for j in sorted(per_bucket, key=lambda v: (v is None, v)):
        comm, hid = per_bucket[j]
        rows.append({"bucket": j,
                     "bytes": plan.get(j, {}).get("bytes")
                     if j is not None else None,
                     "comm_s_per_step": comm, "hidden_s_per_step": hid})
    return rows


def _result(key: str, walked, comm_tot, hid_tot, n_red, per_bucket,
            plan_meta, method) -> Dict:
    n_steps = len(walked)
    out = {"n_steps": n_steps,
           "n_reduction_ops": n_red / n_steps if n_steps else 0,
           "comm_s_per_step": comm_tot / n_steps if n_steps else 0.0,
           "hidden_s_per_step": hid_tot / n_steps if n_steps else 0.0,
           key: (hid_tot / comm_tot) if comm_tot > 0 else None,
           "buckets": _rows({j: (c / n_steps, h / n_steps)
                             for j, (c, h) in per_bucket.items()},
                            plan_meta),
           "method": method, "source": "trace"}
    if comm_tot <= 0:
        out["reason"] = ("no bucket reduce in the trace: a one-rank group "
                         "issues no bucket collective"
                         if n_steps else "no step window with device "
                         "activity in the trace")
    return out


def _load(trace_or_summary):
    if isinstance(trace_or_summary, str):
        from ..traceview import parse as _parse

        return _parse.load_trace(trace_or_summary)
    return trace_or_summary


def schedule_overlap_from_trace(trace_or_summary,
                                plan_meta: Optional[dict] = None) -> Dict:
    """The measured overlap of the bucket exchange: per bucket reduce,
    its device time and the part of it compute covers; ``overlap_measured``
    = Σ min(t_comm, t_hidden) / Σ t_comm over the step windows, per step
    and lane as ``traceview.parse`` weights them (None without any
    bucket reduce, with ``reason``).  ``trace_or_summary``: a kineto
    chrome trace (dict or path) or a traceview summary (whose overlap
    block is the same figure; per-bucket hidden time is then None).
    ``plan_meta`` names each bucket's bytes."""
    payload = _load(trace_or_summary)
    from ..traceview import parse as _parse

    if _parse.is_traceview_summary(payload):
        ov = payload.get("overlap") or {}
        out = {"n_steps": (payload.get("steps") or {}).get("n"),
               "comm_s_per_step": ov.get("comm_s_per_step"),
               "hidden_s_per_step": ov.get("overlapped_s_per_step"),
               "overlap_measured": ov.get("overlap_frac"),
               "buckets": [{"bucket": b.get("bucket"),
                            "bytes": b.get("bytes"),
                            "comm_s_per_step": b.get("device_s_per_step"),
                            "hidden_s_per_step": None}
                           for b in payload.get("buckets") or []],
               "method": "traceview summary overlap block",
               "source": "summary"}
        if out["overlap_measured"] is None:
            out["reason"] = "the summary holds no bucket reduce"
        return out
    walked = _walk(payload)
    comm_tot = hid_tot = 0.0
    n_red = 0
    per_bucket: Dict = {}
    for k, lanes in walked:
        w = 1e-6 / (len(lanes) * k)
        for comm, comp, _opt in lanes:
            union = _parse._union([(a, b) for a, b, _j in comp])
            for a, b, j in comm:
                t_comm = b - a
                t_hid = min(t_comm, _covered(a, b, union))
                comm_tot += t_comm * w
                hid_tot += t_hid * w
                c, h = per_bucket.get(j, (0.0, 0.0))
                per_bucket[j] = (c + t_comm * w, h + t_hid * w)
            n_red += len(comm) / (len(lanes) * k)
    return _result("overlap_measured", walked, comm_tot, hid_tot, n_red,
                   per_bucket, plan_meta,
                   "device trace: compute kernels' time under each bucket "
                   "reduce's device interval over the reduce's time")


def schedulable_overlap_from_trace(trace, plan_meta: Optional[dict] = None
                                   ) -> Dict:
    """The dataflow bound on the bucket exchange's overlap: each bucket
    reduce may start once its bucket's gradients exist (its pack, the
    first kernel under its ``mxbkt`` scope before it; the reduce's own
    start without one) and must end before the update (the first
    optimizer kernel after that); the compute time in that span, handed
    out earliest-first to the reduces in issue order and never twice,
    up to each reduce's device time, is the most any schedule could
    hide.  ``overlap_schedulable`` = Σ that / Σ t_comm (None without a
    bucket reduce).  An upper bound, not a measured schedule."""
    payload = _load(trace)
    from ..traceview import parse as _parse

    if _parse.is_traceview_summary(payload):
        raise ValueError("the dataflow bound needs the trace itself (its "
                         "kernels and scopes), not a summary")
    walked = _walk(payload)
    comm_tot = hid_tot = 0.0
    n_red = 0
    per_bucket: Dict = {}
    for k, lanes in walked:
        w = 1e-6 / (len(lanes) * k)
        for comm, comp, opt in lanes:
            union = _parse._union([(a, b) for a, b, _j in comp])
            taken: List[Tuple[float, float]] = []
            for a, b, j in sorted(comm):
                packs = [x for x, _y, jj in comp if jj == j and x <= a]
                ready = max(packs) if packs and j is not None else a
                later = [t for t in opt if t >= ready]
                deadline = min(later) if later else max(
                    [y for _x, y, _j in comp] + [b])
                need, got = b - a, 0.0
                for x, y in union:
                    x, y = max(x, ready), min(y, deadline)
                    for free_a, free_b in list(_free(x, y, taken)):
                        if got >= need:
                            break
                        use = min(free_b - free_a, need - got)
                        taken.append((free_a, free_a + use))
                        got += use
                    if got >= need:
                        break
                taken = _parse._union(taken)
                comm_tot += need * w
                hid_tot += got * w
                c, h = per_bucket.get(j, (0.0, 0.0))
                per_bucket[j] = (c + need * w, h + got * w)
            n_red += len(comm) / (len(lanes) * k)
    return _result("overlap_schedulable", walked, comm_tot, hid_tot, n_red,
                   per_bucket, plan_meta,
                   "dataflow bound: compute between each bucket's pack and "
                   "the update, assigned earliest-first to the reduces in "
                   "issue order (an upper bound, not a measured schedule)")


def _free(x: float, y: float, taken: List[Tuple[float, float]]):
    """The parts of [x, y) that no interval of ``taken`` (a union)
    holds, in time order."""
    cur = x
    for a, b in taken:
        if b <= cur or a >= y:
            continue
        if a > cur:
            yield cur, min(a, y)
        cur = max(cur, b)
        if cur >= y:
            return
    if cur < y:
        yield cur, y


# ---------------------------------------------------------------------------
# the live measurement
# ---------------------------------------------------------------------------
def _overlap_rank(spec: dict) -> dict:
    """One rank: the zoo model through the data-parallel FusedTrainStep,
    one untraced call, then ``steps`` traced windows armed through
    ``MXNET_TRACE_DIR``; rank 0's trace measured both ways."""
    import numpy as np
    import torch

    from .. import context as _context
    from .. import dist, gluon
    from .. import initializer as init
    from .. import random as _random
    from ..gluon.model_zoo import vision
    from ..ndarray import NDArray
    from ..traceview import capture as _capture
    from ..traceview import parse as _parse
    from . import dp as _dp
    from .mesh import data_parallel_mesh

    dev = dist.device()
    ctx = _context.Context("cpu") if dev.type == "cpu" \
        else _context.Context("gpu", dev.index or 0)
    mesh = data_parallel_mesh()
    np.random.seed(0)
    _random.seed(0)
    with ctx:
        net = getattr(vision, spec["model"])(classes=spec["classes"])
        net.initialize(init.Xavier(), ctx=ctx)
        rng = np.random.RandomState(0)
        b, s = spec["batch"] * mesh.size, spec["image"]
        x = NDArray.from_raw(torch.as_tensor(
            rng.uniform(size=(b, 3, s, s)).astype("float32")).to(dev), ctx)
        y = NDArray.from_raw(torch.as_tensor(
            (np.arange(b) % spec["classes"]).astype("float32")).to(dev),
            ctx)
        step = _dp.FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                  mesh=mesh, learning_rate=0.05,
                                  momentum=0.9, dtype=spec["dtype"])
        trace_dir = spec["trace_dir"] or tempfile.mkdtemp(
            prefix="mxoverlap_")
        saved = {k: os.environ.get(k)
                 for k in ("MXNET_TRACE_DIR", "MXNET_TRACE_STEPS")}
        _capture.reset()
        os.environ.update(MXNET_TRACE_DIR=os.path.join(
            trace_dir, "rank%d" % dist.rank()),
            MXNET_TRACE_STEPS=str(spec["steps"]))
        try:
            for _ in range(spec["steps"] + 1):
                step.run_steps(x, y, steps=1).asnumpy()
            summ = _capture.last_summary()
        finally:
            for key, v in saved.items():
                if v is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = v
            _capture.reset()
        if summ is None:
            raise RuntimeError("measure_overlap: the capture wrote no "
                               "summary")
        trace = _parse.load_trace(summ["capture"]["trace_path"])
        if not spec["trace_dir"]:
            shutil.rmtree(trace_dir, ignore_errors=True)
    meta = step.bucket_plan_meta()
    measured = schedule_overlap_from_trace(trace, meta)
    bound = schedulable_overlap_from_trace(trace, meta)
    return {"rank": dist.rank(), "n_ranks": mesh.size,
            "model": "%s dp=%d, %s, batch %d a rank"
            % (spec["model"], mesh.size, spec["dtype"] or "float32",
               spec["batch"]),
            "device": str(dev),
            "overlap_measured": measured["overlap_measured"],
            "overlap_schedulable_bound": bound["overlap_schedulable"],
            "traceview_overlap_frac": summ["overlap"]["overlap_frac"],
            "reason": measured.get("reason"),
            "n_reduction_ops": measured["n_reduction_ops"],
            "comm_s_per_step": measured["comm_s_per_step"],
            "hidden_s_per_step": measured["hidden_s_per_step"],
            "schedulable_hidden_s_per_step": bound["hidden_s_per_step"],
            "step_s": summ["steps"]["mean_s"],
            "n_steps": summ["steps"]["n"],
            "buckets": measured["buckets"],
            "bound_buckets": bound["buckets"],
            "plan": meta,
            "lost_launches": summ["capture"]["lost_launches"],
            "trace_path": summ["capture"]["trace_path"]
            if spec["trace_dir"] else None}


def measure_overlap(steps: int = 3, *, batch: int = 32,
                    ranks: Optional[int] = None, device=None,
                    backend: Optional[str] = None,
                    dtype: Optional[str] = "bfloat16",
                    model: str = "resnet50_v1", classes: int = 1000,
                    image: int = 224, trace_dir: Optional[str] = None,
                    timeout: float = 900.0) -> Dict:
    """Capture ``steps`` windows of the port's data-parallel
    ``FusedTrainStep`` (``model`` from the zoo, ``batch`` rows a rank)
    on ``ranks`` processes (default: one a visible card; ``device``
    ``"cpu"`` runs gloo ranks on the CPU, where the capture holds no
    device kernels) and return rank 0's measured overlap and dataflow
    bound beside traceview's ``overlap_frac``.  One rank issues no
    bucket collective: both are then None and ``reason`` says why.
    ``trace_dir`` keeps the traces (default: a temporary directory)."""
    import torch

    from .. import dist
    from .scaling import require_device

    require_device(device, "overlap.measure_overlap")
    if ranks is None:
        ranks = 1 if device is not None and \
            torch.device(device).type == "cpu" \
            else max(torch.cuda.device_count(), 1)
    spec = {"steps": int(steps), "batch": int(batch), "dtype": dtype,
            "model": model, "classes": int(classes), "image": int(image),
            "trace_dir": trace_dir}
    return dist.launch(_overlap_rank, int(ranks), (spec,), backend=backend,
                       device=device, timeout_s=timeout)[0]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.parallel.overlap",
        description="measured and schedulable overlap of the bucket "
                    "exchange, from a device trace")
    ap.add_argument("--self-test", action="store_true",
                    help="check both measures on the kineto fixture "
                         "against their hand-computed values")
    ap.add_argument("--trace", default=None,
                    help="a torch.profiler chrome trace to measure")
    ap.add_argument("--plan", default=None,
                    help="a plan_meta JSON naming the buckets' bytes")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="the ranks' device (default: the card)")
    args = ap.parse_args(argv)

    if args.self_test:
        return _self_test()
    if args.trace:
        plan = None
        if args.plan:
            with open(args.plan) as f:
                plan = json.load(f)
        out = schedule_overlap_from_trace(args.trace, plan)
        out["schedulable_bound"] = schedulable_overlap_from_trace(
            args.trace, plan)
        print(json.dumps(out))
        return 0
    print(json.dumps(measure_overlap(args.steps, batch=args.batch,
                                     ranks=args.ranks,
                                     device=args.device)))
    return 0


def _self_test() -> int:
    """The kineto fixture of traceview (2 steps; bucket 0's reduce under
    the backward kernels, bucket 1's partly after them): measured 195 of
    220 µs a step hidden, the bound the same (each reduce already
    issues as its gradients exist), and traceview's overlap_frac equal
    to the measured one."""
    from ..traceview import parse as _parse

    path = os.path.join(os.path.dirname(_parse.__file__),
                        "fixture_kineto.json")
    with open(path) as f:
        fx = json.load(f)
    m = schedule_overlap_from_trace(fx["trace"], fx["plan_meta"])
    b = schedulable_overlap_from_trace(fx["trace"], fx["plan_meta"])
    summ = _parse.attribute(fx["trace"], plan_meta=fx["plan_meta"])
    checks = {
        "measured==195/220": abs(m["overlap_measured"] - 195 / 220) < 1e-12,
        "measured==traceview": abs(m["overlap_measured"]
                                   - summ["overlap"]["overlap_frac"])
        < 1e-12,
        "bucket_rows==2": [r["bucket"] for r in m["buckets"]] == [0, 1],
        "bound==195/220": abs(b["overlap_schedulable"] - 195 / 220) < 1e-12,
        "reduces_per_step==2": m["n_reduction_ops"] == 2,
    }
    ok = all(checks.values())
    print(json.dumps({"self_test_ok": ok, "checks": checks}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
