"""Scaling: the rank sweep, collective accounting from a trace, and the
bucket-pipeline projection.

Counterpart: ``mxnet_tpu/parallel/scaling.py``.  Three pieces:

1. :func:`sweep` / :func:`control_sweep` — the fused train step at each
   rank count, each count a fresh set of processes (``dist.launch``:
   one process a device, gloo on the CPU or by name, NCCL on cards),
   the same seeds and the same global batch everywhere; each count's
   loss trajectory is held against the one-rank run (float32; float64
   and a zero learning rate for the control).  The JAX package runs
   virtual devices through ``XLA_FLAGS``; the port runs real ranks, so
   a rank count the machine cannot give raises.
2. :func:`collective_stats` / :func:`reduction_accounting` — what the
   step puts on the wire, by verb.  The JAX package parses compiled
   HLO; the port reads a torch.profiler trace (kineto chrome export) or
   a traceview summary: counts and payload bytes a step from the
   ``record_param_comms`` events ``torch.distributed`` records on NCCL
   (``Collective name``, ``In msg nelems`` / ``Out msg nelems``,
   ``dtype``, ``Group size``), else from its ``c10d::*`` ops (gloo;
   bytes from their recorded input shapes when the capture kept them);
   kernel launches from the ``ncclDevKernel_*`` / ``ncclKernel_*``
   device events.
3. :func:`simulate_bucketed_overlap` / :func:`project_efficiency_bucketed`
   / :func:`project_efficiency` — the JAX package's pure cost model,
   copied: eff(n) = t_step / (t_step + exposed(n)).  The link bandwidth
   (``ici_GBps``, the name kept for parity: GB/s of whatever link the
   ranks share) has no default here; the caller passes a measured or
   stated figure, else these raise.

:func:`mp_placement_sweep` (the JAX package's model-parallel LSTM) runs
the reference's ``example/model-parallel/lstm/lstm.py``, which is not in
this repository (ROADMAP A12.4): it raises.
"""
from __future__ import annotations

import re
import shutil
import tempfile
from typing import Dict, List, Optional, Sequence

__all__ = [
    "collective_stats", "reduction_accounting", "sweep", "control_sweep",
    "mp_placement_sweep", "grad_entries", "grad_leaf_bytes",
    "resnet50_grad_entries", "resnet50_grad_leaf_bytes",
    "resnet50_bucket_bytes", "resnet50_grad_bytes",
    "simulate_bucketed_overlap", "project_efficiency_bucketed",
    "project_efficiency",
]

#: kineto's host event for one collective, with its size and group
PARAM_COMMS = "record_param_comms"
#: ``c10d::`` ops that are bookkeeping, not traffic
_NOT_TRAFFIC = ("barrier", "init", "wait", "monitored_barrier")
#: kineto's ``dtype`` spellings (c10 ScalarType names) → bytes
_SCALAR_BYTES = {"double": 8, "float": 4, "bfloat16": 2, "half": 2,
                 "long": 8, "int": 4, "short": 2, "char": 1, "byte": 1,
                 "bool": 1, "float64": 8, "float32": 4, "float16": 2,
                 "int64": 8, "int32": 4, "int8": 1, "uint8": 1}
_NCCL_KERNEL_RE = re.compile(r"nccl(?:Dev)?Kernel_([A-Za-z]+)")


def _verb(name: str) -> Optional[str]:
    """The JAX package's HLO name for one torch collective name
    (``allreduce``, ``c10d::_allgather_base_``, ``AllReduce``, ...);
    None for bookkeeping (barrier, init)."""
    n = name.lower().replace("c10d::", "").strip("_")
    if any(n.startswith(b) for b in _NOT_TRAFFIC):
        return None
    n = n.replace("_", "")
    if "allreduce" in n:
        return "all-reduce"
    if "allgather" in n:
        return "all-gather"
    if "reducescatter" in n:
        return "reduce-scatter"
    if "alltoall" in n:
        return "all-to-all"
    if n.startswith(("send", "recv")):
        return "collective-permute"
    if "broadcast" in n:
        return "broadcast"
    if n.startswith("reduce"):
        return "reduce"
    return n or None


def _events(trace) -> list:
    if isinstance(trace, str):
        from ..traceview import parse as _parse

        trace = _parse.load_trace(trace)
    return trace.get("traceEvents") or []


def _windows(events):
    """(t0, t1, micro-steps) per step annotation; the whole capture as
    one step without any."""
    from ..traceview import parse as _parse

    wins = [(t0, t1, k) for t0, t1, _i, k in _parse._step_windows(events)]
    return wins or [(float("-inf"), float("inf"), 1)]


def _shape_payload(args: dict):
    """``(elements, bytes)`` of a ``c10d::`` op's first tensor (or tensor
    list) from its recorded input shapes: ``bytes`` None where the trace
    names no dtype (a tensor list), both None without shapes."""
    dims, types = args.get("Input Dims"), args.get("Input type")
    if not dims or not types:
        return None, None
    for d, t in zip(dims, types):
        if not d:
            continue
        shapes = d if isinstance(d[0], list) else [d]
        n_el = 0
        for shp in shapes:
            n = 1
            for x in shp:
                n *= int(x)
            n_el += n
        size = _SCALAR_BYTES.get(str(t).lower().replace("c10::", ""))
        return n_el, None if size is None else n_el * size
    return None, None


def _calls(events) -> List[dict]:
    """One row per host collective call, time-ordered: ``{"ts", "op",
    "elements", "bytes", "group_size", "name"}``.  ``record_param_comms``
    rows win; without any (gloo), the ``c10d::`` ops."""
    rows = []
    for e in events:
        if e.get("ph") != "X" or e.get("name") != PARAM_COMMS:
            continue
        a = e.get("args") or {}
        op = _verb(str(a.get("Collective name") or ""))
        if op is None:
            continue
        nel = a.get("Out msg nelems", a.get("In msg nelems"))
        size = _SCALAR_BYTES.get(str(a.get("dtype") or "").lower())
        rows.append({"ts": float(e["ts"]), "op": op,
                     "elements": None if nel is None else int(nel),
                     "bytes": None if nel is None or size is None
                     else int(nel) * size,
                     "group_size": a.get("Group size"),
                     "name": a.get("Collective name")})
    if not rows:
        for e in events:
            name = str(e.get("name") or "")
            if e.get("ph") != "X" or e.get("cat") != "cpu_op" or \
                    not name.startswith("c10d::"):
                continue
            op = _verb(name)
            if op is None:
                continue
            n_el, nbytes = _shape_payload(e.get("args") or {})
            rows.append({"ts": float(e["ts"]), "op": op,
                         "elements": n_el, "bytes": nbytes,
                         "group_size": None, "name": name})
    rows.sort(key=lambda r: r["ts"])
    return rows


def _kernels(events) -> List[dict]:
    """NCCL device events: ``{"ts", "op"}`` (the launch's host time
    where the trace links it)."""
    launch = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") == "X" and corr is not None and \
                e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launch[corr] = float(e["ts"])
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        m = _NCCL_KERNEL_RE.search(str(e.get("name") or ""))
        if m is None:
            continue
        corr = (e.get("args") or {}).get("correlation")
        out.append({"ts": launch.get(corr, float(e["ts"])),
                    "op": _verb(m.group(1)) or m.group(1)})
    return out


def _from_summary(summary: dict) -> Dict[str, Dict[str, float]]:
    rows = [b for b in summary.get("buckets") or [] if b.get("bytes")]
    if not rows:
        return {}
    return {"all-reduce": {"count": len(rows), "elements": None,
                           "bytes": float(sum(int(b["bytes"])
                                              for b in rows)),
                           "kernels": None}}


def collective_stats(trace_or_summary) -> Dict[str, Dict[str, float]]:
    """Collectives a step, by verb: ``{verb: {"count", "bytes",
    "elements", "kernels"}}`` (the JAX package's ``count`` / ``bytes``,
    verbs under its HLO names:
    ``all-reduce``, ``all-gather``, ``reduce-scatter``,
    ``collective-permute``, ``all-to-all``; ``broadcast`` besides).

    ``trace_or_summary``: a kineto chrome trace (dict or path) or a
    traceview summary.  From a trace: host calls per step window
    (``mxnet:step`` annotations; the whole capture without any), divided
    by the windows' micro-steps; ``count`` and ``bytes`` from the
    ``record_param_comms`` events (NCCL), else the ``c10d::`` ops
    (gloo: sizes only when the capture recorded shapes, and bytes None
    for a tensor list, whose dtype the trace does not name);
    ``kernels`` the NCCL kernels launched in the windows.  From a
    summary: the bucket reduces its plan matched (all-reduce only,
    ``kernels`` None)."""
    from ..traceview import parse as _parse

    if _parse.is_traceview_summary(trace_or_summary):
        return _from_summary(trace_or_summary)
    events = _events(trace_or_summary)
    wins = _windows(events)
    steps = sum(max(int(k), 1) for _a, _b, k in wins)

    def inside(t):
        return any(a <= t < b for a, b, _k in wins)

    out: Dict[str, Dict[str, float]] = {}

    def entry(op):
        return out.setdefault(op, {"count": 0.0, "bytes": 0.0,
                                   "elements": 0.0, "kernels": 0.0})

    for r in _calls(events):
        if not inside(r["ts"]):
            continue
        ent = entry(r["op"])
        ent["count"] += 1.0 / steps
        for key in ("bytes", "elements"):
            if r[key] is None or ent[key] is None:
                ent[key] = None
            else:
                ent[key] += r[key] / steps
    for r in _kernels(events):
        if inside(r["ts"]):
            entry(r["op"])["kernels"] += 1.0 / steps
    return out


def reduction_accounting(trace_or_summary) -> List[Dict[str, object]]:
    """One row per collective of the first step window, in issue order:
    ``{"op", "bytes", "elements", "bucket"}`` (``bucket``: the ``mxbkt``
    scope the
    call was issued under, None for sync BatchNorm's and the loss
    mean's) — the evidence that the bucketed exchange is many
    reductions, not one.  A summary gives its matched bucket reduces."""
    from ..traceview import parse as _parse

    if _parse.is_traceview_summary(trace_or_summary):
        return [{"op": "all-reduce", "bytes": int(b["bytes"]),
                 "elements": None, "bucket": b.get("bucket")}
                for b in trace_or_summary.get("buckets") or []
                if b.get("bytes")]
    events = _events(trace_or_summary)
    t0, t1, _k = _windows(events)[0]
    scopes = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
               _parse._scope_bucket(str(e.get("name") or "")))
              for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and _parse._scope_bucket(str(e.get("name") or ""))
              is not None]
    rows = []
    for r in _calls(events):
        if not t0 <= r["ts"] < t1:
            continue
        hit = [b for a, z, b in scopes if a <= r["ts"] < z]
        rows.append({"op": r["op"], "bytes": r["bytes"],
                     "elements": r["elements"],
                     "bucket": hit[0] if hit else None})
    return rows


# ---------------------------------------------------------------------------
# the rank sweep
# ---------------------------------------------------------------------------
def _build_net(model: str, classes: int):
    """A zoo name (``resnet18_v1``) or ``module:function`` returning a
    block for ``classes`` outputs."""
    if ":" in model:
        import importlib

        mod, fn = model.split(":", 1)
        return getattr(importlib.import_module(mod), fn)(classes)
    from ..gluon.model_zoo import vision

    return getattr(vision, model)(classes=classes)


def _sweep_rank(spec: dict) -> dict:
    """One rank of one sweep point: the seeded net on this rank's
    device, ``steps`` steps of the same global batch and their losses,
    then one traced step: its collectives by verb and in issue order,
    and the bucket rows."""
    import numpy as np
    import torch

    from .. import context as _context
    from .. import dist
    from .. import gluon
    from .. import initializer as init
    from .. import random as _random
    from ..ndarray import NDArray
    from ..traceview import capture as _capture
    from . import dp as _dp
    from .mesh import data_parallel_mesh

    dev = dist.device()
    ctx = _context.Context("cpu") if dev.type == "cpu" \
        else _context.Context("gpu", dev.index or 0)
    # float32 is float32: no TF32 in the card's convolutions and
    # matmuls, whose rounding would swamp the reduction-order noise the
    # trajectories are held to
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = spec["dtype"]
    np.random.seed(0)
    _random.seed(0)
    with ctx:
        net = _build_net(spec["model"], spec["classes"])
        net.initialize(init.Xavier(), ctx=ctx)
        rng = np.random.RandomState(0)
        b, s = spec["batch"], spec["image"]
        x = NDArray.from_raw(torch.as_tensor(
            rng.uniform(size=(b, 3, s, s)).astype("float32")).to(dev), ctx)
        y = NDArray.from_raw(torch.as_tensor(
            (np.arange(b) % spec["classes"]).astype("float32")).to(dev),
            ctx)
        step = _dp.FusedTrainStep(
            net, gluon.loss.SoftmaxCrossEntropyLoss(),
            mesh=data_parallel_mesh(), learning_rate=spec["lr"],
            momentum=0.9, dtype=dtype)
        losses = step.run_steps(x, y, steps=spec["steps"])
        vals = [float(v) for v in losses.asnumpy().reshape(-1)]
        # one more step, traced: what a built step puts on the wire
        tmp = tempfile.mkdtemp(prefix="mxscaling_")
        try:
            _capture.start_device_trace(tmp, device=dev,
                                        record_shapes=True)
            try:
                with _capture.annotation("mxnet:step:0:k=1"):
                    step.run_steps(x, y, steps=1).asnumpy()
            finally:
                path = _capture.stop_device_trace()
            from ..traceview import parse as _parse

            trace = _parse.load_trace(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return {"n": dist.num_processes(), "losses": vals,
            "collectives": collective_stats(trace),
            "reductions": reduction_accounting(trace),
            "bucketed": bool(step.bucketed),
            "buckets": step.bucket_accounting()}


def require_device(device, who: str) -> None:
    """The card unless the caller names the CPU: ``device`` None without
    a card raises and names ``device='cpu'``."""
    import torch

    if device is None and not torch.cuda.is_available():
        raise RuntimeError("%s: no CUDA device; pass device='cpu' to run "
                           "the ranks on the CPU" % who)


def _launch_points(counts: Sequence[int], spec: dict, device, backend,
                   timeout, threads) -> List[dict]:
    """Rank 0's result at each rank count, every count launched at once
    (each its own fresh processes, so they share nothing but the
    machine); a count that fails raises."""
    import threading

    from .. import dist

    require_device(device, "scaling.sweep")
    if any(int(n) < 1 for n in counts):
        raise ValueError("a sweep point needs at least one rank: %r"
                         % (list(counts),))
    out: List = [None] * len(counts)

    def run(i, n):
        try:
            out[i] = dist.launch(_sweep_rank, int(n), (spec,),
                                 backend=backend, device=device,
                                 timeout_s=timeout, threads=threads)[0]
        except BaseException as exc:     # re-raised below
            out[i] = exc

    ths = [threading.Thread(target=run, args=(i, n))
           for i, n in enumerate(counts)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    for r in out:
        if isinstance(r, BaseException):
            raise r
    return out


def _spec(steps, batch, dtype, lr, model, classes, image) -> dict:
    return {"steps": int(steps), "batch": int(batch), "dtype": dtype,
            "lr": float(lr), "model": model, "classes": int(classes),
            "image": int(image)}


def sweep(device_counts: Sequence[int] = (1, 2, 4, 8), steps: int = 4,
          batch: int = 16, timeout: int = 1200, *, device=None,
          backend: Optional[str] = None, dtype: Optional[str] = None,
          model: str = "resnet18_v1", classes: int = 16, image: int = 32,
          lr: float = 0.05, threads: Optional[int] = None) -> Dict:
    """The numeric-consistency and collective sweep over rank counts.

    Each count is a fresh launch of that many processes (``dist.launch``;
    every count at once), ``device`` the ranks' device: the card by
    default, ``"cpu"`` for gloo on the CPU, ``"cuda:0"`` with
    ``backend="gloo"`` to share one card (``backend``: NCCL on cards by
    default).  Same seeds and the same
    global batch at every count: each count's loss trajectory is held
    against the one-rank run (``first_step_rel_err`` < 5e-3 over the
    first two losses, the JAX package's float32 gate; the drift over
    every step is reported).  The ranks turn TF32 off.  A rank that
    cannot start raises."""
    spec = _spec(steps, batch, dtype, lr, model, classes, image)
    results = _launch_points(device_counts, spec, device, backend, timeout,
                             threads)
    ref = next((r for r in results if r["n"] == 1), None)
    for r in results:
        if r is ref or ref is None:
            continue
        head = [abs(a - b) / max(abs(a), 1e-6)
                for a, b in zip(r["losses"][:2], ref["losses"][:2])]
        drift = max(abs(a - b) / max(abs(a), 1e-6)
                    for a, b in zip(r["losses"], ref["losses"]))
        r["first_step_rel_err"] = max(head)
        r["trajectory_rel_drift"] = drift
        # the JAX package's float32 gate: one-pass BatchNorm statistics
        # cancel two all-reduced sums, so reduction-order noise grows;
        # correctness is pinned by control_sweep's float64 run
        r["numerically_consistent"] = bool(max(head) < 5e-3)
    return {"steps": steps, "global_batch": batch, "sweep": results}


def control_sweep(device_counts: Sequence[int] = (1, 2, 8), steps: int = 4,
                  batch: int = 16, timeout: int = 1200, *, device=None,
                  backend: Optional[str] = None,
                  model: str = "resnet18_v1", classes: int = 16,
                  image: int = 32, threads: Optional[int] = None) -> Dict:
    """The drift-is-chaos control: ``fp64`` (the same sweep in float64:
    every step must agree across counts to 1e-9, which a sharding bug
    would not) and ``lr0`` (float32 at learning rate 0: nothing moves,
    so every step agrees to 1e-4)."""
    out: Dict[str, Dict] = {}
    for name, dtype, lr, tol in (("fp64", "float64", 0.05, 1e-9),
                                 ("lr0", None, 0.0, 1e-4)):
        spec = _spec(steps, batch, dtype, lr, model, classes, image)
        results = _launch_points(device_counts, spec, device, backend,
                                 timeout, threads)
        ref = next((r for r in results if r["n"] == 1), None)
        ok = ref is not None
        for r in results:
            if r is ref or ref is None:
                continue
            drift = max(abs(a - b) / max(abs(a), 1e-12)
                        for a, b in zip(r["losses"], ref["losses"]))
            r["multi_step_rel_drift"] = float(drift)
            r["multi_step_consistent"] = bool(drift < tol)
            ok = ok and r["multi_step_consistent"]
        out[name] = {"dtype": dtype or "float32", "lr": lr,
                     "tolerance": tol, "steps": steps,
                     "sweep": results, "all_consistent": ok}
    return out


def mp_placement_sweep(timeout: int = 1200) -> Dict:
    """The JAX package's model-parallel LSTM placement sweep: it trains
    the reference's ``example/model-parallel/lstm/lstm.py``, read from a
    reference checkout outside the repository.  Not ported until that
    file is in the repository (ROADMAP A12.4).  Raises."""
    raise NotImplementedError(
        "scaling.mp_placement_sweep trains the reference's "
        "example/model-parallel/lstm/lstm.py, which waits to be in the "
        "repository (ROADMAP A12.4)")


# ---------------------------------------------------------------------------
# gradient leaves
# ---------------------------------------------------------------------------
def grad_entries(params, dtype: Optional[str] = None) -> List[tuple]:
    """The gradient exchange's leaves: ``(name, shape, dtype)`` for every
    trainable entry of ``params`` in iteration (layer) order — what
    ``buckets.partition`` and ``autotune.from_leaf_bytes`` consume.
    ``params``: a ``{name: leaf}`` mapping (gluon ``collect_params()``,
    the LM's parameter dict, tensors) or a list of ``(name, shape,
    dtype)``; ``grad_req == 'null'`` entries are skipped; ``dtype``
    overrides each leaf's own."""
    from . import buckets as _buckets

    out: List[tuple] = []
    items = params.items() if hasattr(params, "items") else None
    if items is None:
        for name, shape, dt in params:
            out.append((name, tuple(shape), dtype or str(dt)))
        return out
    for name, p in items:
        if getattr(p, "grad_req", None) == "null":
            continue
        dt = dtype if dtype is not None else \
            _buckets.dtype_name(getattr(p, "dtype", "float32"))
        out.append((name, tuple(p.shape), dt))
    return out


def grad_leaf_bytes(entries: Sequence[tuple]) -> List[int]:
    """Payload bytes of each ``grad_entries`` row, in order."""
    from . import buckets as _buckets

    return [_buckets._nbytes(shape, dt) for _name, shape, dt in entries]


def _resnet50_params():
    """The zoo's ResNet-50 v1 (1000 classes) with its shapes settled by
    one forward on the CPU (only the shapes are read)."""
    import numpy as np

    from .. import autograd, context, nd
    from .. import initializer as init
    from .. import random as _random
    from ..gluon.model_zoo import vision

    np.random.seed(0)
    _random.seed(0)
    with context.Context("cpu"):
        net = vision.resnet50_v1(classes=1000)
        net.initialize(init.Xavier())
        with autograd.pause():
            net(nd.zeros((1, 3, 224, 224)))
    return net.collect_params()


def resnet50_grad_entries(dtype: str = "float32") -> List[tuple]:
    """The data-parallel ResNet-50 exchange's leaves (the zoo instance
    of :func:`grad_entries`)."""
    return grad_entries(_resnet50_params(), dtype=dtype)


def resnet50_grad_leaf_bytes(dtype: str = "float32") -> List[int]:
    """ResNet-50's gradient leaf bytes in layer order."""
    return grad_leaf_bytes(resnet50_grad_entries(dtype))


def resnet50_bucket_bytes(dtype: str = "float32",
                          cap_bytes: Optional[int] = None) -> List[int]:
    """Bucket payloads of the ResNet-50 exchange under ``cap_bytes``
    (default ``MXNET_KVSTORE_BUCKET_BYTES``), by ``buckets.partition``."""
    from . import buckets as _buckets

    plan = _buckets.partition(resnet50_grad_entries(dtype), cap_bytes)
    return [int(b.nbytes) for b in plan]


def resnet50_grad_bytes(dtype_bytes: int = 4) -> int:
    """Gradient payload of one data-parallel ResNet-50 step: the
    trainable parameters' elements times ``dtype_bytes``."""
    total = 0
    for p in _resnet50_params().values():
        if p.grad_req != "null":
            n = 1
            for d in p.shape:
                n *= int(d)
            total += n
    return total * dtype_bytes


# ---------------------------------------------------------------------------
# the cost model (the JAX package's, with the bandwidth required)
# ---------------------------------------------------------------------------
def _bandwidth(ici_GBps) -> float:
    if ici_GBps is None:
        raise ValueError(
            "ici_GBps is required: the GB/s of the link the ranks share, "
            "measured (autotune.timing.from_trace, "
            "tools/torch_autotune_scale.py) or stated; the port assumes "
            "no figure")
    if not float(ici_GBps) > 0:
        raise ValueError("ici_GBps must be positive, got %r" % (ici_GBps,))
    return float(ici_GBps)


def simulate_bucketed_overlap(bucket_bytes: Sequence[int],
                              step_time_s: float, n: int,
                              ici_GBps: Optional[float] = None,
                              backward_frac: float = 2.0 / 3.0,
                              coll_latency_s: float = 0.0,
                              readiness: str = "uniform",
                              accum_steps: int = 1) -> Dict:
    """The DDP pipeline model over a bucket plan: bucket k's collective
    becomes issuable partway through backward (reverse layer order),
    collectives serialize on the communication stream, and whatever runs
    past the end of backward is exposed.  ``readiness``: ``'uniform'``
    (bucket k at (k+1)/B of backward) or ``'bytes'`` (at its cumulative
    byte share); ``coll_latency_s``: a launch cost a collective;
    ``accum_steps`` > 1: the gradients exist only in the last
    microbatch's backward (bucket k at ((A-1) + share)/A of it).
    ``ici_GBps``: the link's GB/s (required).  A model, returned with its
    assumptions."""
    bw = _bandwidth(ici_GBps)
    t_bwd = backward_frac * step_time_s
    A = max(int(accum_steps), 1)
    ring = 2.0 * (n - 1) / n
    clock, total = 0.0, 0.0
    B = max(len(bucket_bytes), 1)
    total_bytes = float(sum(bucket_bytes)) or 1.0
    cum = 0
    for k, nbytes in enumerate(bucket_bytes):
        cum += nbytes
        share = (cum / total_bytes if readiness == "bytes"
                 else (k + 1) / B)
        ready = ((A - 1) + share) / A * t_bwd
        dur = coll_latency_s + ring * nbytes / (bw * 1e9)
        clock = max(clock, ready) + dur
        total += dur
    exposed = max(0.0, clock - t_bwd)
    overlap = 1.0 - exposed / total if total else 1.0
    return {"overlap": round(max(0.0, min(1.0, overlap)), 4),
            "exposed_s": exposed, "t_comm_total_s": total,
            "t_backward_s": t_bwd, "n_buckets": len(bucket_bytes),
            "coll_latency_s": coll_latency_s, "readiness": readiness,
            "accum_steps": A}


def project_efficiency_bucketed(bucket_bytes: Sequence[int],
                                step_time_s: float,
                                chips: Sequence[int] = (8, 16, 32, 64,
                                                        128, 256),
                                ici_GBps: Optional[float] = None,
                                backward_frac: float = 2.0 / 3.0,
                                coll_latency_s: float = 0.0,
                                readiness: str = "uniform",
                                accum_steps: int = 1) -> Dict:
    """The projection under the bucket-pipeline model: eff(n) = t_step /
    (t_step + exposed(n)) at each rank count of ``chips``; ``ici_GBps``
    required (see :func:`simulate_bucketed_overlap`)."""
    bw = _bandwidth(ici_GBps)
    table = {}
    detail = {}
    for n in chips:
        sim = simulate_bucketed_overlap(bucket_bytes, step_time_s, n,
                                        bw, backward_frac,
                                        coll_latency_s=coll_latency_s,
                                        readiness=readiness,
                                        accum_steps=accum_steps)
        table[str(n)] = round(
            step_time_s / (step_time_s + sim["exposed_s"]), 4)
        detail[str(n)] = sim["overlap"]
    return {
        "model": "bucket-pipeline: reverse-layer-order buckets become "
                 "issueable through backward (%s readiness), serialize "
                 "on the comm stream; eff = t_step/(t_step + exposed). "
                 "A MODEL over the measured bucket plan and step time, "
                 "not a measured schedule" % readiness,
        "bucket_bytes": list(int(b) for b in bucket_bytes),
        "step_time_s": step_time_s,
        "ici_GBps_assumed": bw,
        "backward_frac_assumed": backward_frac,
        "coll_latency_s_assumed": coll_latency_s,
        "overlap_by_chips": detail,
        "projected_efficiency": table,
        "reference_resnet152_256gpu": 0.901,
    }


def project_efficiency(grad_bytes: int, step_time_s: float,
                       chips: Sequence[int] = (8, 16, 32, 64, 128, 256),
                       ici_GBps: Optional[float] = None,
                       overlap: float = 0.7,
                       overlap_source: str = "assumed") -> Dict:
    """The ring all-reduce cost model: t_comm(n) = 2(n-1)/n * bytes /
    link, (1 - overlap) of it exposed.  ``overlap`` should come from
    ``parallel.overlap``'s measurement (``overlap_source``); 0.7 is the
    JAX package's stated assumption.  ``ici_GBps`` required."""
    bw = _bandwidth(ici_GBps)
    table = {}
    for n in chips:
        t_comm = 2.0 * (n - 1) / n * grad_bytes / (bw * 1e9)
        exposed = (1.0 - overlap) * t_comm
        table[str(n)] = round(step_time_s / (step_time_s + exposed), 4)
    return {
        "model": "ring allreduce, eff = t_step/(t_step + "
                 "(1-overlap)*2(n-1)/n*B/BW)",
        "grad_bytes": grad_bytes,
        "step_time_s": step_time_s,
        "ici_GBps_assumed": bw,
        "overlap": overlap,
        "overlap_source": overlap_source,
        "projected_efficiency": table,
        "reference_resnet152_256gpu": 0.901,
    }
