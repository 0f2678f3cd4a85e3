"""Where the time goes when ``mxnet_tpu_torch`` trains ResNet-50 v1 on
one GPU.

    python3 tools/torch_train_profile.py [--batch 128] [--steps 5]

Builds the ``train`` phase's model of ``chip_smoke.py`` (ResNet-50 v1,
1000 classes, 224x224, Xavier from numpy seed 0, bf16,
``FusedTrainStep`` with SGD lr 0.05 momentum 0.9), warms it with 3
steps, and prints one JSON line per part:

1. ``traced``: ``--steps`` steps untraced (the step time), then the
   same under ``torch.profiler`` (CPU + CUDA): device time a step and
   its share of the untraced step, kernel launches per step, and device
   time per step grouped by kernel: convolution
   forward, dgrad and wgrad (cuDNN's kernel names), other GEMMs, the
   BatchNorm forward and the SGD update (the kernels launched inside
   those two, found through profiler ranges this tool puts around the
   op body and the update), elementwise, reductions, copies and layout
   transforms, other; then the top kernels;
2. ``batchnorm``: the port's BatchNorm forward + backward alone at
   every BatchNorm shape of the net: device time (traced), wall (CUDA
   events) and launches, against the bytes its inputs and outputs must
   move;
3. ``update``: the fused SGD-momentum update alone over the net's
   parameters, the same three, against its bytes (weights, gradients
   and momenta read, weights and momenta written).

Part 2 and 3 are the two memory-bound candidates for a hand-written
kernel.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch import gluon  # noqa: E402
from mxnet_tpu_torch import optimizer as topt  # noqa: E402
from mxnet_tpu_torch.ops import registry  # noqa: E402
from mxnet_tpu_torch.parallel.dp import FusedTrainStep  # noqa: E402

GROUPS = ("conv_fwd", "conv_dgrad", "conv_wgrad", "gemm", "batchnorm_fwd",
          "sgd_update", "elementwise", "reduction", "copy", "layout",
          "other")


def kernel_group(name: str) -> str:
    """The group of a device kernel, by its name."""
    n = name.lower()
    if "dgrad" in n:
        return "conv_dgrad"
    if "wgrad" in n:
        return "conv_wgrad"
    if "fprop" in n or "convolve" in n or "conv2d" in n:
        return "conv_fwd"
    if "nchwtonhwc" in n or "nhwctonchw" in n or "transpose" in n:
        return "layout"
    if "gemm" in n or "cutlass" in n or "xmma" in n:
        return "gemm"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copy"
    if "reduce" in n:
        return "reduction"
    if "elementwise" in n:
        return "elementwise"
    return "other"


def _ranged(fn, label):
    def wrapper(*a, **k):
        with torch.profiler.record_function(label):
            return fn(*a, **k)
    return wrapper


def _range_kernels(events, label):
    """Device kernels launched inside every ``label`` range:
    ``[(name, us)]``."""
    out = []

    def walk(ev):
        out.extend((k.name, k.duration) for k in ev.kernels)
        for c in ev.cpu_children:
            walk(c)

    for ev in events:
        if ev.name == label:
            walk(ev)
    return out


def _kernels(prof, labels=()):
    """``[(name, us)]`` of the device kernels and copies of a trace:
    device events, without the GPU spans that ``record_function``
    ranges leave beside them."""
    from torch.autograd import DeviceType

    return [(ev.name, ev.device_time_total) for ev in prof.events()
            if ev.device_type == DeviceType.CUDA and ev.name not in labels
            and not getattr(ev, "is_user_annotation", False)]


def alone(fn, reps=5):
    """``fn`` on its own: device ms a call (kernels summed, from a
    trace), wall ms a call (CUDA events: host launch gaps included) and
    kernel launches a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = _kernels(prof)
    return (sum(us for _, us in kernels) / 1e3 / reps,
            cs.time_ms(fn, iters=reps, warmup=1), len(kernels) / reps)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: no CUDA device available")
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    net = cs.resnet50(ctx)
    data, label = cs.train_batch(args.batch, ctx)
    step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                          learning_rate=cs.TRAIN_LR,
                          momentum=cs.TRAIN_MOMENTUM, dtype="bfloat16")
    step.run_steps(data, label, steps=3).asnumpy()

    # BatchNorm's input shapes, from one recorded forward
    bn_op = registry.get("BatchNorm")
    bn_fn = bn_op.fn
    shapes = []

    def spy(x, *rest, **kw):
        shapes.append(tuple(x.shape))
        return bn_fn(x, *rest, **kw)

    bn_op.fn = spy
    step.run_steps(data, label, steps=1).asnumpy()
    bn_op.fn = bn_fn

    # untraced: the step as chip_smoke.py times it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step.run_steps(data, label, steps=args.steps)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) / args.steps * 1e3

    # 1. traced
    from torch.profiler import ProfilerActivity, profile

    bn_op.fn = _ranged(bn_fn, "mx::BatchNorm")
    fused = topt.fused_sgd_mom_grouped
    topt.fused_sgd_mom_grouped = _ranged(fused, "mx::sgd_update")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.run_steps(data, label, steps=args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    bn_op.fn = bn_fn
    topt.fused_sgd_mom_grouped = fused

    events = prof.events()
    kernels = _kernels(prof, ("mx::BatchNorm", "mx::sgd_update"))
    per_group = defaultdict(float)
    per_kernel = defaultdict(lambda: [0, 0.0])
    for name, us in kernels:
        per_group[kernel_group(name)] += us
        per_kernel[name][0] += 1
        per_kernel[name][1] += us
    for label_, group in (("mx::BatchNorm", "batchnorm_fwd"),
                          ("mx::sgd_update", "sgd_update")):
        for name, us in _range_kernels(events, label_):
            per_group[kernel_group(name)] -= us
            per_group[group] += us
    busy_us = sum(us for _, us in kernels)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:15]
    n = args.steps
    busy_ms = busy_us / 1e3 / n
    print(json.dumps({
        "run": "traced", "device": torch.cuda.get_device_name(0),
        "batch": args.batch, "dtype": "bfloat16", "steps": n,
        "untraced_step_ms": untraced_ms,
        "traced_step_ms": wall / n * 1e3,
        "device_busy_ms_per_step": busy_ms,
        # against the untraced step: the profiler slows the host
        "device_busy_share": busy_ms / untraced_ms,
        "device_idle_share": 1.0 - busy_ms / untraced_ms,
        "launches_per_step": len(kernels) / n,
        "device_ms_per_step": {g: per_group[g] / 1e3 / n for g in GROUPS},
        "top_kernels": [{"name": k[:120], "group": kernel_group(k),
                         "count_per_step": c / n,
                         "device_ms_per_step": us / 1e3 / n}
                        for k, (c, us) in top],
    }), flush=True)

    # 2. BatchNorm alone, forward + backward, every shape of the net
    dev = data._data.device
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for shp in shapes:
        c = shp[1]
        x = torch.randn(shp, generator=g, device=dev).to(
            torch.bfloat16).requires_grad_(True)
        params = [torch.ones(c, device=dev, dtype=torch.bfloat16)
                  .requires_grad_(True),
                  torch.zeros(c, device=dev, dtype=torch.bfloat16)
                  .requires_grad_(True),
                  torch.zeros(c, device=dev, dtype=torch.bfloat16),
                  torch.ones(c, device=dev, dtype=torch.bfloat16)]
        cot = torch.randn(shp, generator=g, device=dev).to(torch.bfloat16)
        cases.append((x, params, cot))

    def bn_all():
        for x, params, cot in cases:
            out = bn_fn(x, *params, eps=1e-5, momentum=0.9,
                        fix_gamma=False)[0]
            torch.autograd.grad(out, [x] + params[:2], cot)

    bn_dev, bn_wall, bn_launches = alone(bn_all)
    # bytes: forward reads x, writes y; backward reads x and dy, writes dx
    bn_bytes = sum(5 * x.numel() * 2 for x, _, _ in cases)
    print(json.dumps({
        "run": "batchnorm", "layers": len(cases), "batch": args.batch,
        "device_ms_per_step": bn_dev, "wall_ms_per_step": bn_wall,
        "launches_per_step": bn_launches,
        "bound_ms": bn_bytes / cs.PEAK_BYTES_S * 1e3, "bound_by": "bytes",
        "bytes": bn_bytes,
    }), flush=True)

    # 3. the fused update alone over the real parameters
    params = [p.data()._data.detach() for p in step._cells]
    grads = {i: torch.zeros_like(params[i]) for i in step._diff}
    moms = step._moms

    def update():
        topt.fused_sgd_mom_grouped(step._diff, params, grads, moms,
                                   cs.TRAIN_LR, cs.TRAIN_MOMENTUM, 0.0)

    upd_dev, upd_wall, upd_launches = alone(update)
    n_el = sum(params[i].numel() for i in step._diff)
    upd_bytes = 5 * n_el * params[step._diff[0]].element_size()
    print(json.dumps({
        "run": "update", "parameters": n_el, "tensors": len(step._diff),
        "device_ms_per_step": upd_dev, "wall_ms_per_step": upd_wall,
        "launches_per_step": upd_launches,
        "bound_ms": upd_bytes / cs.PEAK_BYTES_S * 1e3, "bound_by": "bytes",
        "bytes": upd_bytes,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
