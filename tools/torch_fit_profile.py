"""Where the time goes when ``mxnet_tpu_torch`` trains the symbolic
ResNet-50 v1 through ``Module.fit`` on one GPU.

    python3 tools/torch_fit_profile.py [--bulk-k 8]

Builds the ``fit`` phase's cell of ``chip_smoke.py`` (``FIT``: the
``bench.py:1219`` symbol at batch 32, 224x224, 1000 classes, float32
with TF32 off, ``NDArrayIter`` over 8 batches, Xavier, SGD lr 0.05
momentum 0.9) and, for the bulk loop (``engine.set_bulk_size(K)``) and
the per-batch loop in turns, prints one JSON line each:

  * ``step_ms``: one untraced epoch's wall over its steps, after a
    warm-up epoch;
  * ``host_ms``: host time a step inside the parts of a step, from
    wrappers around them in that untraced epoch — the bulk loop's
    K-batch stack and copy (``stack``), the per-batch feed (``feed``),
    the executor's forward + backward (``train_step``), the optimizer
    update through the kvstore (``update``) and the metric
    (``metric``); a part's host time includes any wait for the card
    inside it (a full launch queue, ``asnumpy``);
  * under ``torch.profiler`` (one more epoch): device busy ms a step
    (kernel durations summed), the idle share of the traced epoch,
    kernel launches a step, and device ms a step by kernel group
    (``tools/torch_train_profile.py``'s grouping).

Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
import torch_train_profile as ttp  # noqa: E402


def _timed(owner, attr, label, acc):
    """Wrap ``owner.attr`` so its host time adds to ``acc[label]``."""
    fn = getattr(owner, attr)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc[label] += time.perf_counter() - t0

    setattr(owner, attr, wrapper)
    return fn


def profile_mode(bulk_k, X, y):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import engine, executor, metric
    from mxnet_tpu_torch.module import bulk, module
    from torch.profiler import ProfilerActivity, profile

    it = mx.io.NDArrayIter(X, y, batch_size=cs.FIT["batch"],
                           label_name="softmax_label")
    mod = mx.mod.Module(cs.sym_resnet50(cs.FIT["classes"]),
                        context=mx.gpu(0))
    np.random.seed(0)
    kw = dict(optimizer="sgd", eval_metric=["acc", "ce"],
              optimizer_params=(("learning_rate", cs.FIT["lr"]),
                                ("momentum", cs.FIT["momentum"])),
              initializer=mx.init.Xavier())
    prev = engine.set_bulk_size(bulk_k)
    try:
        mod.fit(it, num_epoch=1, **kw)            # warm-up epoch
        acc = defaultdict(float)
        patched = [(owner, attr, _timed(owner, attr, label, acc))
                   for owner, attr, label in (
                       (bulk.BulkTrainLoop, "_stack", "stack"),
                       (module.Module, "_feed", "feed"),
                       (executor.Executor, "run_train_step", "train_step"),
                       (module.Module, "update", "update"),
                       (metric.CompositeEvalMetric, "update", "metric"))]
        steps = cs.FIT["n_batches"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for owner, attr, fn in patched:
            setattr(owner, attr, fn)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            mod.fit(it, num_epoch=1, **kw)
            torch.cuda.synchronize()
            traced = time.perf_counter() - t1
    finally:
        engine.set_bulk_size(prev)
    kernels = ttp._kernels(prof)
    groups = defaultdict(float)
    for name, us in kernels:
        groups[ttp.kernel_group(name)] += us
    busy_ms = sum(us for _, us in kernels) / 1e3
    loop = mod._bulk_loop
    return {"bulk_k": bulk_k,
            "bulk_used": bool(loop is not None and loop.groups > 0),
            "step_ms": wall / steps * 1e3,
            "host_ms": {k: v / steps * 1e3 for k, v in sorted(acc.items())},
            "traced_step_ms": traced / steps * 1e3,
            "device_busy_ms": busy_ms / steps,
            "idle_share": 1.0 - busy_ms / (traced * 1e3),
            "launches_per_step": len(kernels) / steps,
            "device_ms_by_group": {g: us / 1e3 / steps
                                   for g, us in sorted(groups.items())}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bulk-k", type=int, default=cs.FIT["bulk_k"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_fit_profile: no CUDA device available")
    cs.phase_device()
    X, y = cs._fit_data(cs.FIT["batch"], cs.FIT["image"], cs.FIT["classes"],
                        cs.FIT["n_batches"])
    for k in (args.bulk_k, 1, args.bulk_k, 1):
        print(json.dumps(profile_mode(k, X, y)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
