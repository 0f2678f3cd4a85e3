"""The mirror's design against two other torch idioms, on the card.

ResNet-50 v1 at batch 128, 224x224, bf16, ``FusedTrainStep`` (SGD lr
0.05 momentum 0.9), in turns over two rounds:

  * ``none``            — no remat;
  * ``mirror``          — the port's ``MXNET_BACKWARD_DO_MIRROR``: plain
    checkpoints over regions that end at conv/dense layers;
  * ``mirror_selective`` — the same regions, each under a selective
    checkpoint whose policy keeps convolution and matmul outputs
    (``torch.utils.checkpoint.create_selective_checkpoint_contexts``);
  * ``whole_selective`` — no regions: the whole forward under one such
    selective checkpoint (the JAX package's ``jax.checkpoint`` with a
    save policy, translated literally).

Each prints step ms (5 steps after one warm-up), the peak allocated
bytes over those steps, and the device-busy ms a step from a
torch.profiler trace of 2 more steps; the card's name and power limit
first.  Run from the repository root on a machine with a card:

    python3 tools/torch_remat_ab.py
"""
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# the ATen ops whose outputs a selective policy keeps: convolutions and
# matrix products, as they reach the policy (the autograd level)
KEEP = {"convolution", "_convolution", "cudnn_convolution", "mm", "addmm",
        "bmm", "baddbmm"}


def _policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE \
        if op.overloadpacket.__name__ in KEEP \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _selective(fn, *args):
    """``remat.checkpoint`` with the selective policy added."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    from mxnet_tpu_torch import autograd, random as mx_random, remat
    from mxnet_tpu_torch.context import current_context

    rng = mx_random.get_state()
    st = remat._st()
    env = (autograd.is_recording(), autograd.is_training(), st.depth,
           st.mirror, current_context())

    class Both:
        def __init__(self, inner):
            self.inner, self.rec = inner, remat._Recompute(rng, env)

        def __enter__(self):
            self.rec.__enter__()
            self.inner.__enter__()

        def __exit__(self, *exc):
            self.inner.__exit__(*exc)
            self.rec.__exit__(*exc)

    def context_fn():
        fwd, rec = create_selective_checkpoint_contexts(_policy)
        return fwd, Both(rec)

    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)


@contextlib.contextmanager
def variant(name):
    """The knobs and patches of one variant."""
    from mxnet_tpu_torch import remat

    saved = (remat.checkpoint, remat.maybe_checkpoint)
    os.environ["MXNET_BACKWARD_DO_MIRROR"] = "1" if name.startswith(
        "mirror") else "0"
    if name == "mirror_selective":
        remat.checkpoint = _selective
    elif name == "whole_selective":
        remat.maybe_checkpoint = lambda fn: (
            lambda *a: _selective(fn, *a))
    try:
        yield
    finally:
        remat.checkpoint, remat.maybe_checkpoint = saved
        os.environ["MXNET_BACKWARD_DO_MIRROR"] = "0"


def run(net, w0, data, label, name):
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch import convert, gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    net.cast("float32")
    convert.load_block_params(net, w0)
    with variant(name):
        step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              learning_rate=0.05, momentum=0.9,
                              dtype="bfloat16")
        step.run_steps(data, label, steps=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = step.run_steps(data, label, steps=5)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 5 * 1e3
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step.run_steps(data, label, steps=2)
            torch.cuda.synchronize()
    busy = sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / 2
    return {"variant": name, "step_ms": step_ms, "peak_bytes": int(peak),
            "device_busy_ms_per_step": busy,
            "last_loss": float(losses.asnumpy()[-1])}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_remat_ab: no CUDA device available")
    import chip_smoke as cs

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
        .stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0)
    net = cs.resnet50(ctx)
    w0 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    data, label = cs.train_batch(128, ctx)
    for rnd in range(2):
        for name in ("none", "mirror", "mirror_selective",
                     "whole_selective"):
            row = dict(run(net, w0, data, label, name), round=rnd)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
