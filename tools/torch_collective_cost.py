"""Host cost of one small collective on a one-rank process group (card).

    python3 tools/torch_collective_cost.py

Starts one rank (``mxnet_tpu_torch.dist.launch``) three times: NCCL with
the defaults, NCCL with its flight recorder off
(``TORCH_NCCL_TRACE_BUFFER_SIZE=0``), and gloo on ``cuda:0``.  Each rank
times, over 500 calls after 20 warm-up calls and a synchronize, the
host microseconds of ``all_reduce`` of a (2, 256) float32 tensor
(blocking; asynchronous without and with ``wait()``), of an in-place
add (one launch, for scale), and of sync BatchNorm's mean over ranks
(``ops.nn._cross_device_mean``) forward and backward; then the host
ops of 20 blocking all-reduces under torch.profiler.  One JSON line per
run.  Needs a CUDA device.
"""
import json
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _per_call_us(fn, n=500):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def rank():
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.ops import nn as nn_ops
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh

    mesh = data_parallel_mesh()
    x = torch.randn(2, 256, device="cuda")
    out = {"backend": dist.get_backend(),
           "TORCH_NCCL_TRACE_BUFFER_SIZE":
               os.environ.get("TORCH_NCCL_TRACE_BUFFER_SIZE"),
           "all_reduce_sync_us": _per_call_us(lambda: dist.all_reduce(x)),
           "all_reduce_async_nowait_us": _per_call_us(
               lambda: dist.all_reduce(x, async_op=True)),
           "all_reduce_async_wait_us": _per_call_us(
               lambda: dist.all_reduce(x, async_op=True).wait()),
           "add_us": _per_call_us(lambda: x.add_(0.0))}
    xr = x.clone().requires_grad_(True)

    def mean_fwd_bwd():
        with nn_ops.cross_device_batch_stats("dp", mesh):
            nn_ops._cross_device_mean(xr).sum().backward()

    out["cross_device_mean_fwd_bwd_us"] = _per_call_us(mean_fwd_bwd, 200)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            dist.all_reduce(x)
        torch.cuda.synchronize()
    out["host_us_per_call_by_op"] = [
        (e.key, e.cpu_time_total / 20) for e in sorted(
            prof.key_averages(), key=lambda e: -e.cpu_time_total)[:8]]
    return out


def _card() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_collective_cost: no CUDA device")
    print(_card(), flush=True)
    from mxnet_tpu_torch import dist

    print(json.dumps(dist.launch(rank, 1, backend="nccl")[0]), flush=True)
    os.environ["TORCH_NCCL_TRACE_BUFFER_SIZE"] = "0"
    print(json.dumps(dist.launch(rank, 1, backend="nccl")[0]), flush=True)
    print(json.dumps(dist.launch(rank, 1, backend="gloo",
                                 device="cuda:0")[0]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
