"""Where the time goes on ``mxnet_tpu_torch``'s imperative path on one GPU.

    python3 tools/torch_nd_profile.py [--n 4096]

Runs the chain of ``chip_smoke.py``'s ``ndarray`` phase ((n, n) float32
operands on ``mx.gpu(0)``: upload, the rtc ``add`` kernel, a ``dot``,
elementwise/broadcast/reduce ops under ``autograd.record()``, one
``backward()``, then max/argmax/transpose-slice/topk) three times in a
fresh process, with ``torch.cuda.synchronize()`` before and after each
step, so every step's host-clock time includes its device work.  The
first pass pays the one-time costs (CUDA's lazy loading of each kernel
at its first launch, cuBLAS set-up, PyTorch's first autograd pass);
the later ones are the steady state.  Prints one JSON line per pass
with the seconds of each step.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import ADD_SIG, _add_grid, _add_source  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import rtc  # noqa: E402


def one_pass(a, b, bias, add):
    nd, ctx, n = mx.nd, mx.gpu(0), a.shape[0]
    env, times = {}, {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env[name] = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0

    def upload():
        x, w = nd.array(a, ctx=ctx), nd.array(b, ctx=ctx)
        x.attach_grad()
        w.attach_grad()
        return x, w, nd.array(bias, ctx=ctx)

    def rtc_add():
        x, w, _ = env["upload"]
        s = nd.zeros((n, n), ctx=ctx)
        grid, block = _add_grid(s.size)
        add.launch([x, w, s, s.size], ctx, grid, block)
        return s

    step("upload", upload)
    x, w, c = env["upload"]
    step("rtc_add", rtc_add)
    with mx.autograd.record():
        step("dot", lambda: nd.dot(x, w) / float(n // 64))
        step("sigmoid", lambda: nd.sigmoid(env["rtc_add"]))
        step("broadcast_add_relu_mul", lambda: nd.relu(
            nd.broadcast_add(env["dot"], c)) * env["sigmoid"])
        z = env["broadcast_add_relu_mul"]
        step("mean_square_sum", lambda: (z.mean(axis=1) ** 2).sum())
    step("backward", lambda: env["mean_square_sum"].backward())
    step("max", lambda: z.max(axis=0))
    step("argmax", lambda: nd.argmax(z, axis=1))
    step("transpose_slice", lambda: nd.transpose(z)[::3, 1:257])
    step("topk", lambda: z.topk(axis=1, k=4, ret_typ="value"))
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_nd_profile: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    a, b = (rng.randn(args.n, args.n).astype(np.float32) for _ in range(2))
    bias = rng.randn(1, args.n).astype(np.float32)
    t0 = time.perf_counter()
    add = rtc.CudaModule(_add_source()).get_kernel(
        "add", ADD_SIG.format("float"))
    compile_s = time.perf_counter() - t0
    for i in range(args.passes):
        times = one_pass(a, b, bias, add)
        print(json.dumps({"pass": i + 1, "n": args.n,
                          "device": torch.cuda.get_device_name(0),
                          "nvrtc_s": compile_s if i == 0 else None,
                          "total_s": sum(times.values()),
                          "steps_s": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
