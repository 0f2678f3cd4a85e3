"""Smoke run of ``mxnet_tpu_torch`` on one NVIDIA GPU: build the CUDA
kernels from source, hold each against its plain PyTorch version, serve
a GPT-2-small-width transformer through the port's ``ModelServer`` with
paged-KV continuous batching (in process, then over HTTP beside a
predictor, under the load generator, through a live reload and through
``python -m mxnet_tpu_torch.serving``), check the numbers against the
dense reference, drive the imperative ``mx.nd`` / ``mx.autograd`` / ``mx.rtc``
path at (4096, 4096) float32 against numpy in float64, train
ResNet-50 v1 at full width through ``FusedTrainStep`` (bf16 timed,
float64 and float32 held against the CPU in float64), and train the
GPT-2-small-width transformer LM through ``TransformerTrainStep``
(the flash-attention forward and backward kernels on every layer;
``fit`` with a checkpoint resumed bit for bit; float32 held against
the CPU in float64).

    python3 chip_smoke.py

Each phase prints one JSON line; any failure raises and the script exits
non-zero.  The line before the last is ``{"kernels": [...]}`` (per
kernel: launches on its path, error, times, bound); the last
line is ``{"ok": true, "device": {...}}``.  Needs a CUDA device, the
CUDA toolkit (``nvcc``) and the rest of this repository beside it; it
imports nothing of JAX.

Phases:
  device   card name, power limit (nvidia-smi), TF32 off
  build    nvcc of every ``mxnet_tpu_torch/csrc/*.cu``, all at once;
           ptxas's register report; ``cuobjdump -sass`` counts of HGMMA
           (wgmma) and UTMALDG (TMA loads) and ``cuobjdump -res-usage``
           per flash kernel (fails if the wgmma kernels have none, or
           if they or the backward kernels use local memory: a spill)
  kernel:flash_attention_fwd
           the kernel against the plain version at the prefill's
           shapes, bf16 on the ``wgmma`` route (D 64 and 128, ragged T,
           the strided fused-projection view) and float32 on the
           ``simt`` route: error (absolute, and row-scaled: each
           row's error over that row's magnitude), route,
           kernel/plain/library times
           (10 calls back to back, hot L2), one call's time with the
           host's launch, device time from a CUDA graph, bound
  kernel:flash_attention_bwd
           the backward kernels (``csrc/flash_attn_bwd.cu``, from the
           forward kernel's output and log-sum-exp; the ``mma`` route
           for bf16, ``simt`` for float32) against their plain
           version ``flash_attention_bwd_reference`` and against
           autograd of ``attention_reference`` in float32, at the
           train_lm shape (8, 1024, 1024, 12, 64) causal bf16 (the
           wgmma forward), D 128, ragged T 1000, Tq 384 < Tk 512, full,
           the strided fused-projection views, float32 (simt) and Tq >
           Tk (fully masked rows: dq exactly 0); errors over each
           head's largest magnitude (``BWD_*_RTOL``); at the first
           shape the kernel (10 calls), CUDA-graph, plain and library
           (SDPA's backward alone) times, the bound (5 products over
           the unmasked pairs, or the bytes), and the forward with and
           without the log-sum-exp
  kernel:rtc_add
           NVRTC compile of ``csrc/rtc/add.cu`` through
           ``rtc.CudaModule`` (timed), the kernel against
           ``rtc.add_reference`` at (8, 128), 2**20+3 and 2**26 float32
           elements (exact) and 2**20+3 bfloat16; kernel/plain/library
           (``torch.add``) times and the bound at 2**26
  serve    vocab 32000, 12 layers, d_model 768, 12 heads, d_ff 3072,
           bf16, random weights from seed 0; slots 8, KV blocks of 16
           tokens, prompts up to 512, context up to 1024, prefill
           batches of 4; 16 requests with prompts over 16..512 and 32
           new tokens each, through ``submit_generation``; every
           prefill launch of the flash kernel on the ``wgmma`` route
  serve_http
           the same generator and 16 prompts through ``ModelServer`` +
           ``HttpFrontend`` on 127.0.0.1 (SIGTERM hook installed), 8
           streamed (one client resets after 4 tokens) and 8 blocking,
           beside the ``bench_serve`` predictor (dim 64, hidden 128,
           max batch 32: bench.py:758); then ``:predict`` of 32
           instances.  15/15 full replies, stream tokens = terminal
           count, the reset one ``cancelled`` and its blocks freed,
           ``:predict`` = ``runtime.execute``, probes 200, ``/metrics``
           valid with the request counters at the counts sent, every
           prefill flash launch on ``wgmma``; tokens/s, TTFT and TPOT
           p50/p99 (server side, as ``serve``; and at the streaming
           client) beside the ``serve`` phase's
  loadgen  ``gen_tokens_at_slo`` on the same generator (p99 TPOT SLO
           200 ms, bench.py:835; 4 req/s doubling to 64, 1.5 s
           windows): tokens/s at the SLO, TTFT p50/p99 there, the p99
           attribution of the ramp's slowest requests; then the
           continuous vs whole-batch A/B of bench.py:866-892 (16
           requests, every 8th at 32 new tokens, the rest 4-8) against
           a ``continuous=False`` twin sharing the weights, best of 3
  reload   the predictor under ``BackgroundLoad`` (300 req/s): weights
           of step 2 saved with ``checkpoint.save_checkpoint`` and
           reloaded (canary 50 %, 8 batches) must promote with zero
           dropped or failed requests; step 3 under chaos
           ``bad_version`` for version 3 must roll back while version
           2 keeps serving; time to promote, canary counts
  serve_cli
           ``python -m mxnet_tpu_torch.serving --self-test`` on the card
           (``"self_test_ok": true``), then ``--serve --port 0``: one
           ``:generate`` over HTTP, SIGTERM, exit code 83
  numerics the same width at 2 layers in float32: prefill logits through
           the kernel (``simt`` route) against ``apply`` with dense
           attention (1e-3 abs), and greedy tokens against the dense
           greedy reference
  ndarray  the imperative path on ``mx.gpu(0)``, twice (the first pass
           pays one-time costs): (4096, 4096) float32 operands, the rtc
           ``add`` kernel launched on them through ``CudaKernel.launch``,
           one 4096**3 ``dot``, a chain of elementwise, broadcast,
           reduce and matrix ops under ``autograd.record()`` and one
           ``backward()``; every result against numpy in float64 (error
           over the largest magnitude, 1e-4), ``nd.save``/``nd.load``
           round trips bitwise
  train    ResNet-50 v1 training at full width and depth (1000 classes,
           224x224, Xavier from numpy seed 0, SoftmaxCrossEntropyLoss,
           SGD lr 0.05 momentum 0.9) through ``FusedTrainStep.run_steps``
           in bf16 at batch 32 and at batch 128: 3 warm-up steps, then
           10 timed steps (synchronized); images/s, step ms, first and
           last losses (finite), peak memory, achieved TFLOP/s (3
           forwards of 2 x 4.09 G multiply-adds an image against the
           989 TFLOP/s bf16 peak); one float32
           step at batch 128 from the same weights and batch, whose loss
           the bf16 first loss must match within 2e-2 relative.  This
           path runs no hand-written kernel: convolutions and GEMMs are
           cuDNN/cuBLAS through torch, as the JAX package left them to XLA
  train_numerics
           ResNet-50 v1 at batch 4, 224x224: two ``FusedTrainStep``
           steps on the card and the same port on the CPU in float64
           from the same weights and batches.  The card in float64:
           losses within 1e-10 relative and the parameters' update
           within 1e-8 of its size, where a skipped step 2 or a step 2
           without momentum reads ~0.3-0.7 (checked from the reference
           trajectory).  The card in float32 (TF32 off): step 1's loss
           within 1e-4 relative; step 2's loss and the update within 5
           times the distance of the CPU's own float32 run from float64
           (see ``NUMERICS_FP32_FACTOR``)
  train_lm GPT-2-small width (vocab 32000, 12 layers, d_model 768, 12
           heads, d_ff 3072), bf16 compute over float32 parameters,
           ``TransformerTrainStep`` (SGD lr 0.01 momentum 0.9, remat
           none) on ``LMTokenIter`` batches of 8 x 1024 tokens: 3 warm
           steps, 5 timed windows of 4 steps (tokens/s and step ms from
           the median window, peak memory, TFLOP/s of 6 x N x tokens
           plus attention), 12 forward (all ``wgmma``) and 12 backward
           (all ``mma``) kernel launches a step; 2 steps under
           torch.profiler after a traced warm-up step (device busy ms
           and the idle share of the untraced step, device ms by kernel
           group); ``fit`` for 20 steps
           (finite, the last loss below the first), then 10 steps
           writing a checkpoint at step 10 and a fresh step resuming it
           to step 20: losses and parameters bitwise the 20-step run's
  train_lm_numerics
           2 layers, d_model 128, 2 heads, d_ff 512, vocab 512, batch 4
           x 256: 3 steps on the card in float32 (both kernels on the
           simt route) against the port on the CPU in float64 from the
           same parameters (``LM_NUM_*`` limits, the CPU's own float32
           distance beside); one bf16 step, its loss within 2e-2 of the
           float32 first loss
  kernels  every kernel and its status
"""
from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12     # float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12

GPT2_SMALL = dict(vocab_size=32000, n_layers=12, d_model=768, n_heads=12,
                  d_ff=3072)
SERVE = dict(slots=8, block_tokens=16, max_prompt=512, max_context=1024,
             prefill_batch=4, max_new=32)
N_REQUESTS = 16

# the repo's headline training row (bench.py:111 batch 32, :132 batch 128;
# bench_model at bench.py:283-305)
RESNET_BATCHES = (32, 128)
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
TRAIN_LR, TRAIN_MOMENTUM = 0.05, 0.9
# ResNet-50 v1 does 4.09 G multiply-adds a 224x224 forward (He et al.
# 2015, table 1; bench.py:185 lists them as GFLOP): 2 FLOP each
RESNET50_GFLOP = 2 * 4.09    # forward GFLOP a 224x224 image
TRAIN_FLOP_FACTOR = 3.0     # forward + dgrad + wgrad
BF16_LOSS_RTOL = 2e-2       # bf16 activations against float32, step 1
NUMERICS_BATCH = 4
# train_numerics holds the card's SGD-momentum trajectory, two steps in
# float64, against the same port on the CPU in float64: cuDNN's and the
# CPU's convolutions sum in other orders, and the gradients below the
# last block amplify that ~1e5-fold (the folded BatchNorm, below), so
# float64 agrees to ~1e-11 where float32 cannot tell a fault from its
# own rounding.  Errors: losses relative; parameters as ||card - cpu||
# over ||cpu - start|| (the size of the update) after each step
TRAJ_LOSS_RTOL = 1e-10
TRAJ_UPDATE_TOL = 1e-8
# the same two steps in float32 on the card are held to the CPU float64
# run too.  Step 1's loss is one forward: 1e-4 relative.  After that the
# float32 gradient of this net at this initialisation is ill-conditioned:
# the reference's BatchNorm folds its normalisation into a scale and a
# shift (ops/nn.py:465-471), so d/dscale = sum(dy*x) - mean*sum(dy), a
# difference of two large sums; on the CPU, float32 lies 1-3 % (norm)
# from float64 in the gradients below the last block, and the JAX
# package's float32 further (tools/resnet_fp32_conditioning.py).  So the
# float32 update and step 2's float32 loss are held to
# NUMERICS_FP32_FACTOR times how far the CPU's own float32 run of the
# same steps lies from float64, and never looser than these floors
TRAIN_LOSS_RTOL = 1e-4
TRAIN_UPDATE_TOL = 1e-3
NUMERICS_FP32_FACTOR = 5.0

# the largest error of an output row over the largest magnitude of that
# row of the plain version, per dtype: bf16 rounding of the output (and
# of P on the wgmma route) stays near 2**-9 of a row, where an absolute
# limit would let a late causal row (magnitude ~0.1) be wrong by tens of
# per cent; a row that should be all zero is held to zero
ROW_RTOL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}
# (B, Tq, Tk, H, D, causal, dtype, atol, layout); the first is the
# serving path's largest prefill cell (4 prompts padded to 512);
# layout "fused": q, k and v are strided views of one fused projection
KERNEL_SHAPES = [
    (4, 512, 512, 12, 64, True, torch.bfloat16, 2e-2, "dense"),
    (4, 512, 512, 12, 128, True, torch.bfloat16, 2e-2, "dense"),
    (2, 200, 200, 12, 64, True, torch.bfloat16, 2e-2, "dense"),
    (4, 512, 512, 12, 64, True, torch.bfloat16, 2e-2, "fused"),
    (1, 200, 200, 12, 64, True, torch.float32, 1e-4, "dense"),
    (2, 64, 192, 12, 64, True, torch.float32, 1e-4, "dense"),
    (2, 128, 128, 12, 64, False, torch.float32, 1e-4, "dense"),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 25, warmup: int = 3, inner: int = 1) -> float:
    """Median device time of ``fn`` over ``iters`` runs (CUDA events);
    with ``inner`` > 1 each run is that many calls back to back, divided
    out, so the host's launch overhead hides behind the device work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, inner: int = 10) -> float:
    """Device time of one ``fn`` call: ``inner`` calls captured in a
    CUDA graph, the replay timed as :func:`time_ms` does, divided by
    ``inner``.  No host launch cost is in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return time_ms(graph.replay) / inner


def row_scaled_err(got, want) -> float:
    """Largest error of a row of ``got`` (over its last dim) divided by
    the largest magnitude of the same row of ``want``."""
    err = (got.float() - want).abs().amax(-1)
    return (err / want.abs().amax(-1).clamp_min(1e-30)).max().item()


def attention_bound(B, Tq, Tk, H, D, causal, dtype):
    """(bound_ms, bound_by) for attention over these inputs: the larger
    of the bytes (q, k, v read once, o written once) over the memory
    rate and the FLOPs of the unmasked (q, k) pairs (two products of
    2*D each) over the peak rate of the input type."""
    if causal:
        shift = Tk - Tq
        pairs = sum(max(min(Tk, i + shift + 1), 0) for i in range(Tq))
    else:
        pairs = Tq * Tk
    flops = 4.0 * B * H * D * pairs
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * B * H * D * (2 * Tq + 2 * Tk)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_device():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": False})


def _kernel_label(mangled: str) -> str:
    """``flash_fwd_wgmma<64>``, ``flash_fwd_kernel<bf16,128>`` and so on
    from a mangled kernel name."""
    m = re.search(r"(flash_(?:fwd|bwd)_\w+?)I(13__nv_bfloat16|f)?Li(\d+)E",
                  mangled)
    if not m:
        return mangled
    dt = {"13__nv_bfloat16": "bf16,", "f": "f32,"}.get(m.group(2), "")
    return "%s<%s%s>" % (m.group(1), dt, m.group(3))


def _cuobjdump(lib: Path, flag: str) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, flag, str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def _sass_counts(sass: str):
    """{kernel: {"HGMMA": n, "UTMALDG": n, "UTMASTG": n}} from the
    output of ``cuobjdump -sass``."""
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = _kernel_label(m.group(1))
            out[cur] = {"HGMMA": 0, "UTMALDG": 0, "UTMASTG": 0}
        elif cur:
            for op in out[cur]:
                out[cur][op] += op in ln
    return out


def _res_usage(text: str):
    """{kernel: {"REG": n, "STACK": n, "LOCAL": n}} from the output of
    ``cuobjdump -res-usage`` (a spill lands in LOCAL and STACK)."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function (\S+?):", ln)
        if m:
            cur = _kernel_label(m.group(1))
            out[cur] = {}
        if cur:
            for key in ("REG", "STACK", "LOCAL"):
                m = re.search(r"\b%s:(\d+)" % key, ln)
                if m:
                    out[cur][key] = int(m.group(1))
    return out


def phase_build():
    from mxnet_tpu_torch import _build

    t0 = time.perf_counter()
    secs = _build.build()
    wall = time.perf_counter() - t0
    # ptxas speaks only when nvcc ran (printed, not read); cuobjdump
    # reads any built library, a cached one too
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in _build.build_logs.items()}
    lib = _build._lib_path(_build.sources()["flash_attn_fwd"])
    sass = _sass_counts(_cuobjdump(lib, "-sass"))
    usage = _res_usage(_cuobjdump(lib, "-res-usage"))
    bwd_lib = _build._lib_path(_build.sources()["flash_attn_bwd"])
    bwd_usage = _res_usage(_cuobjdump(bwd_lib, "-res-usage"))
    emit({"phase": "build", "seconds": round(wall, 3),
          "per_source_s": {k: round(v, 3) for k, v in secs.items()},
          "ptxas": ptxas, "flash_sass": sass, "flash_res_usage": usage,
          "flash_bwd_res_usage": bwd_usage})
    wgmma = ["flash_fwd_wgmma<64>", "flash_fwd_wgmma<128>"]
    if not all(sass.get(k, {}).get("HGMMA") and sass[k]["UTMALDG"]
               for k in wgmma):
        raise RuntimeError("build: the wgmma flash kernels lack HGMMA or "
                           "UTMALDG instructions: %r" % sass)
    spills = {k: usage.get(k) for k in wgmma
              if usage.get(k, {}).get("LOCAL", 1) or usage[k].get("STACK", 1)}
    bwd = ["flash_bwd_%s<%s,%d>" % (part, dt, d) for part in ("dq", "dkv")
           for dt in ("f32", "bf16") for d in (64, 128)] + \
        ["flash_bwd_%s_mma<%d>" % (part, d) for part in ("dq", "dkv")
         for d in (64, 128)]
    spills.update({k: bwd_usage.get(k) for k in bwd
                   if bwd_usage.get(k, {}).get("LOCAL", 1)
                   or bwd_usage[k].get("STACK", 1)})
    if spills:
        raise RuntimeError("build: the wgmma or backward flash kernels "
                           "spill (or their resource usage is unreadable): "
                           "%r" % spills)


def phase_kernel():
    from mxnet_tpu_torch.parallel.attention import (flash_attention,
                                                    flash_attention_fwd,
                                                    kernel_route)

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    rows = []
    for B, Tq, Tk, H, D, causal, dtype, atol, layout in KERNEL_SHAPES:
        if layout == "fused":
            # the prefill's q/k/v: column blocks of one projection
            qkv = torch.randn((B, Tq, 3 * H * D), generator=g).to(dev, dtype)
            q, k, v = (x.reshape(B, Tq, H, D)
                       for x in torch.split(qkv, H * D, dim=-1))
        else:
            q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev, dtype)
                       for T in (Tq, Tk, Tk))
        n0 = flash_attention_fwd.launches
        by0 = dict(flash_attention_fwd.launches_by_route)
        out = flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        route = [r for r, n in flash_attention_fwd.launches_by_route.items()
                 if n != by0[r]]
        want_route = kernel_route(dtype, D)
        if flash_attention_fwd.launches != n0 + 1 or route != [want_route]:
            raise RuntimeError("flash_attention_fwd did not count one "
                               "launch on the %s route: %r"
                               % (want_route, route))
        qf, kf, vf = q.float(), k.float(), v.float()
        want = flash_attention(qf, kf, vf, causal=causal)
        if out.shape != q.shape or out.dtype != dtype:
            raise RuntimeError("kernel output %s %s" % (out.shape,
                                                        out.dtype))
        if not torch.isfinite(out).all():
            raise RuntimeError("kernel output is not finite")
        err = (out.float() - want).abs().max().item()
        row_err = row_scaled_err(out, want)
        # the library yardstick: one PyTorch call for the same function
        # (BHTD layout; an explicit mask for the aligned diagonal)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if causal and Tq != Tk:
            mask = torch.ones((Tq, Tk), dtype=torch.bool,
                              device=dev).tril(Tk - Tq)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal)
        lib_err = (lib().transpose(1, 2).float() - want).abs().max().item()
        bound_ms, bound_by = attention_bound(B, Tq, Tk, H, D, causal,
                                             dtype)
        kern = lambda: flash_attention_fwd(q, k, v,  # noqa: E731
                                           causal=causal)
        # device times over runs of 10 back-to-back calls on inputs that
        # stay in the 50 MB L2 (hot); single_call_ms is one call between
        # two events, host launch cost included, as serving pays it
        row = {
            "shape": [B, Tq, Tk, H, D], "causal": causal,
            "dtype": str(dtype).replace("torch.", ""), "layout": layout,
            "route": want_route, "max_err": err, "atol": atol,
            "row_err": row_err, "row_rtol": ROW_RTOL[dtype], "l2": "hot",
            "kernel_ms": time_ms(kern, inner=10),
            "plain_ms": time_ms(lambda: flash_attention(
                qf, kf, vf, causal=causal), inner=10),
            "library_ms": time_ms(lib, inner=10),
            "single_call_ms": time_ms(kern),
            "library_single_call_ms": time_ms(lib),
            "graph_ms": graph_ms(kern), "library_graph_ms": graph_ms(lib),
            "library_max_err": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit(dict({"phase": "kernel:flash_attention_fwd"}, **row))
        if not (err <= atol and row_err <= ROW_RTOL[dtype]):
            raise RuntimeError("flash_attention_fwd disagrees with the "
                               "plain version at %s: error %g (limit %g), "
                               "row-scaled %g (limit %g)"
                               % (row["shape"], err, atol, row_err,
                                  ROW_RTOL[dtype]))
        rows.append(row)
    return rows


# (B, Tq, Tk, H, D, causal, dtype, layout); the first is the train_lm
# phase's attention (GPT-2-small width, batch 8, seq 1024, bf16: the
# wgmma forward); layout "fused": q, k and v are the strided views of
# one fused projection that transformer/model.py _qkv makes
BWD_SHAPES = [
    (8, 1024, 1024, 12, 64, True, torch.bfloat16, "dense"),
    (2, 512, 512, 12, 128, True, torch.bfloat16, "dense"),
    (2, 1000, 1000, 12, 64, True, torch.bfloat16, "dense"),
    (2, 384, 512, 12, 64, True, torch.bfloat16, "dense"),
    (2, 512, 512, 12, 64, False, torch.bfloat16, "dense"),
    (8, 1024, 1024, 12, 64, True, torch.bfloat16, "fused"),
    (2, 512, 512, 12, 64, True, torch.float32, "dense"),
    (2, 300, 200, 12, 64, True, torch.float32, "dense"),
]
# a gradient's error over the largest magnitude of its head (each (b, h)
# slice): the scale of its rounding (a row can cancel to ~0, as causal
# row 0 of dq does exactly, so a row's own magnitude is no scale).
# Against the plain backward on the same inputs (the kernel's own o and
# lse): float32 is another summation order; bf16 (the mma route) rounds
# P and dS to bf16 for their products and the gradients on output.
# Against autograd of attention_reference in float32: bf16 also carries
# the wgmma forward's bf16 P in o
BWD_HEAD_RTOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
BWD_AUTOGRAD_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def head_scaled_err(got, want) -> float:
    """Largest error of a (B, T, H, D) tensor within each (b, h) head
    over the largest magnitude of ``want`` in that head."""
    err = (got.float() - want.float()).abs().amax(dim=(1, 3))
    return (err / want.float().abs().amax(dim=(1, 3)).clamp_min(1e-30)
            ).max().item()


def causal_pairs(Tq, Tk, causal):
    if not causal:
        return Tq * Tk
    shift = Tk - Tq
    return sum(max(min(Tk, i + shift + 1), 0) for i in range(Tq))


def attention_bwd_bound(B, Tq, Tk, H, D, causal, dtype):
    """(bound_ms, bound_by) of the attention backward: the larger of the
    bytes (q, k, v, o, dO and lse read once, dq, dk and dv written once)
    over the memory rate, and five products of 2*D FLOPs over the
    unmasked (q, k) pairs over the input type's peak."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * B * H * D * (4 * Tq + 4 * Tk) + 4 * B * H * Tq
    flops = 5 * 2.0 * B * H * D * causal_pairs(Tq, Tk, causal)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_kernel_bwd():
    """The backward kernel against its plain version and against
    autograd of ``attention_reference``, at the training path's shape
    and the edge cases; times at the first shape."""
    from mxnet_tpu_torch.parallel.attention import (
        attention_reference, bwd_route, flash_attention_bwd,
        flash_attention_bwd_reference, flash_attention_fwd, kernel_route)

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    rows = []
    for i, (B, Tq, Tk, H, D, causal, dtype, layout) in enumerate(BWD_SHAPES):
        if layout == "fused":
            qkv = torch.randn((B, Tq, 3 * H * D), generator=g).to(dev, dtype)
            q, k, v = (x.reshape(B, Tq, H, D)
                       for x in torch.split(qkv, H * D, dim=-1))
        else:
            q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev, dtype)
                       for T in (Tq, Tk, Tk))
        do = torch.randn((B, Tq, H, D), generator=g).to(dev, dtype)
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     return_lse=True)
        route = bwd_route(q, k, v, o, do)
        want_route = "mma" if dtype == torch.bfloat16 else "simt"
        n0 = flash_attention_bwd.launches_by_route[route]
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        if route != want_route or \
                flash_attention_bwd.launches_by_route[route] != n0 + 1:
            raise RuntimeError("flash_attention_bwd did not count one "
                               "launch on the %s route (%s)"
                               % (want_route, route))
        f32 = [t.float() for t in (q, k, v, o, do)]
        want = flash_attention_bwd_reference(f32[0], f32[1], f32[2], f32[3],
                                             lse, f32[4], causal=causal)
        leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
        # attention_reference gives a row that sees no key (causal, Tq >
        # Tk) the mean of V where flash attention gives 0: no gradient
        # flows from such a row in the function the kernel computes
        do_ref = f32[4].clone()
        if causal and Tq > Tk:
            do_ref[:, :Tq - Tk] = 0
        ref = torch.autograd.grad(
            attention_reference(*leaves, causal=causal), leaves, do_ref)
        del leaves, do_ref
        bad = [n for n, t in zip(("dq", "dk", "dv"), got)
               if t.dtype != dtype or t.shape != (q if n == "dq" else k).shape
               or not torch.isfinite(t).all()]
        if bad:
            raise RuntimeError("flash_attention_bwd: bad %s at %s"
                               % (bad, (B, Tq, Tk, H, D)))
        row = {"shape": [B, Tq, Tk, H, D], "causal": causal,
               "dtype": str(dtype).replace("torch.", ""), "layout": layout,
               "forward_route": kernel_route(dtype, D), "route": route,
               "max_err": max((a.float() - b).abs().max().item()
                              for a, b in zip(got, want)),
               "head_err": {n: head_scaled_err(a, b) for n, a, b in
                            zip(("dq", "dk", "dv"), got, want)},
               "head_rtol": BWD_HEAD_RTOL[dtype],
               "autograd_head_err": {n: head_scaled_err(a, b) for n, a, b in
                                     zip(("dq", "dk", "dv"), got, ref)},
               "autograd_head_rtol": BWD_AUTOGRAD_RTOL[dtype]}
        if causal and Tq > Tk:
            row["masked_rows_dq_nonzero"] = int(
                torch.count_nonzero(got[0][:, :Tq - Tk]))
        if i == 0:
            bound_ms, bound_by = attention_bwd_bound(B, Tq, Tk, H, D,
                                                     causal, dtype)
            kern = lambda: flash_attention_bwd(  # noqa: E731
                q, k, v, o, lse, do, causal=causal)
            # the library yardstick: SDPA's backward alone (BHTD), its
            # forward run once outside the timing
            qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                          for t in (q, k, v))
            out_t = F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal)
            do_t = do.transpose(1, 2)
            lib = lambda: torch.autograd.grad(  # noqa: E731
                out_t, (qt, kt, vt), do_t, retain_graph=True)
            row.update({
                "kernel_ms": time_ms(kern, iters=10),
                "graph_ms": graph_ms(kern, inner=3),
                "plain_ms": time_ms(lambda: flash_attention_bwd_reference(
                    f32[0], f32[1], f32[2], f32[3], lse, f32[4],
                    causal=causal), iters=5, warmup=1),
                "library_ms": time_ms(lib, iters=10),
                "fwd_lse_ms": time_ms(lambda: flash_attention_fwd(
                    q, k, v, causal=causal, return_lse=True), inner=10),
                "fwd_ms": time_ms(lambda: flash_attention_fwd(
                    q, k, v, causal=causal), inner=10),
                "bound_ms": bound_ms, "bound_by": bound_by})
            del out_t, qt, kt, vt
        emit(dict({"phase": "kernel:flash_attention_bwd"}, **row))
        if max(row["head_err"].values()) > BWD_HEAD_RTOL[dtype] or \
                max(row["autograd_head_err"].values()) > \
                BWD_AUTOGRAD_RTOL[dtype] or row.get("masked_rows_dq_nonzero"):
            raise RuntimeError("flash_attention_bwd disagrees at %s: %r"
                               % (row["shape"], row))
        rows.append(row)
        del q, k, v, o, lse, do, got, want, ref, f32
    return rows


def _add_grid(n: int):
    """Grid of the rtc add kernel: 256 threads a block, 4 elements a
    thread, at most 8 blocks per SM (the loop strides over the rest)."""
    return (max(1, min(-(-n // (256 * 4)), 132 * 8)), 1, 1), (256, 1, 1)


def _add_source() -> str:
    import mxnet_tpu_torch

    return (Path(mxnet_tpu_torch.__file__).resolve().parent / "csrc"
            / "rtc" / "add.cu").read_text()


ADD_SIG = "const {0} *x, const {0} *y, {0} *out, long n"
# (elements, dtype, kernel name, C type)
RTC_ADD_SIZES = [
    ((8, 128), torch.float32, "add", "float"),
    ((2 ** 20 + 3,), torch.float32, "add", "float"),
    ((2 ** 26,), torch.float32, "add", "float"),
    ((2 ** 20 + 3,), torch.bfloat16, "add_bf16", "__nv_bfloat16"),
]


def phase_rtc_add():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc

    t0 = time.perf_counter()
    mod = rtc.CudaModule(_add_source())
    nvrtc_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape, dtype, name, ctype in RTC_ADD_SIZES:
        k = mod.get_kernel(name, ADD_SIG.format(ctype))
        x, y = (mx.nd.NDArray.from_raw(
            torch.randn(shape, generator=g, device=dev).to(dtype),
            mx.gpu(0)) for _ in range(2))
        out = mx.nd.zeros(shape, ctx=mx.gpu(0), dtype=dtype)
        n = x.size
        grid, block = _add_grid(n)
        n0 = rtc.launches[name]

        def launch():
            k.launch([x, y, out, n], mx.gpu(0), grid, block)

        launch()
        torch.cuda.synchronize()
        if rtc.launches[name] != n0 + 1:
            raise RuntimeError("rtc add did not count its launch")
        want = rtc.add_reference(x._data, y._data)
        err = (out._data.float() - want.float()).abs().max().item()
        row = {"shape": list(shape), "dtype": str(dtype).replace(
            "torch.", ""), "kernel": name, "grid": list(grid),
            "max_err": err, "atol": 0.0,
            "bitwise_equal": bool(torch.equal(out._data, want))}
        if n == 2 ** 26:
            row.update({
                "kernel_ms": time_ms(launch, inner=10),
                "plain_ms": time_ms(lambda: rtc.add_reference(
                    x._data, y._data), inner=10),
                "library_ms": time_ms(lambda: torch.add(x._data, y._data),
                                      inner=10),
                "single_call_ms": time_ms(launch),
                # bytes: x and y read once, out written once; one add a
                # element is far below the card's operations per byte
                "bound_ms": 3 * n * x._data.element_size()
                / PEAK_BYTES_S * 1e3,
                "bound_by": "bytes"})
        emit(dict({"phase": "kernel:rtc_add"}, **row))
        if not row["bitwise_equal"]:
            raise RuntimeError("rtc add disagrees with add_reference at %s "
                               "%s: max error %g" % (shape, dtype, err))
        rows.append(row)
    emit({"phase": "kernel:rtc_add", "nvrtc_s": nvrtc_s,
          "nvrtc": rtc._nvrtc.path, "nvrtc_version": rtc._nvrtc.version(),
          "arch": rtc.ARCH, "cubin_bytes": len(mod.cubin)})
    return rows


ND_N = 4096
ND_RTOL = 1e-4


def _rel_err(got, want):
    """Largest error over the largest magnitude of ``want`` (float64)."""
    got = np.asarray(got, dtype=np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


def phase_ndarray():
    """The imperative path at (4096, 4096) float32 on the card: the rtc
    add, a 4096**3 dot, elementwise/broadcast/reduce/matrix ops, one
    recorded backward, save/load; numpy float64 on the host checks."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc

    nd, n = mx.nd, ND_N
    rng = np.random.RandomState(0)
    a = rng.randn(n, n).astype(np.float32)
    b = rng.randn(n, n).astype(np.float32)
    bias = rng.randn(1, n).astype(np.float32)
    ctx = mx.gpu(0)
    mod = rtc.CudaModule(_add_source())      # cached by the kernel phase
    add = mod.get_kernel("add", ADD_SIG.format("float"))

    def drive():
        """One pass of the path; returns its arrays, op count and the
        host-clock seconds of the upload and of the ops (each synced)."""
        ops = 0

        def op(f, *args, **kw):
            nonlocal ops
            ops += 1
            return f(*args, **kw)

        t0 = time.perf_counter()
        x = nd.array(a, ctx=ctx)
        w = nd.array(b, ctx=ctx)
        c = nd.array(bias, ctx=ctx)
        x.attach_grad()
        w.attach_grad()
        nd.waitall()
        t1 = time.perf_counter()
        s = op(nd.zeros, (n, n), ctx=ctx)
        grid, block = _add_grid(s.size)
        op(add.launch, [x, w, s, s.size], ctx, grid, block)  # s = x + w
        with mx.autograd.record():
            h = op(nd.dot, x, w) / float(n // 64)             # 4096**3
            ops += 1
            g = op(nd.sigmoid, s)
            z = op(nd.relu, op(nd.broadcast_add, h, c)) * g
            ops += 1
            m = op(z.mean, axis=1)
            loss = op((m * m).sum)
            ops += 1
        loss.backward()
        out = dict(x=x, w=w, s=s, h=h, z=z, m=m, loss=loss,
                   zmax=op(z.max, axis=0), arg=op(nd.argmax, z, axis=1),
                   zt=op(nd.transpose, z)[::3, 1:257],
                   top=op(z.topk, axis=1, k=4, ret_typ="value"))
        ops += 1
        nd.waitall()
        return out, ops, t1 - t0, time.perf_counter() - t1

    torch.cuda.synchronize()
    # the path, twice (the first pass pays one-time costs): counts start
    # at 0 here and are read just after
    rtc.launches.clear()
    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        res, ops, upload_s, ops_s = drive()
        passes.append({"wall_s": time.perf_counter() - t0,
                       "upload_s": upload_s, "ops_s": ops_s})
    launches = dict(rtc.launches)
    x, w, s, h, z, m, loss = (res[k] for k in "x w s h z m loss".split())
    zmax, arg, zt, top = (res[k] for k in ("zmax", "arg", "zt", "top"))

    # numpy float64 on the host
    a64, b64, c64 = (v.astype(np.float64) for v in (a, b, bias))
    s64 = a64 + b64
    h64 = a64 @ b64 / (n // 64)
    g64 = 1.0 / (1.0 + np.exp(-s64))
    pre = h64 + c64
    z64 = np.maximum(pre, 0.0) * g64
    m64 = z64.mean(axis=1)
    z32 = z.asnumpy()
    dz = np.broadcast_to((2.0 * m64 / n)[:, None], z64.shape)
    # relu's branch as the card took it (z > 0 exactly where h + c > 0):
    # an element within float32 rounding of 0 may fall on the other side
    # in float64, and one such flip moves a whole gradient row by ~1e-2
    dh = dz * g64 * (z32 > 0) / (n // 64)
    checks = {
        "rtc_add": _rel_err(s.asnumpy(), s64),
        "dot": _rel_err(h.asnumpy(), h64),
        "z": _rel_err(z32, z64),
        "mean": _rel_err(m.asnumpy(), m64),
        "loss": _rel_err(loss.asnumpy(), np.asarray((m64 * m64).sum())),
        "max": _rel_err(zmax.asnumpy(), z64.max(axis=0)),
        "transpose_slice": _rel_err(zt.asnumpy(), z64.T[::3, 1:257]),
        "topk": _rel_err(top.asnumpy(), -np.sort(-z64, axis=1)[:, :4]),
        "grad_x": _rel_err(x.grad.asnumpy(), dh @ b64.T),
        "grad_w": _rel_err(w.grad.asnumpy(), a64.T @ dh),
    }
    # argmax: ties aside, the float32 result's argmax must pick a value
    # within the tolerance of the float64 row maximum
    picked = z64[np.arange(n), arg.asnumpy().astype(np.int64)]
    checks["argmax"] = _rel_err(picked, z64.max(axis=1))
    rtc_exact = bool(np.array_equal(s.asnumpy(), a + b))

    # save / load round trips, bitwise, in both formats
    build = Path(mx.__file__).resolve().parent / "_build"
    build.mkdir(parents=True, exist_ok=True)
    saved = {}
    with tempfile.TemporaryDirectory(dir=str(build)) as d:
        for fmt in ("params", "npz"):
            path = str(Path(d) / ("nd." + fmt))
            payload = {"z": z, "w": w, "arg": arg,
                       "bf16": s.astype("bfloat16")}
            if fmt == "params":
                payload.pop("bf16")      # the container has no bfloat16
            t1 = time.perf_counter()
            nd.save(path, payload)
            back = nd.load(path, ctx=ctx)
            saved[fmt] = {
                "bitwise": all(torch.equal(back[k]._data, v._data)
                               for k, v in payload.items()),
                "bytes": Path(path).stat().st_size,
                "seconds": time.perf_counter() - t1}
    row = {"phase": "ndarray", "n": n, "dtype": "float32", "ops": ops,
           "passes": passes, "rtol": ND_RTOL, "rel_err": checks,
           "rtc_add_exact": rtc_exact, "rtc_launches": launches,
           "save_load": saved}
    emit(row)
    bad = {k: v for k, v in checks.items() if not v <= ND_RTOL}
    if bad:
        raise RuntimeError("ndarray: results differ from numpy float64 "
                           "beyond %g: %r" % (ND_RTOL, bad))
    if not rtc_exact:
        raise RuntimeError("ndarray: the rtc add is not x + y exactly")
    if launches.get("add", 0) != len(passes):
        raise RuntimeError("ndarray: the rtc add ran %r times on the path"
                           % launches)
    if not all(v["bitwise"] for v in saved.values()):
        raise RuntimeError("ndarray: save/load is not bitwise: %r" % saved)
    return row


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if xs else None


def phase_serve():
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.parallel.attention import flash_attention_fwd
    from mxnet_tpu_torch.transformer import model as tm

    cfg = tm.TransformerConfig(dtype="bfloat16", param_dtype="bfloat16",
                               **GPT2_SMALL)
    torch.cuda.reset_peak_memory_stats()
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    rt = serving.GenerationRuntime("gpt2_small", params, cfg, **SERVE)
    srv = serving.ModelServer()
    t0 = time.perf_counter()
    srv.add_generator(rt)       # warms every prefill and decode cell
    warm_s = time.perf_counter() - t0

    rng = np.random.RandomState(0)
    lens = rng.permutation(np.linspace(16, SERVE["max_prompt"],
                                       N_REQUESTS).astype(int))
    prompts = [rng.randint(1, cfg.vocab_size, size=n) for n in lens]
    # the serving path: counts start at 0 here and are read just after
    flash_attention_fwd.launches = 0
    flash_attention_fwd.launches_by_route = {"wgmma": 0, "simt": 0}
    batches0 = rt.engine.prefill_batches
    t0 = time.perf_counter()
    reqs = [srv.submit_generation("gpt2_small", p,
                                  max_new=SERVE["max_new"],
                                  deadline_ms=None) for p in prompts]
    results = [r.wait(600.0) for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_fwd.launches
    by_route = dict(flash_attention_fwd.launches_by_route)
    batches = rt.engine.prefill_batches - batches0
    kv = rt.kv.stats()
    drain = srv.drain(timeout_s=60.0)

    ok = [r for r in results if len(r["tokens"]) == SERVE["max_new"]
          and all(0 <= t < cfg.vocab_size for t in r["tokens"])]
    ttft = [r.ttft_s() * 1e3 for r in reqs if r.ttft_s() is not None]
    tpot = [d * 1e3 for r in reqs for d in r.tpot_s()]
    tokens = sum(len(r["tokens"]) for r in ok)
    row = {
        "phase": "serve", "config": dict(GPT2_SMALL, dtype="bfloat16"),
        "serve": SERVE, "requests": N_REQUESTS, "requests_ok": len(ok),
        "prompt_tokens": int(lens.sum()), "tokens_out": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_ms_p50": _pct(ttft, 50), "ttft_ms_p99": _pct(ttft, 99),
        "tpot_ms_p50": _pct(tpot, 50), "tpot_ms_p99": _pct(tpot, 99),
        "warmup_s": warm_s,
        "warmup_cells": len(rt.prefill_plan) + len(rt.decode_plan),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "prefill_batches": batches, "flash_launches": launches,
        "flash_launches_by_route": by_route,
        "decode_ticks": rt.engine.ticks, "kv": kv, "drain": drain,
    }
    emit(row)
    if len(ok) != N_REQUESTS:
        raise RuntimeError("serve: %d of %d requests ok"
                           % (len(ok), N_REQUESTS))
    if launches == 0 or launches != cfg.n_layers * batches:
        raise RuntimeError("serve: %d flash launches for %d prefill "
                           "batches of %d layers" % (launches, batches,
                                                     cfg.n_layers))
    if by_route["wgmma"] != launches:
        raise RuntimeError("serve: the prefill's bf16 attention left the "
                           "wgmma route: %r" % by_route)
    if kv["blocks_live"] != 0 or not drain["drained"]:
        raise RuntimeError("serve: leaked KV blocks or undrained: %r %r"
                           % (kv, drain))
    return row, rt, prompts


# ---------------------------------------------------------------------
# the serving tier over HTTP, the load generator, live reload, the CLI
# ---------------------------------------------------------------------
def _flash_counts_reset():
    from mxnet_tpu_torch.parallel.attention import flash_attention_fwd

    flash_attention_fwd.launches = 0
    flash_attention_fwd.launches_by_route = {"wgmma": 0, "simt": 0}


def _flash_counts():
    from mxnet_tpu_torch.parallel.attention import flash_attention_fwd

    return (flash_attention_fwd.launches,
            dict(flash_attention_fwd.launches_by_route))


def _stream_generate(host, port, model, body, stop_after=None):
    """POST a streaming ``:generate`` on a raw socket and de-chunk the
    reply: returns ``(t_sent, [(t_arrival, line_obj), ...])``.  With
    ``stop_after`` the client reads that many token lines and then
    resets the connection (a client that went away)."""
    import socket
    import struct

    data = json.dumps(dict(body, stream=True)).encode()
    sk = socket.create_connection((host, port), timeout=600)
    buf = b""
    lines = []
    t_sent = time.perf_counter()
    sk.sendall(b"POST /v1/models/%s:generate HTTP/1.1\r\nHost: smoke\r\n"
               b"Content-Type: application/json\r\nContent-Length: %d"
               b"\r\n\r\n" % (model.encode(), len(data)) + data)

    def fill():
        chunk = sk.recv(65536)
        if not chunk:
            raise RuntimeError("stream closed early")
        return chunk

    while b"\r\n\r\n" not in buf:
        buf += fill()
    head, buf = buf.split(b"\r\n\r\n", 1)
    if not head.startswith(b"HTTP/1.0 200") and \
            not head.startswith(b"HTTP/1.1 200"):
        raise RuntimeError("stream: %r" % head[:200])
    while True:
        while b"\r\n" not in buf:
            buf += fill()
        size_line, buf = buf.split(b"\r\n", 1)
        size = int(size_line, 16)
        if size == 0:
            break
        while len(buf) < size + 2:
            buf += fill()
        obj = json.loads(buf[:size])
        buf = buf[size + 2:]
        lines.append((time.perf_counter(), obj))
        if stop_after is not None and len(lines) >= stop_after:
            sk.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                          struct.pack("ii", 1, 0))  # close sends RST
            break
    sk.close()
    return t_sent, lines


def _post_json(base, path, payload, timeout=600):
    import urllib.request

    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(base, path):
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return resp.status, resp.read().decode()


def _counter_values(diag, prefix="mxnet_serve_requests_total"):
    return {k: v["value"] for k, v in diag.metrics.dump_json()[
        "metrics"].items() if k.startswith(prefix)}


def http_clients(host, port, model, prompts, max_new):
    """One client thread a prompt against ``:generate``: even ones
    stream (the first resets after 4 tokens), odd ones block.  Returns
    the JSON-able ``{"results", "errors", "wall_s"}``; times are this
    process's ``perf_counter``."""
    import threading

    base = "http://%s:%d" % (host, port)
    results = [None] * len(prompts)
    errors = []

    def client(i, p):
        try:
            body = {"prompt": p, "max_new": max_new, "deadline_ms": None}
            if i % 2 == 0:   # streamed
                results[i] = ("stream",) + _stream_generate(
                    host, port, model, body,
                    stop_after=4 if i == 0 else None)
            else:
                t0 = time.perf_counter()
                st, out = _post_json(base, "/v1/models/%s:generate"
                                     % model, body)
                results[i] = ("blocking", t0, (time.perf_counter(), st, out))
        except Exception as e:  # reported to the caller
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    return {"results": results, "errors": errors,
            "wall_s": time.perf_counter() - t0}


def phase_serve_http(rt, prompts, serve_row):
    """The serve phase's generator and 16 prompts through
    ``ModelServer`` + ``HttpFrontend`` on 127.0.0.1: 8 streamed (one
    client resets after 4 tokens), 8 blocking, sent from a client
    process, then one ``:predict`` of 32 instances to the
    ``bench_serve`` predictor beside it."""
    from mxnet_tpu_torch import diagnostics as diag
    from mxnet_tpu_torch import serving

    pred = serving.demo_runtime("bench_serve", dim=64, hidden=128,
                                max_batch=32)
    srv = serving.ModelServer()
    srv.add_model(pred)
    srv.add_generator(rt)          # already warm
    srv.install_preemption_hook()
    fe = serving.HttpFrontend(srv, host="127.0.0.1", port=0)
    host, port = fe.start()
    base = "http://%s:%d" % (host, port)
    name = rt.name
    max_new = SERVE["max_new"]
    try:
        ready0 = _get(base, "/readyz")[0]
        healthy = _get(base, "/healthz")[0]
        # the server side of each request: the same TTFT/TPOT clock as
        # the serve phase (enqueue -> emitted token)
        gen_reqs = []
        submit = srv.submit_generation

        def recording_submit(*a, **k):
            r = submit(*a, **k)
            gen_reqs.append(r)
            return r
        srv.submit_generation = recording_submit
        counts0 = _counter_values(diag)
        batches0 = rt.engine.prefill_batches
        # the clients run in a process of their own, as callers do: in
        # this one they would wait on the interpreter lock behind the
        # engine thread, and their late sends would read as latency
        _flash_counts_reset()
        args = {"host": host, "port": port, "model": name,
                "prompts": [[int(t) for t in p] for p in prompts],
                "max_new": max_new}
        proc = subprocess.run(
            [sys.executable, "-c", "import json, sys, chip_smoke; print("
             "json.dumps(chip_smoke.http_clients(**json.loads("
             "sys.argv[1]))))", json.dumps(args)],
            cwd=str(Path(__file__).resolve().parent), capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError("serve_http: clients failed:\n%s"
                               % proc.stderr[-4000:])
        clients = json.loads(proc.stdout.strip().splitlines()[-1])
        results, errors, wall = (clients["results"], clients["errors"],
                                 clients["wall_s"])
        torch.cuda.synchronize()
        launches, by_route = _flash_counts()
        if errors:
            raise RuntimeError("serve_http: client errors %r" % errors)
        batches = rt.engine.prefill_batches - batches0
        # the reset client's request is reaped on the next tick
        deadline = time.monotonic() + 30.0
        while (rt.kv.stats()["blocks_live"]
               or not all(r.done() for r in gen_reqs)) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        kv = rt.kv.stats()
        x = np.random.RandomState(5).randn(32, 64).astype(np.float32)
        st, pred_out = _post_json(base, "/v1/models/bench_serve:predict",
                                  {"instances": x.tolist()})
        want_cls, want_logits = pred.execute(x)
        got_logits = np.asarray(pred_out["predictions"][1])
        pred_err = float(np.abs(got_logits - want_logits).max() /
                         np.abs(want_logits).max())
        prom = _get(base, "/metrics")[1]
        counts1 = _counter_values(diag)
    finally:
        srv.submit_generation = submit
        drain = srv.drain(timeout_s=60.0)
        srv.uninstall_preemption_hook()
        fe.stop()

    full, stream_ok, ttft_c, tpot_c = 0, True, [], []
    for i, res in enumerate(results):
        if res[0] == "stream":
            _, t_sent, lines = res
            toks = [o for _, o in lines if "token" in o]
            if i == 0:
                continue
            done = lines[-1][1]
            ok = done.get("done") is True and done["tokens"] == len(toks) \
                == max_new
            stream_ok &= ok
            full += ok
            ts = [t for t, o in lines if "token" in o]
            ttft_c.append((ts[0] - t_sent) * 1e3)
            tpot_c += [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]
        else:
            _, _, (_, st_, out) = res
            full += st_ == 200 and len(out["tokens"]) == max_new
    delta = {k: counts1.get(k, 0.0) - counts0.get(k, 0.0)
             for k in counts1}

    def count(model, outcome):
        return delta.get('mxnet_serve_requests_total{model="%s",outcome='
                         '"%s",version="v1"}' % (model, outcome), 0.0)
    cancelled = [r for r in gen_reqs
                 if type(r.error).__name__ == "Cancelled"]
    ttft = [r.ttft_s() * 1e3 for r in gen_reqs if r.ttft_s() is not None]
    tpot = [d * 1e3 for r in gen_reqs for d in r.tpot_s()]
    tokens = sum(len(r.tokens) for r in gen_reqs
                 if r.error is None)
    # the server's own wall, first admission to last reply: the clients'
    # connects spread the arrivals, which the in-process phase has not
    first_in = min(r.enqueue_ts for r in gen_reqs)
    server_wall = max(r.done_ts for r in gen_reqs) - first_in
    row = {
        "phase": "serve_http", "requests": len(prompts),
        "streamed": len(prompts) // 2, "full_replies": int(full),
        "wall_s": wall, "tokens_out": tokens,
        "tokens_per_s": tokens / wall,
        "server_wall_s": server_wall,
        "server_tokens_per_s": tokens / server_wall,
        "arrival_spread_ms": (max(r.enqueue_ts for r in gen_reqs)
                              - first_in) * 1e3,
        "ttft_ms_p50": _pct(ttft, 50), "ttft_ms_p99": _pct(ttft, 99),
        "tpot_ms_p50": _pct(tpot, 50), "tpot_ms_p99": _pct(tpot, 99),
        "client_stream_ttft_ms_p50": _pct(ttft_c, 50),
        "client_stream_ttft_ms_p99": _pct(ttft_c, 99),
        "client_stream_tpot_ms_p50": _pct(tpot_c, 50),
        "client_stream_tpot_ms_p99": _pct(tpot_c, 99),
        "serve_phase": {k: serve_row[k] for k in (
            "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99", "tpot_ms_p50",
            "tpot_ms_p99")},
        "cancelled": len(cancelled), "kv": kv,
        "readyz_before": ready0, "healthz": healthy,
        "predict_status": st, "predict_max_rel_err": pred_err,
        "prom_problems": diag.validate_prom_text(prom),
        "requests_total_delta": {
            "generate_ok": count(name, "ok"),
            "generate_cancelled": count(name, "cancelled"),
            "predict_ok": count("bench_serve", "ok")},
        "prefill_batches": batches, "flash_launches": launches,
        "flash_launches_by_route": by_route, "drain": drain,
    }
    emit(row)
    n = len(prompts)
    if full != n - 1 or not stream_ok:
        raise RuntimeError("serve_http: %d of %d full replies (streams "
                           "consistent: %s)" % (full, n - 1, stream_ok))
    if len(cancelled) != 1 or row["requests_total_delta"] != {
            "generate_ok": n - 1, "generate_cancelled": 1,
            "predict_ok": 1}:
        raise RuntimeError("serve_http: outcome counts %r, cancelled %d"
                           % (row["requests_total_delta"],
                              len(cancelled)))
    if kv["blocks_live"] != 0 or not drain["drained"]:
        raise RuntimeError("serve_http: KV or drain: %r %r" % (kv, drain))
    if (ready0, healthy, st) != (200, 200, 200) or row["prom_problems"]:
        raise RuntimeError("serve_http: probes/metrics: %r" % row)
    if not np.array_equal(np.asarray(pred_out["predictions"][0]),
                          want_cls) or pred_err > 2.0 ** -8:
        raise RuntimeError("serve_http: :predict != runtime.execute "
                           "(rel err %r)" % pred_err)
    if launches == 0 or launches != rt.cfg.n_layers * batches or \
            by_route["wgmma"] != launches:
        raise RuntimeError("serve_http: flash launches %d (%r) for %d "
                           "prefill batches" % (launches, by_route,
                                                batches))
    return row, pred


LOAD_SLO_TPOT_MS = 200.0     # bench.py:835 bench_generation's default
LOAD_MAX_QPS = 64.0          # the ramp's cap: 4, 8, 16, 32, 64
AB_REPEATS = 3


def phase_loadgen(rt):
    """``gen_tokens_at_slo`` over the full-width generator (p99 TPOT SLO
    200 ms, from 4 req/s doubling to the cap, 1.5 s windows), then the
    continuous vs whole-batch A/B of bench.py:866-892 on its
    mixed-length work list through a ``continuous=False`` twin that
    shares the weights."""
    import random

    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.serving import reqtrace

    reqtrace.reset(capacity=512, topk=16)
    srv = serving.ModelServer(queue_max=256, default_deadline_ms=30000)
    srv.add_generator(rt)
    _flash_counts_reset()
    t0 = time.perf_counter()
    rep = serving.gen_tokens_at_slo(
        srv, rt.name, slo_p99_tpot_ms=LOAD_SLO_TPOT_MS, start_qps=4.0,
        max_qps=LOAD_MAX_QPS, window_s=1.5)
    ramp_s = time.perf_counter() - t0
    launches, by_route = _flash_counts()
    slowest = reqtrace.top_slowest()
    shares = reqtrace.attribution_shares(slowest)
    slowest_line = reqtrace.attribution(slowest[0]) if slowest else None
    reqtrace.reset()
    drain = srv.drain(timeout_s=120.0)

    # the A/B: one work list, each engine driven to idle on this thread
    t0 = time.perf_counter()
    whole = serving.GenerationRuntime(
        rt.name + "_whole", rt._params, rt.cfg, continuous=False, **SERVE)
    whole.compile()
    twin_warm_s = time.perf_counter() - t0
    rng = random.Random(0)
    work = [([rng.randrange(1, rt.cfg.vocab_size)
              for _ in range(rng.randint(2, SERVE["max_prompt"]))],
             SERVE["max_new"] if i % SERVE["slots"] == 0
             else rng.randint(4, 8)) for i in range(16)]

    def drive_once(r):
        before = r.engine.tokens_out
        for prompt, max_new in work:
            r.engine.enqueue(serving.GenRequest(r.name, prompt, max_new))
        torch.cuda.synchronize()
        t = time.perf_counter()
        while not r.engine.idle():
            r.engine.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t, r.engine.tokens_out - before

    walls = {"whole": [], "continuous": []}
    for _ in range(AB_REPEATS):
        walls["whole"].append(drive_once(whole))
        walls["continuous"].append(drive_once(rt))
    whole_s, ab_tokens = min(walls["whole"])
    cont_s, _ = min(walls["continuous"])
    row = {
        "phase": "loadgen", "slo_p99_tpot_ms": LOAD_SLO_TPOT_MS,
        "max_qps": LOAD_MAX_QPS,
        "tokens_per_s_at_slo": rep["tokens_per_s_at_slo"],
        "tpot_p99_ms_at_slo": rep["tpot_p99_ms_at_slo"],
        "ttft_p50_ms_at_slo": rep["ttft_p50_ms_at_slo"],
        "ttft_p99_ms_at_slo": rep["ttft_p99_ms_at_slo"],
        "ramp": rep["ramp"], "ramp_s": ramp_s,
        "p99_attribution": shares, "slowest": slowest_line,
        "flash_launches": launches, "flash_launches_by_route": by_route,
        "continuous_vs_whole_batch": {
            "work": len(work), "tokens": ab_tokens,
            "whole_s": whole_s, "continuous_s": cont_s,
            "whole_tokens_per_s": ab_tokens / whole_s,
            "continuous_tokens_per_s": ab_tokens / cont_s,
            "speedup": whole_s / cont_s, "repeats": AB_REPEATS,
            "twin_warmup_s": twin_warm_s},
        "kv": rt.kv.stats(), "drain": drain,
    }
    emit(row)
    if not rep["ramp"] or not rep["ramp"][0]["met_slo"]:
        raise RuntimeError("loadgen: the first ramp step missed the SLO")
    if rt.kv.stats()["blocks_live"] or whole.kv.stats()["blocks_live"] \
            or not drain["drained"]:
        raise RuntimeError("loadgen: leaked KV blocks or undrained")
    if by_route["wgmma"] != launches or launches == 0:
        raise RuntimeError("loadgen: flash left the wgmma route: %r"
                           % by_route)
    return row


def phase_reload(pred):
    """Live reload of the ``bench_serve`` predictor under
    ``BackgroundLoad``: step 2 from a checkpoint promotes with zero
    dropped or failed requests; step 3 under chaos ``bad_version`` for
    version 3 rolls back while version 2 keeps serving."""
    import os
    import shutil

    from mxnet_tpu_torch import chaos, checkpoint, serving

    ckdir = tempfile.mkdtemp(prefix="smoke-reload-")
    srv = serving.ModelServer(max_batch=32, queue_max=256,
                              batch_deadline_ms=2,
                              default_deadline_ms=10_000, canary_pct=50,
                              canary_min_n=8)
    srv.add_model(pred)
    x = np.random.RandomState(6).randn(1, 64).astype(np.float32)
    want = serving.demo_runtime("v2", dim=64, hidden=128, max_batch=32,
                                seed=2).execute(x)[1]
    try:
        out = {}
        for version, seed, chaos_spec in (
                (2, 2, None),
                (3, 3, "bad_version:model=bench_serve,version=3,"
                 "count=100000")):
            d = os.path.join(ckdir, "v%d" % version)
            checkpoint.save_checkpoint(d, version,
                                       params=serving.demo_params(
                                           dim=64, hidden=128, seed=seed))
            if chaos_spec:
                os.environ["MXNET_CHAOS"] = chaos_spec
            chaos.reset()
            try:
                load = serving.BackgroundLoad(srv, "bench_serve", qps=300,
                                              duration_s=3.0).start()
                time.sleep(0.3)
                srv.reload("bench_serve", d)
                st = srv.wait_reload("bench_serve", timeout_s=60.0)
                res = load.join(120.0)
                injected = chaos.injected_total("bad_version")
            finally:
                os.environ.pop("MXNET_CHAOS", None)
                chaos.reset()
            serving_v = srv.stats()["bench_serve"]["version"]
            same_as_v2 = bool(np.array_equal(
                srv.predict("bench_serve", x)[1], want))
            out["v%d" % version] = {
                "state": st["state"], "swap_s": st.get("swap_s"),
                "canary_stats": st.get("canary_stats"),
                "stable_stats": st.get("stable_stats"),
                "serving_version": serving_v, "serves_v2": same_as_v2,
                "bad_version_injected": injected,
                "load": {k: res[k] for k in (
                    "offered", "admitted", "ok", "errors", "expired",
                    "hung", "shed_total", "p50_ms", "p99_ms")}}
    finally:
        drain = srv.drain(timeout_s=30.0)
        shutil.rmtree(ckdir, ignore_errors=True)
    row = dict({"phase": "reload", "drain": drain}, **out)
    emit(row)
    v2, v3 = out["v2"], out["v3"]
    for tag, v in out.items():
        ld = v["load"]
        if ld["ok"] != ld["admitted"] or ld["errors"] or ld["hung"] or \
                ld["expired"]:
            raise RuntimeError("reload %s: requests dropped or failed: %r"
                               % (tag, ld))
    if v2["state"] != "promoted" or v2["serving_version"] != 2 or \
            not v2["serves_v2"]:
        raise RuntimeError("reload: step 2 did not promote: %r" % v2)
    if v3["state"] != "rolled_back" or v3["serving_version"] != 2 or \
            not v3["serves_v2"] or not v3["bad_version_injected"]:
        raise RuntimeError("reload: version 3 did not roll back: %r" % v3)
    return row


def phase_serve_cli():
    """``python -m mxnet_tpu_torch.serving --self-test`` on the card,
    then ``--serve --port 0``: one ``:generate`` over HTTP, SIGTERM,
    exit code 83."""
    import os
    import signal

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.serving"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd + ["--self-test"], capture_output=True,
                         text=True, env=env, timeout=300)
    self_test_s = time.perf_counter() - t0
    try:
        payload = json.loads(res.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        payload = {}
    failed = sorted(k for k, v in payload.get("checks", {}).items()
                    if not v)
    proc = subprocess.Popen(cmd + ["--serve", "--port", "0"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        banner = json.loads(proc.stdout.readline())
        st, out = _post_json("http://127.0.0.1:%d" % banner["port"],
                             "/v1/models/demo_gen:generate",
                             {"prompt": [5, 9, 2], "max_new": 6}, 120)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = proc.stderr.read()
    row = {"phase": "serve_cli", "self_test_rc": res.returncode,
           "self_test_ok": payload.get("self_test_ok"),
           "self_test_checks": len(payload.get("checks", {})),
           "self_test_failed": failed, "self_test_s": self_test_s,
           "serve_device": banner.get("device"), "generate_status": st,
           "generate_tokens": len(out.get("tokens", [])),
           "sigterm_rc": rc}
    emit(row)
    if res.returncode != 0 or payload.get("self_test_ok") is not True:
        raise RuntimeError("serve_cli: self-test failed: %r\n%s"
                           % (failed, res.stderr[-4000:]))
    if st != 200 or row["generate_tokens"] != 6 or rc != 83 or \
            not str(banner.get("device")).startswith("cuda"):
        raise RuntimeError("serve_cli: --serve: %r\n%s"
                           % (row, err[-4000:]))
    return row


def phase_numerics():
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.parallel.attention import flash_attention_fwd
    from mxnet_tpu_torch.transformer import model as tm

    cfg = tm.TransformerConfig(dtype="float32", param_dtype="float32",
                               **dict(GPT2_SMALL, n_layers=2))
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    rt = serving.GenerationRuntime("gpt2_small_f32", params, cfg,
                                   **SERVE)
    dev = rt.device
    rng = np.random.RandomState(1)
    mp = SERVE["max_prompt"]
    prompts = [rng.randint(1, cfg.vocab_size, size=n)
               for n in (min(37, mp), mp * 2 // 5, mp)]

    def dense_logits(toks):
        t = torch.as_tensor(np.asarray(toks)[None], device=dev)
        with torch.no_grad():
            return tm.apply(params, t, cfg,
                            attn_fn=tm.dense_causal_attn)[0, -1]

    # prefill through the kernel, in the plan cell the engine would pick
    bt, tb = rt.block_tokens, SERVE["max_prompt"]
    bb = 4
    tokens = np.zeros((bb, tb), dtype=np.int64)
    plens = np.ones((bb,), dtype=np.int64)
    tables = np.zeros((bb, tb // bt), dtype=np.int64)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
        plens[i] = len(p)
        rt.kv.alloc("n%d" % i, len(p))
        tables[i] = rt.kv.block_table("n%d" % i, tb // bt)
    n0 = flash_attention_fwd.launches_by_route["simt"]
    got = rt.prefill(tokens, plens, tables)[:len(prompts)]
    if flash_attention_fwd.launches_by_route["simt"] - n0 != cfg.n_layers:
        raise RuntimeError("numerics: the float32 prefill did not run the "
                           "simt kernel")
    want = torch.stack([dense_logits(p) for p in prompts])
    for i in range(len(prompts)):
        rt.kv.free("n%d" % i)
    if not torch.isfinite(got).all() or got.shape != want.shape:
        raise RuntimeError("numerics: bad prefill logits %s"
                           % (tuple(got.shape),))
    err = (got - want).abs().max().item()

    # greedy through the engine against dense greedy decoding
    n_new = 16
    srv = serving.ModelServer()
    srv.add_generator(rt)
    reqs = [srv.submit_generation(rt.name, p, max_new=n_new,
                                  deadline_ms=None) for p in prompts]
    outs = [r.wait(600.0)["tokens"] for r in reqs]
    drain = srv.drain(timeout_s=60.0)
    match = first_ok = 0
    for p, out in zip(prompts, outs):
        hist = [int(t) for t in p]
        ref = []
        for _ in range(n_new):
            nxt = int(dense_logits(hist).argmax())
            ref.append(nxt)
            hist.append(nxt)
        match += sum(int(a == b) for a, b in zip(out, ref))
        first_ok += int(out[0] == ref[0])
    row = {"phase": "numerics", "config": dict(GPT2_SMALL, n_layers=2,
                                               dtype="float32"),
           "prompt_lens": [len(p) for p in prompts],
           "prefill_logits_max_err": err, "atol": 1e-3,
           "greedy_tokens_matching": match,
           "greedy_tokens": n_new * len(prompts),
           "first_tokens_matching": first_ok,
           "kv_blocks_live": rt.kv.stats()["blocks_live"],
           "drained": drain["drained"]}
    emit(row)
    if not err <= 1e-3:
        raise RuntimeError("numerics: prefill logits differ from the "
                           "dense reference by %g" % err)
    if row["kv_blocks_live"] != 0 or not drain["drained"]:
        raise RuntimeError("numerics: leaked KV blocks or undrained")
    return row


def resnet50(ctx, seed=0):
    """ResNet-50 v1 as ``bench_model`` builds it (``get_model``, Xavier
    from numpy's generator seeded with ``seed``) on ``ctx``, its deferred
    shapes settled by one inference forward at batch 2."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    np.random.seed(seed)
    net = vision.get_model("resnet50_v1", classes=1000, prefix="resnet50_")
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.pause():
        net(mx.nd.zeros((2, 3, 224, 224), ctx=ctx))
    return net


def train_batch(batch, ctx, seed=0):
    """A batch as ``bench_model`` draws it: ``nd.random.uniform`` images
    and ``np.random.randint(0, 1000)`` labels."""
    import mxnet_tpu_torch as mx

    mx.random.seed(seed)
    data = mx.nd.random.uniform(shape=(batch, 3, 224, 224), ctx=ctx)
    label = mx.nd.array(np.random.RandomState(seed).randint(
        0, 1000, batch).astype("float32"), ctx=ctx)
    return data, label


def train_tflops(batch, step_s):
    """Achieved TFLOP/s of a ResNet-50 train step: 3 forwards of 2 x 4.09
    G multiply-adds an image over the step time."""
    return TRAIN_FLOP_FACTOR * RESNET50_GFLOP * 1e9 * batch / step_s / 1e12


def _kernel_counts():
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.parallel.attention import (flash_attention_bwd,
                                                    flash_attention_fwd)

    return {"flash_attention_fwd": flash_attention_fwd.launches,
            "flash_attention_fwd_by_route":
                dict(flash_attention_fwd.launches_by_route),
            "flash_attention_bwd": flash_attention_bwd.launches,
            "flash_attention_bwd_by_route":
                dict(flash_attention_bwd.launches_by_route),
            "rtc_add": sum(rtc.launches.values())}


def _reset_kernel_counts():
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.parallel.attention import (flash_attention_bwd,
                                                    flash_attention_fwd)

    flash_attention_fwd.launches = 0
    flash_attention_fwd.launches_by_route = {"wgmma": 0, "simt": 0}
    flash_attention_bwd.launches = 0
    flash_attention_bwd.launches_by_route = {"mma": 0, "simt": 0}
    rtc.launches.clear()


def phase_train():
    """ResNet-50 v1 bf16 training at batch 32 and 128 through
    ``FusedTrainStep``, and one float32 step at batch 128 from the same
    weights and batch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert, gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    net = resnet50(ctx)
    w0 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    build_s = time.perf_counter() - t0
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    big = train_batch(max(RESNET_BATCHES), ctx)
    f32 = FusedTrainStep(net, loss_fn, learning_rate=TRAIN_LR,
                         momentum=TRAIN_MOMENTUM)
    f32_loss = float(f32.run_steps(*big, steps=1).asnumpy()[0])
    del f32
    rows = []
    for batch in RESNET_BATCHES:
        data, label = big if batch == max(RESNET_BATCHES) else             train_batch(batch, ctx)
        net.cast("float32")
        convert.load_block_params(net, w0)
        step = FusedTrainStep(net, loss_fn, learning_rate=TRAIN_LR,
                              momentum=TRAIN_MOMENTUM, dtype="bfloat16")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the path: counts start at 0 here and are read just after
        _reset_kernel_counts()
        t0 = time.perf_counter()
        warm = step.run_steps(data, label, steps=TRAIN_WARMUP).asnumpy()
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = step.run_steps(data, label, steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = losses.asnumpy()
        step_s = wall / TRAIN_STEPS
        rows.append({
            "batch": batch, "dtype": "bfloat16",
            "images_per_s": batch / step_s, "step_ms": step_s * 1e3,
            "warmup_s": warm_s, "first_loss": float(warm[0]),
            "last_loss": float(losses[-1]),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "tflops": train_tflops(batch, step_s),
            "tflops_frac_of_bf16_peak":
                train_tflops(batch, step_s) * 1e12 / PEAK_BF16_FLOPS,
            "kernel_launches": _kernel_counts()})
        del step
    row = {"phase": "train", "model": "resnet50_v1", "classes": 1000,
           "image": 224, "init": "Xavier, numpy seed 0",
           "optimizer": {"lr": TRAIN_LR, "momentum": TRAIN_MOMENTUM},
           "build_s": build_s, "runs": rows,
           "tflops_basis": "3 x 2 x 4.09 G multiply-adds an image "
                           "(He et al. 2015) against the 989 TFLOP/s "
                           "bf16 peak",
           "float32_first_loss": f32_loss,
           "bf16_first_loss_rel_err":
               abs(rows[-1]["first_loss"] - f32_loss) / abs(f32_loss),
           "bf16_loss_rtol": BF16_LOSS_RTOL}
    emit(row)
    bad = [r for r in rows if not (np.isfinite(r["first_loss"])
                                   and np.isfinite(r["last_loss"]))]
    if bad or not np.isfinite(f32_loss):
        raise RuntimeError("train: a loss is not finite: %r" % (bad,))
    if not row["bf16_first_loss_rel_err"] <= BF16_LOSS_RTOL:
        raise RuntimeError("train: bf16 first loss %g against float32 %g"
                           % (rows[-1]["first_loss"], f32_loss))
    return row


def _update_err(got, want, w0):
    """Error of a parameter trajectory over the size of the update:
    ||got - want|| / ||want - w0||, over every parameter at once."""
    num = sum(float(np.sum((np.asarray(got[k], np.float64) - w) ** 2))
              for k, w in want.items())
    den = sum(float(np.sum((w - np.asarray(w0[k], np.float64)) ** 2))
              for k, w in want.items())
    return (num / den) ** 0.5


def numerics_run(net, w0, data, label, dtype, momentum=TRAIN_MOMENTUM):
    """Load ``w0`` into ``net`` and take one ``FusedTrainStep`` step for
    each batch of ``data`` / ``label`` (a leading step dim) in ``dtype``
    on the net's device.  Returns the losses and the parameters after
    each step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert, gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    ctx = next(iter(net.collect_params().values())).list_ctx()[0]
    net.cast("float32")
    convert.load_block_params(net, w0)
    step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                          learning_rate=TRAIN_LR, momentum=momentum,
                          dtype=dtype)
    losses, params = [], []
    for k in range(len(data)):
        losses.append(float(step.run_steps(
            mx.nd.array(data[k:k + 1].astype(dtype or "float32"), ctx=ctx),
            mx.nd.array(label[k:k + 1], ctx=ctx)).asnumpy()[0]))
        params.append({n: p.data().asnumpy()
                       for n, p in net.collect_params().items()})
    return np.array(losses), params


def trajectory_errors(got, got_p, ref, ref_p, w0):
    """Per-step relative loss errors and update errors of one trajectory
    against another from the same start ``w0``."""
    return (np.abs(got - ref) / np.abs(ref),
            np.array([_update_err(g, r, w0) for g, r in zip(got_p, ref_p)]))


def check_trajectory(got, got_p, ref, ref_p, w0):
    """Raise unless the trajectory ``got`` follows ``ref`` to
    ``TRAJ_LOSS_RTOL`` / ``TRAJ_UPDATE_TOL``; returns the errors."""
    loss_err, upd_err = trajectory_errors(got, got_p, ref, ref_p, w0)
    if not (np.isfinite(got).all() and (loss_err <= TRAJ_LOSS_RTOL).all()):
        raise RuntimeError("train_numerics: float64 losses %r differ by %r "
                           "(limit %g)" % (got.tolist(), loss_err.tolist(),
                                           TRAJ_LOSS_RTOL))
    if not (upd_err <= TRAJ_UPDATE_TOL).all():
        raise RuntimeError("train_numerics: the float64 parameters' update "
                           "differs by %r of its size (limit %g)"
                           % (upd_err.tolist(), TRAJ_UPDATE_TOL))
    return loss_err, upd_err


def fault_update_errs(ref_p, w0, aux):
    """What the update check reads at step 2 for two faults of the
    trajectory ``ref_p`` (SGD-momentum, no weight decay): step 2 not
    applied (the parameters stay at step 1's), and step 2 without
    momentum (its update lacks momentum x step 1's update; the aux
    states ``aux`` do not depend on it)."""
    p1, p2 = ref_p
    no_mom = {k: v if k in aux else v - TRAIN_MOMENTUM * (p1[k] - w0[k])
              for k, v in p2.items()}
    return {"step2_skipped": _update_err(p1, p2, w0),
            "step2_without_momentum": _update_err(no_mom, p2, w0)}


def phase_train_numerics():
    """ResNet-50 v1 on the card against the same port in float64 on the
    CPU, two steps from the same weights and batches: the card in
    float64 to ``TRAJ_*`` (the check of the SGD-momentum trajectory), and
    in float32 to limits scaled by the CPU's own float32 distance (see
    ``NUMERICS_FP32_FACTOR``)."""
    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(7)
    data = rng.uniform(0, 1, (2, NUMERICS_BATCH, 3, 224, 224))
    label = rng.randint(0, 1000, (2, NUMERICS_BATCH)).astype(np.float64)
    net = resnet50(mx.gpu(0))
    w0 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    aux = {k for k, p in net.collect_params().items()
           if p.grad_req == "null"}
    t0 = time.perf_counter()
    card64, card64_p = numerics_run(net, w0, data, label, "float64")
    card64_s = time.perf_counter() - t0
    card, card_p = numerics_run(net, w0, data, label, None)
    cnet = resnet50(mx.cpu())
    t0 = time.perf_counter()
    ref, ref_p = numerics_run(cnet, w0, data, label, "float64")
    cpu_s = time.perf_counter() - t0
    f32, f32_p = numerics_run(cnet, w0, data, label, None)

    loss64_err, upd64_err = trajectory_errors(card64, card64_p, ref, ref_p,
                                              w0)
    faults = fault_update_errs(ref_p, w0, aux)
    loss_err, upd_err = trajectory_errors(card, card_p, ref, ref_p, w0)
    f32_loss_err, f32_upd_err = trajectory_errors(f32, f32_p, ref, ref_p, w0)
    loss_tol = np.maximum(TRAIN_LOSS_RTOL,
                          NUMERICS_FP32_FACTOR * f32_loss_err)
    loss_tol[0] = TRAIN_LOSS_RTOL          # step 1: one forward
    upd_tol = np.maximum(TRAIN_UPDATE_TOL, NUMERICS_FP32_FACTOR * f32_upd_err)
    row = {"phase": "train_numerics", "model": "resnet50_v1",
           "batch": NUMERICS_BATCH, "steps": 2, "allow_tf32": False,
           "reference": "the port on the CPU, float64",
           "cpu_losses": ref.tolist(),
           "float64": {"card_losses": card64.tolist(),
                       "loss_rel_err": loss64_err.tolist(),
                       "loss_rtol": TRAJ_LOSS_RTOL,
                       "update_rel_err": upd64_err.tolist(),
                       "update_tol": TRAJ_UPDATE_TOL,
                       "fault_update_err": faults},
           "float32": {"card_losses": card.tolist(),
                       "cpu_float32_losses": f32.tolist(),
                       "loss_rel_err": loss_err.tolist(),
                       "cpu_float32_loss_rel_err": f32_loss_err.tolist(),
                       "loss_rtol": loss_tol.tolist(),
                       "update_rel_err": upd_err.tolist(),
                       "cpu_float32_update_rel_err": f32_upd_err.tolist(),
                       "update_tol": upd_tol.tolist()},
           "card_float64_s": card64_s, "cpu_float64_s": cpu_s}
    emit(row)
    check_trajectory(card64, card64_p, ref, ref_p, w0)
    if not min(faults.values()) > TRAJ_UPDATE_TOL:
        raise RuntimeError("train_numerics: the float64 check cannot tell "
                           "a fault of step 2 from the reference: %r"
                           % (faults,))
    if not np.isfinite(card).all():
        raise RuntimeError("train_numerics: bad card losses %r" % (card,))
    if not (loss_err <= loss_tol).all():
        raise RuntimeError("train_numerics: float32 losses differ by %r "
                           "(limits %r)" % (loss_err.tolist(),
                                            loss_tol.tolist()))
    if not (upd_err <= upd_tol).all():
        raise RuntimeError("train_numerics: the float32 parameters' update "
                           "differs by %r of its size (limits %r)"
                           % (upd_err.tolist(), upd_tol.tolist()))
    return row


# ---------------------------------------------------------------------
# transformer-LM training: GPT-2-small width through TransformerTrainStep
# ---------------------------------------------------------------------
# the serve phase's widths (GPT2_SMALL), bf16 compute over float32
# parameters, batch 8 of 1024 tokens from LMTokenIter, SGD lr 0.01 (the
# class default) momentum 0.9, remat none
LM = dict(batch=8, seq=1024, lr=0.01, momentum=0.9, remat="none")
LM_SEQUENCES = 256          # 32 batches: every run below stays in epoch 1
LM_WARMUP = 3
LM_WINDOWS, LM_WINDOW_STEPS = 5, 4
LM_PROFILE_STEPS = 2
LM_FIT_STEPS, LM_CKPT_STEP = 20, 10
# train_lm_numerics: 2 layers, d_model 128, 2 heads (head_dim 64), d_ff
# 512, vocab 512, batch 4 of 256 tokens, 3 steps at lr 0.05
LM_NUM = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=2, d_ff=512)
LM_NUM_BATCH, LM_NUM_SEQ, LM_NUM_STEPS, LM_NUM_LR = 4, 256, 3, 0.05
# the card in float32 (TF32 off; both attention kernels on the simt
# route) against the port on the CPU in float64 from the same
# parameters: float32 rounding of the forward and of the gradients,
# ~5e-8 of the loss and 1.3e-5 of the update, as the CPU's own float32
# run (reported beside).  The update limit sits 7.5x above that.  The
# phase also reads the update check on faults planted in the float64
# reference and fails unless every one exceeds the limit: step 2
# skipped (0.64), step 2 without momentum (0.38), the attention's
# gradient of v dropped (0.19) and of k dropped (5.7e-3, the smallest)
LM_NUM_LOSS_RTOL = 1e-5
LM_NUM_UPDATE_TOL = 1e-4


def lm_config(**over):
    from mxnet_tpu_torch.transformer import TransformerConfig

    kw = dict(GPT2_SMALL, dtype="bfloat16", param_dtype="float32")
    kw.update(over)
    return TransformerConfig(**kw)


def lm_iter(cfg, batch, seq, num_sequences, seed=0):
    from mxnet_tpu_torch.transformer import LMTokenIter

    return LMTokenIter(batch_size=batch, seq_len=seq,
                       vocab_size=cfg.vocab_size,
                       num_sequences=num_sequences, seed=seed)


def lm_step_flops(cfg, n_params, batch, seq):
    """Model FLOPs of one training step: 6 x N x tokens (N counts every
    parameter, the tied embedding once, as the head's product) plus the
    attention's two score products, 2 x 2 x D FLOPs over the unmasked
    (q, k) pairs a head, 3 times (forward + backward), every layer."""
    attn = 3 * 4.0 * batch * cfg.n_heads * cfg.head_dim * \
        causal_pairs(seq, seq, True) * cfg.n_layers
    return 6.0 * n_params * batch * seq + attn


def lm_kernel_group(name: str) -> str:
    n = name.lower()
    if "flash_bwd" in n:
        return "attention_bwd"
    if "flash_fwd" in n:
        return "attention_fwd"
    if "gemm" in n or "cutlass" in n or "xmma" in n or "nvjet" in n:
        # the step's only float32 products are the tied head's (logits
        # in f32, as the JAX package computes them); the rest are bf16
        return "gemm_f32_head" if "sgemm" in n or "f32f32" in n \
            else "gemm_bf16"
    if "softmax" in n or "logsumexp" in n or "reduce" in n:
        return "reduction"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    if "memcpy" in n or "memset" in n or "copy" in n or "cat" in n:
        return "copy"
    return "other"


def lm_profile(step, it, steps, untraced_ms):
    """``steps`` train steps under torch.profiler, after one traced
    warm-up step: device busy ms a step, the idle share against the
    untraced step time ``untraced_ms`` (and against the traced wall,
    which carries the profiler's own host cost), device ms a step by
    kernel group and the top kernels."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    batches = [it.next() for _ in range(steps + 1)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps)) as prof:
        for i, b in enumerate(batches):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            step.step(b.data[0], b.label[0])
            if i == steps:
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            else:
                # (a step() after the last active step would end the
                # cycle, and the profiler drops a finished cycle's events)
                prof.step()
    kernels = [(ev.name, ev.device_time_total) for ev in prof.events()
               if ev.device_type == DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False)]
    groups, per_kernel = defaultdict(float), defaultdict(float)
    for name, us in kernels:
        groups[lm_kernel_group(name)] += us / 1e3 / steps
        per_kernel[name] += us / 1e3 / steps
    busy = sum(us for _, us in kernels) / 1e3 / steps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": steps, "traced_wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / untraced_ms,
            "idle_share_traced": 1.0 - busy / (wall * 1e3 / steps),
            "launches_per_step": len(kernels) / steps,
            "device_ms_by_group": dict(groups),
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def phase_train_lm():
    """GPT-2-small width transformer-LM training on the card through
    ``TransformerTrainStep``: timed windows, a profile, then ``fit`` for
    20 steps and a checkpoint at step 10 resumed to step 20, bitwise
    equal to the uninterrupted run."""
    from mxnet_tpu_torch.transformer import (TransformerTrainStep,
                                             param_shapes)

    cfg = lm_config()
    B, T = LM["batch"], LM["seq"]

    def new_step():
        return TransformerTrainStep(cfg, learning_rate=LM["lr"],
                                    momentum=LM["momentum"],
                                    remat=LM["remat"], seed=0)

    t0 = time.perf_counter()
    step = new_step()
    it = lm_iter(cfg, B, T, LM_SEQUENCES)
    step.bucket_plan_meta()         # builds: the parameters on the card
    n_params = sum(int(np.prod(shape)) for _, shape, _ in param_shapes(cfg))
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = [float(step.step(b.data[0], b.label[0]))
            for b in (it.next() for _ in range(LM_WARMUP))]
    warm_s = time.perf_counter() - t0
    # the path: counts start at 0 here and are read just after
    _reset_kernel_counts()
    windows, losses = [], []
    for _ in range(LM_WINDOWS):
        batches = [it.next() for _ in range(LM_WINDOW_STEPS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [step.step(b.data[0], b.label[0]) for b in batches]
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / LM_WINDOW_STEPS * 1e3)
        losses += [float(x) for x in out]
    counts = _kernel_counts()
    n_steps = LM_WINDOWS * LM_WINDOW_STEPS
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(windows)
    prof = lm_profile(step, it, LM_PROFILE_STEPS, step_ms)
    del step
    flops = lm_step_flops(cfg, n_params, B, T)

    # fit: 20 steps uninterrupted; 10 steps writing a checkpoint at
    # step 10; that checkpoint resumed to step 20
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    try:
        control = new_step()
        t0 = time.perf_counter()
        fit_losses = control.fit(lm_iter(cfg, B, T, LM_SEQUENCES),
                                 LM_FIT_STEPS)
        fit_s = time.perf_counter() - t0
        want = control.params_numpy()
        del control
        first = new_step()
        t0 = time.perf_counter()
        first_losses = first.fit(lm_iter(cfg, B, T, LM_SEQUENCES),
                                 LM_CKPT_STEP,
                                 checkpoint_every_n=LM_CKPT_STEP,
                                 checkpoint_dir=ckdir)
        ckpt_fit_s = time.perf_counter() - t0
        del first
        resumed = TransformerTrainStep(cfg, learning_rate=LM["lr"],
                                       momentum=LM["momentum"],
                                       remat=LM["remat"], seed=1)
        t0 = time.perf_counter()
        resumed_losses = resumed.fit(lm_iter(cfg, B, T, LM_SEQUENCES),
                                     LM_FIT_STEPS, resume_from=ckdir)
        resume_s = time.perf_counter() - t0
        got = resumed.params_numpy()
        del resumed
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    differ = sorted(k for k in want if not np.array_equal(want[k], got[k]))

    tokens_s = B * T / (step_ms / 1e3)
    row = {
        "phase": "train_lm", "config": dict(GPT2_SMALL, dtype="bfloat16",
                                            param_dtype="float32"),
        "params": n_params, "train": LM, "build_s": build_s,
        "warmup_steps": LM_WARMUP, "warmup_s": warm_s,
        "warm_losses": warm,
        "tokens_per_s": tokens_s, "step_ms": step_ms,
        "step_ms_windows": windows,
        "window_steps": LM_WINDOW_STEPS, "timed_losses": losses,
        "peak_mem_bytes": peak,
        "tflops": flops / (step_ms / 1e3) / 1e12,
        "tflops_frac_of_bf16_peak": flops / (step_ms / 1e3) /
            PEAK_BF16_FLOPS,
        "flops_per_step": flops,
        "tflops_basis": "6 x N x tokens + 3 x 4 x B x H x D x causal "
                        "pairs x layers, against the 989 TFLOP/s bf16 "
                        "peak",
        "kernel_launches": counts, "steps_counted": n_steps,
        "profile": prof,
        "fit": {"steps": LM_FIT_STEPS, "losses": fit_losses,
                "seconds": fit_s},
        "resume": {"checkpoint_step": LM_CKPT_STEP,
                   "first_losses_equal": first_losses ==
                       fit_losses[:LM_CKPT_STEP],
                   "losses_equal": resumed_losses ==
                       fit_losses[LM_CKPT_STEP:],
                   "params_differ": differ, "fit_s": ckpt_fit_s,
                   "resume_s": resume_s},
    }
    emit(row)
    want_launches = cfg.n_layers * n_steps
    if counts["flash_attention_fwd"] != want_launches or \
            counts["flash_attention_fwd_by_route"]["wgmma"] != want_launches \
            or counts["flash_attention_bwd"] != want_launches or \
            counts["flash_attention_bwd_by_route"]["mma"] != want_launches:
        raise RuntimeError("train_lm: %r kernel launches in %d steps of %d "
                           "layers (want %d forward, all wgmma, and %d "
                           "backward, all mma)"
                           % (counts, n_steps, cfg.n_layers, want_launches,
                              want_launches))
    allx = warm + losses + fit_losses
    if not np.isfinite(allx).all():
        raise RuntimeError("train_lm: a loss is not finite")
    if not fit_losses[-1] < fit_losses[0]:
        raise RuntimeError("train_lm: fit did not lower the loss: %r"
                           % (fit_losses,))
    if not (row["resume"]["first_losses_equal"]
            and row["resume"]["losses_equal"]) or differ:
        raise RuntimeError("train_lm: the resumed run is not bitwise the "
                           "uninterrupted one: %r" % (row["resume"],))
    return row


# faults planted in the attention's backward: the gradient of one input
# is dropped (that input is detached from the graph)
LM_ATTN_FAULTS = {
    "attention_dk_zero": lambda f: lambda q, k, v: f(q, k.detach(), v),
    "attention_dv_zero": lambda f: lambda q, k, v: f(q, k, v.detach()),
}


def _lm_numerics_run(cfg, device, w0, steps, dtype=None, attn_fault=None):
    """``steps`` fit steps from parameters ``w0`` on ``device``; returns
    the losses and the parameters after each step (float64 numpy).
    ``attn_fault`` names an entry of ``LM_ATTN_FAULTS`` to plant."""
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    step = TransformerTrainStep(cfg, learning_rate=LM_NUM_LR, momentum=0.9,
                                device=device)
    step.load_state({"params": {k: v.astype(dtype or v.dtype)
                                for k, v in w0.items()}})
    if attn_fault is not None:
        # load_state built the step and bound its attention
        step._attn_fn = LM_ATTN_FAULTS[attn_fault](step._attn_fn)
    it = lm_iter(cfg, LM_NUM_BATCH, LM_NUM_SEQ, LM_NUM_BATCH * steps, seed=1)
    losses, params = [], []
    for _ in range(steps):
        b = it.next()
        losses.append(float(step.step(b.data[0], b.label[0])))
        params.append({k: v.astype(np.float64)
                       for k, v in step.params_numpy().items()})
    return np.array(losses), params


def phase_train_lm_numerics():
    """A small config on the card against the port on the CPU in
    float64, and bf16 on the card against float32 (see LM_NUM_*)."""
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    cfg32 = lm_config(**LM_NUM, dtype="float32", param_dtype="float32")
    cfg64 = lm_config(**LM_NUM, dtype="float64", param_dtype="float64")
    cfg16 = lm_config(**LM_NUM, dtype="bfloat16", param_dtype="float32")
    w0 = TransformerTrainStep(cfg32, device="cpu", seed=0).params_numpy()
    _reset_kernel_counts()
    card, card_p = _lm_numerics_run(cfg32, "cuda", w0, LM_NUM_STEPS)
    counts = _kernel_counts()
    ref, ref_p = _lm_numerics_run(cfg64, "cpu", w0, LM_NUM_STEPS,
                                  np.float64)
    cpu32, cpu32_p = _lm_numerics_run(cfg32, "cpu", w0, LM_NUM_STEPS)
    bf16, _ = _lm_numerics_run(cfg16, "cuda", w0, 1)
    loss_err, upd_err = trajectory_errors(card, card_p, ref, ref_p, w0)
    c32_loss_err, c32_upd_err = trajectory_errors(cpu32, cpu32_p, ref, ref_p,
                                                  w0)
    p1, p2 = ref_p[0], ref_p[1]
    no_mom = {k: v - 0.9 * (p1[k] - w0[k]) for k, v in p2.items()}
    faults = {"step2_skipped": _update_err(p1, p2, w0),
              "step2_without_momentum": _update_err(no_mom, p2, w0)}
    for name in LM_ATTN_FAULTS:
        bad, bad_p = _lm_numerics_run(cfg64, "cpu", w0, LM_NUM_STEPS,
                                      np.float64, attn_fault=name)
        # the largest reading over the steps: the check holds every step
        faults[name] = float(trajectory_errors(bad, bad_p, ref, ref_p,
                                               w0)[1].max())
    bf16_rel = abs(bf16[0] - card[0]) / abs(card[0])
    want = cfg32.n_layers * LM_NUM_STEPS
    row = {"phase": "train_lm_numerics", "config": LM_NUM,
           "batch": LM_NUM_BATCH, "seq": LM_NUM_SEQ, "steps": LM_NUM_STEPS,
           "reference": "the port on the CPU, float64",
           "cpu_losses": ref.tolist(), "card_float32_losses": card.tolist(),
           "loss_rel_err": loss_err.tolist(), "loss_rtol": LM_NUM_LOSS_RTOL,
           "update_rel_err": upd_err.tolist(),
           "update_tol": LM_NUM_UPDATE_TOL,
           "cpu_float32_loss_rel_err": c32_loss_err.tolist(),
           "cpu_float32_update_rel_err": c32_upd_err.tolist(),
           "fault_update_err": faults, "kernel_launches": counts,
           "bf16_first_loss": float(bf16[0]),
           "bf16_first_loss_rel_err": bf16_rel,
           "bf16_loss_rtol": BF16_LOSS_RTOL}
    emit(row)
    if counts["flash_attention_fwd_by_route"]["simt"] != want or \
            counts["flash_attention_bwd_by_route"]["simt"] != want:
        raise RuntimeError("train_lm_numerics: float32 kernel launches %r, "
                           "want %d simt forward and backward"
                           % (counts, want))
    if not (np.isfinite(card).all() and (loss_err <= LM_NUM_LOSS_RTOL).all()
            and (upd_err <= LM_NUM_UPDATE_TOL).all()):
        raise RuntimeError("train_lm_numerics: float32 on the card is off "
                           "the float64 trajectory: %r" % (row,))
    if not min(faults.values()) > LM_NUM_UPDATE_TOL:
        raise RuntimeError("train_lm_numerics: the check cannot tell a "
                           "planted fault from the reference: %r"
                           % (faults,))
    if not (np.isfinite(bf16).all() and bf16_rel <= BF16_LOSS_RTOL):
        raise RuntimeError("train_lm_numerics: bf16 first loss %r against "
                           "float32 %r" % (bf16.tolist(), card[0]))
    return row


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    # without the rest of the repository beside this script the import
    # fails here, before anything is printed
    import mxnet_tpu_torch  # noqa: F401

    phase_device()
    phase_build()
    rows = phase_kernel()
    bwd_rows = phase_kernel_bwd()
    add_rows = phase_rtc_add()
    serve, served_rt, prompts = phase_serve()
    http, pred = phase_serve_http(served_rt, prompts, serve)
    load = phase_loadgen(served_rt)
    del served_rt
    phase_reload(pred)
    phase_serve_cli()
    phase_numerics()
    ndrow = phase_ndarray()
    phase_train()
    phase_train_numerics()
    lm = phase_train_lm()
    phase_train_lm_numerics()
    main_row, bwd_row = rows[0], bwd_rows[0]
    add_row = next(r for r in add_rows if "kernel_ms" in r)
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "kernel_route": main_row["route"],
        "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "mxnet_tpu/parallel/attention.py:126",
        "launches": serve["flash_launches"],
        "launches_by_route": serve["flash_launches_by_route"],
        "launches_by_path": {"serve": serve["flash_launches"],
                             "serve_http": http["flash_launches"],
                             "loadgen": load["flash_launches"],
                             "train_lm": lm["kernel_launches"][
                                 "flash_attention_fwd"]},
        "max_abs_err": max(r["max_err"] for r in rows),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "single_call_ms": main_row["single_call_ms"],
        "graph_ms": main_row["graph_ms"],
        "library_graph_ms": main_row["library_graph_ms"],
        "shape": main_row["shape"], "dtype": main_row["dtype"],
        "train_shape": bwd_row["shape"],
        "train_ms_with_lse": bwd_row["fwd_lse_ms"],
        "train_ms_without_lse": bwd_row["fwd_ms"],
    }, {
        "name": "flash_attention_bwd", "route": "cuda",
        "kernel_route": bwd_row["route"],
        "launches_by_route": lm["kernel_launches"][
            "flash_attention_bwd_by_route"],
        "source": "mxnet_tpu_torch/csrc/flash_attn_bwd.cu",
        # the VJP of the scan flash_attention, which the JAX package
        # trains through (the Pallas kernel at :126 is forward only)
        "replaces": "mxnet_tpu/parallel/attention.py:76",
        "launches": lm["kernel_launches"]["flash_attention_bwd"],
        "max_abs_err": max(r["max_err"] for r in bwd_rows),
        "ms": bwd_row["kernel_ms"], "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"], "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
        "graph_ms": bwd_row["graph_ms"],
        "shape": bwd_row["shape"], "dtype": bwd_row["dtype"],
    }, {
        "name": "rtc_add", "route": "cuda", "kernel_route": "nvrtc",
        "source": "mxnet_tpu_torch/csrc/rtc/add.cu",
        "replaces": "tests/test_parity_tail.py:148",
        "launches": ndrow["rtc_launches"].get("add", 0),
        "max_abs_err": max(r["max_err"] for r in add_rows),
        "ms": add_row["kernel_ms"], "plain_ms": add_row["plain_ms"],
        "bound_ms": add_row["bound_ms"], "bound_by": add_row["bound_by"],
        "library_ms": add_row["library_ms"],
        "single_call_ms": add_row["single_call_ms"],
        "shape": add_row["shape"], "dtype": add_row["dtype"],
    }]
    emit({"phase": "kernels",
          "kernels": {k["name"]: "checked" for k in kernels}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
