"""Time the port's hand-written kernels on one NVIDIA GPU, for A/B runs
of two checkouts in one call.

    python3 tools/torch_kernel_ab.py [--pkg-root DIR] [--label NAME]

``--pkg-root`` names the directory whose ``mxnet_tpu_torch`` is timed
(default: this checkout), so an unpacked parent commit and this tree can
be run in turns (parent, change, change, parent) with the same
measuring code, which is ``chip_smoke.py``'s of this checkout.  Prints
one JSON line:

* ``flash``: ``flash_attention_fwd`` at the serving prefill's largest
  cell, (B, Tq, Tk, H, D) = (4, 512, 512, 12, 64), causal, bf16: error
  against the plain version, the kernel's and SDPA's times over runs of
  10 back-to-back calls (``*_ms``, hot L2), for one call (host launch
  included, ``*_single_call_ms``), and per call in a CUDA graph of 10
  (device only, ``*_graph_ms``).
* ``flash_bwd``: ``flash_attention_bwd`` at the train_lm phase's cell,
  (8, 1024, 1024, 12, 64), causal, bf16, from the forward kernel's output
  and log-sum-exp: its route, each gradient's largest error over its
  head's largest magnitude against ``flash_attention_bwd_reference``,
  the time of 10 back-to-back calls (``kernel_ms``), per call in a CUDA
  graph of 3 (``graph_ms``), and the device time under torch.profiler
  with its kernels by name (``device_ms``, ``device_kernels``); SDPA's
  backward alone through autograd, host-timed (``library_ms``) and under
  torch.profiler (``library_device_ms``, ``library_kernels``).
* ``add``: the ``mx.rtc`` ``add`` kernel (``csrc/rtc/add.cu``) of that
  directory at 2**26 float32 against ``torch.add``, 10 calls back to
  back, on two grids: ``resident`` (``chip_smoke._add_grid``: 256-thread
  blocks, at most 8 an SM, the grid-stride loop covering the rest) and
  ``oneshot`` (one 16-byte vector a thread, 128-thread blocks); bitwise
  equality with ``x + y``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parents[1]
MAIN = (4, 512, 512, 12, 64)
TRAIN = (8, 1024, 1024, 12, 64)
N_ADD = 2 ** 26


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_tools",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grids(smoke, n):
    return {"resident": smoke._add_grid(n),
            "oneshot": ((max(1, -(-n // 512)), 1, 1), (128, 1, 1))}


def time_flash(smoke, attn):
    B, Tq, Tk, H, D = MAIN
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn((B, T, H, D), generator=g).to("cuda",
                                                         torch.bfloat16)
               for T in (Tq, Tk, Tk))
    out = attn.flash_attention_fwd(q, k, v, causal=True)
    want = attn.flash_attention(q.float(), k.float(), v.float(), causal=True)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kern = lambda: attn.flash_attention_fwd(q, k, v, causal=True)  # noqa
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    return {"shape": list(MAIN), "causal": True, "dtype": "bfloat16",
            "max_err": (out.float() - want).abs().max().item(),
            "kernel_ms": smoke.time_ms(kern, inner=10),
            "library_ms": smoke.time_ms(lib, inner=10),
            "kernel_single_call_ms": smoke.time_ms(kern),
            "library_single_call_ms": smoke.time_ms(lib),
            "kernel_graph_ms": smoke.graph_ms(kern),
            "library_graph_ms": smoke.graph_ms(lib)}


def time_flash_bwd(smoke, attn):
    B, Tq, Tk, H, D = TRAIN
    g = torch.Generator(device="cpu").manual_seed(1)
    q, k, v, do = (torch.randn((B, T, H, D), generator=g).to(
        "cuda", torch.bfloat16) for T in (Tq, Tk, Tk, Tq))
    o, lse = attn.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    got = attn.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    f32 = [t.float() for t in (q, k, v, o, do)]
    want = attn.flash_attention_bwd_reference(
        f32[0], f32[1], f32[2], f32[3], lse, f32[4], causal=True)
    kern = lambda: attn.flash_attention_bwd(  # noqa: E731
        q, k, v, o, lse, do, causal=True)
    qt, kt, vt = (t.transpose(1, 2).requires_grad_(True) for t in (q, k, v))
    out_t = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib = lambda: torch.autograd.grad(  # noqa: E731
        out_t, (qt, kt, vt), do.transpose(1, 2), retain_graph=True)
    dev_ms, dev_kernels = smoke.profiled_ms(kern)
    lib_dev_ms, lib_kernels = smoke.profiled_ms(lib)
    return {"shape": list(TRAIN), "causal": True, "dtype": "bfloat16",
            "route": attn.bwd_route(q, k, v, o, do),
            "head_err": {n: smoke.head_scaled_err(a, b) for n, a, b in
                         zip(("dq", "dk", "dv"), got, want)},
            "kernel_ms": smoke.time_ms(kern, iters=10),
            "graph_ms": smoke.graph_ms(kern, inner=3),
            "device_ms": dev_ms, "device_kernels": dev_kernels,
            "library_ms": smoke.time_ms(lib, iters=10),
            "library_device_ms": lib_dev_ms, "library_kernels": lib_kernels,
            "bound_ms": smoke.attention_bwd_bound(*TRAIN, True,
                                                  torch.bfloat16)[0]}


def _time_add(smoke, mx, kernel, grid, x, y, out, want):
    out._data.zero_()

    def launch():
        kernel.launch([x, y, out, N_ADD], mx.gpu(0), *grid)

    launch()
    torch.cuda.synchronize()
    return {"ms": smoke.time_ms(launch, inner=10),
            "bitwise_equal": bool(torch.equal(out._data, want))}


def time_add(smoke, mx, rtc, root):
    src = (root / "mxnet_tpu_torch" / "csrc" / "rtc" / "add.cu").read_text()
    sig = "const float *x, const float *y, float *out, long n"
    kernel = rtc.CudaModule(src).get_kernel("add", sig)
    g = torch.Generator(device="cuda").manual_seed(0)
    x, y = (mx.nd.NDArray.from_raw(torch.randn((N_ADD,), generator=g,
                                               device="cuda"), mx.gpu(0))
            for _ in range(2))
    out = mx.nd.zeros((N_ADD,), ctx=mx.gpu(0))
    want = x._data + y._data
    grids = _grids(smoke, N_ADD)
    res = {"n": N_ADD, "dtype": "float32",
           "library_ms": smoke.time_ms(lambda: torch.add(x._data, y._data),
                                       inner=10),
           "bound_ms": 3 * 4 * N_ADD / smoke.PEAK_BYTES_S * 1e3}
    for name, grid in grids.items():
        res[name] = _time_add(smoke, mx, kernel, grid, x, y, out, want)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pkg-root", default=str(HERE))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device available")
    root = Path(args.pkg_root).resolve()
    smoke = _load_smoke()
    sys.path.insert(0, str(root))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.parallel import attention as attn

    if not Path(mx.__file__).resolve().is_relative_to(root):
        raise SystemExit("torch_kernel_ab: imported %s, not from %s"
                         % (mx.__file__, root))
    torch.backends.cuda.matmul.allow_tf32 = False
    row = {"label": args.label, "pkg_root": str(root),
           "device": torch.cuda.get_device_name(0),
           "flash": time_flash(smoke, attn),
           "flash_bwd": time_flash_bwd(smoke, attn),
           "add": time_add(smoke, mx, rtc, root)}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
