"""Time the port's two hand-written kernels on one NVIDIA GPU, for A/B
runs of two checkouts in one call.

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
           "add": time_add(smoke, mx, rtc, root)}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
