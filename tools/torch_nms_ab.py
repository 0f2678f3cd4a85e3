"""Time the NMS kernel (``nms_keep`` on the card) at the detection and
RPN shapes, for A/B runs of two checkouts in one call.

    python3 tools/torch_nms_ab.py [--pkg-root DIR] [--label NAME]

``--pkg-root`` names the directory whose ``mxnet_tpu_torch`` is timed
(default: this checkout), so an unpacked parent commit and this tree can
be run in turns (parent, change, change, parent) with the same measuring
code, ``chip_smoke.py``'s of this checkout.  Prints the card's name and
power limit, then one JSON line with a row for each shape, each as the
smoke's ``_nms_row`` gives it (keep mismatches against the plain loop on
the same card inputs; ``ms``, a call with its host work, over 10 calls;
``graph_ms``, a call's device work in a CUDA graph; the plain loop's ms
once; the bound); ``--profile`` adds each kernel's device ms:

* ``ssd_top400``: ``chip_smoke._nms_full_rows`` (SSD-512's 6,132
  anchors, 21-way softmax scores from a seed) in float32, the first 400
  in score order, with class ids;
* ``ssd_full``: the same rows in float64, all 6,132, with class ids
  (``MultiBoxDetection``'s default ``nms_topk=-1``);
* ``rpn``: ``chip_smoke.rpn_nms_inputs``, what ``MultiProposal`` at its
  defaults gives ``nms_keep``: (2, 6000) float32, no ids.

Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_tools",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profile(args, calls=5):
    """Device ms a call of ``nms_keep(*args)`` by kernel name."""
    from mxnet_tpu_torch.ops import contrib

    contrib.nms_keep(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            contrib.nms_keep(*args)
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / 1e3 / calls
            for e in prof.key_averages() if e.device_time_total > 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pkg-root", default=str(HERE))
    ap.add_argument("--label", default="this")
    ap.add_argument("--profile", action="store_true",
                    help="also each shape's device ms by kernel name "
                         "(torch.profiler over 5 calls)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_nms_ab: no CUDA device available")
    sys.path.insert(0, str(Path(args.pkg_root).resolve()))
    smoke = _load_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    import mxnet_tpu_torch

    rows = smoke._nms_full_rows()
    params = dict(overlap_thresh=smoke.SSD["detection"]["nms_threshold"])
    out = {"label": args.label, "pkg": mxnet_tpu_torch.__file__,
           "nvidia_smi": smi}
    inputs = {
        "ssd_top400": smoke._nms_sorted(rows.float().cuda(),
                                        dict(params, topk=400)),
        "ssd_full": smoke._nms_sorted(rows.cuda(), dict(params, topk=-1)),
        "rpn": smoke.rpn_nms_inputs()}
    for name, args_ in inputs.items():
        out[name] = smoke._nms_row(*args_)
        if args.profile:
            out[name]["device_ms_by_kernel"] = _profile(args_)
    print(json.dumps(out), flush=True)
    bad = [k for k in ("ssd_top400", "ssd_full", "rpn")
           if out[k]["mismatches"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
