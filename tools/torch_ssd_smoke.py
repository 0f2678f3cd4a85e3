"""The detection tier's smoke phases alone, on one GPU.

    python3 tools/torch_ssd_smoke.py

Runs ``chip_smoke.py``'s ``device``, ``build`` (nvcc of every kernel
source: the NMS kernel ``csrc/box_nms.cu`` among them), ``ssd``
(BASELINE config 4 at full width: SSD-512 on ResNet-50 trained at batch
32 from records, detection through the NMS kernel, the VOC07 mAP; the
example SSD's learning check) and ``ssd_numerics`` (every detection op
in float64 on the card against the CPU, box_nms at (32, 6132), the
RPN's NMS at (2, 6000), a mini R-CNN step, planted faults) in a fresh
process, each phase's JSON line
as the smoke prints it, then one line with every phase's wall seconds.
Exits non-zero if a phase fails; needs a CUDA device; imports no JAX.
"""
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_ssd_smoke: no CUDA device available")
    t0 = time.perf_counter()
    cs.phase_device()
    cs.phase_build()
    ok = True
    for phase in (cs.phase_ssd, cs.phase_ssd_numerics):
        try:
            phase()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            ok = False
    print(json.dumps({"phase_seconds": cs.PHASE_S,
                      "wall_s": time.perf_counter() - t0}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
