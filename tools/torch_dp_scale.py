"""Data-parallel scaling across every visible card (a card machine).

    python3 tools/torch_dp_scale.py

Runs ``chip_smoke.py``'s phases for the data-parallel paths and the
single-card rows they are compared with, in this order: ``device``,
``build``, ``train`` (ResNet-50 v1 bf16 on one card), ``dp`` (one NCCL
rank per visible card, batch 128 a rank), ``dp_numerics`` (two float64
ranks over gloo on ``cuda:0``, and over NCCL on two cards where there
are two), ``train_lm`` (one card) and ``train_lm_dp`` (one NCCL rank
per card, ZeRO-1).  Each prints its JSON line; on a machine with one
card this is a subset of the smoke.  ``resnet`` or ``lm`` as the one
argument runs only that model's phases.  Needs a CUDA device.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_dp_scale: no CUDA device")
    only = argv[0] if argv else None
    if only not in (None, "resnet", "lm"):
        raise SystemExit("torch_dp_scale: resnet, lm or nothing, not %r"
                         % only)
    cs.phase_device()
    cs.phase_build()
    if only != "lm":
        cs.phase_dp(cs.phase_train())
        cs.phase_dp_numerics()
    if only != "resnet":
        cs.phase_train_lm_dp(cs.phase_train_lm())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
