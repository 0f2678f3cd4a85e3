"""Sequence-parallel scaling over NCCL across the visible cards.

    python3 tools/torch_sp_scale.py

At ``chip_smoke.py``'s ``train_lm_sp`` width (GPT-2-small, bf16 over
float32 parameters, 8192 tokens a sequence, 2 sequences a dp replica),
one NCCL rank a card: sp=2, sp=4 and dp=2 x sp=2 (the meshes that fit
the visible cards), ring and Ulysses each, after the one-card
``train_lm`` row (batch 8 x 1024) and the one-card step at the same 2 x
8192 batch (flash).  Per mesh and impl: tokens/s in all and a card,
efficiency against ``train_lm`` and against the one-card step at the
same tokens a sequence (tokens/s over cards x the one-card rate), step
ms, peak memory a rank, and from rank 0's torch.profiler trace of 2
steps the device ms and the exposed ms (no other kernel running) a step
of the sequence exchange (NCCL ``SendRecv`` for the ring, ``AllToAll``
for Ulysses) and of the gradient exchange (``AllReduce``).  One JSON
line per row; needs CUDA devices (four cards for every mesh).

    python3 tools/torch_sp_scale.py --ab OTHER_TREE

compares two checkouts in one call: the rank body of OTHER_TREE's copy
of this tool, then this tree's twice, then OTHER_TREE's again, at the
meshes AB_MESHES (tokens/s, step ms, and rank 0's gradient- and
sequence-exchange launches, device ms and exposed ms a step).
"""
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

if sys.argv[1:2] == ["--ab-tree"]:
    # the other tree's package, kernels and copy of this tool come first
    sys.path[:0] = [sys.argv[2], str(Path(sys.argv[2]) / "tools")]
else:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

SEQ, ROWS = cs.LM_SP["seq"], cs.LM_SP["batch"]
WARMUP, STEPS, PROFILE_STEPS = 1, 4, 2
MESHES = ((1, 2), (1, 4), (2, 2))
AB_MESHES = ((1, 2), (2, 2))
EXCHANGE = {"ring": ("SendRecv",), "ulysses": ("AllToAll", "SendRecv")}


def _rank(shape):
    """One rank: ring then Ulysses over a ``shape`` (dp, sp) mesh; timed
    steps, then rank 0 profiles PROFILE_STEPS more (every rank steps)."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.parallel.mesh import make_mesh
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    cs._rank_setup()
    mesh = make_mesh(shape, ("dp", "sp"))
    cfg = cs.lm_config()
    B = ROWS * shape[0]
    n = WARMUP + STEPS + PROFILE_STEPS
    out = {}
    for impl in ("ring", "ulysses"):
        step = TransformerTrainStep(cfg, mesh=mesh, attn_impl=impl,
                                    learning_rate=cs.LM["lr"],
                                    momentum=cs.LM["momentum"],
                                    remat=cs.LM["remat"], seed=0)
        it = cs.lm_iter(cfg, B, SEQ, B * n)
        for _ in range(WARMUP):
            b = it.next()
            step.step(b.data[0], b.label[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(STEPS):
            b = it.next()
            t0 = time.perf_counter()
            float(step.step(b.data[0], b.label[0]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        batches = [it.next() for _ in range(PROFILE_STEPS)]
        if mesh.rank == 0:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for b in batches:
                    float(step.step(b.data[0], b.label[0]))
                torch.cuda.synchronize()
            ev = prof.events()
            trace = {"sequence_exchange": cs._nccl_stats(
                         ev, PROFILE_STEPS, EXCHANGE[impl]),
                     "gradient_exchange": cs._nccl_stats(
                         ev, PROFILE_STEPS, ("AllReduce", "ReduceScatter",
                                             "AllGather"))}
        else:
            for b in batches:
                float(step.step(b.data[0], b.label[0]))
            trace = None
        ms = statistics.median(times)
        out[impl] = {"step_ms": ms, "step_ms_each": times,
                     "tokens_per_s": B * SEQ / ms * 1e3,
                     "peak_mem_bytes": peak, "trace": trace}
        del step
        torch.cuda.empty_cache()
    return out


def _ab_tree(tree) -> int:
    """AB_MESHES with the rank body of ``tree``'s copy of this tool (its
    package and kernels), one row per mesh and impl."""
    import importlib

    from mxnet_tpu_torch import dist

    mod = importlib.import_module("torch_sp_scale")
    mod.cs.phase_build()
    for shape in AB_MESHES:
        ranks = dist.launch(mod._rank, shape[0] * shape[1], (shape,),
                            backend="nccl", timeout_s=600)
        for impl in ("ring", "ulysses"):
            r0 = ranks[0][impl]
            cs.emit({"phase": "sp_scale_ab", "tree": tree,
                     "mesh": {"dp": shape[0], "sp": shape[1]},
                     "impl": impl, "tokens_per_s": r0["tokens_per_s"],
                     "step_ms": r0["step_ms"],
                     "step_ms_each": r0["step_ms_each"],
                     "rank0_trace": r0["trace"]})
    return 0


def main(argv) -> int:
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    if not torch.cuda.is_available():
        raise SystemExit("torch_sp_scale: no CUDA device")
    if argv[:1] == ["--ab"]:
        # one process a tree: each imports its own package
        here = str(Path(__file__).resolve().parent.parent)
        other = str(Path(argv[1]).resolve())
        cs.emit({"phase": "device", "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()})
        for tree in (other, here, here, other):
            subprocess.run([sys.executable, __file__, "--ab-tree", tree],
                           check=True)
        return 0
    if argv[:1] == ["--ab-tree"]:
        return _ab_tree(argv[1])
    cards = torch.cuda.device_count()
    cs.phase_device()
    cs.phase_build()
    lm = cs.phase_train_lm()
    # one card at the same 2 x 8192 batch (flash on the whole sequence)
    cfg = cs.lm_config()
    step = TransformerTrainStep(cfg, learning_rate=cs.LM["lr"],
                                momentum=cs.LM["momentum"],
                                remat=cs.LM["remat"], seed=0)
    it = cs.lm_iter(cfg, ROWS, SEQ, ROWS * (WARMUP + STEPS))
    times = []
    for i in range(WARMUP + STEPS):
        b = it.next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step.step(b.data[0], b.label[0]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    one_ms = statistics.median(times[WARMUP:])
    one = ROWS * SEQ / one_ms * 1e3
    cs.emit({"phase": "sp_scale_one_card", "rows": ROWS, "seq": SEQ,
             "step_ms": one_ms, "tokens_per_s": one,
             "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    del step
    torch.cuda.empty_cache()
    for shape in MESHES:
        n = shape[0] * shape[1]
        if n > cards:
            cs.emit({"phase": "sp_scale", "mesh": shape, "ran": False,
                     "why": "%d visible card(s)" % cards})
            continue
        ranks = dist.launch(_rank, n, (shape,), backend="nccl",
                            timeout_s=600)
        for impl in ("ring", "ulysses"):
            r0 = ranks[0][impl]
            cs.emit({"phase": "sp_scale", "mesh": {"dp": shape[0],
                                                   "sp": shape[1]},
                     "impl": impl, "backend": "nccl", "cards": n,
                     "global_batch": ROWS * shape[0], "seq": SEQ,
                     "tokens_per_s": r0["tokens_per_s"],
                     "tokens_per_s_per_card": r0["tokens_per_s"] / n,
                     "efficiency_vs_train_lm":
                         r0["tokens_per_s"] / (n * lm["tokens_per_s"]),
                     "efficiency_vs_one_card_same_seq":
                         r0["tokens_per_s"] / (n * one),
                     "step_ms": r0["step_ms"],
                     "step_ms_each": r0["step_ms_each"],
                     "peak_mem_bytes_per_rank": [r[impl]["peak_mem_bytes"]
                                                 for r in ranks],
                     "rank0_trace": r0["trace"]})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
