"""Device records a ``traceview`` capture loses, on one GPU.

    python3 tools/torch_trace_loss.py [--captures 6] [--smoke] [--fresh]

Runs ``--captures`` env-armed captures (``MXNET_TRACE_DIR``) of
``chip_smoke.py``'s ``train_lm`` step, each on a fresh
``TransformerTrainStep`` as the smoke's ``traceview`` phase builds it,
and reads each raw trace: the kernel launches whose kernel the trace
does not hold, before the first window (the primer's) and in each
window, the flash launches a window, and the device clock against the
host's (a kernel's start minus its launch, µs).  ``--smoke`` runs the
whole of ``chip_smoke.py`` and makes the captures at the start of its
``traceview`` phase, in a process that has run every earlier phase,
then reads the phase's own traces the same way.  ``--fresh`` steps the
trainer three times before each capture, so the warm-up dispatch is not
the trainer's first step; ``--no-primer K`` starts the first K of the
captures without ``traceview.capture``'s primer.  One JSON line a
capture; needs a CUDA device; imports no JAX.
"""
import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

T0 = time.monotonic()


def read(trace, what, wins):
    from mxnet_tpu_torch.traceview import parse

    ev = trace["traceEvents"]
    have = {(e.get("args") or {}).get("correlation") for e in ev
            if e.get("ph") == "X" and e.get("cat") in parse.DEVICE_CATS}
    launch = {}
    for e in ev:
        c = (e.get("args") or {}).get("correlation")
        if e.get("ph") == "X" and c is not None and \
                e.get("cat") in parse.LAUNCH_CATS:
            launch.setdefault(c, float(e["ts"]))
    lag = sorted(float(e["ts"]) - launch[c] for e in ev
                 if e.get("ph") == "X" and e.get("cat") in parse.DEVICE_CATS
                 for c in [(e.get("args") or {}).get("correlation")]
                 if c in launch)
    t_first = min(float(e["ts"]) for e in ev if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and cs.STEP_ANNOT_RE.match(str(e.get("name", ""))))
    before = sorted(float(e["ts"]) - t_first for e in ev
                    if e.get("ph") == "X" and e.get("cat")
                    in parse.LAUNCH_CATS
                    and parse.KERNEL_LAUNCH_RE.match(str(e.get("name", "")))
                    and (e.get("args") or {}).get("correlation") not in have
                    and float(e["ts"]) < t_first)
    from mxnet_tpu_torch.traceview import capture as tvcap

    cs.emit({"capture": what, "primer": tvcap.PRIMER_LAUNCHES,
             "process_age_s": time.monotonic() - T0,
             "lost_before_windows": len(before),
             "lost_before_ms": [before[0] / 1e3, before[-1] / 1e3]
             if before else None,
             "lost_per_window": parse.lost_launches(trace),
             "flash_per_window": [cs.flash_launches(w["launches"])
                                  for w in wins],
             "device_minus_launch_us": {
                 "min": lag[0], "p01": lag[len(lag) // 100],
                 "p50": lag[len(lag) // 2]} if lag else None})


def captures(n, fresh, no_primer):
    from mxnet_tpu_torch.traceview import capture as tvcap
    from mxnet_tpu_torch.transformer import TransformerTrainStep

    primer = tvcap.PRIMER_LAUNCHES
    for i in range(n):
        tvcap.PRIMER_LAUNCHES = 0 if i < no_primer else primer
        tmp = tempfile.mkdtemp(prefix="torch_trace_loss_")
        try:
            cfg = cs.lm_config()
            step = TransformerTrainStep(cfg, learning_rate=cs.LM["lr"],
                                        momentum=cs.LM["momentum"],
                                        remat=cs.LM["remat"], seed=0)
            it = cs.lm_iter(cfg, cs.LM["batch"], cs.LM["seq"],
                            cs.LM_SEQUENCES)
            step.bucket_plan_meta()
            for _ in range(3 if fresh else 0):
                b = it.next()
                step.step(b.data[0], b.label[0])
            with cs._trace_armed(os.path.join(tmp, "lm"),
                                 cs.TV_LM_STEPS) as capture:
                for _ in range(cs.TV_LM_STEPS + 1):
                    b = it.next()
                    step.step(b.data[0], b.label[0])
                torch.cuda.synchronize()
                # _captured reads the trace through cs.trace_windows
                cs._captured(capture, "train_lm capture %d" % i)
            del step
        finally:
            tvcap.PRIMER_LAUNCHES = primer
            shutil.rmtree(tmp, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--captures", type=int, default=6)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--no-primer", type=int, default=0, metavar="K",
                    help="the first K captures start without the primer")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_trace_loss: no CUDA device available")
    import mxnet_tpu_torch  # noqa: F401

    windows = cs.trace_windows

    def reading_as(what):
        def reading(trace):
            wins = windows(trace)
            read(trace, what, wins)
            return wins
        return reading

    if not args.smoke:
        cs.phase_device()
        cs.trace_windows = reading_as("train_lm")
        captures(args.captures, args.fresh, args.no_primer)
        return 0
    phase = cs.phase_traceview

    def traceview(lm_row):
        cs.trace_windows = reading_as("extra train_lm")
        captures(args.captures, args.fresh, args.no_primer)
        cs.trace_windows = reading_as("traceview phase")
        return phase(lm_row)

    cs.phase_traceview = traceview
    sys.argv = [sys.argv[0]]
    return cs.main()


if __name__ == "__main__":
    sys.exit(main())
