"""The input tier on one GPU, alone: the ``device``, ``train`` and
``input`` phases of ``chip_smoke.py``, and a sweep of the decode pool's
worker count under the same training.

    python3 tools/torch_input_smoke.py [--sweep 1,2,7] [--staged]

``train`` gives the synthetic-batch ResNet-50 img/s that the ``input``
phase's ``feed_efficiency`` divides by; ``input`` writes the seeded
records, times the native decode on one thread, the decode pool, the
host-to-device link (pageable, pinned, a registered slot) and ResNet-50
bf16 training fed by ``InputPipeline``, and holds the card's batches, a
repeated stream and a resumed stream bitwise.  ``--sweep`` then trains
the same way at each listed worker count over the same records (a count
that does not divide the records into whole batches a worker is
refused) and prints img/s, step ms and the traced idle share of each:
whether the workers' own CPU time slows the step.  ``--staged`` adds a
run at the phase's worker count with the slots' registration refused,
so the device stage takes its fallback, a pinned copy of each slot:
what registering the slots in place saves.  Each phase prints its JSON
line; a failure raises.  Needs a CUDA device; imports no JAX.
"""
import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def sweep(counts, train_ips, staged=False):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io_pipeline as iop

    n_rec = cs.input_records(cs.input_workers())
    for w in counts:
        if n_rec % (w * cs.INPUT_BATCH):
            raise SystemExit("--sweep: %d workers do not divide %d records "
                             "into whole batches" % (w, n_rec))
    tmp = tempfile.mkdtemp(prefix="torch_input_sweep_")
    try:
        rec, idx, _ = cs.write_input_records(tmp, cs.input_codec()[0],
                                            n_rec)
        fn = iop.make_record_iter_fn(**cs.input_iter_kwargs(rec, idx))
        net = cs.resnet50(mx.gpu(0))
        w0 = {k: p.data().asnumpy()
              for k, p in net.collect_params().items()}
        runs = [cs._input_e2e(net, w0, fn, w, cs.INPUT_PROFILE_STEPS)
                for w in counts]
        if staged:
            real = iop._Registered

            def refuse(pool):
                raise RuntimeError("registration refused (--staged)")

            iop._Registered = refuse
            try:
                runs.append(cs._input_e2e(net, w0, fn, cs.input_workers(),
                                          cs.INPUT_PROFILE_STEPS))
            finally:
                iop._Registered = real
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cs.emit({"phase": "input_sweep", "records": n_rec,
             "train_synthetic_ips": train_ips,
             "runs": [{"workers": r["workers"], "pin_mode": r["pin"],
                       "e2e_ips": r["e2e_ips"],
                       "feed_efficiency": r["e2e_ips"] / train_ips,
                       "step_ms": r["step_ms"], "epoch_s": r["epoch_s"],
                       "idle_share": r["profile"]["idle_share"],
                       "device_busy_ms_per_step":
                           r["profile"]["device_busy_ms_per_step"]}
                      for r in runs]})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", default="",
                    help="comma-separated worker counts to train with")
    ap.add_argument("--staged", action="store_true",
                    help="one more run with the slots' registration "
                         "refused (the pinned-copy fallback)")
    args = ap.parse_args()
    t0 = time.perf_counter()
    cs.phase_device()
    train = cs.phase_train()
    t1 = time.perf_counter()
    cs.phase_input(train)
    t2 = time.perf_counter()
    if args.sweep or args.staged:
        ips = next(r["images_per_s"] for r in train["runs"]
                   if r["batch"] == cs.INPUT_BATCH)
        sweep([int(w) for w in args.sweep.split(",") if w], ips,
              args.staged)
    cs.emit({"phase": "wall", "wall_s": time.perf_counter() - t0,
             "input_s": t2 - t1})
    return 0


if __name__ == "__main__":
    sys.exit(main())
