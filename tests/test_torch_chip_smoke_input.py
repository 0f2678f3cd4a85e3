"""The host-side helpers of ``chip_smoke.py``'s ``input`` phase, on the
CPU: the record count rounds up to whole batches for every decode
worker, the records it writes (raw HWC payloads; JPEG where the native
library decodes it) read back through the port's ``ImageRecordIter`` at
the phase's shapes, the stream digest sees every byte, and the phase
runs after ``train`` (whose img/s it divides by) and reports its kernel
launches on every kernel's ``launches_by_path``.  The phase itself
needs a card."""
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mxnet_tpu_torch import io as tio

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("workers,want", [(7, 1792), (1, 1024), (3, 1152),
                                          (8, 1024)])
def test_input_records_round_up_to_whole_batches(workers, want):
    n = cs.input_records(workers)
    assert n == want and n >= cs.INPUT_RECORDS
    assert n % (workers * cs.INPUT_BATCH) == 0


@pytest.mark.parametrize("codec", ["raw", "jpeg"])
def test_written_records_read_back_at_the_phase_shapes(tmp_path, codec,
                                                       monkeypatch):
    monkeypatch.setattr(cs, "INPUT_BATCH", 4)
    rec, idx, nbytes = cs.write_input_records(str(tmp_path), codec, 8)
    assert nbytes > 8 * (150_000 if codec == "raw" else 10_000)
    kw = cs.input_iter_kwargs(rec, idx)
    assert kw["batch_size"] == 4 and kw["dtype"] == "uint8"
    it = tio.ImageRecordIter(**kw)
    b = it.next()
    assert b.data[0].shape == (4, 3, cs.INPUT_SIDE, cs.INPUT_SIDE)
    assert b.data[0]._data.dtype == torch.uint8
    np.testing.assert_array_equal(b.label[0].asnumpy() % 1, 0)
    assert sorted(set(b.label[0].asnumpy().tolist()) | set(
        it.next().label[0].asnumpy().tolist())) == list(range(8))
    codec, why = cs.input_codec()
    assert codec == ("jpeg" if why["native_jpeg"] and why["pil"] else "raw")


def test_batch_digest_sees_every_byte():
    a = torch.zeros((2, 3), dtype=torch.uint8)
    lab = torch.arange(2, dtype=torch.float32)
    d0 = cs.batch_digest(a, lab)
    b = a.clone()
    b[1, 2] = 1
    assert cs.batch_digest(b, lab) != d0
    assert cs.batch_digest(a, lab + 1) != d0
    assert cs.batch_digest(a.clone(), lab.clone()) == d0


def test_input_phase_runs_after_train_and_reports_launches():
    src = (REPO / "chip_smoke.py").read_text()
    main = src[src.index("def main()"):]
    order = [main.index(p) for p in ("phase_train()",
                                     "phase_train_numerics()",
                                     "phase_input(train)",
                                     '"phase": "kernels"')]
    assert order == sorted(order)
    # the three kernels of the earlier slices and the NMS kernel
    assert main.count('"input": inp_counts[') == 4


def test_host_census_counts_threads_and_children():
    import subprocess
    import threading

    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="census-probe")
    t.start()
    child = subprocess.Popen(["sleep", "5"])
    try:
        got = cs.host_census()
    finally:
        child.kill()
        child.wait()
        stop.set()
        t.join(5)
    assert "census-probe" in got["threads"]
    assert got["child_processes"] >= 1
    assert got["loadavg_1m"] >= 0
