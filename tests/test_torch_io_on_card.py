"""The input tier's device stage on the card.

Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_io_on_card.py

Held exactly (uint8 and float32 bytes): the batches the device stage
puts on the card equal the host stream, for both ways of page-locking
(the pool's slots registered with CUDA, and the staging fallback
through pinned memory, forced by refusing the registration); every
copy reads
page-locked memory; a slot is not handed back to its decode worker
before the copy out of it has completed — a copy delayed on the copy
stream (``torch.cuda._sleep`` planted before it, one slot per worker, so
an early return would let the worker overwrite the slot under the copy)
still lands the right bytes, and the consumer's stream reads them after
the copy without a host wait; ``DataLoader(pin_memory=True)`` gives
page-locked batches."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io_pipeline as iop

#: cycles of the planted delay: tens of ms on an H100's clock
DELAY_CYCLES = 50_000_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the device stage copies to it)")
    return torch.device("cuda")


def _fn(n=64):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (n, 3, 8, 8)).astype(np.uint8)
    y = np.arange(n, dtype=np.float32)
    return iop.make_ndarray_iter_fn(x, y, batch_size=4,
                                    last_batch_handle="discard")


def _drain(pipe):
    out = []
    while True:
        try:
            b = pipe.next()
        except StopIteration:
            return out
        d, lab = b.data[0]._data, b.label[0]._data
        assert d.is_cuda and lab.is_cuda
        # read on the consumer's stream right away: no host wait
        out.append((d.cpu().numpy(), lab.cpu().numpy()))


def _host(fn, workers):
    with iop.InputPipeline(fn, num_workers=workers, device=False) as p:
        out = []
        while True:
            try:
                b = p.next()
            except StopIteration:
                return out
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy()))


def _force(pin, monkeypatch):
    """``stage``: the slots' registration fails, as it would where
    ``cudaHostRegister`` is refused."""
    if pin == "stage":
        def refuse(pool):
            raise RuntimeError("registration refused (test)")

        monkeypatch.setattr(iop, "_Registered", refuse)


def _same(a, b):
    assert len(a) == len(b) == 16
    for (da, la), (db, lb) in zip(a, b):
        assert da.dtype == db.dtype == np.uint8
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.cuda
@pytest.mark.parametrize("pin", ["register", "stage"])
def test_device_batches_equal_host_batches(cuda_device, pin, monkeypatch):
    fn = _fn()
    want = _host(fn, 2)
    _force(pin, monkeypatch)
    sources = []
    with iop.InputPipeline(fn, num_workers=2, device=mx.gpu(0)) as p:
        issue = p._issue_copy

        def spy(dst, src):
            sources.append(src.is_pinned())
            issue(dst, src)

        p._issue_copy = spy
        got = _drain(p)
        assert p.pin_mode == pin
        p.reset()
        again = _drain(p)
    _same(want, got)
    _same(want, again)
    assert sources and all(sources)


@pytest.mark.cuda
@pytest.mark.parametrize("pin", ["register", "stage"])
def test_slot_is_not_reused_before_its_copy_lands(cuda_device, pin,
                                                  monkeypatch):
    fn = _fn()
    want = _host(fn, 2)
    _force(pin, monkeypatch)
    with iop.InputPipeline(fn, num_workers=2, device=mx.gpu(0),
                           slots_per_worker=1, depth=1) as p:
        issue = p._issue_copy

        def slow(dst, src):
            torch.cuda._sleep(DELAY_CYCLES)  # on the copy stream
            issue(dst, src)

        p._issue_copy = slow
        got = _drain(p)
        assert p.pin_mode == pin
    _same(want, got)


@pytest.mark.cuda
def test_cpu_target_gives_cpu_batches(cuda_device):
    fn = _fn()
    with iop.InputPipeline(fn, num_workers=1, device="cpu") as p:
        b = p.next()
        assert b.data[0]._data.device.type == "cpu"
        assert p.pin_mode is None


@pytest.mark.cuda
def test_dataloader_pin_memory_gives_page_locked_batches(cuda_device):
    ds = mx.gluon.data.ArrayDataset(np.ones((8, 3), np.float32),
                                    np.arange(8, dtype=np.float32))
    for workers in (0, 2):
        for b in mx.gluon.data.DataLoader(ds, batch_size=4, pin_memory=True,
                                          num_workers=workers):
            for a in b:
                assert a._data.is_pinned()
                assert a.context == mx.cpu_pinned()
        b = next(iter(mx.gluon.data.DataLoader(ds, batch_size=4)))
        assert not b[0]._data.is_pinned()


@pytest.mark.cuda
def test_fused_step_takes_the_card_batch_without_a_copy(cuda_device):
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="card_io_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.GlobalAvgPool2D(),
                nn.Dense(4))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    step = FusedTrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                          learning_rate=0.1)
    with iop.InputPipeline(_fn(), num_workers=1, device=mx.gpu(0)) as p:
        b = p.next()
        x = b.data[0]
        assert step._as_tensor(x).data_ptr() == x._data.data_ptr()
        loss, _ = step(x, b.label[0] % 4)
        assert np.isfinite(float(loss.asnumpy()))
