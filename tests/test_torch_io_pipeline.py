"""The port's ``io_pipeline`` against the JAX package's, on the CPU: the
decode pool's stream is deterministic, complete and equal to the JAX
package's pool at the same worker count (in-memory arrays and JPEG
records, bitwise); ``skip_batches`` lands where consuming would; a
killed worker's shard is adopted with the stream unchanged; nothing is
left under /dev/shm after ``close`` or after the self-test CLI's SIGTERM
(the CLI runs once, ``--device cpu``); the knobs are registered with the
JAX package's defaults; a small conv net trained 3 steps through the
port's ``FusedTrainStep`` from ``InputPipeline`` equals, bit for bit,
the same net fed the plain iterators' batches; ``Module.fit`` and
``TransformerTrainStep.fit`` train from it; a checkpoint written by
either package's ``Module.fit`` with a pipeline resumes the other
package's pipeline at the same sample.  At most 2 workers, 16x16
records.  The device stage on the card is held in
``tests/test_torch_io_on_card.py``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import io_pipeline as jiop
from mxnet_tpu_torch import io_pipeline as tiop
from mxnet_tpu_torch import recordio as trio

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
X = np.arange(96, dtype=np.float32).reshape(48, 2)
Y = np.arange(48, dtype=np.float32)


def _fn(pkg, batch=4):
    return pkg.make_ndarray_iter_fn(X, Y, batch_size=batch,
                                    last_batch_handle="discard")


def _stream(pipe, limit=200):
    out = []
    for _ in range(limit):
        try:
            b = pipe.next()
        except StopIteration:
            return out
        out.append(([np.asarray(d.asnumpy()) for d in b.data],
                    [np.asarray(lb.asnumpy()) for lb in b.label], b.pad))
    raise AssertionError("stream did not end")


def _same(a, b, label_dtype=True):
    assert len(a) == len(b) and a
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da, db):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype or not label_dtype
            np.testing.assert_array_equal(x, y)


def _ids(stream):
    return [int(v) for _d, (lab,), _p in stream for v in lab.reshape(-1)]


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("pipe") / "r")
    rng = np.random.RandomState(5)
    w = trio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(40):
        img = rng.randint(0, 256, (20, 24, 3)).astype(np.uint8)
        w.write_idx(i, trio.pack_img(trio.IRHeader(0, float(i % 4), i, 0),
                                     img, quality=90))
    w.close()
    return prefix


def _rec_kw(rec, **kw):
    out = dict(path_imgrec=rec + ".rec", path_imgidx=rec + ".idx",
               data_shape=(3, 16, 16), batch_size=4, dtype="uint8",
               rand_crop=True, rand_mirror=True, shuffle=True, seed=3,
               preprocess_threads=1)
    out.update(kw)
    return out


@pytest.mark.parametrize("workers", [1, 2])
def test_stream_deterministic_complete_and_equal_to_jax(workers):
    with tiop.InputPipeline(_fn(tiop), num_workers=workers,
                            device=False) as tp, \
            jiop.InputPipeline(_fn(jiop), num_workers=workers,
                               device=False) as jp:
        e1 = _stream(tp)
        assert sorted(_ids(e1)) == list(range(48))
        if workers == 2:
            # worker 0 owns rows 0,2,4..; round robin, one batch a turn
            assert _ids(e1)[:8] == [0, 2, 4, 6, 1, 3, 5, 7]
        _same(_stream(jp), e1)
        assert tp.cursor == 48
        tp.reset()
        _same(_stream(tp), e1)
        assert e1[0][0][0].dtype == np.float32


def test_record_stream_equals_jax_pool(rec):
    kw = _rec_kw(rec)
    with tiop.InputPipeline(tiop.make_record_iter_fn(**kw), num_workers=2,
                            device=False) as tp, \
            jiop.InputPipeline(jiop.make_record_iter_fn(**kw),
                               num_workers=2, device=False) as jp:
        # the labels' dtype departs (float32 here, uint8 in the JAX
        # package's slots); their values are the same below 256
        t1 = _stream(tp)
        _same(_stream(jp), t1, label_dtype=False)
        assert t1[0][0][0].dtype == np.uint8
        assert t1[0][1][0].dtype == np.float32
        tp.reset()
        jp.reset()
        _same(_stream(jp), _stream(tp), label_dtype=False)
    # two runs of the pool give the same stream
    with tiop.InputPipeline(tiop.make_record_iter_fn(**kw), num_workers=2,
                            device=False) as tp:
        _same(_stream(tp), t1)


def test_uint8_pool_keeps_class_ids_past_255(tmp_path):
    path = str(tmp_path / "big.rec")
    w = trio.MXRecordIO(path, "w")
    for i in range(8):
        w.write(trio.pack(trio.IRHeader(0, float(997 - i), i, 0),
                          np.full((8, 8, 3), i, np.uint8).tobytes()))
    w.close()
    kw = dict(path_imgrec=path, data_shape=(3, 8, 8), batch_size=4,
              dtype="uint8")
    with tiop.InputPipeline(tiop.make_record_iter_fn(**kw), num_workers=2,
                            device="cpu") as p:
        ids = sorted(_ids(_stream(p)))
    assert ids == list(range(990, 998))


def test_skip_batches_matches_consumed_stream():
    with tiop.InputPipeline(_fn(tiop), num_workers=2, device=False) as p1:
        full = _stream(p1)
    with tiop.InputPipeline(_fn(tiop), num_workers=2, device="cpu") as p2:
        p2.skip_batches(3)
        assert p2.cursor == 12
        _same(_stream(p2), full[3:])
        # mid-epoch skip once the device stage runs
        p2.reset()
        p2.next()
        p2.skip_batches(2)
        assert p2.cursor == 12
        _same(_stream(p2), full[3:])


def test_killed_worker_is_adopted_with_the_stream_unchanged():
    from mxnet_tpu_torch import diagnostics as diag

    deaths = diag.metrics.counter("mxnet_io_worker_deaths_total").value
    with tiop.InputPipeline(_fn(tiop), num_workers=2, device=False) as p:
        full = _stream(p)
    # the kill must land while worker 1 still has batches to deliver: it
    # owns 6 of the 12 batches, and can have delivered at most the ones
    # the stream took from it (the consumer's 2 head batches, the
    # prefetch queue's 1 and the 1 the thread holds: worker 1's share is
    # 2) plus the one slot it may fill: 3 < 6, so its end message
    # cannot be queued yet and the stream must find it dead
    with tiop.InputPipeline(_fn(tiop), num_workers=2, device="cpu",
                            depth=1, slots_per_worker=1) as p:
        head = [p.next() for _ in range(2)]
        victim = p.pool._procs[1]
        victim.kill()
        victim.join(5.0)
        rest = _stream(p)
        assert p.pool._dead[1]
        got = [([d.asnumpy() for d in b.data],
                [lb.asnumpy() for lb in b.label], b.pad) for b in head]
        _same(got + rest, full)
        p.reset()  # the adopted shard restarts with the next epoch
        _same(_stream(p), full)
    assert diag.metrics.counter(
        "mxnet_io_worker_deaths_total").value == deaths + 1


def test_close_leaves_no_shm_litter_and_default_device_is_the_card():
    p = tiop.InputPipeline(_fn(tiop), num_workers=2, device=False)
    p.next()
    token = p.pool._uid
    assert len(tiop._leaked_segments(token)) == 2 * p.pool.slots_per_worker
    p.close()
    assert tiop._leaked_segments(token) == []
    p.close()  # twice is fine
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError, match="mx.cpu"):
            tiop.InputPipeline(_fn(tiop), num_workers=1)


def test_self_test_cli_sigterm_leaves_no_litter():
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    env.pop("MXNET_CHAOS", None)
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.io_pipeline",
         "--self-test", "--device", "cpu"], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    payload = json.loads(res.stdout.strip().splitlines()[-1])
    assert payload["self_test_ok"], payload
    assert payload["checks"]["sigterm_no_shm_litter"]
    assert len(payload["checks"]) == 15
    if not torch.cuda.is_available():
        res = subprocess.run(
            [sys.executable, "-m", "mxnet_tpu_torch.io_pipeline",
             "--self-test"], capture_output=True, text=True, env=env,
            cwd=ROOT, timeout=120)
        assert res.returncode != 0 and "--device cpu" in res.stderr


def test_io_knobs_registered_with_the_jax_defaults():
    from mxnet_tpu import env as jenv
    from mxnet_tpu_torch import env as tenv

    for name in ("MXNET_IO_WORKERS", "MXNET_IO_PREFETCH_DEPTH",
                 "MXNET_IO_POOL_SLOTS", "MXNET_IO_START_METHOD",
                 "MXNET_CPU_WORKER_NTHREADS"):
        t, j = tenv.var(name), jenv.var(name)
        assert (t.kind, t.default) == (j.kind, j.default), name


def test_knobs_drive_the_pool(monkeypatch):
    monkeypatch.setenv("MXNET_IO_WORKERS", "2")
    monkeypatch.setenv("MXNET_IO_POOL_SLOTS", "3")
    monkeypatch.setenv("MXNET_IO_PREFETCH_DEPTH", "1")
    monkeypatch.setenv("MXNET_IO_START_METHOD", "spawn")
    with tiop.InputPipeline(_fn(tiop), device="cpu") as p:
        assert p.num_workers == 2 and p.pool.slots_per_worker == 3
        assert p.pool.start_method == "spawn" and p._depth == 1
        assert sorted(_ids(_stream(p))) == list(range(48))


def test_telemetry_feeds(rec):
    from mxnet_tpu_torch import diagnostics as diag

    before = diag.metrics.counter("mxnet_io_bytes_total").value
    n = diag.metrics.histogram("mxnet_io_decode_seconds").count
    with tiop.InputPipeline(tiop.make_record_iter_fn(**_rec_kw(rec)),
                            num_workers=2, device="cpu") as p:
        got = _stream(p)
    assert diag.metrics.histogram("mxnet_io_decode_seconds").count - n \
        == len(got) == 10
    assert diag.metrics.counter("mxnet_io_bytes_total").value - before \
        == 10 * (4 * 3 * 16 * 16 + 4 * 4)
    assert diag.metrics.gauge("mxnet_io_queue_depth").value is not None
    assert diag.validate_prom_text(diag.metrics.to_prom()) == []


# ---------------------------------------------------------------------
# consumers
# ---------------------------------------------------------------------
def _conv_net():
    nn = tmx.gluon.nn
    net = nn.HybridSequential(prefix="iop_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(), nn.Dense(4))
    with tmx.cpu():
        np.random.seed(0)
        net.initialize(tmx.init.Xavier())
        with tmx.autograd.pause():
            net(tmx.nd.zeros((2, 3, 16, 16)))
    return net


def _train(batches):
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    net = _conv_net()
    with tmx.cpu():
        step = FusedTrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              learning_rate=0.1, momentum=0.9)
        losses = [float(step(d, lab)[0].asnumpy()) for d, lab in batches]
    return losses, {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}


def test_fused_step_from_the_pipeline_equals_the_plain_iterators(rec):
    kw = _rec_kw(rec)
    with tiop.InputPipeline(tiop.make_record_iter_fn(**kw), num_workers=2,
                            device=tmx.cpu()) as p:
        got = []
        for _ in range(3):
            b = p.next()
            assert b.data[0]._data.dtype == torch.uint8
            got.append((b.data[0], b.label[0]))
        losses, params = _train(got)
    # the plain iterators, one a worker's shard, read round robin
    its = [tmx.io.ImageRecordIter(num_parts=2, part_index=w, **kw)
           for w in range(2)]
    plain = []
    for k in range(3):
        (d,), (lab,), _pad = its[k % 2].next_raw()
        plain.append((tmx.nd.array(d, ctx=tmx.cpu()),
                      tmx.nd.array(lab, ctx=tmx.cpu())))
    want_losses, want = _train(plain)
    assert losses == want_losses and np.isfinite(losses).all()
    for k in want:
        np.testing.assert_array_equal(params[k], want[k], err_msg=k)


def test_transformer_fit_trains_from_the_pipeline():
    from mxnet_tpu_torch import transformer as tr

    cfg = tr.TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                               n_layers=1, d_ff=32)
    rng = np.random.RandomState(0)
    tok = rng.randint(0, 32, (16, 9)).astype(np.int32)
    fn = tiop.make_ndarray_iter_fn(tok[:, :-1], tok[:, 1:], batch_size=4,
                                   last_batch_handle="discard")
    plain = tmx.io.NDArrayIter(tok[:, :-1], tok[:, 1:], batch_size=4,
                               last_batch_handle="discard")
    with tiop.InputPipeline(fn, num_workers=1, device="cpu") as p:
        got = tr.TransformerTrainStep(cfg, device="cpu", seed=0).fit(p, 6)
    want = tr.TransformerTrainStep(cfg, device="cpu", seed=0).fit(plain, 6)
    assert got == want and np.isfinite(got).all()


def _mlp(mx):
    x = mx.sym.Variable("data")
    x = mx.sym.FullyConnected(x, num_hidden=3, name="fc")
    return mx.sym.SoftmaxOutput(x, name="softmax")


class _Recording:
    """Wraps an InputPipeline class: records the ids of every batch the
    consumer takes."""

    @staticmethod
    def make(base):
        class Rec(base):
            seen = []

            def next(self):
                b = super().next()
                lab = b.label[0].asnumpy()
                type(self).seen.append([int(v) for v in lab])
                return b
        Rec.seen = []
        return Rec


def _fit(pkg, iop, pipe_cls, **fit_kw):
    xs = np.random.RandomState(0).rand(48, 2).astype(np.float32)
    fn = iop.make_ndarray_iter_fn(xs, (Y % 3).astype(np.float32),
                                  batch_size=4, last_batch_handle="discard")
    pipe = pipe_cls(fn, num_workers=2, device=False)
    try:
        mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
        mod.fit(pipe, num_epoch=1, optimizer="sgd",
                optimizer_params=(("learning_rate", 0.125),),
                initializer=pkg.init.Uniform(0.1), **fit_kw)
    finally:
        pipe.close()
    return pipe_cls.seen


def _resume_stream(iop, pipe_cls, payload):
    """What a resumed ``Module.fit`` does to its pipeline: skip the
    checkpoint's ``nbatch`` batches, then read on."""
    xs = np.random.RandomState(0).rand(48, 2).astype(np.float32)
    fn = iop.make_ndarray_iter_fn(xs, (Y % 3).astype(np.float32),
                                  batch_size=4, last_batch_handle="discard")
    with pipe_cls(fn, num_workers=2, device=False) as pipe:
        pipe.skip_batches(int(payload["nbatch"]))
        _stream(pipe)
    return pipe_cls.seen


@pytest.fixture
def per_batch_fit():
    """Both engines as imported (no explicit bulk size) for the test,
    restored after: the checkpoint cadence below is the per-batch
    loop's, and some JAX-package test files leave an explicit bulk size
    behind in the process (ROADMAP's watch list), which moves the JAX
    fit's checkpoints to its group ends."""
    saved = [(e, e._bulk_size, e._bulk_explicit)
             for e in (jmx.engine, tmx.engine)]
    for e in (jmx.engine, tmx.engine):
        e._bulk_size, e._bulk_explicit = 15, None
    yield
    for e, size, explicit in saved:
        e._bulk_size, e._bulk_explicit = size, explicit


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_checkpoint_cursor_resumes_the_other_package(tmp_path, writer,
                                                     reader, per_batch_fit):
    """``Module.fit`` over a pipeline checkpoints every 5 steps (12 steps
    an epoch: the newest is step 10); the other package resumes its own
    pipeline there and reads batches 10 and 11 of the same stream: the
    port through ``Module.fit(resume_from=...)``, the JAX package
    through its fit's resume rule (``skip_batches(nbatch)``; its
    ``Module.fit`` cannot load the port's pickled optimizer state)."""
    from mxnet_tpu import checkpoint as jckpt
    from mxnet_tpu_torch import checkpoint as tckpt

    pkgs = {"jax": (jmx, jiop, jckpt), "torch": (tmx, tiop, tckpt)}
    d = str(tmp_path / "ck")
    wpkg, wiop, _ = pkgs[writer]
    rpkg, riop, rckpt = pkgs[reader]
    full = _fit(wpkg, wiop, _Recording.make(wiop.InputPipeline),
                checkpoint_every_n=5, checkpoint_dir=d)
    assert len(full) == 12
    payload = rckpt.load_checkpoint(d)
    assert payload["step"] == 10 and payload["nbatch"] == 10
    # fit has taken batch 11 already (its one-batch lookahead)
    assert payload["iterator"]["cursor"] == 44
    assert payload["iterator"]["batch_size"] == 4
    if reader == "torch":
        resumed = _fit(rpkg, riop, _Recording.make(riop.InputPipeline),
                       resume_from=d)
    else:
        resumed = _resume_stream(riop, _Recording.make(riop.InputPipeline),
                                 payload)
    assert resumed == full[10:]
