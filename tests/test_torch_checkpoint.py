"""Parity of the port's checkpoint layout (``mxnet_tpu_torch.checkpoint``)
with the JAX package's: a step written by either package loads in the
other with identical arrays (float32, int64 and bfloat16, whose dtype
survives both ways without ``ml_dtypes`` on the port's side), both
audits report the same, a missing rank is named identically, a corrupt
shard fails closed in both, and retention keeps the same steps.  The
port's asynchronous writer: its shards cross to the JAX package too,
a writer error is raised at ``wait()`` and at the next save, ``wait``
times out while a write is pending, ``MXNET_CKPT_ASYNC=0`` writes
blocking, a dropout ``Module.fit`` resumes bitwise from an asynchronous
shard, and a SIGTERM while the writer writes drains it and exits 83.

Tolerance: none — every array must come back bit for bit.
"""
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from mxnet_tpu import checkpoint as jck
from mxnet_tpu_torch import checkpoint as tck

PKGS = {"jax": jck, "port": tck}


def _params(dtype, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(5, 7).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    if dtype == "bfloat16":
        w, b = w.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    return {"w": w, "b": b, "steps": np.arange(4, dtype=np.int64)}


def _for_port(a):
    """A JAX-side host array as the port holds it (bf16 as a torch
    tensor: numpy has none without ml_dtypes)."""
    if a.dtype == ml_dtypes.bfloat16:
        bits = a.view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return a


def _same(got, want):
    """Bitwise equality of a loaded value with the value written."""
    if isinstance(want, torch.Tensor):
        want = want.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16
        got = got.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    assert got.dtype == want.dtype and got.shape == want.shape
    return np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax"),
                                           ("port_async", "jax")])
def test_a_step_crosses_packages(tmp_path, dtype, writer, reader):
    d = str(tmp_path)
    params = _params(dtype)
    aux = {"mean": np.linspace(0, 1, 7).astype(np.float32)}
    written = params if writer == "jax" else \
        {k: _for_port(v) for k, v in params.items()}
    if writer == "port_async":
        # the port's background writer: the snapshot is taken before
        # save() returns, so the caller's in-place update right after
        # it (as the port's optimizers make) cannot reach the shard
        live = {k: torch.as_tensor(v).clone() if isinstance(v, np.ndarray)
                else v.clone() for k, v in written.items()}
        mgr = tck.CheckpointManager(d, async_write=True)
        mgr.save(3, params=live, aux_params=aux, epoch=2, nbatch=9)
        for v in live.values():
            v.add_(1)
        assert mgr.wait(timeout=60)
        assert mgr._writer.name == "mx-ckpt-writer"
    else:
        PKGS[writer].save_checkpoint(d, 3, params=written, aux_params=aux,
                                     epoch=2, nbatch=9)
    got = PKGS[reader].load_checkpoint(d)
    assert got["step"] == 3 and got["epoch"] == 2 and got["nbatch"] == 9
    assert sorted(got["params"]) == sorted(params)
    for k, v in params.items():
        assert _same(got["params"][k], v), k
        if reader == "port" and dtype == "bfloat16" and k != "steps":
            assert isinstance(got["params"][k], torch.Tensor)
        if reader == "jax":
            assert got["params"][k].dtype == v.dtype, k
    assert _same(got["aux_params"]["mean"], aux["mean"])
    # both audits pass it, and the manifests agree on the tree spec
    assert jck.verify_dir(d)["ok"] and tck.verify_dir(d)["ok"]
    assert jck.read_manifest(d, 3)["tree"] == tck.read_manifest(d, 3)[
        "tree"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_verify_dir_reports_agree(tmp_path, writer):
    d = str(tmp_path)
    for step in (1, 2, 3):
        PKGS[writer].save_checkpoint(d, step, params=_params("float32",
                                                             step))
    with open(jck.shard_path(d, 3, 0), "r+b") as f:
        f.seek(60)
        f.write(b"\xff\x00\xff\x00")
    want, got = jck.verify_dir(d), tck.verify_dir(d)
    assert got == want
    assert got["n_verified"] == 2 and got["n_corrupt"] == 1
    assert got["steps"][-1]["corrupt"] == ["rank0.ckpt"]
    assert tck.main(["--verify", d, "--json"]) == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_missing_rank_is_named_identically(tmp_path, writer):
    d = str(tmp_path)
    PKGS[writer].CheckpointManager(d, rank=0, num_ranks=2,
                                   async_write=False).save(
        5, params={"w": np.ones(3, dtype="float32")})
    assert tck.missing_ranks(d, 5, 2) == jck.missing_ranks(d, 5, 2) == [1]
    assert tck.latest_step(d, 2) is None and jck.latest_step(d, 2) is None
    msgs = []
    for pkg in (jck, tck):
        with pytest.raises(FileNotFoundError) as ei:
            pkg.load_checkpoint(d, rank=1, num_ranks=2)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "rank(s) [1] of 2" in msgs[1]


@pytest.mark.parametrize("explicit", [True, False])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_corrupt_shard_fails_closed(tmp_path, writer, explicit):
    d = str(tmp_path)
    PKGS[writer].save_checkpoint(d, 4, params=_params("bfloat16"))
    with open(jck.shard_path(d, 4, 0), "r+b") as f:
        f.seek(80)
        f.write(b"\x00\x01\x02\x03")
    for pkg in (jck, tck):
        with pytest.raises(pkg.CheckpointCorrupt, match="rank0.ckpt"):
            pkg.load_checkpoint(d, step=4 if explicit else None)


def test_newest_corrupt_step_falls_back_in_both(tmp_path):
    d = str(tmp_path)
    tck.save_checkpoint(d, 1, params=_params("float32", 1))
    jck.save_checkpoint(d, 2, params=_params("float32", 2))
    with open(jck.shard_path(d, 2, 0), "r+b") as f:
        f.seek(60)
        f.write(b"\xff" * 8)
    for pkg in (jck, tck):
        got = pkg.load_checkpoint(d)
        assert got["step"] == 1
        assert _same(got["params"]["w"], _params("float32", 1)["w"])


def test_retention_keeps_the_same_steps(tmp_path):
    kept = {}
    for name, pkg in PKGS.items():
        d = str(tmp_path / name)
        mgr = pkg.CheckpointManager(d, keep=2, async_write=False)
        for step in range(1, 6):
            mgr.save(step, params={"w": np.full(3, step, np.float32)})
        kept[name] = (pkg.list_steps(d), pkg.latest_step(d))
        assert pkg.load_checkpoint(d)["params"]["w"][0] == 5
    assert kept["port"] == kept["jax"] == ([4, 5], 5)


def test_reads_a_bf16_shard_without_ml_dtypes(tmp_path, monkeypatch):
    """The card's machine has no ml_dtypes: the port's reader must not
    import it to load a JAX-written bf16 shard."""
    import builtins
    import sys

    d = str(tmp_path)
    jck.save_checkpoint(d, 1, params=_params("bfloat16"))
    real_import = builtins.__import__

    def no_ml_dtypes(name, *a, **k):
        if name.split(".")[0] == "ml_dtypes":
            raise ImportError("no ml_dtypes here")
        return real_import(name, *a, **k)

    monkeypatch.delitem(sys.modules, "ml_dtypes")
    monkeypatch.setattr(builtins, "__import__", no_ml_dtypes)
    got = tck.load_checkpoint(d)
    monkeypatch.undo()
    assert got["params"]["w"].dtype == torch.bfloat16
    assert _same(got["params"]["w"], _params("bfloat16")["w"])


# ---------------------------------------------------------------------------
# the asynchronous writer
# ---------------------------------------------------------------------------
def _slow_writes(monkeypatch, gate=None, fail_steps=()):
    """Make the writer thread's writes wait on ``gate`` (a
    threading.Event) and fail for ``fail_steps``."""
    real = tck.CheckpointManager._write

    def write(self, step, payload, path):
        if gate is not None:
            assert gate.wait(30)
        if step in fail_steps:
            raise OSError("disk full at step %d" % step)
        return real(self, step, payload, path)

    monkeypatch.setattr(tck.CheckpointManager, "_write", write)


def test_a_writer_error_is_raised_at_wait_and_at_the_next_save(
        tmp_path, monkeypatch):
    _slow_writes(monkeypatch, fail_steps=(1, 2))
    mgr = tck.CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(1, params=_params("float32"))
    with pytest.raises(OSError, match="step 1"):
        mgr.wait(timeout=30)
    assert mgr.wait(timeout=30)             # raised once, then clean
    mgr.save(2, params=_params("float32"))
    mgr._q.join()
    with pytest.raises(OSError, match="step 2"):
        mgr.save(3, params=_params("float32"))
    mgr.save(3, params=_params("float32"))
    assert mgr.wait(timeout=30)
    assert tck.list_steps(str(tmp_path)) == [3]


def test_wait_times_out_while_a_write_is_pending(tmp_path, monkeypatch):
    import threading

    gate = threading.Event()
    _slow_writes(monkeypatch, gate=gate)
    mgr = tck.CheckpointManager(str(tmp_path), async_write=True)
    path = mgr.save(1, params=_params("float32"))
    assert mgr.wait(timeout=0.2) is False
    assert not os.path.exists(path)
    gate.set()
    assert mgr.wait(timeout=30) is True
    assert os.path.exists(path) and tck.verify_step(
        str(tmp_path), 1)["verified"]


def test_ckpt_async_0_writes_blocking(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "0")
    mgr = tck.CheckpointManager(str(tmp_path))
    assert mgr.async_write is False
    path = mgr.save(1, params=_params("float32"))
    assert os.path.exists(path) and mgr._writer is None
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "1")
    assert tck.CheckpointManager(str(tmp_path)).async_write is True
    monkeypatch.delenv("MXNET_CKPT_ASYNC")
    assert tck.CheckpointManager(str(tmp_path)).async_write is True


def _dropout_fit(epochs, seed=4, **fit_kw):
    """FC(16), ReLU, Dropout(0.5), FC(4), SoftmaxOutput on 40 rows at
    batch 8 (5 steps an epoch), on the CPU, from fixed weights."""
    import mxnet_tpu_torch as mx

    rng = np.random.RandomState(0)
    X = rng.uniform(-1, 1, (40, 6)).astype(np.float32)
    y = rng.randint(0, 4, 40).astype(np.float32)
    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        x = mx.sym.FullyConnected(x, num_hidden=16, name="fc1")
        x = mx.sym.Activation(x, act_type="relu")
        x = mx.sym.Dropout(x, p=0.5)
        x = mx.sym.FullyConnected(x, num_hidden=4, name="fc2")
        sym = mx.sym.SoftmaxOutput(x, name="softmax")
    it = mx.io.NDArrayIter(X, y, batch_size=8)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    w = np.random.RandomState(3)
    mod.init_params(arg_params={
        n: mx.nd.array(w.uniform(-0.3, 0.3, s), ctx=mx.cpu())
        for n, s in zip(sym.list_arguments(),
                        sym.infer_shape(data=(8, 6))[0])
        if n not in ("data", "softmax_label")})
    mx.random.seed(seed)
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.125),
                              ("momentum", 0.9)), **fit_kw)
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_a_dropout_fit_resumes_bitwise_from_an_async_shard(
        tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "1")
    full = _dropout_fit(2)
    d = str(tmp_path / "ck")
    seen = []
    real = tck.CheckpointManager.save

    def save(self, *a, **k):
        seen.append(self.async_write and not k.get("blocking"))
        return real(self, *a, **k)

    monkeypatch.setattr(tck.CheckpointManager, "save", save)
    _dropout_fit(1, checkpoint_every_n=3, checkpoint_dir=d)
    assert seen == [True]
    assert tck.verify_dir(d)["ok"] and tck.latest_step(d) == 3
    resumed = _dropout_fit(2, seed=99, resume_from=d)
    for k in full:
        np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)


_SIGTERM_CHILD = """
import os, sys, time
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint as ck

marker, d = sys.argv[1], sys.argv[2]
real = ck.CheckpointManager._write

def slow_write(self, step, payload, path):
    with open(marker, "w") as f:
        f.write(str(step))
    time.sleep(0.5)
    return real(self, step, payload, path)

ck.CheckpointManager._write = slow_write
rng = np.random.RandomState(0)
X = rng.uniform(-1, 1, (160, 6)).astype(np.float32)
y = rng.randint(0, 4, 160).astype(np.float32)
x = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                          name="fc")
mod = mx.mod.Module(mx.sym.SoftmaxOutput(x, name="softmax"),
                    context=mx.cpu())
mod.fit(mx.io.NDArrayIter(X, y, batch_size=8), num_epoch=1,
        optimizer_params=(("learning_rate", 0.1),),
        checkpoint_every_n=2, checkpoint_dir=d,
        batch_end_callback=lambda p: time.sleep(0.1))
sys.exit(3)  # the SIGTERM must land before the fit ends
"""


def test_a_sigterm_while_the_writer_writes_drains_and_exits_83(tmp_path):
    import signal
    import subprocess
    import sys
    import time

    marker, d = str(tmp_path / "writing"), str(tmp_path / "ck")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = subprocess.Popen(
        [sys.executable, "-c", _SIGTERM_CHILD, marker, d], cwd=repo,
        env=dict(os.environ, MXNET_CKPT_ASYNC="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(marker) and child.poll() is None:
            assert time.monotonic() < deadline, "no write started"
            time.sleep(0.02)
        child.send_signal(signal.SIGTERM)
        _, err = child.communicate(timeout=90)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 83, err.decode()[-2000:]
    report = tck.verify_dir(d)
    assert report["ok"] and report["n_verified"] >= 1, report
    step = tck.latest_step(d)
    assert tck.verify_step(d, step)["verified"]
    assert tck.load_checkpoint(d)["step"] == step
    leftovers = [n for _, _, files in os.walk(d) for n in files
                 if n.endswith(".tmp")]
    assert leftovers == []
