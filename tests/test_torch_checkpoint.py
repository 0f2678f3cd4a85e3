"""Parity of the port's checkpoint layout (``mxnet_tpu_torch.checkpoint``)
with the JAX package's: a step written by either package loads in the
other with identical arrays (float32, int64 and bfloat16, whose dtype
survives both ways without ``ml_dtypes`` on the port's side), both
audits report the same, a missing rank is named identically, a corrupt
shard fails closed in both, and retention keeps the same steps.

Tolerance: none — every array must come back bit for bit.
"""
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
                                           ("port", "jax")])
def test_a_step_crosses_packages(tmp_path, dtype, writer, reader):
    d = str(tmp_path)
    params = _params(dtype)
    aux = {"mean": np.linspace(0, 1, 7).astype(np.float32)}
    written = params if writer == "jax" else \
        {k: _for_port(v) for k, v in params.items()}
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
    kw = {} if writer == "port" else {"async_write": False}
    PKGS[writer].CheckpointManager(d, rank=0, num_ranks=2, **kw).save(
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
        kw = {} if name == "port" else {"async_write": False}
        mgr = pkg.CheckpointManager(d, keep=2, **kw)
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
