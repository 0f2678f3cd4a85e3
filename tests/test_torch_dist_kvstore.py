"""The port's parameter-server tier (``kvstore.create("dist_*")``,
``kvstore_server``, ``_ps``, ``mxnet_tpu_torch.launch``) on loopback
clusters on the CPU: the reference worker's exact arithmetic identities
(``tests/dist_worker.py``, ported as ``tests/torch_dist_worker.py``),
and ``Module.fit`` over ``dist_sync`` against the JAX package's
``Module.fit`` at the doubled batch under ``local``.

Three clusters start once for this file, side by side: ``sync`` (2
workers, 2 servers: Module.fit, then the push/pull kinds), ``env`` (2
workers, 1 server, ``MXNET_GRADIENT_COMPRESSION=2bit`` and a chaos
``drop_push``) and ``async`` (2 workers, 1 server, ``dist_async``).  A
worker asserts its identities and exits non-zero on a failure.
"""
import os
import socket
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _ps
from mxnet_tpu_torch.launch import launch_local

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as worker  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
TOL = 1e-10
FIT = dict(n=32, batch=8, epochs=2)


def _fit_start():
    """The MLP's Xavier parameters drawn by the JAX package's Module, the
    data, as float64."""
    rng = np.random.RandomState(0)
    X = rng.uniform(-1, 1, (FIT["n"], 6))
    y = rng.randint(0, 4, FIT["n"]).astype(np.float64)
    it = jmx.io.NDArrayIter(X, y, batch_size=2 * FIT["batch"])
    mod = jmx.mod.Module(worker.fit_mlp(jmx), context=jmx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    _cast_jax(mod)
    np.random.seed(3)
    mod.init_params(jmx.init.Xavier(magnitude=2.0))
    args = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return X, y, args


def _cast_jax(mod):
    ex = mod._exec
    for d in (ex.arg_dict, ex.aux_dict, ex.grad_dict):
        for cell in d.values():
            if cell is not None:
                cell._data = cell._data.astype("float64")


def _jax_fit(X, y, args):
    """The JAX package's Module.fit at the doubled batch under local."""
    it = jmx.io.NDArrayIter(X, y, batch_size=2 * FIT["batch"])
    mod = jmx.mod.Module(worker.fit_mlp(jmx), context=jmx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    _cast_jax(mod)
    mod.init_params(arg_params={k: jmx.nd.array(v, dtype=v.dtype)
                                for k, v in args.items()})
    mod.fit(it, num_epoch=FIT["epochs"], optimizer="sgd",
            optimizer_params=worker.FIT_OPT, kvstore="local")
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    io = tmp_path_factory.mktemp("dist_fit")
    X, y, args = _fit_start()
    np.savez(io / "fit_in.npz", X=X, y=y, batch=FIT["batch"],
             epochs=FIT["epochs"], **{"arg:" + k: v for k, v in args.items()})
    cmd = [sys.executable, WORKER]
    runs = {
        "sync": (2, 2, cmd + ["sync", "--device", "cpu", "--io", str(io)],
                 {}),
        "env": (2, 1, cmd + ["env", "--device", "cpu"],
                {"MXNET_GRADIENT_COMPRESSION": "2bit",
                 "MXNET_GRADIENT_COMPRESSION_THRESHOLD": "0.5",
                 "MXNET_CHAOS": "drop_push:rank=1,key=c,nth=2",
                 "MXNET_PS_RETRY_BACKOFF_S": "0.01"}),
        "async": (2, 1, cmd + ["async", "--device", "cpu"], {}),
    }
    env = {"OMP_NUM_THREADS": "1"}
    with ThreadPoolExecutor(len(runs)) as pool:
        futs = {k: pool.submit(launch_local, nw, ns, c, dict(env, **e))
                for k, (nw, ns, c, e) in runs.items()}
        codes = {k: f.result() for k, f in futs.items()}
    return {"codes": codes, "io": io, "fit": (X, y, args)}


def test_dist_sync_identities(clusters):
    """Push/pull sums, several values a key merged, shuffled orders and
    bursts, liveness, the server optimizer, optimizer states across 2
    server shards, the 2-bit wire at 1/16 of the bytes with bitwise
    error feedback, compression after the optimizer, barriers and the
    sparse / SDC refusals: every worker exits 0."""
    assert clusters["codes"]["sync"] == [0, 0]


def test_dist_sync_env_compression_and_chaos_drop(clusters):
    assert clusters["codes"]["env"] == [0, 0]


def test_dist_async_applies_every_push_once(clusters):
    assert clusters["codes"]["async"] == [0, 0]


def test_module_fit_over_dist_sync_matches_jax_local_doubled_batch(
        clusters):
    """2 workers x batch 8 over dist_sync (the server's SGD with momentum
    and weight decay, rescale 1/(8 x 2)) = the JAX package's Module.fit
    at batch 16 under local, float64, 4 steps."""
    assert clusters["codes"]["sync"] == [0, 0]
    want = _jax_fit(*clusters["fit"])
    with np.load(clusters["io"] / "fit_out.npz") as f:
        got = {k: f[k] for k in f.files}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max()) / max(1.0, np.abs(w).max())
        assert err <= TOL, (k, err)
    start = clusters["fit"][2]
    assert max(np.abs(got[k] - start[k]).max() for k in got) > 1e-3


def test_single_process_dist_fallback():
    """dist_sync without the cluster env is the one-process store."""
    for var in ("DMLC_ROLE", "DMLC_PS_ROOT_URI"):
        assert var not in os.environ
    with tmx.cpu():
        kv = tmx.kv.create("dist_sync")
        assert kv.rank == 0 and kv.num_workers == 1
        assert type(kv) is tmx.kvstore.KVStore
        kv.init("k", tmx.nd.zeros((2,)))
        kv.push("k", tmx.nd.ones((2,)))
        out = tmx.nd.zeros((2,))
        kv.pull("k", out=out)
    np.testing.assert_allclose(out.asnumpy(), 1.0)


def test_local_set_gradient_compression_raises():
    """In-process stores refuse compression; invalid params raise for
    every kind; the launcher-less dist store validates and warns."""
    for kind in ("local", "device", "tpu", "nccl"):
        with pytest.raises(tmx.MXNetError, match="dist"):
            tmx.kv.create(kind).set_gradient_compression(
                {"type": "2bit", "threshold": 0.5})
    with pytest.raises(ValueError):
        tmx.kv.create("local").set_gradient_compression({"type": "1bit"})
    with pytest.raises(ValueError):
        tmx.kv.create("local").set_gradient_compression(
            {"type": "2bit", "threshold": -1.0})
    kv = tmx.kv.create("dist_sync")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    with pytest.raises(ValueError):
        kv.set_gradient_compression({"type": "1bit"})


def _dispatch(msg, controller=None):
    """One request through a server shard's dispatch (no cluster)."""
    from mxnet_tpu_torch.kvstore_server import KVStoreServer

    srv = KVStoreServer.__new__(KVStoreServer)
    srv.controller = controller
    a, b = socket.socketpair()
    try:
        _ps.send_msg(a, msg)
        conn_msg = _ps.recv_msg(b)
        try:
            closed = srv._dispatch(b, conn_msg)
        except NotImplementedError as e:
            return None, str(e)
        return closed, _ps.recv_msg(a)
    finally:
        a.close()
        b.close()


def test_server_command_channel_controller():
    """SendCommandToServers -> the server's controller (the
    MXKVStoreRunServer contract)."""
    got = []
    closed, reply = _dispatch({"op": "command", "head": 7,
                               "body": "sync=0"},
                              lambda head, body: got.append((head, body)))
    assert closed in (None, False) and reply == {"ok": True}
    assert got == [(7, "sync=0")]


@pytest.mark.parametrize("msg,item", [
    ({"op": "pull_rows", "key": "k", "rows": [0]}, "A10 sparse"),
    ({"op": "push", "key": "k", "sparse": True, "worker": 0}, "A10 sparse"),
    ({"op": "sdc_report", "step": 0, "worker": 0, "fps": []}, "A11")])
def test_sparse_and_sdc_server_ops_raise(msg, item):
    _, err = _dispatch(msg)
    assert item in err, err
