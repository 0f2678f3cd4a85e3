"""The port's parameter-server tier (``kvstore.create("dist_*")``,
``kvstore_server``, ``_ps``, ``mxnet_tpu_torch.launch``) on loopback
clusters on the CPU: the reference worker's exact arithmetic identities
(``tests/dist_worker.py``, ported as ``tests/torch_dist_worker.py``),
and ``Module.fit`` over ``dist_sync`` against the JAX package's
``Module.fit`` at the doubled batch under ``local``.

Five clusters start once for this file, side by side: ``sync`` (2
workers, 2 servers: Module.fit, then the push/pull kinds), ``env`` (2
workers, 1 server, ``MXNET_GRADIENT_COMPRESSION=2bit`` and a chaos
``drop_push``), ``async`` (2 workers, 1 server, ``dist_async``),
``sparse_wire`` (2 workers, 2 servers) and ``sparse_chaos`` (2 workers,
1 server, a chaos ``drop_sparse_pull``).  A
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
        "sparse_wire": (2, 2, cmd + ["sparse_wire", "--device", "cpu"],
                        {}),
        "sparse_chaos": (2, 1, cmd + ["sparse_chaos", "--device", "cpu"],
                         {"MXNET_CHAOS": "drop_sparse_pull:rank=1,nth=2",
                          "MXNET_PS_RETRY_BACKOFF_S": "0.01"}),
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
    error feedback, compression after the optimizer, barriers,
    row-sparse pulls and pushes and the SDC refusals: every worker
    exits 0."""
    assert clusters["codes"]["sync"] == [0, 0]


def test_dist_sync_env_compression_and_chaos_drop(clusters):
    assert clusters["codes"]["env"] == [0, 0]


def test_dist_async_applies_every_push_once(clusters):
    assert clusters["codes"]["async"] == [0, 0]


def test_dist_sparse_wire_bytes_and_compression(clusters):
    """2 workers x 2 servers: row-sparse pull / push bytes proportional
    to unique rows (exact formulas), an empty part counted in its round,
    and the 2-bit sparse push with per-row error feedback bitwise the
    uncompressed control (``torch_dist_worker.run_sparse_wire``)."""
    assert clusters["codes"]["sparse_wire"] == [0, 0]


def test_dist_sparse_chaos_drop_pull(clusters):
    """``drop_sparse_pull:rank=1,nth=2``: the retry absorbs the lost
    response and every pulled value is bitwise the clean schedule's."""
    assert clusters["codes"]["sparse_chaos"] == [0, 0]


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


def _server(controller=None):
    """A server shard's state without its sockets: one worker, sync."""
    import threading

    from mxnet_tpu_torch.kvstore_server import KVStoreServer

    srv = KVStoreServer.__new__(KVStoreServer)
    srv.controller = controller
    srv.num_workers, srv.sync_mode = 1, True
    srv.store, srv.state = {}, {}
    srv.updater, srv.gc = None, None
    srv.lock = threading.Condition()
    srv.apply_s, srv.applies = 0.0, 0
    return srv


def _dispatch(msg, controller=None, srv=None):
    """One request through a server shard's dispatch (no cluster)."""
    srv = srv if srv is not None else _server(controller)
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


_TABLE = np.arange(12, dtype=np.float32).reshape(6, 2)


@pytest.mark.parametrize("msg,item", [
    ({"op": "pull_rows", "key": "k", "rows": np.array([4, 1])},
     {"data": _TABLE[[4, 1]], "rows": [4, 1]}),
    ({"op": "push", "key": "k", "sparse": True, "worker": 0,
      "rows": np.array([2, 5, 2]), "shape": (6, 2),
      "data": np.ones((3, 2), np.float32)},
     {"stored_rows": {2: [2.0, 2.0], 5: [1.0, 1.0], 0: [0.0, 1.0]}}),
    ({"op": "sdc_report", "step": 0, "worker": 0, "fps": []}, "A11")])
def test_sparse_and_sdc_server_ops_raise(msg, item):
    """The row-sparse server ops answer (``pull_rows`` the requested
    rows; a sparse push, duplicate rows summed, replaces only its rows
    without an optimizer); the SDC ops still raise and name A11."""
    srv = _server()
    _dispatch({"op": "init", "key": "k", "data": _TABLE}, srv=srv)
    _, reply = _dispatch(msg, srv=srv)
    if isinstance(item, str):
        assert item in reply, reply
        return
    if "data" in item:
        np.testing.assert_array_equal(reply["data"], item["data"])
        np.testing.assert_array_equal(reply["rows"], item["rows"])
    for row, want in item.get("stored_rows", {}).items():
        np.testing.assert_array_equal(srv.store["k"][row], want)


def test_sparse_rounds_on_the_server():
    """Two workers' row-sparse parts merge in touched-rows space; an
    empty (0, dim) part counts toward the round; the updater gets a
    row-sparse gradient and moves only its rows; float64 values sum in
    float64 (the server's precision rule, as for dense pushes)."""
    srv = _server()
    srv.num_workers = 2
    table = np.zeros((6, 2), np.float64)
    _dispatch({"op": "init", "key": "t", "data": table}, srv=srv)

    def push(worker, rows, vals, key="t"):
        _dispatch({"op": "push", "key": key, "sparse": True,
                   "worker": worker, "pseq": None, "shape": (6, 2),
                   "rows": np.asarray(rows, np.int64),
                   "data": np.asarray(vals).reshape(len(rows), 2)}, srv=srv)

    push(0, [1], np.full((1, 2), 1.0 + 2.0 ** -40))
    assert srv.state["t"].applied == 0
    push(1, [], np.zeros((0, 2)))
    assert srv.state["t"].applied == 1
    # float32 would round 2**-40 away
    np.testing.assert_array_equal(srv.store["t"][1], 1.0 + 2.0 ** -40)
    np.testing.assert_array_equal(srv.store["t"][[0, 2, 3, 4, 5]], 0.0)
    # a round of two empty parts updates nothing
    push(0, [], np.zeros((0, 2)))
    push(1, [], np.zeros((0, 2)))
    assert srv.state["t"].applied == 2
    np.testing.assert_array_equal(srv.store["t"][1], 1.0 + 2.0 ** -40)
    # with an optimizer: the lazy update of the round's rows only
    import pickle

    _dispatch({"op": "set_optimizer", "payload": pickle.dumps(
        tmx.optimizer.SGD(learning_rate=0.5, momentum=0.9))}, srv=srv)
    _dispatch({"op": "init", "key": "u", "data": np.ones((6, 2),
                                                         np.float32)},
              srv=srv)
    push(0, [0, 3], np.ones((2, 2)), key="u")
    push(1, [3], np.ones((1, 2)), key="u")
    u = srv.store["u"]
    np.testing.assert_allclose(u[0], 0.5)
    np.testing.assert_allclose(u[3], 0.0)
    np.testing.assert_array_equal(u[[1, 2, 4, 5]], 1.0)
    push(0, [0], np.zeros((1, 2)), key="u")
    push(1, [], np.zeros((0, 2)), key="u")
    # row 0's momentum carries (-0.5 * 0.9), row 3's does not move
    np.testing.assert_allclose(srv.store["u"][0], 0.05, rtol=1e-6)
    np.testing.assert_allclose(srv.store["u"][3], 0.0)
