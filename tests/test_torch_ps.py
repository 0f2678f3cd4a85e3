"""The port's parameter-server failure semantics (``mxnet_tpu_torch._ps``,
``kvstore.KVStoreDist``, ``kvstore_server``), as
``tests/test_ps_failure.py`` holds the JAX package's: a request to a
hung peer times out, a closed peer raises instead of hanging, a tampered
frame is rejected under ``MXNET_PS_SECRET``, the scheduler ages
heartbeats into dead nodes and gives a recovering node its rank back,
and a worker whose server is stopped mid-run (SIGSTOP: the socket stays
open) fails within its request timeout.  Timeouts are short."""
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from mxnet_tpu_torch import _ps
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kvstore import KVStoreDist

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_request_timeout_on_hung_peer():
    """A peer that accepts but never responds must raise within the
    request timeout, not block forever."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    addr = lst.getsockname()

    def accept_and_sit():
        conn, _ = lst.accept()
        time.sleep(20)
        conn.close()

    t = threading.Thread(target=accept_and_sit, daemon=True)
    t.start()
    c = _ps.Client(addr)
    t0 = time.time()
    with pytest.raises(ConnectionError, match="no response"):
        c.request({"op": "pull", "key": "k"}, timeout=1.5)
    assert time.time() - t0 < 10
    c.close()
    lst.close()


def test_closed_peer_raises_not_hangs():
    """A peer that dies (connection closed) surfaces as MXNetError via
    the worker's response check."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    addr = lst.getsockname()

    def accept_one_then_close():
        conn, _ = lst.accept()
        msg = _ps.recv_msg(conn)
        _ps.send_msg(conn, {"ok": True})
        conn.close()

    t = threading.Thread(target=accept_one_then_close, daemon=True)
    t.start()
    c = _ps.Client(addr)
    assert KVStoreDist._req(c, {"op": "init"}) == {"ok": True}
    time.sleep(0.2)
    with pytest.raises(MXNetError, match="connection lost"):
        KVStoreDist._req(c, {"op": "push"})
    c.close()
    lst.close()


def test_hmac_authentication(monkeypatch):
    """With MXNET_PS_SECRET set, frames authenticate; a tampered frame
    is rejected instead of reaching pickle.loads."""
    monkeypatch.setenv("MXNET_PS_SECRET", "s3cret")
    a, b = socket.socketpair()
    _ps.send_msg(a, {"op": "x", "v": 1})
    assert _ps.recv_msg(b) == {"op": "x", "v": 1}
    # tamper: flip a payload byte after the tag
    import pickle
    import struct

    payload = pickle.dumps({"op": "evil"})
    tag = b"\x00" * _ps._TAG_LEN
    a.sendall(struct.pack("<Q", len(payload)) + tag + payload)
    with pytest.raises(ConnectionError, match="authentication"):
        _ps.recv_msg(b)
    a.close()
    b.close()


def test_scheduler_liveness_and_recovery():
    """Heartbeat aging drives dead_nodes; a recovering node reclaims its
    rank without shifting assignment."""
    port = _free_port()
    os.environ["DMLC_PS_ROOT_URI"] = "127.0.0.1"
    os.environ["DMLC_PS_ROOT_PORT"] = str(port)
    try:
        sched = _ps.Scheduler(port, num_servers=1, num_workers=1)
        t = threading.Thread(target=sched.run, daemon=True)
        t.start()

        srv = _ps.Client(("127.0.0.1", port))
        assert srv.request({"op": "register_server",
                            "addr": ("127.0.0.1", 1)})["rank"] == 0
        wrk = _ps.Client(("127.0.0.1", port))
        resp = wrk.request({"op": "register_worker"})
        assert resp["rank"] == 0
        assert resp["servers"] == [("127.0.0.1", 1)]

        # both heartbeated at registration: nothing dead at 60s horizon
        assert wrk.request({"op": "dead_nodes",
                            "timeout": 60})["dead"] == []
        time.sleep(1.1)
        # nobody has beaten for >1s: both show up at a 1s horizon
        dead = wrk.request({"op": "dead_nodes", "timeout": 1.0})["dead"]
        assert "server:0" in dead and "worker:0" in dead
        # a beat brings the server back
        srv.request({"op": "heartbeat", "role": "server", "rank": 0})
        dead = wrk.request({"op": "dead_nodes", "timeout": 1.0})["dead"]
        assert "server:0" not in dead and "worker:0" in dead

        # recovery rejoin: a "restarted" worker reclaims rank 0 and the
        # fresh-rank counter is untouched
        wrk2 = _ps.Client(("127.0.0.1", port))
        resp2 = wrk2.request({"op": "register_worker", "recovery": 0})
        assert resp2["rank"] == 0
        assert sched.worker_ranks == 1

        for c in (srv, wrk):
            c.request({"op": "finalize"})
            c.close()
        wrk2.close()
        t.join(timeout=5)
        assert not t.is_alive()
    finally:
        os.environ.pop("DMLC_PS_ROOT_URI", None)
        os.environ.pop("DMLC_PS_ROOT_PORT", None)


_STALL_WORKER = r"""
import sys
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd

mx.cpu().__enter__()
kv = mx.kv.create("dist_sync")
kv.init("k", nd.zeros((4,)))
open(sys.argv[1], "w").write("ready")
# keep pushing/pulling until the (stopped) server stops answering
try:
    for i in range(10000):
        kv.push("k", nd.ones((4,)))
        out = nd.zeros((4,))
        kv.pull("k", out=out)
except Exception as e:
    print("worker saw failure: %r" % e, flush=True)
    sys.exit(42)
sys.exit(0)
"""


def test_kill_server_mid_push_raises_within_timeout(tmp_path):
    """SIGSTOP the server mid-run (socket stays open — the true hang
    case): the worker must exit with our failure code within the request
    timeout instead of hanging forever."""
    port = _free_port()
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""),
        "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_NUM_SERVER": "1",
        "DMLC_NUM_WORKER": "1",
        "MXNET_PS_REQUEST_TIMEOUT": "1",
        "MXNET_PS_RETRY_BACKOFF_S": "0.05",
    })

    def spawn(role, argv):
        e = dict(env)
        e["DMLC_ROLE"] = role
        return subprocess.Popen(argv, env=e, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    node = [sys.executable, "-m", "mxnet_tpu_torch.kvstore_server"]
    ready = str(tmp_path / "ready")
    wscript = str(tmp_path / "worker.py")
    with open(wscript, "w") as f:
        f.write(_STALL_WORKER)

    sched = spawn("scheduler", node)
    server = spawn("server", node)
    worker = spawn("worker", [sys.executable, wscript, ready])
    try:
        deadline = time.time() + 60
        while not os.path.exists(ready):
            assert time.time() < deadline, "cluster never came up"
            assert worker.poll() is None, worker.communicate()[0]
            time.sleep(0.1)
        os.kill(server.pid, signal.SIGSTOP)  # hung, not closed
        t0 = time.time()
        try:
            rc = worker.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pytest.fail("worker hung on a stopped server")
        elapsed = time.time() - t0
        out = worker.communicate()[0].decode()
        assert rc == 42, out
        assert "failure" in out
        assert elapsed < 25
    finally:
        for p in (worker, sched):
            if p.poll() is None:
                p.kill()
        try:
            os.kill(server.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        server.wait()
        sched.wait()
        worker.wait()
