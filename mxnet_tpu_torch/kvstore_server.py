"""Parameter-server node: request handling and role bootstrap.

Counterpart: ``mxnet_tpu/kvstore_server.py`` (ref:
src/kvstore/kvstore_dist_server.h: the DataHandleEx dispatch :173, sync
aggregation waiting for NumWorkers parts :187-189, the compressed
handler :392, the sync-mode command :154-159, the serialized optimizer
executor :54-98; python/mxnet/kvstore_server.py:28-73, the bootstrap by
DMLC_ROLE).

One server shard keeps its keys in host memory as numpy arrays, as the
JAX package's does.  The optimizer runs under one lock (the reference's
serialized executor), so sync aggregation is deterministic: every
worker's pull after its push sees the round's update.  Departures:

  * the ``Updater`` (a pickled port optimizer) runs on host tensors that
    share the stored arrays' memory, in place; the JAX server moves each
    key to its default device for the update and back;
  * a round aggregates in the pushed dtype where it is wider than
    float32 (float64 stays float64); the JAX server aggregates in
    float32 whatever was pushed.

Row-sparse pushes and pulls raise and name ROADMAP A10 sparse; the SDC
fingerprint ops raise and name A11.
"""
from __future__ import annotations

import os
import pickle
import socket
import threading
from typing import Any, Dict, Optional

import numpy as np

from . import _ps
from .gradient_compression import GradientCompression

__all__ = ["KVStoreServer", "run_scheduler", "run_server", "init"]

_SPARSE = ("row-sparse pushes and pulls need sparse storage, which is "
           "not ported (ROADMAP A10 sparse)")
_SDC = ("the SDC fingerprint vote is not ported (ROADMAP A11)")


class _KeyState:
    __slots__ = ("agg", "parts", "pushed_by", "applied")

    def __init__(self):
        self.agg: Optional[np.ndarray] = None
        self.parts = 0  # parts buffered toward the current round
        self.pushed_by: Dict[int, int] = {}  # worker -> total pushes
        self.applied = 0  # completed aggregation rounds


def _agg_dtype(a: np.ndarray):
    """The dtype a round sums in: float32, or the pushed dtype where it
    is wider."""
    return np.promote_types(a.dtype, np.float32)


class KVStoreServer:
    """One PS shard (ref: KVStoreDistServer, kvstore_dist_server.h:113)."""

    def __init__(self, controller=None):
        self.controller = controller
        host, port, num_servers, num_workers = _ps.env_cluster()
        self.num_workers = num_workers
        self.sync_mode = True
        self.store: Dict[Any, np.ndarray] = {}
        self.state: Dict[Any, _KeyState] = {}
        self.updater = None
        self.gc: Optional[GradientCompression] = None
        self.lock = threading.Condition()
        self.stopped_workers = 0
        # seconds in the optimizer / aggregate store, and the count
        self.apply_s, self.applies = 0.0, 0
        self.listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # never listen on external interfaces for loopback clusters
        self.listen.bind((_ps.bind_host(), 0))
        self.listen.listen(128)
        self.addr = (socket.gethostbyname(socket.gethostname())
                     if host not in ("127.0.0.1", "localhost")
                     else "127.0.0.1", self.listen.getsockname()[1])
        sched = _ps.connect_scheduler()
        reg = {"op": "register_server", "addr": self.addr}
        if os.environ.get("DMLC_PS_IS_RECOVERY"):
            # is_recovery rejoin (ref: kvstore_dist.h:56): reclaim the
            # previous rank slot instead of taking a fresh one
            reg["recovery"] = int(os.environ.get("DMLC_SERVER_ID", "0"))
        resp = sched.request(reg)
        self.rank = resp["rank"]
        self.sched = sched
        self._heartbeat = _ps.Heartbeat("server", self.rank)

    def run(self):
        """Accept one connection per worker and serve until every worker
        says stop."""
        threads = []
        while True:
            with self.lock:
                if self.stopped_workers >= self.num_workers:
                    break
            self.listen.settimeout(0.2)
            try:
                conn, _ = self.listen.accept()
            except socket.timeout:
                continue
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=5)
        self._heartbeat.stop()
        self.sched.request({"op": "finalize", "role": "server",
                            "rank": self.rank})
        self.sched.close()
        self.listen.close()

    # -- request dispatch (ref: DataHandleEx, kvstore_dist_server.h:173)
    def _serve(self, conn):
        try:
            while True:
                msg = _ps.recv_msg(conn)
                if msg is None:
                    return
                try:
                    if self._dispatch(conn, msg):
                        return
                except (RuntimeError, ValueError, KeyError,
                        NotImplementedError) as e:
                    # handler errors go back as error frames; the
                    # connection stays usable
                    _ps.send_msg(conn, {"error": "%s: %s"
                                        % (type(e).__name__, e)})
        finally:
            conn.close()

    def _dispatch(self, conn, msg) -> bool:
        """Handle one request; returns True when the connection should
        close (the worker said stop)."""
        op = msg["op"]
        if op == "init":
            with self.lock:
                if msg["key"] not in self.store or msg.get("force"):
                    self.store[msg["key"]] = np.array(msg["data"],
                                                      copy=True)
                    self.state.setdefault(msg["key"], _KeyState())
            _ps.send_msg(conn, {"ok": True})
        elif op == "push":
            applied = self._handle_push(msg)
            _ps.send_msg(conn, {"ok": True, "dup": not applied})
        elif op == "worker_hello":
            # is_recovery rejoin: hand back the worker's push counts so
            # its fresh pushes are not deduped (exactly-once survives
            # the restart)
            w = int(msg["worker"])
            with self.lock:
                counts = {key: st.pushed_by[w]
                          for key, st in self.state.items()
                          if w in st.pushed_by}
            _ps.send_msg(conn, {"ok": True, "pseq": counts})
        elif op == "pull":
            _ps.send_msg(conn, {"data": self._handle_pull(msg)})
        elif op == "pull_rows":
            raise NotImplementedError(_SPARSE)
        elif op in ("sdc_report", "sdc_gather", "sdc_digest"):
            raise NotImplementedError(_SDC)
        elif op == "set_optimizer":
            # ref: the server command channel (kvstore_dist.h:102); the
            # optimizer travels pickled
            with self.lock:
                from . import optimizer as _opt

                optimizer = pickle.loads(msg["payload"])
                # None uninstalls: back to raw-aggregate semantics
                self.updater = (None if optimizer is None
                                else _opt.get_updater(optimizer))
            _ps.send_msg(conn, {"ok": True})
        elif op == "command":
            # the generic command channel (ref: SendCommandToServers ->
            # server_controller, kvstore_dist_server.h:154)
            if self.controller is not None:
                self.controller(int(msg.get("head", 0)),
                                str(msg.get("body", "")))
            _ps.send_msg(conn, {"ok": True})
        elif op == "stats":
            with self.lock:
                stats = {"apply_s": self.apply_s, "applies": self.applies,
                         "keys": len(self.store)}
            _ps.send_msg(conn, {"data": stats})
        elif op == "set_sync":
            # ref: the sync-mode command, kvstore_dist_server.h:154
            with self.lock:
                self.sync_mode = bool(msg["sync"])
            _ps.send_msg(conn, {"ok": True})
        elif op == "set_compression":
            with self.lock:
                self.gc = GradientCompression(
                    type=msg["type"], threshold=float(msg["threshold"]))
            _ps.send_msg(conn, {"ok": True})
        elif op == "save_optimizer_states":
            with self.lock:
                blob = (self.updater.get_states(
                    msg.get("dump_optimizer", False))
                    if self.updater else b"")
            _ps.send_msg(conn, {"data": blob})
        elif op == "load_optimizer_states":
            with self.lock:
                if self.updater is None:
                    _ps.send_msg(conn, {"ok": False,
                                        "error": "no optimizer"})
                else:
                    self.updater.set_states(msg["data"])
                    _ps.send_msg(conn, {"ok": True})
        elif op == "stop":
            with self.lock:
                self.stopped_workers += 1
                self.lock.notify_all()
            _ps.send_msg(conn, {"ok": True})
            return True
        else:
            _ps.send_msg(conn, {"error": "bad op %r" % op})
        return False

    def _handle_push(self, msg) -> bool:
        """Fold one push into the aggregation round; returns False for
        a deduplicated resend (nothing applied)."""
        key = msg["key"]
        if msg.get("sparse"):
            raise NotImplementedError(_SPARSE)
        if msg.get("compressed"):
            if self.gc is None:
                raise RuntimeError("compressed push without "
                                   "set_compression")
            grad = self.gc.decompress(msg["data"], msg["shape"])
        else:
            grad = np.asarray(msg["data"])
        with self.lock:
            st = self.state.setdefault(key, _KeyState())
            w = int(msg["worker"])
            # exactly-once under worker retry: a push whose response was
            # lost is resent with the same per-(worker, key) pseq; a pseq
            # already counted is acked without applying it again
            pseq = msg.get("pseq")
            if pseq is not None and int(pseq) <= st.pushed_by.get(w, 0):
                return False
            st.pushed_by[w] = st.pushed_by.get(w, 0) + 1
            if not self.sync_mode:
                # ref: dist_async, every push applies at once
                # (kvstore_dist_server.h:266)
                self._apply(key, grad)
                st.applied += 1
                self.lock.notify_all()
                return True
            if st.agg is None:
                st.agg = grad.astype(_agg_dtype(grad), copy=True)
            else:
                st.agg = st.agg + grad
            st.parts += 1
            if st.parts >= self.num_workers:
                # ref: ApplyUpdates once NumWorkers parts arrived
                # (kvstore_dist_server.h:187-189: parts, not distinct
                # workers, so an over-pushing worker rolls into the next
                # round instead of counting twice in one)
                self._apply(key, st.agg)
                st.agg = None
                st.parts -= self.num_workers
                st.applied += 1
                self.lock.notify_all()
        return True

    def _apply(self, key, merged):
        import time as _time

        t0 = _time.perf_counter()
        self._apply_now(key, merged)
        self.apply_s += _time.perf_counter() - t0
        self.applies += 1

    def _apply_now(self, key, merged):
        if self.updater is not None:
            if key not in self.store:
                raise RuntimeError("push before init on %r" % key)
            self.update_host(key, merged, self.store[key])
        else:
            # no optimizer installed: store the aggregate
            # (ref: merged.CopyTo(stored))
            self.store[key] = np.asarray(merged,
                                         dtype=_agg_dtype(np.asarray(merged)))

    def update_host(self, key, grad, stored):
        """Run the ``Updater`` on host tensors that share ``stored``'s
        memory (in place)."""
        import torch

        from .context import Context
        from .ndarray import NDArray

        cpu = Context("cpu")
        g = NDArray.from_raw(torch.from_numpy(
            np.ascontiguousarray(grad)), cpu)
        host = torch.from_numpy(stored)
        w = NDArray.from_raw(host, cpu)
        self.updater(int(key) if str(key).isdigit() else key, g, w)
        if w._data.data_ptr() != host.data_ptr():
            # the update swapped in a new tensor: write it back
            stored[...] = w._data.detach().numpy()

    def _handle_pull(self, msg):
        """Sync mode: a worker's pull blocks until every push it made has
        been folded into an applied round (ref: the timestamped ZPush /
        ZPull ordering: a pull after a push sees the round's update)."""
        import time as _time

        from . import env as _env

        key = msg["key"]
        w = msg.get("worker")
        with self.lock:
            st = self.state.setdefault(key, _KeyState())
            if self.sync_mode and w is not None:
                want = st.pushed_by.get(int(w), 0)
                # an overall deadline that resets whenever a round
                # applies: a slow peer between pushes is progress
                window = _env.get_float("MXNET_KVSTORE_SYNC_TIMEOUT")
                last_applied = st.applied
                deadline = _time.monotonic() + window
                while st.applied < want:
                    self.lock.wait(timeout=1.0)
                    if st.applied != last_applied:
                        last_applied = st.applied
                        deadline = _time.monotonic() + window
                    elif _time.monotonic() > deadline:
                        raise RuntimeError(
                            "sync pull timed out after %.0fs without "
                            "progress: key %r waits for round %d, applied "
                            "%d (did every worker push?)"
                            % (window, key, want, st.applied))
            if key not in self.store:
                raise RuntimeError("pull before init on %r" % key)
            # async: a later push updates the array in place while this
            # reply is sent — send a copy
            return self.store[key] if self.sync_mode \
                else self.store[key].copy()


def run_scheduler():
    _, port, ns, nw = _ps.env_cluster()
    _ps.Scheduler(port, ns, nw).run()


def run_server(controller=None):
    KVStoreServer(controller=controller).run()


def init(controller=None):
    """Role-based bootstrap: runs the node loop and exits in the
    scheduler and server roles, returns at once for workers (ref:
    kvstore_server.py:28-73).  ``controller(head, body)`` receives the
    workers' generic commands (the MXKVStoreRunServer server_controller
    contract)."""
    role = _ps.env_role()
    if role == "scheduler":
        run_scheduler()
        raise SystemExit(0)
    if role == "server":
        run_server(controller=controller)
        raise SystemExit(0)


if __name__ == "__main__":
    init()
