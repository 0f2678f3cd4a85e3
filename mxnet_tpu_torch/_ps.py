"""Parameter-server transport and cluster bootstrap.

Counterpart: ``mxnet_tpu/_ps.py``, whole (ref: the ps-lite layer the
reference builds kvstore_dist on, src/kvstore/kvstore_dist.h:54-58, and
the DMLC_ROLE / DMLC_PS_ROOT_URI bootstrap of include/mxnet/kvstore.h:
254-306).  The gradient exchange of a train step rides NCCL
(``parallel``); this module is the host-side parameter server that
``dist_sync`` / ``dist_async`` / ``dist_device_sync`` use: key/value
traffic between processes over TCP, with the scheduler assigning ranks,
running barriers and tracking node liveness the way ps-lite's
Postoffice does (GetDeadNodes, kvstore_dist.h:113-121).

Protocol: length-prefixed pickled dicts over TCP.  When
``MXNET_PS_SECRET`` is set, every frame carries an HMAC-SHA256 tag over
the payload and unauthenticated frames are rejected, so pickle is only
ever loaded from peers holding the shared secret.  Sockets bind to the
interface implied by ``DMLC_PS_ROOT_URI`` (loopback launches never
listen on external interfaces).  The frames carry numpy arrays: a
worker moves a device value to the host before it sends it.

Roles from env:
  DMLC_ROLE           scheduler | server | worker
  DMLC_PS_ROOT_URI    scheduler host
  DMLC_PS_ROOT_PORT   scheduler port
  DMLC_NUM_SERVER     server count
  DMLC_NUM_WORKER     worker count
  MXNET_PS_SECRET     optional shared secret authenticating frames
  MXNET_PS_REQUEST_TIMEOUT   per-request socket timeout, seconds
  MXNET_PS_HEARTBEAT_INTERVAL  node heartbeat period, seconds
"""
from __future__ import annotations

import hashlib
import hmac as _hmac
import os
import pickle
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

_LEN = struct.Struct("<Q")
_TAG_LEN = hashlib.sha256().digest_size


def _secret() -> Optional[bytes]:
    from . import env as _env

    s = _env.get_str("MXNET_PS_SECRET")
    return s.encode() if s else None


def request_timeout() -> float:
    # default exceeds the server's sync-pull grace window (600s,
    # MXNET_KVSTORE_SYNC_TIMEOUT) so a straggler the server tolerates is
    # not aborted client-side first
    from . import env as _env

    return _env.get_float("MXNET_PS_REQUEST_TIMEOUT")


def heartbeat_interval() -> float:
    from . import env as _env

    return _env.get_float("MXNET_PS_HEARTBEAT_INTERVAL")


def retry_max() -> int:
    from . import env as _env

    return max(_env.get_int("MXNET_PS_RETRY_MAX"), 0)


def retry_backoff_s() -> float:
    from . import env as _env

    return max(_env.get_float("MXNET_PS_RETRY_BACKOFF_S"), 0.0)


def backoff_delays(attempts: int) -> List[float]:
    """Exponential backoff with +-50% jitter: base * 2^i, jittered, one
    delay per retry attempt.  Jitter keeps a fleet of workers that all
    saw the same server blip from resending in lockstep (the
    thundering-herd ps-lite avoids with its own resend timers)."""
    import random as _random

    base = retry_backoff_s()
    return [base * (2 ** i) * (0.5 + _random.random())
            for i in range(attempts)]


def bind_host() -> str:
    """The interface servers/scheduler listen on: loopback for loopback
    clusters, all interfaces only when the cluster spans hosts.

    Listening beyond loopback without frame authentication would hand
    pickle.loads to any peer that can reach the port, so a multi-host
    bind REQUIRES ``MXNET_PS_SECRET`` — the secure configuration is the
    default, not opt-in."""
    root = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
    if root in ("127.0.0.1", "localhost"):
        return "127.0.0.1"
    if _secret() is None:
        raise RuntimeError(
            "refusing to listen on a non-loopback interface "
            "(DMLC_PS_ROOT_URI=%s) without MXNET_PS_SECRET: frames are "
            "pickled, and unauthenticated pickle from the network is "
            "arbitrary code execution.  Generate a shared secret (e.g. "
            "`openssl rand -hex 16`) and export MXNET_PS_SECRET with "
            "the same value on every node before launching." % root)
    return "0.0.0.0"


def send_msg(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    key = _secret()
    tag = _hmac.new(key, payload, hashlib.sha256).digest() if key else b""
    sock.sendall(_LEN.pack(len(payload)) + tag + payload)


def recv_msg(sock: socket.socket) -> Any:
    hdr = _recv_exact(sock, _LEN.size)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    key = _secret()
    tag = b""
    if key:
        tag = _recv_exact(sock, _TAG_LEN)
        if tag is None:
            return None
    body = _recv_exact(sock, n)
    if body is None:
        return None
    if key:
        want = _hmac.new(key, body, hashlib.sha256).digest()
        if not _hmac.compare_digest(tag, want):
            raise ConnectionError(
                "rejected PS frame with bad authentication tag")
    return pickle.loads(body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def env_role() -> Optional[str]:
    return os.environ.get("DMLC_ROLE")


def env_cluster() -> Tuple[str, int, int, int]:
    return (os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"),
            int(os.environ.get("DMLC_PS_ROOT_PORT", "9091")),
            int(os.environ.get("DMLC_NUM_SERVER", "1")),
            int(os.environ.get("DMLC_NUM_WORKER", "1")))


class Scheduler:
    """Rendezvous + barrier + liveness service (the Postoffice scheduler
    role).

    Servers register with their listen address; workers register and
    receive the full server table + their rank.  Every node heartbeats
    on a side connection; ``dead_nodes`` reports nodes whose last beat
    is older than the caller's timeout — the reference's
    ``ps::Postoffice::GetDeadNodes`` (kvstore_dist.h:113-121).  A node
    re-registering with its previous rank (``recovery``) gets its slot
    back without shifting rank assignment — the ``is_recovery`` rejoin
    path.  Runs until every non-recovered node sends ``finalize``."""

    def __init__(self, port: int, num_servers: int, num_workers: int):
        self.num_servers = num_servers
        self.num_workers = num_workers
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((bind_host(), port))
        self.sock.listen(128)
        self.lock = threading.Condition()
        self.servers: List[Tuple[str, int]] = []
        self.worker_ranks = 0
        # per-generation set of arrived worker ranks: a rank arriving
        # twice (crash + recovery replay) cannot double-count
        self.barrier_ranks: Dict[int, set] = {}
        self.barrier_gen: Dict[int, int] = {}
        self.heartbeats: Dict[Tuple[str, int], float] = {}
        self.done = 0

    def run(self):
        threads = []
        total = self.num_servers + self.num_workers
        self.sock.settimeout(0.2)
        while True:
            with self.lock:
                if self.done >= total:
                    break
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=5)
        self.sock.close()

    def _serve(self, conn):
        try:
            while True:
                msg = recv_msg(conn)
                if msg is None:
                    return
                op = msg["op"]
                if op == "register_server":
                    with self.lock:
                        if msg.get("recovery") is not None:
                            rank = int(msg["recovery"])
                            while len(self.servers) <= rank:
                                self.servers.append(None)
                            self.servers[rank] = tuple(msg["addr"])
                        else:
                            rank = len(self.servers)
                            self.servers.append(tuple(msg["addr"]))
                        self.heartbeats[("server", rank)] = time.time()
                        self.lock.notify_all()
                    send_msg(conn, {"rank": rank})
                elif op == "register_worker":
                    with self.lock:
                        # every server slot must be filled with a real
                        # address (a recovering server may fill a later
                        # slot before earlier ones re-register)
                        while (len(self.servers) < self.num_servers or
                               any(s is None for s in self.servers)):
                            self.lock.wait()
                        if msg.get("recovery") is not None:
                            # rejoin with the previous rank: rank table
                            # unchanged; the response carries the barrier
                            # generation so the rejoiner can skip exactly
                            # the startup barriers the cohort already
                            # passed, then participate normally
                            rank = int(msg["recovery"])
                        else:
                            rank = self.worker_ranks
                            self.worker_ranks += 1
                        self.heartbeats[("worker", rank)] = time.time()
                        gen = self.barrier_gen.get(0, 0)
                    send_msg(conn, {"rank": rank,
                                    "servers": list(self.servers),
                                    "barrier_gen": gen})
                elif op == "barrier":
                    gid = msg.get("group", 0)
                    rank = msg.get("rank")
                    with self.lock:
                        gen = self.barrier_gen.setdefault(gid, 0)
                        arrived = self.barrier_ranks.setdefault(gid, set())
                        # anonymous callers get a synthetic id; ranked
                        # callers dedupe across crash/recovery replays
                        arrived.add(rank if rank is not None
                                    else object())
                        if len(arrived) >= self.num_workers:
                            arrived.clear()
                            self.barrier_gen[gid] = gen + 1
                            self.lock.notify_all()
                        else:
                            while self.barrier_gen[gid] == gen:
                                self.lock.wait()
                    send_msg(conn, {"ok": True})
                elif op == "heartbeat":
                    with self.lock:
                        self.heartbeats[(msg["role"], int(msg["rank"]))] = \
                            time.time()
                    send_msg(conn, {"ok": True})
                elif op == "dead_nodes":
                    timeout = float(msg.get("timeout", 60.0))
                    now = time.time()
                    with self.lock:
                        dead = sorted(
                            ["%s:%d" % node
                             for node, ts in self.heartbeats.items()
                             if now - ts > timeout])
                    send_msg(conn, {"dead": dead})
                elif op == "finalize":
                    with self.lock:
                        self.done += 1
                        # a cleanly-exited node must not be reported
                        # dead by later dead_nodes queries
                        if "role" in msg:
                            self.heartbeats.pop(
                                (msg["role"], int(msg.get("rank", -1))),
                                None)
                        self.lock.notify_all()
                    send_msg(conn, {"ok": True})
                    return
        except ConnectionError:
            pass
        finally:
            conn.close()


class Client:
    """One TCP connection with request/response framing + a lock so
    multiple frontend threads can share it.  Requests carry a socket
    timeout (MXNET_PS_REQUEST_TIMEOUT): a hung peer surfaces as a
    ConnectionError instead of blocking the worker forever — the
    failure-detection contract kvstore_dist.h gets from ps-lite
    timeouts."""

    def __init__(self, addr: Tuple[str, int],
                 timeout: Optional[float] = None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.connect(tuple(addr))
        self.addr = tuple(addr)
        self.timeout = timeout
        self.broken = False
        self.lock = threading.Lock()

    def _chaos_fault(self, msg: Any) -> None:
        """Fault-injection point for the chaos harness: a 'drop_push'
        rule matching this push's (rank, key) simulates a network loss
        — mode=request loses the request before it is sent,
        mode=response (default, the hard case) delivers the request but
        loses the reply, so the caller's retry RESENDS and the server
        must dedupe the duplicate via pseq.  'drop_sparse_pull' is the
        same fault against a pull_rows exchange: the read is
        side-effect-free server-side, so the retry just re-reads — the
        invariant is that training stays bitwise identical."""
        from . import chaos as _chaos

        if not isinstance(msg, dict):
            return
        kind = {"push": "drop_push",
                "pull_rows": "drop_sparse_pull"}.get(msg.get("op"))
        if kind is None:
            return
        rule = _chaos.fault(kind, rank=msg.get("worker"),
                            key=msg.get("key"))
        if rule is None:
            return
        mode = str(rule.params.get("mode", "response"))
        if mode != "request":
            send_msg(self.sock, msg)  # the server DID get this request
        self.broken = True
        raise ConnectionError(
            "chaos: dropped %s %s for key %r (rank %s)"
            % (msg.get("op"), mode, msg.get("key"), msg.get("worker")))

    def request(self, msg: Any, timeout: Optional[float] = None) -> Any:
        t = timeout if timeout is not None else (
            self.timeout if self.timeout is not None else request_timeout())
        with self.lock:
            if self.broken:
                raise ConnectionError(
                    "connection to %s:%d was aborted after an earlier "
                    "failure (timeout, authentication rejection, or "
                    "interrupted exchange)" % self.addr)
            try:
                self.sock.settimeout(t)
                from . import chaos as _chaos

                if _chaos.enabled():
                    self._chaos_fault(msg)
                send_msg(self.sock, msg)
                return recv_msg(self.sock)
            except socket.timeout:
                # the peer's late response would desync request/response
                # pairing — this connection is unusable from here on
                self.broken = True
                raise ConnectionError(
                    "no response from %s:%d within %.0fs for %r (peer "
                    "dead or hung)" % (self.addr[0], self.addr[1], t,
                                       msg.get("op")))
            except BaseException:
                # ANY mid-exchange failure (HMAC rejection, partial
                # write, interrupt) leaves the stream position unknown:
                # a later request could pair with this exchange's reply
                self.broken = True
                raise
            finally:
                if self.broken:
                    try:
                        self.sock.close()
                    except OSError:
                        pass
                else:
                    try:
                        self.sock.settimeout(None)
                    except OSError:
                        pass

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class Heartbeat:
    """Background liveness beacon + dead-peer detector: a daemon thread
    on its own scheduler connection (barriers block the main connection,
    so heartbeats ride a side channel).

    Each beat also asks the scheduler for peers whose heartbeat has
    aged out (``dead_nodes``, the ps::Postoffice::GetDeadNodes role) and
    feeds the answer to ``diagnostics.set_dead_peers`` and the
    ``mxnet_ps_dead_peers`` gauge.  A peer is
    declared dead after missing ~3 beats (``3 x
    MXNET_PS_HEARTBEAT_INTERVAL``, floor 1s)."""

    def __init__(self, role: str, rank: int):
        self.role, self.rank = role, rank
        self.dead: List[str] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        interval = heartbeat_interval()
        dead_after = max(3.0 * interval, 1.0)
        client = None
        while not self._stop.wait(interval):
            if self.role == "worker":
                # the elastic supervisor's liveness file rides the same
                # beacon: a worker stuck in a collective still beats
                # here, so only a truly wedged PROCESS goes stale.
                # Workers only — a server/scheduler touching the
                # rank-0 file would mask a hung worker 0.
                try:
                    from . import diagnostics as _diag

                    _diag.touch_heartbeat()
                except Exception:
                    pass
            try:
                if client is None:
                    client = connect_scheduler(retries=1)
                client.request({"op": "heartbeat", "role": self.role,
                                "rank": self.rank}, timeout=interval)
                resp = client.request({"op": "dead_nodes",
                                       "timeout": dead_after},
                                      timeout=interval)
                dead = sorted(resp.get("dead", [])) if resp else []
                me = "%s:%d" % (self.role, self.rank)
                dead = [d for d in dead if d != me]
                if dead != self.dead:
                    self.dead = dead
                    self._publish(dead)
            except (OSError, ConnectionError):
                if client is not None:
                    client.close()
                client = None
        if client is not None:
            client.close()

    def _publish(self, dead: List[str]) -> None:
        try:
            from . import diagnostics as _diag

            _diag.set_dead_peers(dead)
            # unconditional, including 0: a recovered peer must clear
            # the gauge, or alerts see a dead peer in a healthy fleet
            _diag.metrics.gauge(
                "mxnet_ps_dead_peers",
                help="peers whose scheduler heartbeat aged out"
            ).set(len(dead))
        except Exception:
            pass  # liveness telemetry must never kill the beacon

    def stop(self):
        self._stop.set()


def connect_scheduler(retries: int = 200, delay: float = 0.05) -> Client:
    host, port, _, _ = env_cluster()
    last = None
    for _ in range(retries):
        try:
            return Client((host, port))
        except OSError as e:
            last = e
            time.sleep(delay)
    raise ConnectionError("cannot reach scheduler at %s:%d: %s"
                          % (host, port, last))
