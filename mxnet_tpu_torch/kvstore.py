"""KVStore: ``local``, ``device``, ``tpu``, ``nccl`` in one process, and
the parameter server's ``dist_sync`` / ``dist_async`` /
``dist_device_sync``.

Counterpart: ``mxnet_tpu/kvstore.py`` ``KVStore`` (:153-452; ref:
include/mxnet/kvstore.h, src/kvstore/kvstore_local.h), ``KVStoreDist``
(:578-1178) and ``create`` (:1180-1203).  ``push`` sums the values
pushed for a key, ``pull`` copies the stored value out, and
``set_optimizer`` moves the update into the store (update_on_kvstore),
with the optimizer's states saved in the JAX package's format.
``rank`` / ``num_workers`` follow the rank contract (kvstore.h:254-306):
after ``dist.initialize()`` they are the process group's.  ``tpu`` and
``nccl`` are the base store under their names: the JAX package's
``KVStoreTPU`` merges a multi-key push one bucket at a time, which
computes the same sums as the per-key push; the port keeps the per-key
sum until a workload that pushes several values a key is timed on the
card (the gradient exchange of a multi-context ``Module`` runs in
``parallel.dp.DataParallelRunner``, not in the store).

The ``dist_*`` kinds under the parameter-server launcher
(``python -m mxnet_tpu_torch.launch -n W -s S cmd...``, the DMLC_* env)
are :class:`KVStoreDist`, a worker of servers that keep the keys in host
memory (``kvstore_server``, ``_ps``); without that env they are the
one-process store, rank 0 of 1.  On the card a push moves each key's
value to the host once, through a pinned buffer the key reuses
(``dist_device_sync`` first sums a key's values on the card,
``dist_sync`` on the host); with 2-bit compression the codes and the
residual are computed on the card and only the codes cross PCIe; a pull
writes into the device array in place.  Every verb feeds
``mxnet_kvstore_bytes_total{op=push|pull|allreduce}``.

Row-sparse storage (``ndarray.sparse``): several row-sparse values
pushed for a key merge into one row-sparse sum (ref: comm.h
ReduceRowSparse), an updater receives it and its lazy update touches
only those rows; ``row_sparse_pull`` gathers only the requested unique
rows, on the store's device in process (ref: kvstore_local.h
PullRowSparseImpl) or from the servers (``pull_rows``).  Such pushes and
pulls count under ``op=row_sparse_push`` / ``op=row_sparse_pull``:
unique rows x (row payload + 8 bytes of row id), or the row ids and the
2-bit codes of the values under compression.  While the profiler runs,
each verb stamps the JAX package's comms span (``KVStore::Push`` /
``Pull`` / ``AllReduce`` / ``PullRowSparse``, with its bytes and store
type) and cumulative ``kvstore:{push,pull,allreduce,row_sparse_pull}
_bytes`` counter, and a dist store pins the profiler's rank to the one
the scheduler assigned.  The SDC vote's exchanges raise (ROADMAP A11b);
the verbs' flight-recorder entries come with the flight recorder
(A11b).
"""
from __future__ import annotations

import contextlib
import logging
import os
import pickle
from typing import Any, Callable, Dict, List, Optional

import numpy as _np
import torch

from . import profiler as _profiler
from .base import MXNetError, torch_dtype
from .ndarray import NDArray
from . import optimizer as _opt

__all__ = ["KVStore", "KVStoreDist", "PSConnectionLost", "create"]

_log = logging.getLogger(__name__)

_VALID = {"local", "device", "tpu", "nccl", "dist_sync", "dist_async",
          "dist_device_sync", "dist"}


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _int_key(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def _payload_nbytes(value) -> int:
    """The bytes of a push / pull payload: NDArrays or nested lists of
    them (a row-sparse array: its rows and their int64 ids)."""
    from .ndarray import sparse as _sp

    if value is None:
        return 0
    if isinstance(value, (list, tuple)):
        return sum(_payload_nbytes(v) for v in value)
    if isinstance(value, _sp.RowSparseNDArray):
        p = value._parts()
        return sum(t.numel() * t.element_size()
                   for t in (p["data"], p["indices"]))
    if isinstance(value, NDArray):
        return value._data.numel() * value._data.element_size()
    return 0


def _all_row_sparse(value) -> bool:
    """Every leaf of a push payload is row-sparse: the push counts under
    ``op=row_sparse_push``."""
    from .ndarray import sparse as _sp

    if isinstance(value, _sp.RowSparseNDArray):
        return True
    if isinstance(value, (list, tuple)) and value:
        return all(_all_row_sparse(v) for v in value)
    return False


def _unique_rows(rid) -> _np.ndarray:
    """The sorted unique int64 row ids of a ``row_ids`` argument (the
    host holds them: they are the request's metadata)."""
    if isinstance(rid, NDArray):
        rid = rid.asnumpy()
    return _np.unique(_np.asarray(rid).astype(_np.int64).ravel())


def _row_ids_per_key(keys, row_ids):
    rids = _as_list(row_ids)
    if len(rids) == 1 and len(keys) > 1:
        rids = rids * len(keys)
    return [_unique_rows(r) for r in rids]


def _rsp_pull_wire_nbytes(outs, rows_per_key) -> int:
    """The bytes of one row_sparse_pull: per key, the unique requested
    rows x (row payload + 8-byte row id), whatever the table's size."""
    total = 0
    for olist, rows in zip(outs, rows_per_key):
        o = _as_list(olist)[0]
        row_elems = 1
        for d in o.shape[1:]:
            row_elems *= int(d)
        itemsize = torch_dtype(o.dtype).itemsize
        total += int(rows.size) * (row_elems * itemsize + 8)
    return total


def _merge_values(vs):
    """The sum of one key's pushed values: row-sparse values stay
    row-sparse (ref: comm.h ReduceRowSparse), others add densely."""
    from .ndarray import sparse as _sp

    if all(isinstance(v, _sp.RowSparseNDArray) for v in vs):
        merged = vs[0]
        for v in vs[1:]:
            merged = _sp.add(merged, v)
        return merged
    acc = vs[0]._data
    for v in vs[1:]:
        acc = acc + v._data.to(acc.device)
    return NDArray.from_raw(acc, vs[0].context)


def _feed_bytes(op: str, nbytes: int) -> None:
    from . import diagnostics as _diag

    _diag.feed_kvstore_bytes(op, nbytes)


def _comms_span(prof: bool, name: str, args: dict):
    """The profiler span of one verb, or a no-op context when no
    profiling session runs (each verb's _do_* call stays at one
    site)."""
    if not prof:
        return contextlib.nullcontext()
    return _profiler.span(name, cat="comms", args=args)


def _key_value(key, value):
    """Parallel lists of keys and values; a value is an NDArray or a
    per-device list of them (ref: kvstore_local.h GroupKVPairs)."""
    if isinstance(key, (list, tuple)):
        return list(key), list(value)
    return [key], [value]


class KVStore:
    """ref: python/mxnet/kvstore.py KVStore."""

    def __init__(self, kind: str):
        self._kind = kind
        self._store: Dict[Any, NDArray] = {}
        self._updater: Optional[Callable] = None
        self._opt_updater: Optional[_opt.Updater] = None
        self._pending: Dict[Any, NDArray] = {}

    @property
    def type(self) -> str:
        return self._kind

    @property
    def rank(self) -> int:
        from . import dist

        return dist.rank()

    @property
    def num_workers(self) -> int:
        from . import dist

        return dist.num_processes()

    # -- core API (ref: include/mxnet/kvstore.h Init/Push/Pull) --------
    def init(self, key, value) -> None:
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            self._store[k] = v.copy()

    def push(self, key, value, priority: int = 0) -> None:
        """Sum every value pushed for a key (ref: kvstore_local.h Push ->
        Comm::Reduce); with an updater, apply it to the stored value.
        An all-row-sparse push counts under ``op=row_sparse_push``."""
        op = "row_sparse_push" if _all_row_sparse(value) else "push"
        nbytes = self._push_wire_nbytes(key, value)
        prof = _profiler.is_running()
        with _comms_span(prof, "KVStore::Push",
                         {"bytes": nbytes, "type": self._kind}):
            self._do_push(key, value, priority)
        if prof:
            _profiler.record_bytes("kvstore:push_bytes", nbytes)
        _feed_bytes(op, nbytes)

    def _push_wire_nbytes(self, key, value) -> int:
        """The bytes one push puts on the wire (the payload; the dist
        store counts 2-bit codes where it compresses)."""
        return _payload_nbytes(value)

    def pull(self, key, out=None, priority: int = 0,
             ignore_sparse: bool = True) -> None:
        nbytes = _payload_nbytes(out)
        prof = _profiler.is_running()
        with _comms_span(prof, "KVStore::Pull",
                         {"bytes": nbytes, "type": self._kind}):
            self._do_pull(key, out, priority, ignore_sparse)
        if prof:
            _profiler.record_bytes("kvstore:pull_bytes", nbytes)
        _feed_bytes("pull", nbytes)

    def pushpull(self, key, value, out=None, priority: int = 0) -> None:
        """The allreduce verb: push, then pull into ``out`` (or back into
        ``value``)."""
        nbytes = _payload_nbytes(value)
        prof = _profiler.is_running()
        with _comms_span(prof, "KVStore::AllReduce",
                         {"bytes": nbytes, "type": self._kind}):
            self._do_push(key, value, priority)
            self._do_pull(key, out if out is not None else value,
                          priority, True)
        if prof:
            _profiler.record_bytes("kvstore:allreduce_bytes", nbytes)
        _feed_bytes("allreduce", nbytes)

    def _do_push(self, key, value, priority: int = 0) -> None:
        keys, values = _key_value(key, value)
        for k, vlist in zip(keys, values):
            vs = _as_list(vlist)
            merged = _merge_values(vs) if len(vs) > 1 else vs[0]
            if self._updater is not None:
                if k not in self._store:
                    raise MXNetError("push before init on key %r" % k)
                self._updater(_int_key(k), merged, self._store[k])
            else:
                self._pending[k] = merged

    def _do_pull(self, key, out=None, priority: int = 0,
                 ignore_sparse: bool = True) -> None:
        keys, outs = _key_value(key, out)
        for k, olist in zip(keys, outs):
            if self._updater is not None or k not in self._pending:
                src = self._store.get(k)
                if src is None:
                    src = self._pending.get(k)
            else:
                src = self._pending[k]
            if src is None:
                raise MXNetError("pull on uninitialised key %r" % k)
            for o in _as_list(olist):
                src.copyto(o)

    def row_sparse_pull(self, key, out=None, priority=0,
                        row_ids=None) -> None:
        """Pull only the rows named in ``row_ids`` (deduplicated) into
        ``out``: a RowSparseNDArray holding those rows, or a dense array
        holding them and zeros elsewhere (ref: kvstore_dist.h:258
        PullRowSparseImpl)."""
        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids (matches "
                             "reference)")
        if out is None:
            raise MXNetError("row_sparse_pull requires out (matches "
                             "reference)")
        keys, outs = _key_value(key, out)
        rows = _row_ids_per_key(keys, row_ids)
        nbytes = _rsp_pull_wire_nbytes(outs, rows)
        prof = _profiler.is_running()
        with _comms_span(prof, "KVStore::PullRowSparse",
                         {"bytes": nbytes, "type": self._kind}):
            self._do_row_sparse_pull(keys, outs, rows)
        if prof:
            _profiler.record_bytes("kvstore:row_sparse_pull_bytes",
                                   nbytes)
        _feed_bytes("row_sparse_pull", nbytes)

    def _do_row_sparse_pull(self, keys, outs, rows_per_key) -> None:
        """In process: a gather of the requested rows on the stored
        value's device; the full table never moves."""
        for k, olist, rows in zip(keys, outs, rows_per_key):
            # the source pull() would read: a pending push wins when no
            # updater is installed
            if self._updater is not None or k not in self._pending:
                src = self._store.get(k, self._pending.get(k))
            else:
                src = self._pending[k]
            if src is None:
                raise MXNetError("pull on uninitialised key %r" % k)
            idx = torch.from_numpy(rows).to(src._data.device)
            _deliver_rows(olist, src.shape, src._data.detach().index_select(
                0, idx), idx)

    def set_gradient_compression(self, compression_params) -> None:
        """Validate the params (an invalid type or threshold raises for
        every kind), then refuse for in-process stores, which put no
        bytes on a wire.  The launcher-less ``dist_*`` store (one
        process, no wire) warns and ignores them, so launcher scripts
        still run."""
        from .gradient_compression import GradientCompression

        params = dict(compression_params or {})
        GradientCompression(type=params.get("type", "2bit"),
                            threshold=float(params.get("threshold", 0.5)))
        if "dist" not in self._kind:
            raise MXNetError(
                "gradient compression is not supported for %r kvstore: "
                "only dist stores compress pushes on the wire.  Create a "
                "dist_sync/dist_async store under the PS launcher "
                "(python -m mxnet_tpu_torch.launch) to compress."
                % self._kind)
        _log.warning("set_gradient_compression on a launcher-less %r "
                     "store: one process, no wire — params validated and "
                     "ignored", self._kind)

    # -- updater / optimizer (ref: kvstore.h set_updater) --------------
    def set_updater(self, updater: Callable) -> None:
        self._updater = updater

    def set_optimizer(self, optimizer: _opt.Optimizer) -> None:
        """ref: python/mxnet/kvstore.py set_optimizer: in process, an
        ``Updater`` over the stored values."""
        self._opt_updater = _opt.get_updater(optimizer)
        self._updater = self._opt_updater

    def barrier(self) -> None:
        pass  # one process

    def send_command_to_servers(self, head: int, body: str) -> None:
        pass

    def get_optimizer_states_bytes(self, dump_optimizer: bool = False
                                   ) -> bytes:
        if self._opt_updater is None:
            raise MXNetError("no optimizer state to save")
        return self._opt_updater.get_states(dump_optimizer)

    def set_optimizer_states_bytes(self, states: bytes) -> None:
        if self._opt_updater is None:
            raise MXNetError("set_optimizer before loading states")
        self._opt_updater.set_states(states)

    def save_optimizer_states(self, fname: str,
                              dump_optimizer: bool = False) -> None:
        with open(fname, "wb") as f:
            f.write(self.get_optimizer_states_bytes(dump_optimizer))

    def load_optimizer_states(self, fname: str) -> None:
        with open(fname, "rb") as f:
            self.set_optimizer_states_bytes(f.read())


def _deliver_rows(olist, shape, data: torch.Tensor,
                  rows: torch.Tensor) -> None:
    """Write pulled ``rows`` of a ``shape`` table into each out: a
    RowSparseNDArray takes them as its parts (on its own device, in its
    dtype), a dense out takes them densified."""
    from .ndarray import sparse as _sp

    for o in _as_list(olist):
        if isinstance(o, _sp.RowSparseNDArray):
            dev = o._parts()["data"].device
            o._sp_shape = tuple(shape)
            o._sp_parts = {"data": data.to(dev, o._sp_dtype, copy=True),
                           "indices": rows.to(dev, copy=True)}
            o._dense_cache = None
        else:
            dense = torch.zeros(tuple(shape), dtype=o._data.dtype,
                                device=o._data.device)
            dense[rows.to(dense.device)] = data.to(dense.device, dense.dtype)
            o._set_data(dense)


class PSConnectionLost(MXNetError, ConnectionError):
    """A PS peer vanished mid-exchange: an ``MXNetError`` (the API's
    error) and a ``ConnectionError`` (the retry layer's transport
    failure)."""


class KVStoreDist(KVStore):
    """A parameter-server worker (ref: src/kvstore/kvstore_dist.h:49
    KVStoreDist; counterpart ``mxnet_tpu/kvstore.py:578-1178``).

    Keys shard over the servers by crc32 (the EncodeDefaultKey analogue,
    kvstore_dist.h:229).  ``dist_sync`` / ``dist_device_sync``: the
    servers aggregate a key until every worker pushed, then apply the
    server-side optimizer; a worker's pull after its push waits for that
    round.  ``dist_async``: every push applies at once
    (kvstore_dist_server.h:266).  A request lost to the transport is
    resent (``MXNET_PS_RETRY_MAX``, backoff ``MXNET_PS_RETRY_BACKOFF_S``)
    over a fresh connection, and the server drops a resent push by its
    sequence number."""

    def __init__(self, kind: str):
        super().__init__(kind)
        import threading

        from . import _ps

        self._ps = _ps
        self._sync = "async" not in kind
        self._device_merge = kind == "dist_device_sync"
        self._recovery = bool(os.environ.get("DMLC_PS_IS_RECOVERY"))
        sched = _ps.connect_scheduler()
        reg = {"op": "register_worker"}
        if self._recovery:
            # is_recovery rejoin (ref: kvstore_dist.h:56): reclaim the
            # previous rank; the startup barriers the cohort passed are
            # skipped
            reg["recovery"] = int(os.environ.get("DMLC_WORKER_ID", "0"))
        resp = sched.request(reg)
        self._rank = resp["rank"]
        # per-rank trace dumps (profile_rank{K}.json, pid=rank) key off
        # the scheduler-assigned rank, not the launcher env
        _profiler.set_rank(self._rank, _ps.env_cluster()[3])
        self._barrier_skip = resp.get("barrier_gen", 0) \
            if self._recovery else 0
        self._server_addrs = [tuple(a) for a in resp["servers"]]
        self._server_clients = [_ps.Client(a) for a in self._server_addrs]
        self._reconnect_lock = threading.Lock()
        # a per-key push sequence rides every push, so a resent push is
        # dropped by the server instead of counted twice
        self._pseq: Dict[Any, int] = {}
        self._pseq_lock = threading.Lock()
        # pinned host buffers, one a key, reused by every push
        self._pinned: Dict[Any, Any] = {}
        self._sched = sched
        self._nw = _ps.env_cluster()[3]
        self._gc = None
        self._closed = False
        if self._recovery:
            # re-seed the push counters from every server's high water
            for c in self._server_clients:
                resp = self._req(c, {"op": "worker_hello",
                                     "worker": self._rank,
                                     "recovery": True})
                for key, count in (resp.get("pseq") or {}).items():
                    self._pseq[key] = max(self._pseq.get(key, 0),
                                          int(count))
        self._heartbeat = _ps.Heartbeat("worker", self._rank)
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=16)
        if not self._sync:
            if self._rank == 0:
                for c in self._server_clients:
                    self._req(c, {"op": "set_sync", "sync": False})
            # every rank reaches this barrier once the servers switched
            self.barrier()
        from . import env as _env

        gc_type = _env.get_str("MXNET_GRADIENT_COMPRESSION")
        if gc_type:
            self.set_gradient_compression({
                "type": gc_type,
                "threshold": _env.get_float(
                    "MXNET_GRADIENT_COMPRESSION_THRESHOLD")})
        import atexit

        atexit.register(self.close)

    # -- identity ------------------------------------------------------
    @property
    def rank(self) -> int:
        return self._rank

    @property
    def num_workers(self) -> int:
        return self._nw

    def _server_idx(self, key) -> int:
        import zlib

        return zlib.crc32(str(key).encode()) % len(self._server_clients)

    @staticmethod
    def _req(client, msg):
        """One request and its error check (a failed server command is
        never swallowed)."""
        resp = client.request(msg)
        if resp is None:
            # EOF mid-exchange: the peer died
            client.broken = True
            try:
                client.sock.close()
            except OSError:
                pass
            raise PSConnectionLost("server connection lost during %r"
                                   % msg.get("op"))
        if resp.get("error") or resp.get("ok") is False:
            raise MXNetError("server rejected %r: %s"
                             % (msg.get("op"),
                                resp.get("error", "unknown error")))
        return resp

    # ops safe to resend after a transport failure: init is idempotent,
    # pulls (pull_rows too) are reads, pushes are deduped by pseq.
    # Control ops keep failing fast (a resent 'stop' could end a server
    # under its peers).
    _RETRY_OPS = frozenset(("init", "push", "pull", "pull_rows"))

    def _req_server(self, idx: int, msg):
        """A server request with bounded retry: on a transport failure
        back off with jitter, reconnect and resend; an error frame (the
        server is alive and said no) is not retried."""
        import time as _time

        op = msg.get("op")
        retries = self._ps.retry_max() if op in self._RETRY_OPS else 0
        delays = [0.0] + self._ps.backoff_delays(retries)
        last_exc = None
        for attempt, delay in enumerate(delays):
            if delay:
                _time.sleep(delay)
            try:
                client = self._server_clients[idx]
                if client.broken:
                    client = self._reconnect(idx)
                return self._req(client, msg)
            except (ConnectionError, OSError) as e:
                last_exc = e
                if attempt >= len(delays) - 1:
                    break
                from . import diagnostics as _diag

                _diag.metrics.counter(
                    "mxnet_ps_retries_total",
                    help="PS requests resent after transport failures",
                    labels={"op": str(op)}).inc()
                _log.warning("PS %r to server %d failed (%s) — retry %d/%d "
                             "after %.2fs backoff", op, idx, e, attempt + 1,
                             retries, delays[attempt + 1])
        raise MXNetError(
            "PS %r to server %d failed after %d attempt(s): %s"
            % (op, idx, len(delays), last_exc)) from last_exc

    def _reconnect(self, idx: int):
        """Replace a broken server connection (once, however many fan-out
        threads saw it break)."""
        with self._reconnect_lock:
            client = self._server_clients[idx]
            if not client.broken:
                return client
            client.close()
            fresh = self._ps.Client(self._server_addrs[idx])
            self._server_clients[idx] = fresh
            return fresh

    def _next_pseq(self, key) -> int:
        with self._pseq_lock:
            n = self._pseq.get(key, 0) + 1
            self._pseq[key] = n
            return n

    def _fanout(self, work):
        """Run per-key request thunks concurrently (keys shard over the
        servers, so their round trips overlap)."""
        if len(work) <= 1:
            return [w() for w in work]
        return list(self._pool.map(lambda w: w(), work))

    # -- host staging --------------------------------------------------
    def _host(self, key, t):
        """``t`` (a tensor) as a numpy array on the host: a card's tensor
        crosses once, into the key's pinned buffer (bfloat16 as
        float32)."""
        import torch

        t = t.detach()
        dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        if t.device.type == "cpu":
            return t.to(dtype).numpy()
        # one flat buffer a key, grown as needed: a row-sparse push's
        # row count changes from step to step
        buf = self._pinned.get(key)
        if buf is None or buf.numel() < t.numel() or buf.dtype != dtype:
            buf = torch.empty(t.numel(), dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        view = buf[:t.numel()].view(t.shape)
        view.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return view.numpy()

    def _merged(self, key, vlist):
        """One key's pushed values summed: on the card for
        ``dist_device_sync`` (one copy to the host after), on the host
        otherwise (each value crosses once); one value stays where it
        is."""
        vs = _as_list(vlist)
        if len(vs) == 1:
            return vs[0]._data
        if self._device_merge:
            acc = vs[0]._data
            for v in vs[1:]:
                acc = acc + v._data.to(acc.device)
            return acc
        acc = self._host(key, vs[0]._data).copy()
        for i, v in enumerate(vs[1:]):
            acc = acc + self._host((key, i), v._data)
        return acc

    # -- core API ------------------------------------------------------
    def init(self, key, value) -> None:
        keys, values = _key_value(key, value)
        self._fanout([
            (lambda k=k, v=v: self._req_server(
                self._server_idx(k),
                {"op": "init", "key": k,
                 "data": self._host(k, _as_list(v)[0]._data).copy()}))
            for k, v in zip(keys, values)])
        self.barrier()

    def _do_push(self, key, value, priority: int = 0) -> None:
        import torch

        keys, values = _key_value(key, value)

        def one(k, vlist):
            # pseq makes the push exactly-once under retry
            msg = {"op": "push", "key": k, "worker": self._rank,
                   "pseq": self._next_pseq(k)}
            if _all_row_sparse(vlist):
                # only the touched rows travel (ref: kvstore_dist.h:444
                # EncodeRowSparseKey), the ids exact beside the values
                # or their 2-bit codes (the residual follows each row)
                merged = _merge_values(_as_list(vlist))
                p = merged._parts()
                rows = p["indices"].cpu().numpy()
                msg.update(sparse=True, rows=rows, shape=tuple(merged.shape))
                if self._gc is not None and rows.size:
                    codes, _shape = self._gc.compress_rows(k, rows,
                                                           p["data"])
                    msg.update(compressed=True, data=codes)
                else:
                    msg["data"] = self._host(("rows", k), p["data"])
                self._req_server(self._server_idx(k), msg)
                return
            merged = self._merged(k, vlist)
            if self._gc is not None:
                codes, shape = self._gc.compress(k, merged)
                if isinstance(codes, torch.Tensor):
                    codes = self._host(("codes", k), codes).tobytes()
                msg.update(compressed=True, data=codes, shape=shape)
            else:
                msg["data"] = merged if isinstance(merged, _np.ndarray) \
                    else self._host(k, merged)
            self._req_server(self._server_idx(k), msg)

        self._fanout([
            (lambda k=k, v=v: one(k, v)) for k, v in zip(keys, values)])

    def _push_wire_nbytes(self, key, value) -> int:
        """The bytes a push puts on the wire, a key at a time: a
        row-sparse value's merged rows x (row payload + 8-byte id), or
        the ids and the values' 2-bit codes under compression
        (``rows_wire_nbytes``); a dense value's payload, or the 2-bit
        codes of one merged array (``ceil(n/4)`` bytes)."""
        from .gradient_compression import GradientCompression

        total = 0
        for vlist in _key_value(key, value)[1]:
            vs = _as_list(vlist)
            if _all_row_sparse(vs):
                n_rows = _np.unique(_np.concatenate(
                    [v._parts()["indices"].cpu().numpy() for v in vs])).size
                row_elems = int(_np.prod(vs[0].shape[1:]))
                if self._gc is not None and n_rows:
                    total += GradientCompression.rows_wire_nbytes(
                        n_rows, row_elems)
                else:
                    total += n_rows * (
                        row_elems * torch_dtype(vs[0].dtype).itemsize + 8)
            elif self._gc is None:
                total += _payload_nbytes(vlist)
            else:
                total += GradientCompression.wire_nbytes(
                    vs[0]._data.numel())
        return total

    def _do_pull(self, key, out=None, priority: int = 0,
                 ignore_sparse: bool = True) -> None:
        import torch

        keys, outs = _key_value(key, out)

        def one(k, olist):
            resp = self._req_server(self._server_idx(k),
                                    {"op": "pull", "key": k,
                                     "worker": self._rank})
            src = torch.from_numpy(_np.asarray(resp["data"]))
            for o in _as_list(olist):
                # in place: the device array is written, not replaced
                with torch.no_grad():
                    o._data.copy_(src.reshape(o._data.shape))
                o._bump_version()

        self._fanout([
            (lambda k=k, o=o: one(k, o)) for k, o in zip(keys, outs)])

    def _do_row_sparse_pull(self, keys, outs, rows_per_key) -> None:
        """Each key's unique requested rows from its server
        (``pull_rows``, ref: the row-sparse handler of
        kvstore_dist_server.h:223), the keys' requests fanned out."""

        def one(k, olist, rows):
            resp = self._req_server(self._server_idx(k),
                                    {"op": "pull_rows", "key": k,
                                     "rows": rows, "worker": self._rank})
            _deliver_rows(olist, _as_list(olist)[0].shape,
                          torch.from_numpy(_np.asarray(resp["data"])),
                          torch.from_numpy(_np.asarray(resp["rows"])))

        self._fanout([(lambda k=k, o=o, r=r: one(k, o, r))
                      for k, o, r in zip(keys, outs, rows_per_key)])

    # -- the optimizer travels to the servers --------------------------
    def set_optimizer(self, optimizer) -> None:
        """ref: kvstore.py set_optimizer: pickle the optimizer and send it
        over the servers' command channel (rank 0; every rank waits at
        the barrier)."""
        if self._rank == 0:
            payload = pickle.dumps(optimizer)
            for c in self._server_clients:
                self._req(c, {"op": "set_optimizer", "payload": payload})
        self.barrier()

    def send_command_to_servers(self, head: int, body: str) -> None:
        """A generic command to every server, received by its controller
        callback (ref: KVStore::SendCommandToServers)."""
        for c in self._server_clients:
            self._req(c, {"op": "command", "head": int(head),
                          "body": str(body)})

    def set_gradient_compression(self, compression_params) -> None:
        """Encode pushes on this worker (the residual is this worker's
        state, never pushed) and send the params to every server so its
        decode matches (ref: kvstore_dist.h SetGradientCompression)."""
        from .gradient_compression import GradientCompression

        params = dict(compression_params or {})
        self._gc = GradientCompression(
            type=params.get("type", "2bit"),
            threshold=float(params.get("threshold", 0.5)))
        if self._rank == 0:
            for c in self._server_clients:
                self._req(c, {"op": "set_compression",
                              "type": self._gc.type,
                              "threshold": self._gc.threshold})
        self.barrier()

    def get_optimizer_states_bytes(self, dump_optimizer: bool = False,
                                   timeout: Optional[float] = None
                                   ) -> bytes:
        """Every server shard's optimizer states (each holds its own
        keys'), gathered over fresh connections (never the fan-out
        clients, whose lock a hung request may hold)."""
        blobs = {}
        for i, addr in enumerate(self._server_addrs):
            c = self._ps.Client(addr, timeout=timeout)
            try:
                resp = self._req(c, {"op": "save_optimizer_states",
                                     "dump_optimizer": dump_optimizer})
                blobs[i] = resp["data"]
            finally:
                c.close()
        return pickle.dumps({"num_servers": len(blobs), "shards": blobs})

    def set_optimizer_states_bytes(self, states: bytes) -> None:
        payload = pickle.loads(states)
        if not (isinstance(payload, dict) and "shards" in payload
                and "num_servers" in payload):
            # a one-process updater blob: shard its keys as pushes are
            payload = self._reshard_local_states(payload)
        if payload["num_servers"] != len(self._server_clients):
            payload = self._reshard_merged_states(payload)
        for i, c in enumerate(self._server_clients):
            self._req(c, {"op": "load_optimizer_states",
                          "data": payload["shards"][i]})

    def _reshard_local_states(self, data) -> dict:
        """Flat updater states -> one blob a server, keys partitioned by
        the crc32 rule of the pushes."""
        optimizer = None
        if isinstance(data, tuple):
            data, optimizer = data
        n = len(self._server_clients)
        per: Dict[int, dict] = {i: {} for i in range(n)}
        for k, v in (data or {}).items():
            per[self._server_idx(k)][k] = v
        return {"num_servers": n, "shards": {
            i: pickle.dumps((per[i], optimizer) if optimizer is not None
                            else per[i]) for i in range(n)}}

    def _reshard_merged_states(self, payload) -> dict:
        """States saved under another server count: merged and
        partitioned again for this cluster."""
        merged: dict = {}
        optimizer = None
        for blob in payload["shards"].values():
            if not blob:
                continue
            sub = pickle.loads(blob)
            if isinstance(sub, tuple):
                sub, optimizer = sub
            merged.update(sub)
        return self._reshard_local_states(
            (merged, optimizer) if optimizer is not None else merged)

    def server_stats(self) -> List[dict]:
        """Each server's seconds in its optimizer (or storing the
        aggregate) and the rounds it applied, since it started."""
        return [self._req(c, {"op": "stats"})["data"]
                for c in self._server_clients]

    # -- the SDC vote's exchanges --------------------------------------
    def sdc_exchange(self, step, fps, timeout: float = 60.0):
        raise MXNetError("the SDC fingerprint vote is not ported "
                         "(ROADMAP A11)")

    def sdc_reference(self, keys):
        raise MXNetError("the SDC fingerprint vote is not ported "
                         "(ROADMAP A11)")

    # -- cluster control -----------------------------------------------
    def barrier(self) -> None:
        """ref: Postoffice::Barrier, through the scheduler."""
        if self._barrier_skip > 0:
            # is_recovery catch-up: the cohort passed this one already
            self._barrier_skip -= 1
            return
        self._sched.request({"op": "barrier", "rank": self._rank},
                            timeout=86400.0)

    def get_dead_nodes(self, timeout: float = 60.0) -> List[str]:
        """Nodes whose heartbeat is older than ``timeout`` seconds, as
        ``role:rank`` (ref: ps::Postoffice::GetDeadNodes,
        kvstore_dist.h:113-121)."""
        resp = self._sched.request({"op": "dead_nodes",
                                    "timeout": timeout})
        return list(resp["dead"]) if resp else []

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._heartbeat.stop()
        self._pool.shutdown(wait=False)
        for c in self._server_clients:
            try:
                c.request({"op": "stop"})
                c.close()
            except OSError:
                pass
        try:
            self._sched.request({"op": "finalize", "role": "worker",
                                 "rank": self._rank})
            self._sched.close()
        except (OSError, ConnectionError):
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def create(name: str = "local") -> KVStore:
    """ref: src/kvstore/kvstore.cc KVStore::Create.  ``local``,
    ``device``, ``tpu`` and ``nccl`` build the base store under that
    name.  A ``dist_*`` kind runs the node loop and never returns in a
    scheduler or server process (DMLC_ROLE), returns the parameter-server
    worker where the cluster env (DMLC_PS_ROOT_URI) is set, and
    otherwise the one-process store (rank 0 of 1), so launcher-less
    scripts run."""
    if not isinstance(name, str) or name not in _VALID:
        raise MXNetError("unknown kvstore type %r" % (name,))
    if name.startswith("dist"):
        from . import kvstore_server

        kvstore_server.init()
        if os.environ.get("DMLC_PS_ROOT_URI"):
            return KVStoreDist(name)
    return KVStore(name)
