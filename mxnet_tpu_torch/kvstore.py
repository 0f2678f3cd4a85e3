"""KVStore, single process: ``local``, ``device``, ``tpu`` and ``nccl``.

Counterpart: ``mxnet_tpu/kvstore.py`` ``KVStore`` (:153-452; ref:
include/mxnet/kvstore.h, src/kvstore/kvstore_local.h).  ``push`` sums the
values pushed for a key, ``pull`` copies the stored value out, and
``set_optimizer`` moves the update into the store (update_on_kvstore),
with the optimizer's states saved in the JAX package's format.
``rank`` / ``num_workers`` follow the rank contract (kvstore.h:254-306):
after ``dist.initialize()`` they are the process group's.  ``tpu`` and
``nccl`` are the base store under their names: the JAX package's
``KVStoreTPU`` merges a multi-key push one bucket at a time, which
computes the same sums as the per-key push; the port keeps the per-key
sum until a workload that pushes several values a key is timed on the
card (the gradient exchange of a multi-context ``Module`` runs in
``parallel.dp.DataParallelRunner``, not in the store).  The ``dist_*``
kinds are the parameter-server tier (ROADMAP A10): creating one raises.  The profiler spans, byte counters
and flight-recorder entries of the JAX package's verbs wait for the
observability port (ROADMAP A11).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .base import MXNetError
from .ndarray import NDArray
from . import optimizer as _opt

__all__ = ["KVStore", "create"]

_VALID = {"local", "device", "tpu", "nccl", "dist_sync", "dist_async",
          "dist_device_sync", "dist"}


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _int_key(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


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
        Comm::Reduce); with an updater, apply it to the stored value."""
        keys, values = _key_value(key, value)
        for k, vlist in zip(keys, values):
            vs = _as_list(vlist)
            merged = vs[0]
            if len(vs) > 1:
                acc = vs[0]._data
                for v in vs[1:]:
                    acc = acc + v._data.to(acc.device)
                merged = NDArray.from_raw(acc, vs[0].context)
            if self._updater is not None:
                if k not in self._store:
                    raise MXNetError("push before init on key %r" % k)
                self._updater(_int_key(k), merged, self._store[k])
            else:
                self._pending[k] = merged

    def pull(self, key, out=None, priority: int = 0,
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

    def pushpull(self, key, value, out=None, priority: int = 0) -> None:
        """The allreduce verb: push, then pull into ``out`` (or back into
        ``value``)."""
        self.push(key, value, priority)
        self.pull(key, out if out is not None else value, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("row_sparse_pull needs sparse storage, which is "
                         "not ported (ROADMAP A10)")

    def set_gradient_compression(self, compression_params) -> None:
        raise MXNetError("gradient compression is not supported for %r "
                         "kvstore: only dist stores compress pushes on the "
                         "wire (ROADMAP A10)" % self._kind)

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


def create(name: str = "local") -> KVStore:
    """ref: src/kvstore/kvstore.cc KVStore::Create.  ``local``,
    ``device``, ``tpu`` and ``nccl`` build the base store under that
    name; the ``dist_*`` kinds raise (ROADMAP A10)."""
    if not isinstance(name, str) or name not in _VALID:
        raise MXNetError("unknown kvstore type %r" % (name,))
    if name.startswith("dist"):
        raise MXNetError("kvstore %r is the parameter-server tier, not "
                         "ported (ROADMAP A10)" % name)
    return KVStore(name)
