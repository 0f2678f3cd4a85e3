"""The input pipeline that keeps the card fed: a sharded multi-process
decode pool behind an asynchronous, stream-ordered device stage.

Counterpart: ``mxnet_tpu/io_pipeline.py``.  Two pieces:

* :class:`ShardedDecodePool` — N worker *processes*
  (``MXNET_IO_WORKERS``, default cpu_count-1), each owning a disjoint
  record slice through the ``num_parts``/``part_index`` idiom (worker w
  of N under outer rank sharding (R, r) reads the strided slice
  ``r + R*w :: R*N``).  Decoded batches travel through preallocated
  shared-memory slots (files under /dev/shm, ``MXNET_IO_POOL_SLOTS`` a
  worker); only ``(slot, epoch, pad)`` tuples cross the queues.  The
  parent reassembles a deterministic round-robin stream (batch k comes
  from worker k%N), so exact resume and bitwise reproducibility hold
  whatever the workers' timing, and the stream equals the JAX
  package's pool at the same N.  A dead worker's shard is adopted
  inline by the parent at its exact stream position.  Every segment is
  unlinked on close, at exit and on SIGTERM.
* :class:`InputPipeline` — the ``DataIter`` facade.  Its device stage
  is a thread that copies batch k+1 (and k+2, ``MXNET_IO_PREFETCH_DEPTH``)
  to the card while the consumer's step k runs: from page-locked host
  memory, on a CUDA stream of its own, ``non_blocking=True``, then
  records an event.  ``next()`` makes the consumer's current stream
  wait on that event and hands the tensors to the caching allocator
  for that stream (``record_stream``), so the step reads the batch in
  stream order and never blocks the host.  A shared-memory slot goes
  back to its worker only once the copy out of it has completed (its
  event), which takes the place of the JAX package's blocking
  ``_place``.  The pool's slots are page-locked in place
  (``cudaHostRegister`` through ``torch.cuda.cudart()``) and the copies
  read them directly; where registration fails the stage copies each
  slot into pinned memory of the caching host allocator first and
  returns the slot at once (``pin_mode`` says which, and a warning;
  on the H100 the staging copy costs 4–7 ms of host a batch and 5–7 %
  of ResNet-50's img/s, ``PERF.md``).  ``device=False``
  keeps host batches; ``device=mx.cpu()`` (or ``"cpu"``) gives CPU
  tensors through the same stage; the default is ``gpu(0)``, and
  without a card it raises.

Workers are host-only: they fetch through the iterators' ``next_raw``
(numpy, never torch or CUDA), so forking a parent that holds a CUDA
context is safe; ``MXNET_IO_START_METHOD=spawn`` is there for
iterators without ``next_raw``.  Telemetry: the per-batch decode time
feeds ``mxnet_io_decode_seconds``, the consumer-side queue depth
``mxnet_io_queue_depth``, dead workers ``mxnet_io_worker_deaths_total``;
the chaos kind ``slow_decode`` seeds a straggling worker.  While the
profiler runs, each decoded batch stamps an ``io:decode`` span on its
worker's own trace lane (tid ``IO_WORKER_TID_BASE + worker``, named
``io:decode-worker <w>``) from the timestamps the worker took, and the
device stage stamps ``io:device_put`` and the consumer ``io:wait``,
under the JAX package's names.

Departures: the JAX package's ``sharding=`` (a jax placement) is
``device=`` here, and its ``mark_disposable`` / ``take_disposable``
(the donation hand-off into its compiled step) have no counterpart: the
port's steps donate nothing, and a batch already on the card goes
through ``FusedTrainStep`` / ``Module`` without a second copy.  A
failure in the device stage raises from ``next()`` (``MXNetError``,
chained to the cause); the JAX package logs it and ends the epoch.

    python -m mxnet_tpu_torch.io_pipeline --self-test [--device cpu]
"""
from __future__ import annotations

import atexit
import functools
import json
import logging
import mmap
import os
import queue as _queue
import signal
import sys
import tempfile
import threading
import time
import uuid
import weakref
from collections import Counter, deque, namedtuple
from typing import Dict, List, Optional

import multiprocessing as _mp

import numpy as _np
import torch

from . import diagnostics as _diag
from . import profiler as _profiler
from .base import MXNetError
from .io import DataBatch, DataIter, _instrumented_fetch

__all__ = ["ShardedDecodePool", "InputPipeline", "make_ndarray_iter_fn",
           "make_record_iter_fn"]

_log = logging.getLogger(__name__)

#: /dev/shm filename prefix for pool slots (the hygiene tests scan it)
_SHM_PREFIX = "mxio-"

_EPOCH_END = object()
#: trace-lane base: decode worker w stamps spans on tid BASE+w
IO_WORKER_TID_BASE = 100


def _stamp_decode(worker: int, decode_s: float,
                  t0_mono: Optional[float] = None) -> None:
    """Per-batch decode evidence: the ``mxnet_io_decode_seconds``
    histogram, and while the profiler runs a span on the worker's own
    trace lane, anchored at the worker's ``time.monotonic()`` decode
    start (CLOCK_MONOTONIC is one clock for every process of a host)
    translated into the profiler's clock — not at the parent's
    consumption, which would shift the lane by the batch's time in the
    queue.  Never raises."""
    _diag.feed_io_decode_seconds(decode_s)
    if not _profiler.is_running():
        return
    try:
        tid = IO_WORKER_TID_BASE + int(worker)
        _profiler.register_tid_name(tid, "io:decode-worker %d" % worker)
        dur = max(float(decode_s) * 1e6, 1.0)
        now = _profiler._now_us()
        start = now - dur
        if t0_mono is not None:
            age_us = (time.monotonic() - float(t0_mono)) * 1e6
            if 0.0 <= age_us < 3600e6:  # a sane clock: the true anchor
                start = now - age_us
        _profiler.record_span("io:decode", start, dur, cat="io", tid=tid,
                              args={"worker": int(worker)})
    except Exception:
        pass


def _shm_dir() -> str:
    d = "/dev/shm"
    return d if os.path.isdir(d) else tempfile.gettempdir()


# ---------------------------------------------------------------------------
# slot layout: one shared-memory file holds every array of one batch
# ---------------------------------------------------------------------------
class _SlotSpec:
    """Byte layout of one batch slot, derived from provide_data/
    provide_label (fixed shapes: the pool contract).  Picklable (dtype
    kept as str) so workers rebuild identical views."""

    def __init__(self, data_descs, label_descs):
        self.fields = []  # (is_label, name, shape, dtype_str, off, nbytes)
        off = 0
        for is_label, descs in ((False, data_descs), (True, label_descs)):
            for d in descs:
                dt = _np.dtype(d.dtype)
                nb = int(_np.prod(d.shape)) * dt.itemsize if d.shape \
                    else dt.itemsize
                self.fields.append((is_label, d.name, tuple(d.shape),
                                    dt.str, off, nb))
                off = (off + nb + 63) & ~63  # 64B-align each array
        self.nbytes = max(off, 64)

    def views(self, buf):
        """(data_views, label_views) numpy views over one slot buffer."""
        data: List[_np.ndarray] = []
        label: List[_np.ndarray] = []
        for is_label, _name, shape, dtype, off, _nb in self.fields:
            n = int(_np.prod(shape)) if shape else 1
            a = _np.frombuffer(buf, dtype=_np.dtype(dtype), count=n,
                               offset=off).reshape(shape)
            (label if is_label else data).append(a)
        return data, label


def _map_slot(path: str, nbytes: int):
    """mmap one slot file read-write (its creator already sized it)."""
    fd = os.open(path, os.O_RDWR)
    try:
        return mmap.mmap(fd, nbytes)
    finally:
        os.close(fd)


def _host_batch(it):
    """One host batch ``(data_np_list, label_np_list, pad)``: through the
    iterator's host-only ``next_raw`` when it has one (the decode-worker
    path), otherwise ``next()`` and a numpy conversion."""
    nr = getattr(it, "next_raw", None)
    if nr is not None:
        return nr()
    b = it.next()

    def to_np(a):
        asn = getattr(a, "asnumpy", None)
        return _np.asarray(asn()) if asn is not None else _np.asarray(a)

    return ([to_np(a) for a in b.data], [to_np(a) for a in b.label],
            int(getattr(b, "pad", 0) or 0))


# ---------------------------------------------------------------------------
# worker process body — host-only: numpy and the native decoder, never
# torch tensors or CUDA
# ---------------------------------------------------------------------------
def _decode_worker_main(worker_id, iter_fn, num_parts, part_index,
                        slot_files, spec, free_q, result_q, ctrl_q,
                        parent_pid):
    """Decode worker: iterate a disjoint record slice, write each
    decoded batch into a free shared-memory slot, report ``(slot, pad,
    decode_s)``.  Polls everything with timeouts and exits when
    orphaned, so a vanished parent never strands it."""
    try:
        from . import chaos as _chaos
    except Exception:  # chaos must never be load-bearing
        _chaos = None
    it = iter_fn(num_parts=num_parts, part_index=part_index)
    maps = [_map_slot(p, spec.nbytes) for p in slot_files]
    views = [spec.views(m) for m in maps]
    epoch = 0
    exhausted = False
    while True:
        cmd = None
        try:
            cmd = ctrl_q.get_nowait()
        except _queue.Empty:
            if exhausted:
                try:
                    cmd = ctrl_q.get(timeout=0.5)
                except _queue.Empty:
                    if os.getppid() != parent_pid:
                        return
                    continue
        if cmd == "stop":
            return
        if cmd == "reset":
            it.reset()
            epoch += 1
            exhausted = False
            continue
        if exhausted:
            continue
        t0 = time.monotonic()
        try:
            data, label, pad = _host_batch(it)
        except StopIteration:
            result_q.put(("end", epoch))
            exhausted = True
            continue
        if _chaos is not None:
            _chaos.maybe_slow_decode(worker=worker_id)
        decode_s = time.monotonic() - t0
        slot = None
        while slot is None:
            try:
                slot = free_q.get(timeout=0.5)
            except _queue.Empty:
                if os.getppid() != parent_pid:
                    return
                try:
                    cmd = ctrl_q.get_nowait()
                except _queue.Empty:
                    continue
                if cmd == "stop":
                    return
                if cmd == "reset":
                    # drop the decoded batch: the epoch it belongs to is
                    # gone (the parent discards stale messages alike)
                    it.reset()
                    epoch += 1
                    exhausted = False
                    data = None
                    break
        if slot is None or data is None:
            continue
        if slot == -1:  # stop sentinel through the slot channel
            return
        d_views, l_views = views[slot]
        for v, a in zip(d_views, data):
            v[...] = _np.asarray(a).reshape(v.shape)
        for v, a in zip(l_views, label):
            v[...] = _np.asarray(a).reshape(v.shape)
        result_q.put(("b", epoch, slot, int(pad), decode_s, t0))


# ---------------------------------------------------------------------------
# pool-wide cleanup: atexit + SIGTERM chain (shared-memory hygiene)
# ---------------------------------------------------------------------------
_LIVE: "weakref.WeakSet" = weakref.WeakSet()
_cleanup_installed = False


def _cleanup_all() -> None:
    # pipelines first: they unregister the slots their pool maps
    for p in sorted(list(_LIVE),
                    key=lambda p: isinstance(p, ShardedDecodePool)):
        try:
            p.close()
        except Exception:
            pass


def _install_cleanup_once() -> None:
    global _cleanup_installed
    if _cleanup_installed:
        return
    _cleanup_installed = True
    atexit.register(_cleanup_all)
    if threading.current_thread() is not threading.main_thread():
        return
    try:
        prev = signal.getsignal(signal.SIGTERM)
        if prev == signal.SIG_IGN:
            return  # the app deliberately ignores SIGTERM: respect it

        def _term(signum, frame):
            _cleanup_all()
            if callable(prev):
                prev(signum, frame)
                return
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _term)
    except (ValueError, OSError):
        pass


_HostBatch = namedtuple("_HostBatch", "worker slot data label pad decode_s")


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------
class ShardedDecodePool(DataIter):
    """N decode worker processes over disjoint ``num_parts``/
    ``part_index`` record slices, reassembled into one deterministic
    round-robin batch stream.

    Parameters
    ----------
    iter_fn : callable(num_parts=..., part_index=...) -> DataIter
        Picklable factory (:func:`make_ndarray_iter_fn`,
        :func:`make_record_iter_fn`).  The pool composes its worker
        sharding with the caller's outer (rank) sharding.
    num_workers : worker processes (default ``MXNET_IO_WORKERS``,
        0 → cpu_count-1, min 1).
    num_parts / part_index : outer sharding (this rank's slice); each
        worker then owns a disjoint sub-slice of it.
    """

    def __init__(self, iter_fn, num_workers: Optional[int] = None,
                 num_parts: int = 1, part_index: int = 0,
                 slots_per_worker: Optional[int] = None,
                 start_method: Optional[str] = None):
        from . import env as _env

        nw = num_workers if num_workers is not None \
            else _env.get_int("MXNET_IO_WORKERS")
        if not nw or int(nw) <= 0:
            nw = max(1, (os.cpu_count() or 2) - 1)
        self._nw = int(nw)
        self._outer = (int(num_parts), int(part_index))
        self._slots = max(1, int(
            slots_per_worker if slots_per_worker is not None
            else _env.get_int("MXNET_IO_POOL_SLOTS")))
        self._iter_fn = iter_fn
        # probe the unsharded iterator for shapes / batch size / raw
        # capability: shapes are slice-invariant, and probing worker 0's
        # slice would make ImageRecordIter copy that slice into a temp
        # shard just to throw it away
        probe = iter_fn(num_parts=1, part_index=0)
        self._provide_data = list(probe.provide_data)
        self._provide_label = list(probe.provide_label)
        super().__init__(int(getattr(probe, "batch_size", 0)
                             or self._provide_data[0].shape[0]))
        raw_ok = hasattr(probe, "next_raw")
        del probe
        method = start_method or _env.get_str("MXNET_IO_START_METHOD")
        if not method:
            # fork is safe exactly when workers stay host-only: the
            # next_raw contract guarantees that for library iterators
            method = "fork" if raw_ok \
                and "fork" in _mp.get_all_start_methods() else "spawn"
        if method not in _mp.get_all_start_methods():
            raise MXNetError("unknown start method %r" % method)
        self._method = method
        self._spec = _SlotSpec(self._provide_data, self._provide_label)
        self._started = False
        self._closed = False
        self._lock = threading.RLock()
        #: called (with no argument) when the stream waits on a worker
        #: that has nothing ready: the device stage returns slots there
        self.on_wait = None

    # -- sharding arithmetic: arr[r::R][w::N] == arr[r + R*w :: R*N] --
    def _inner_parts(self) -> int:
        return self._outer[0] * self._nw

    def _inner_index(self, w: int) -> int:
        return self._outer[1] + self._outer[0] * w

    @property
    def num_workers(self) -> int:
        return self._nw

    @property
    def slots_per_worker(self) -> int:
        return self._slots

    @property
    def slot_nbytes(self) -> int:
        return self._spec.nbytes

    @property
    def start_method(self) -> str:
        return self._method

    @property
    def provide_data(self):
        return self._provide_data

    @property
    def provide_label(self):
        return self._provide_label

    def slot_maps(self):
        """``[(worker, slot, mmap)]`` of every slot (starts the pool)."""
        self._ensure_started()
        return [(w, s, m) for w, row in enumerate(self._maps)
                for s, m in enumerate(row)]

    # -- lifecycle ------------------------------------------------------
    def _ensure_started(self) -> None:
        with self._lock:
            if self._started:
                return
            if self._closed:
                raise MXNetError("decode pool is closed")
            ctx = _mp.get_context(self._method)
            self._uid = "%s%d-%s" % (_SHM_PREFIX, os.getpid(),
                                     uuid.uuid4().hex[:8])
            base = _shm_dir()
            self._files = [[os.path.join(base, "%s-w%ds%d"
                                         % (self._uid, w, s))
                            for s in range(self._slots)]
                           for w in range(self._nw)]
            for row in self._files:
                for path in row:
                    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o600)
                    try:
                        os.ftruncate(fd, self._spec.nbytes)
                    finally:
                        os.close(fd)
            self._maps = [[_map_slot(p, self._spec.nbytes) for p in row]
                          for row in self._files]
            self._views = [[self._spec.views(m) for m in row]
                           for row in self._maps]
            self._free_qs = [ctx.Queue() for _ in range(self._nw)]
            self._result_qs = [ctx.Queue() for _ in range(self._nw)]
            self._ctrl_qs = [ctx.Queue() for _ in range(self._nw)]
            for w in range(self._nw):
                for s in range(self._slots):
                    self._free_qs[w].put(s)
            self._procs = []
            for w in range(self._nw):
                p = ctx.Process(
                    target=_decode_worker_main,
                    args=(w, self._iter_fn, self._inner_parts(),
                          self._inner_index(w), self._files[w],
                          self._spec, self._free_qs[w],
                          self._result_qs[w], self._ctrl_qs[w],
                          os.getpid()),
                    daemon=True, name="mxio-decode-%d" % w)
                p.start()
                self._procs.append(p)
            self._epoch = 0
            self._rr = 0
            self._finished = [False] * self._nw
            self._consumed = [0] * self._nw
            self._dead = [False] * self._nw
            self._adopted: List[Optional[dict]] = [None] * self._nw
            self._started = True
            _LIVE.add(self)
            _install_cleanup_once()
            _log.info("decode pool up: %d worker(s), %d slot(s) each, "
                      "%d B/slot, start_method=%s", self._nw,
                      self._slots, self._spec.nbytes, self._method)

    def close(self) -> None:
        """Stop workers, unlink every shared-memory segment.  Safe to
        call twice; runs from atexit and the SIGTERM chain."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            started = self._started
        if started:
            for w in range(self._nw):
                try:
                    self._ctrl_qs[w].put("stop")
                    self._free_qs[w].put(-1)
                except Exception:
                    pass
            for p in self._procs:
                p.join(timeout=3.0)
            for p in self._procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=1.0)
            for p in self._procs:
                if p.is_alive():
                    try:
                        p.kill()
                    except Exception:
                        pass
                    p.join(timeout=1.0)
            for q in (self._free_qs + self._result_qs + self._ctrl_qs):
                try:
                    q.close()
                    q.cancel_join_thread()
                except Exception:
                    pass
            self._views = None
            for row in self._maps:
                for m in row:
                    try:
                        m.close()
                    except Exception:
                        pass  # a view still exported: unmapped at GC
            for row in self._files:
                for path in row:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
        _LIVE.discard(self)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- the deterministic stream --------------------------------------
    def next_host(self) -> _HostBatch:
        """Next batch of the round-robin stream as host views into a
        shared-memory slot.  The caller must :meth:`recycle` the batch
        once its bytes are consumed (the device stage does it once the
        copy out of the slot has completed)."""
        self._ensure_started()
        n = self._nw
        while True:
            if all(self._finished):
                raise StopIteration
            w = self._rr % n
            if self._finished[w]:
                self._rr += 1
                continue
            hb = self._fetch_from(w)
            self._rr += 1
            if hb is None:  # w just finished this epoch
                continue
            self._consumed[w] += 1
            return hb

    def recycle(self, hb: _HostBatch) -> None:
        """Return a consumed batch's slot to its worker."""
        if hb.slot is not None and not self._dead[hb.worker]:
            self._free_qs[hb.worker].put(hb.slot)

    def _fetch_from(self, w: int) -> Optional[_HostBatch]:
        if self._dead[w]:
            return self._adopt_next(w)
        q = self._result_qs[w]
        timeout = 0.005 if self.on_wait is not None else 0.2
        while True:
            try:
                msg = q.get(timeout=timeout)
            except _queue.Empty:
                if self.on_wait is not None:
                    self.on_wait()
                    timeout = 0.2
                # an input-bound wait: the parent is alive, just starved
                _diag.touch_heartbeat()
                if not self._procs[w].is_alive():
                    self._declare_dead(w)
                    return self._adopt_next(w)
                continue
            out = self._msg_to_batch(w, msg)
            if out is _EPOCH_END:
                return None
            if out is not None:
                return out

    def _msg_to_batch(self, w: int, msg):
        """One queue message -> _HostBatch | _EPOCH_END | None (stale,
        discarded — its slot recycled)."""
        if msg[0] == "end":
            if msg[1] == self._epoch:
                self._finished[w] = True
                return _EPOCH_END
            return None
        _kind, ep, slot, pad, decode_s = msg[:5]
        if ep != self._epoch:
            if not self._dead[w]:
                self._free_qs[w].put(slot)
            return None
        _stamp_decode(w, decode_s, msg[5] if len(msg) > 5 else None)
        d, lab = self._views[w][slot]
        return _HostBatch(w, slot, d, lab, int(pad), float(decode_s))

    # -- dead-worker adoption ------------------------------------------
    def _declare_dead(self, w: int) -> None:
        self._dead[w] = True
        _diag.feed_io_worker_death()
        _log.warning(
            "io_pipeline: decode worker %d died — adopting its shard "
            "inline at batch %d (degraded throughput, stream "
            "unchanged)", w, self._consumed[w])
        # batches it fully delivered before dying are still readable
        buffered: deque = deque()
        deadline = time.time() + 0.5
        while time.time() < deadline:
            try:
                buffered.append(self._result_qs[w].get(timeout=0.05))
            except _queue.Empty:
                break
        self._adopted[w] = {"buffer": buffered, "it": None}

    def _adopt_next(self, w: int) -> Optional[_HostBatch]:
        st = self._adopted[w]
        while st["buffer"]:
            out = self._msg_to_batch(w, st["buffer"].popleft())
            if out is _EPOCH_END:
                return None
            if out is not None:
                return out
        if self._finished[w]:
            return None
        if st["it"] is None:
            it = self._iter_fn(num_parts=self._inner_parts(),
                               part_index=self._inner_index(w))
            # fast-forward to the dead worker's exact stream position
            # ("exact" for deterministic iterators: the contract exact
            # resume already requires)
            for _ in range(self._consumed[w]):
                try:
                    _host_batch(it)
                except StopIteration:
                    break
            st["it"] = it
        t0 = time.monotonic()
        try:
            data, label, pad = _host_batch(st["it"])
        except StopIteration:
            self._finished[w] = True
            return None
        decode_s = time.monotonic() - t0
        _stamp_decode(w, decode_s, t0)
        return _HostBatch(w, None, data, label, int(pad), decode_s)

    # -- DataIter surface (host mode: safe copies) ----------------------
    def reset(self):
        with self._lock:
            if not self._started:
                return
            self._epoch += 1
            self._rr = 0
            self._finished = [False] * self._nw
            self._consumed = [0] * self._nw
            for w in range(self._nw):
                if self._dead[w]:
                    st = self._adopted[w]
                    st["buffer"].clear()
                    if st["it"] is not None:
                        st["it"].reset()
                else:
                    self._ctrl_qs[w].put("reset")

    def next(self) -> DataBatch:
        return _instrumented_fetch(self, self._next_copy)

    def _next_copy(self) -> DataBatch:
        from .context import cpu
        from .ndarray import NDArray

        hb = self.next_host()
        batch = DataBatch(
            [NDArray.from_raw(torch.from_numpy(v.copy()), cpu())
             for v in hb.data],
            [NDArray.from_raw(torch.from_numpy(v.copy()), cpu())
             for v in hb.label], pad=hb.pad)
        self.recycle(hb)
        return batch


# ---------------------------------------------------------------------------
# the facade: pool + the asynchronous device stage
# ---------------------------------------------------------------------------
def _resolve_target(device):
    """(Context, torch.device) of ``device``, or (None, None) for host
    copies (``device=False``)."""
    from .context import Context, cpu, gpu

    if device is False or device is None:
        return None, None
    if device is True:
        ctx = gpu(0)
    elif isinstance(device, Context):
        ctx = device
    else:
        dev = torch.device(device)
        ctx = cpu() if dev.type == "cpu" else gpu(dev.index or 0)
    return ctx, ctx.torch_device()


class _Registered:
    """The pool's slots page-locked in place (``cudaHostRegister``);
    unregistered on :meth:`release`."""

    def __init__(self, pool):
        cudart = torch.cuda.cudart()
        self._cudart = cudart
        self._ptrs = []
        try:
            for _w, _s, m in pool.slot_maps():
                ptr = _np.frombuffer(m, dtype=_np.uint8).ctypes.data
                torch.cuda.check_error(
                    cudart.cudaHostRegister(ptr, len(m), 0))
                self._ptrs.append(ptr)
        except BaseException:
            self.release()
            raise

    def release(self) -> None:
        for ptr in self._ptrs:
            try:
                self._cudart.cudaHostUnregister(ptr)
            except Exception:
                pass
        self._ptrs = []


class InputPipeline(DataIter):
    """Sharded decode pool behind an asynchronous device stage.

    ``device`` — ``gpu(0)`` by default (``True``), any ``Context`` /
    ``torch.device`` / string, or ``False`` for host copies.  On a CUDA
    device a background thread copies ``depth`` batches ahead
    (``MXNET_IO_PREFETCH_DEPTH``) from page-locked memory on its own
    stream, and ``next()`` returns batches whose tensors the consumer's
    stream may read at once (it waits on the copy's event on the card,
    not on the host); the pool's slots are page-locked in place, or, if
    that fails, staged through pinned memory (:attr:`pin_mode`).  On
    the CPU the stage copies each slot into a fresh tensor.
    """

    def __init__(self, iter_fn, num_workers: Optional[int] = None,
                 num_parts: int = 1, part_index: int = 0,
                 depth: Optional[int] = None,
                 slots_per_worker: Optional[int] = None,
                 device=True, start_method: Optional[str] = None):
        from . import env as _env

        self._ctx, self._dev = _resolve_target(device)
        self._pool = ShardedDecodePool(
            iter_fn, num_workers=num_workers, num_parts=num_parts,
            part_index=part_index, slots_per_worker=slots_per_worker,
            start_method=start_method)
        super().__init__(self._pool.batch_size)
        self._depth = max(1, int(
            depth if depth is not None
            else _env.get_int("MXNET_IO_PREFETCH_DEPTH")))
        self._cuda = self._dev is not None and self._dev.type == "cuda"
        self._pin = "register" if self._cuda else None
        self._q: _queue.Queue = _queue.Queue(maxsize=self._depth)
        self._gen = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._pending: Optional[DataBatch] = None
        self._consumed_batches = 0
        self._copy_stream = None
        self._registered: Optional[_Registered] = None
        self._error: Optional[BaseException] = None
        # (event, host batch) whose slot waits on its copy
        self._inflight: deque = deque()
        self._copy_lock = threading.Lock()
        self._closed = False
        _LIVE.add(self)

    # -- DataIter surface ----------------------------------------------
    @property
    def provide_data(self):
        return self._pool.provide_data

    @property
    def provide_label(self):
        return self._pool.provide_label

    @property
    def num_workers(self) -> int:
        return self._pool.num_workers

    @property
    def pool(self) -> ShardedDecodePool:
        return self._pool

    @property
    def pin_mode(self) -> Optional[str]:
        """How the device stage page-locks: ``register`` (the slots
        themselves), ``stage`` (a pinned copy, where registering failed)
        or None (no CUDA device)."""
        return self._pin

    @property
    def cursor(self) -> int:
        """Stream position in samples (the iterator_state a checkpoint
        records)."""
        return self._consumed_batches * self.batch_size

    def next(self) -> DataBatch:
        if self._pending is not None:
            b, self._pending = self._pending, None
            return b
        return _instrumented_fetch(self, self._next_impl)

    def iter_next(self) -> bool:
        if self._pending is None:
            try:
                self._pending = self.next()
            except StopIteration:
                return False
        return True

    def getdata(self):
        return self._pending.data

    def getlabel(self):
        return self._pending.label

    def getpad(self):
        return self._pending.pad

    def reset(self):
        self._pending = None
        self._stop_thread()
        self._gen += 1
        self._pool.reset()
        self._consumed_batches = 0

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._pending = None
        self._stop_thread()
        if self._registered is not None:
            self._registered.release()
            self._registered = None
        self._pool.close()
        _LIVE.discard(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def skip_batches(self, n: int) -> None:
        """Fast-forward the stream ``n`` batches without copying them to
        the device — the exact-resume fast path (``Module.fit``,
        ``TransformerTrainStep.fit``): the skipped batches are decoded
        (the stream position is what matters) but never cross the link."""
        if self._thread is not None and self._thread.is_alive():
            for _ in range(int(n)):  # device stage already running
                try:
                    self.next()
                except StopIteration:
                    break
            return
        for _ in range(int(n)):
            try:
                hb = self._pool.next_host()
            except StopIteration:
                break
            self._pool.recycle(hb)
            self._consumed_batches += 1

    # -- internals ------------------------------------------------------
    def _next_impl(self) -> DataBatch:
        if self._dev is None:
            batch = self._pool._next_copy()
            self._consumed_batches += 1
            return batch
        self._ensure_thread()
        t0 = _profiler._now_us() if _profiler.is_running() else None
        while True:
            gen, item = self._q.get()
            if gen == self._gen:
                break
        if t0 is not None:
            # consumer-side stall: the input-bound signal
            _profiler.record_span("io:wait", t0,
                                  _profiler._now_us() - t0, cat="io")
        _diag.feed_io_queue_depth(self._q.qsize())
        if item is None:
            t = self._thread
            if t is not None:
                t.join(timeout=2.0)
            self._thread = None
            err, self._error = self._error, None
            if err is not None:
                raise MXNetError("io_pipeline device stage failed: %r"
                                 % (err,)) from err
            raise StopIteration
        batch, event = item
        if event is not None:
            # stream order: the consumer's stream waits on the copy on
            # the card; the allocator keeps the memory for that stream
            consumer = torch.cuda.current_stream(self._dev)
            consumer.wait_event(event)
            for a in list(batch.data) + list(batch.label):
                a._data.record_stream(consumer)
        self._consumed_batches += 1
        return batch

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._error = None
            if self._cuda and self._copy_stream is None:
                self._setup_cuda()
            self._thread = threading.Thread(
                target=self._device_loop, args=(self._gen,),
                daemon=True, name="mxio-device-prefetch")
            self._thread.start()

    def _setup_cuda(self) -> None:
        torch.cuda.set_device(self._dev)
        self._copy_stream = torch.cuda.Stream(self._dev)
        try:
            self._registered = _Registered(self._pool)
        except Exception as e:
            # still page-locked: a pinned copy, and it says so
            _log.warning("io_pipeline: cudaHostRegister of the pool's "
                         "slots failed (%s); staging through pinned "
                         "memory instead", e)
            self._pin = "stage"

    def _stop_thread(self) -> None:
        t = self._thread
        if t is not None:
            self._stop.set()
            # unblock a producer waiting on a full queue
            self._drain_queue()
            t.join(timeout=10.0)
            self._thread = None
            self._stop.clear()
            self._drain_queue()
        self._reclaim(wait=True)

    def _drain_queue(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass

    def _reclaim(self, wait: bool = False) -> None:
        """Return to their workers the slots whose copy has completed
        (all of them with ``wait``).  A worker all of whose slots wait
        on copies cannot decode: then wait for the newest copy (the
        copy stream runs them in order)."""
        with self._copy_lock:
            fl = self._inflight
            if not fl:
                return
            held = Counter(hb.worker for _, hb in fl)
            if wait or max(held.values()) >= self._pool.slots_per_worker:
                fl[-1][0].synchronize()
            while fl and fl[0][0].query():
                self._pool.recycle(fl.popleft()[1])

    def _issue_copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """One host-to-device copy on the copy stream (the current
        stream here)."""
        dst.copy_(src, non_blocking=True)

    def _to_device(self, hb: _HostBatch):
        """Copy one host batch to the target; returns (DataBatch, the
        copy's event or None)."""
        from .ndarray import NDArray

        views = list(hb.data) + list(hb.label)
        if not self._cuda:
            out = [torch.from_numpy(_np.array(v)) for v in views]
            self._pool.recycle(hb)
            event = None
        else:
            with torch.cuda.stream(self._copy_stream):
                srcs = self._pinned_sources(hb, views)
                out = []
                for v, src in zip(views, srcs):
                    dst = torch.empty(v.shape, dtype=src.dtype,
                                      device=self._dev)
                    self._issue_copy(dst, src)
                    out.append(dst)
                event = torch.cuda.Event()
                event.record(self._copy_stream)
            if self._pin == "register" and hb.slot is not None:
                with self._copy_lock:
                    self._inflight.append((event, hb))
            else:
                self._pool.recycle(hb)
        nd = len(hb.data)
        return DataBatch([NDArray.from_raw(t, self._ctx) for t in out[:nd]],
                         [NDArray.from_raw(t, self._ctx) for t in out[nd:]],
                         pad=hb.pad), event

    def _pinned_sources(self, hb: _HostBatch, views):
        """Page-locked host tensors holding the batch's arrays: the
        registered slot itself, or a copy into pinned memory from the
        caching host allocator (which reuses a buffer only once the
        copy out of it has completed)."""
        srcs = [torch.from_numpy(v) for v in views]
        if self._pin == "register" and hb.slot is not None:
            return srcs
        return [t.pin_memory() for t in srcs]

    def _device_loop(self, gen: int) -> None:
        """The device stage: copy batch k+1 (and k+2, up to ``depth``)
        while the consumer's batch k computes."""
        if self._cuda:
            torch.cuda.set_device(self._dev)
            self._pool.on_wait = self._reclaim
        pool = self._pool
        while not self._stop.is_set():
            # any failure must still enqueue the end sentinel: the
            # consumer blocks on an untimed get
            try:
                self._reclaim()
                try:
                    hb = pool.next_host()
                except StopIteration:
                    self._put(gen, None)
                    return
                t0 = _profiler._now_us()
                item = self._to_device(hb)
                if _profiler.is_running():
                    # the copy's issue on the device stage's thread
                    _profiler.record_span(
                        "io:device_put", t0, _profiler._now_us() - t0,
                        cat="io", args={"worker": hb.worker})
            except Exception as e:
                _log.exception("io_pipeline device stage failed")
                self._error = e
                self._put(gen, None)
                return
            if not self._put(gen, item):
                return

    def _put(self, gen, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put((gen, item), timeout=0.1)
                return True
            except _queue.Full:
                if self._cuda:
                    self._reclaim()
        return False


# ---------------------------------------------------------------------------
# picklable iterator factories (the worker-side constructors)
# ---------------------------------------------------------------------------
def _ndarray_iter_fn(data, label, batch_size, kwargs,
                     num_parts=1, part_index=0):
    from .io import NDArrayIter

    return NDArrayIter(data, label, batch_size, num_parts=num_parts,
                       part_index=part_index, **kwargs)


def make_ndarray_iter_fn(data, label=None, batch_size=1, **kwargs):
    """Picklable ``iter_fn`` over in-memory numpy arrays (arrays travel
    by value to spawn workers; fork workers share pages)."""
    if "num_parts" in kwargs or "part_index" in kwargs:
        raise ValueError("pass rank sharding to the pool "
                         "(num_parts/part_index), not the factory")
    return functools.partial(_ndarray_iter_fn, data, label,
                             int(batch_size), kwargs)


def _record_iter_fn(kwargs, num_parts=1, part_index=0):
    from .io import ImageRecordIter

    return ImageRecordIter(num_parts=num_parts, part_index=part_index,
                           **kwargs)


def make_record_iter_fn(**kwargs):
    """Picklable ``iter_fn`` over a .rec file (``ImageRecordIter``
    kwargs: path_imgrec, data_shape, batch_size, ...).  Each worker
    copies its record slice into a private temp shard and decodes only
    that."""
    if "num_parts" in kwargs or "part_index" in kwargs:
        raise ValueError("pass rank sharding to the pool "
                         "(num_parts/part_index), not the factory")
    return functools.partial(_record_iter_fn, kwargs)


# ---------------------------------------------------------------------------
# CLI: python -m mxnet_tpu_torch.io_pipeline --self-test
# ---------------------------------------------------------------------------
def _leaked_segments(token: str) -> List[str]:
    base = _shm_dir()
    try:
        return [n for n in os.listdir(base)
                if n.startswith(_SHM_PREFIX) and token in n]
    except OSError:
        return []


def _drain_ids(pipe) -> List[int]:
    """Consume one epoch; return the label ids seen (stream order)."""
    out: List[int] = []
    while True:
        try:
            b = pipe.next()
        except StopIteration:
            return out
        lab = b.label[0]
        lab = lab.asnumpy() if hasattr(lab, "asnumpy") else _np.asarray(lab)
        keep = len(lab) - b.pad
        out.extend(int(v) for v in _np.asarray(lab).reshape(-1)[:keep])


_SIGTERM_CHILD_SRC = r"""
import time
import numpy as np
from mxnet_tpu_torch import io_pipeline as iop

x = np.arange(64, dtype=np.float32).reshape(32, 2)
y = np.arange(32, dtype=np.float32)
pipe = iop.InputPipeline(iop.make_ndarray_iter_fn(x, y, batch_size=4),
                         num_workers=2, device=False)
pipe.next()  # pool is up, slots exist
print("READY", pipe.pool._uid, flush=True)
time.sleep(60)  # killed by the parent's SIGTERM long before this
"""


def _self_test(device: str = "cuda") -> tuple:
    import subprocess

    checks: Dict[str, bool] = {}
    x = _np.arange(96, dtype=_np.float32).reshape(48, 2)
    y = _np.arange(48, dtype=_np.float32)
    fn = make_ndarray_iter_fn(x, y, batch_size=4,
                              last_batch_handle="discard")

    # 1) start/stream/drain: deterministic round-robin reassembly,
    # disjoint-and-exhaustive coverage, identical across epochs
    pipe = InputPipeline(fn, num_workers=2, device=False)
    token = None
    try:
        e1 = _drain_ids(pipe)
        token = pipe.pool._uid
        checks["covers_every_record"] = sorted(e1) == list(range(48))
        expect = []
        parts = [list(range(w, 48, 2)) for w in range(2)]
        k = 0
        while any(parts[i] for i in range(2)):
            w = k % 2
            if parts[w]:
                expect.extend(parts[w][:4])
                parts[w] = parts[w][4:]
            k += 1
        checks["round_robin_deterministic"] = e1 == expect
        pipe.reset()
        checks["epoch2_identical"] = _drain_ids(pipe) == e1
        pipe.reset()
        for _ in range(3):
            pipe.next()
        pipe.reset()
        checks["mid_epoch_reset_restarts"] = _drain_ids(pipe) == e1
        checks["segments_live_while_open"] = \
            len(_leaked_segments(token)) > 0
    finally:
        pipe.close()
    checks["close_unlinks_segments"] = _leaked_segments(token) == []

    # 2) worker death: kill one worker mid-stream; the stream finishes
    # identically (inline adoption), nothing hangs.  One slot a worker:
    # worker 1 can have delivered at most the batch the stream took from
    # it plus one, 2 of its 6, so the kill lands before its end message
    pipe = InputPipeline(fn, num_workers=2, device=False,
                         slots_per_worker=1)
    try:
        got = [pipe.next() for _ in range(2)]
        ids = [int(v) for b in got
               for v in b.label[0].asnumpy().reshape(-1)]
        victim = pipe.pool._procs[1]
        victim.kill()
        victim.join(5.0)
        rest = _drain_ids(pipe)
        checks["worker_death_stream_exact"] = ids + rest == e1
        checks["worker_death_flagged"] = pipe.pool._dead[1]
    finally:
        pipe.close()

    # 3) slow_decode chaos: a seeded straggler degrades throughput but
    # the epoch still completes (no deadlock)
    os.environ["MXNET_CHAOS"] = "slow_decode:worker=0,ms=30,count=3"
    try:
        pipe = InputPipeline(fn, num_workers=2, device=False)
        try:
            checks["slow_decode_completes"] = \
                sorted(_drain_ids(pipe)) == list(range(48))
        finally:
            pipe.close()
    finally:
        del os.environ["MXNET_CHAOS"]

    # 4) the device stage: batches come back on the device, values
    # equal to the host stream
    pipe = InputPipeline(fn, num_workers=2, device=device)
    try:
        b = pipe.next()
        t = b.data[0]._data
        checks["device_placed"] = t.device.type == \
            torch.device(device).type
        first = t.cpu().numpy()
        checks["device_values_match"] = \
            first.shape == (4, 2) and float(first[0, 0]) == 0.0
        rest = _drain_ids(pipe)
        checks["device_stream_complete"] = len(rest) == 44
    finally:
        pipe.close()

    # 5) SIGTERM hygiene: a SIGTERM'd pipeline process leaves zero
    # shared-memory litter behind
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-c", _SIGTERM_CHILD_SRC],
                            stdout=subprocess.PIPE, text=True, env=env)
    line = proc.stdout.readline().strip()
    child_token = line.split()[-1] if line.startswith("READY") else ""
    checks["sigterm_child_started"] = bool(child_token)
    checks["sigterm_child_segments_exist"] = \
        len(_leaked_segments(child_token)) > 0 if child_token else False
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    proc.stdout.close()
    time.sleep(0.2)
    checks["sigterm_no_shm_litter"] = \
        _leaked_segments(child_token) == [] if child_token else False

    return all(checks.values()), checks


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.io_pipeline",
        description="sharded decode pool + device stage self-test")
    ap.add_argument("--self-test", action="store_true",
                    help="pool start/stop/drain, determinism, worker "
                         "death, slow_decode chaos, device stage, "
                         "SIGTERM shared-memory hygiene")
    ap.add_argument("--device", default="cuda",
                    help="the device stage's target (default cuda; "
                         "pass --device cpu to run without a card)")
    args = ap.parse_args(argv)
    if args.self_test:
        if torch.device(args.device).type == "cuda" and \
                not torch.cuda.is_available():
            raise SystemExit("no CUDA device is available; pass "
                             "--device cpu to run the self-test on the "
                             "CPU")
        ok, checks = _self_test(args.device)
        print(json.dumps({"self_test_ok": ok, "checks": checks}))
        return 0 if ok else 1
    ap.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
