"""DataLoader.

Counterpart: ``mxnet_tpu/gluon/data/dataloader.py``.  ``num_workers >
0`` runs spawned worker processes (a forked child of a parent that
holds a CUDA context must not touch it, and a dataset may) that
assemble batches and return them through
``multiprocessing.shared_memory`` segments: Python-side
``Dataset.transform`` callables run in parallel, off the parent's GIL,
and batch bytes cross process boundaries once.  ``thread_pool=True``
selects the in-process thread pool instead; datasets that fail to
pickle fall back to threads with a warning.

Batches are host NDArrays.  ``pin_memory=True`` page-locks every batch
(context ``cpu_pinned``) when a card is present, so its copy to the
card can be asynchronous (the JAX package accepts the flag and ignores
it); without a card it changes nothing.
"""
from __future__ import annotations

import logging
import pickle
import threading
import queue as _queue
from typing import Any, List, Optional

import numpy as _np
import torch

from ...context import cpu, cpu_pinned
from ...ndarray import NDArray, array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]

_log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# process-worker plumbing.  Top-level (picklable) worker main; numpy
# trees travel through shared_memory segments, specs through queues.
# ---------------------------------------------------------------------------

def _to_numpy_tree(obj):
    if isinstance(obj, NDArray):
        return obj.asnumpy()
    if isinstance(obj, (list, tuple)):
        return [_to_numpy_tree(o) for o in obj]
    return _np.asarray(obj)


def _ship(tree, shm_mod):
    """numpy tree -> (spec tree, [shm segments]); arrays land in shm.
    On failure partway, already-created segments are unlinked (a full
    /dev/shm must not leak what it did manage to allocate)."""
    segs = []

    def go(t):
        if isinstance(t, list):
            return [go(x) for x in t]
        arr = _np.ascontiguousarray(t)
        if arr.nbytes == 0:
            return ("inline", arr)
        seg = shm_mod.SharedMemory(create=True, size=arr.nbytes)
        seg.buf[: arr.nbytes] = arr.tobytes()
        segs.append(seg)
        return ("shm", seg.name, arr.shape, str(arr.dtype))

    try:
        return go(tree), segs
    except BaseException:
        for seg in segs:
            try:
                seg.close()
                seg.unlink()
            except Exception:
                pass
        raise


def _discard(spec, shm_mod):
    """Unlink every shm segment named in a spec tree without reading it
    (stale results from an abandoned iteration)."""
    if isinstance(spec, list):
        for s in spec:
            _discard(s, shm_mod)
        return
    if isinstance(spec, tuple) and spec and spec[0] == "shm":
        try:
            seg = shm_mod.SharedMemory(name=spec[1])
            seg.close()
            seg.unlink()
        except Exception:
            pass


def nd_array(a) -> NDArray:
    """A host NDArray (the loader's batches are host data)."""
    return array(a, ctx=cpu())


def _pin(tree):
    """Page-lock every NDArray of a batch tree (context ``cpu_pinned``)."""
    if isinstance(tree, NDArray):
        return NDArray.from_raw(tree._data.pin_memory(), cpu_pinned())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_pin(t) for t in tree)
    return tree


def _receive(spec, shm_mod):
    """spec tree -> NDArray tree; copies out of shm then unlinks."""
    def go(s):
        if isinstance(s, list):
            return [go(x) for x in s]
        if s[0] == "inline":
            return nd_array(s[1])
        _, name, shape, dtype = s
        seg = shm_mod.SharedMemory(name=name)
        try:
            arr = _np.frombuffer(seg.buf, dtype=dtype)[
                : int(_np.prod(shape))].reshape(shape).copy()
        finally:
            seg.close()
            seg.unlink()
        return nd_array(arr)

    return go(spec)


def _worker_main(dataset_pkl, batchify_pkl, task_q, result_q):
    from multiprocessing import shared_memory as shm_mod

    dataset = pickle.loads(dataset_pkl)
    batchify = pickle.loads(batchify_pkl)
    while True:
        job = task_q.get()
        if job is None:
            return
        epoch, jid, indices = job
        try:
            batch = batchify([dataset[i] for i in indices])
            spec, segs = _ship(_to_numpy_tree(batch), shm_mod)
            result_q.put((epoch, jid, "ok", spec))
            for seg in segs:
                seg.close()
        except BaseException as e:
            result_q.put((epoch, jid, "err",
                          "%s: %s" % (type(e).__name__, e)))


def default_batchify_fn(data):
    """ref: dataloader.py default_batchify_fn."""
    if isinstance(data[0], NDArray):
        return nd_array(_np.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(list(i)) for i in data]
    arr = _np.asarray(data)
    return nd_array(arr)


def _shutdown_pool(procs, task_q):
    try:
        for _ in procs:
            task_q.put(None)
    except Exception:
        pass
    for p in procs:
        p.join(timeout=2)
        if p.is_alive():
            p.terminate()


class DataLoader:
    """ref: dataloader.py DataLoader."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False):
        self._dataset = dataset
        self._thread_pool = bool(thread_pool)
        self._pool = None  # lazily-spawned persistent process pool
        self._epoch = 0
        self._iter_active = False
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size is required when batch_sampler is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with a custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError("batch_sampler is mutually exclusive with "
                             "batch_size/shuffle/sampler/last_batch")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, int(num_workers))
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._pin_memory = bool(pin_memory) and torch.cuda.is_available()

    def __len__(self):
        return len(self._batch_sampler)

    def _make_batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        if not self._pin_memory:
            yield from self._iter_batches()
            return
        for batch in self._iter_batches():
            yield _pin(batch)

    def _iter_batches(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._make_batch(indices)
            return
        if not self._thread_pool:
            # one process-pool iterator at a time: a second concurrent
            # iterator would race the shared result queue — it runs on
            # the thread pool instead (same contract, no interference)
            if not self._iter_active:
                pool = self._ensure_pool()
                if pool:  # False = unpicklable dataset: thread fallback
                    self._iter_active = True
                    yield from self._process_iter(pool)
                    return
        yield from self._threaded_iter()

    # -- process workers ----------------------------------------------
    def _ensure_pool(self):
        """Spawn the persistent worker pool once; None => dataset or
        batchify doesn't pickle and we fall back to threads."""
        if self._pool is not None:
            return self._pool or None
        try:
            dataset_pkl = pickle.dumps(self._dataset)
            batchify_pkl = pickle.dumps(self._batchify_fn)
        except Exception as e:
            _log.warning(
                "DataLoader(num_workers=%d): dataset/batchify_fn does "
                "not pickle (%s); falling back to the in-process thread "
                "pool (pass thread_pool=True to silence this)",
                self._num_workers, e)
            self._pool = False
            return None
        import multiprocessing as mp

        ctx = mp.get_context("spawn")  # see the module docstring
        task_q = ctx.SimpleQueue()
        # a real Queue (not SimpleQueue): get(timeout=) lets the consumer
        # interleave worker-liveness checks — a segfaulted/OOM-killed
        # worker must raise, not hang the training process
        result_q = ctx.Queue()
        procs = [ctx.Process(target=_worker_main,
                             args=(dataset_pkl, batchify_pkl, task_q,
                                   result_q),
                             daemon=True)
                 for _ in range(self._num_workers)]
        for p in procs:
            p.start()
        self._pool = (procs, task_q, result_q)
        import weakref

        self._finalizer = weakref.finalize(self, _shutdown_pool, procs,
                                           task_q)
        return self._pool

    def _teardown_pool(self):
        """Discard a pool with dead workers: the next iteration respawns
        a fresh one instead of nondeterministically reusing survivors."""
        if not self._pool:
            return
        procs, _, _ = self._pool
        fin = getattr(self, "_finalizer", None)
        if fin is not None:
            fin.detach()
        for p in procs:
            if p.is_alive():
                p.terminate()
        self._pool = None

    def _process_iter(self, pool):
        from multiprocessing import shared_memory as shm_mod

        procs, task_q, result_q = pool
        # epoch tag: results from an abandoned/errored earlier iteration
        # must not masquerade as this epoch's batches (job ids restart
        # at 0 every epoch)
        self._epoch += 1
        epoch = self._epoch
        batches = list(self._batch_sampler)
        inflight_cap = max(self._prefetch, self._num_workers)
        results: dict = {}
        submitted = 0
        delivered = 0
        try:
            while delivered < len(batches):
                while submitted < len(batches) and \
                        submitted - delivered < inflight_cap:
                    task_q.put((epoch, submitted,
                                list(batches[submitted])))
                    submitted += 1
                while delivered not in results:
                    try:
                        r_epoch, jid, status, payload = \
                            result_q.get(timeout=2.0)
                    except _queue.Empty:
                        # in-band "err" covers Python exceptions only;
                        # a worker killed by the OS reports nothing
                        dead = [p for p in procs if not p.is_alive()]
                        if dead:
                            codes = [p.exitcode for p in dead]
                            self._teardown_pool()
                            raise RuntimeError(
                                "DataLoader worker(s) exited "
                                "unexpectedly (exitcodes %s) — likely "
                                "killed (segfault/OOM)" % codes)
                        continue
                    if r_epoch != epoch:
                        if status == "ok":
                            _discard(payload, shm_mod)
                        continue
                    results[jid] = (status, payload)
                status, payload = results.pop(delivered)
                delivered += 1
                if status == "err":
                    raise RuntimeError("DataLoader worker failed: %s"
                                       % payload)
                yield _receive(payload, shm_mod)
        finally:
            # error or abandoned iteration: received-but-unread batches
            # must not strand their shm segments
            for status, payload in results.values():
                if status == "ok":
                    _discard(payload, shm_mod)
            self._iter_active = False

    def _threaded_iter(self):
        batches = list(self._batch_sampler)
        out_q: List[Optional[Any]] = [None] * len(batches)
        events = [threading.Event() for _ in batches]
        lock = threading.Lock()
        next_job = [0]
        # backpressure: workers stay at most `prefetch` batches ahead of the
        # consumer (ref: iter_prefetcher.h bounded double buffering)
        budget = threading.Semaphore(max(self._prefetch, self._num_workers))

        def worker():
            while True:
                budget.acquire()
                with lock:
                    j = next_job[0]
                    if j >= len(batches):
                        budget.release()
                        return
                    next_job[0] = j + 1
                try:
                    out_q[j] = ("ok", self._make_batch(batches[j]))
                except BaseException as e:  # surfaced to the consumer
                    out_q[j] = ("err", e)
                events[j].set()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self._num_workers)]
        for t in threads:
            t.start()
        try:
            for j in range(len(batches)):
                events[j].wait()
                status, payload = out_q[j]
                out_q[j] = None
                budget.release()
                if status == "err":
                    raise payload
                yield payload
        finally:
            # consumer stopped early (break/close/error): unpark any workers
            # blocked on the backpressure semaphore so the threads exit
            with lock:
                next_job[0] = len(batches)
            for _ in threads:
                budget.release()
