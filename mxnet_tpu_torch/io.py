"""Data iterators: the ``DataIter`` contract and the in-memory
``NDArrayIter``.

Counterpart: ``mxnet_tpu/io.py`` ``DataDesc``, ``DataBatch``,
``DataIter`` and ``NDArrayIter`` (:30-300), with their semantics:
``num_parts``/``part_index`` sharding (strided row slices, disjoint and
exhaustive), ``next_raw`` (host numpy batches), the ``cursor`` that a
checkpoint records for exact resume, and the ``pad`` / ``discard`` /
``roll_over`` last-batch modes.

Departure: batches are host data.  The JAX iterator makes its batch
arrays with ``array(v[idx])`` on the current context, and the port's
current context is ``gpu(0)`` (the card by default), so the port builds
every batch on ``mx.cpu()`` instead, whatever the current context; the
consumer (``Module``, ``TransformerTrainStep``, a Gluon loop) moves it
to its own device.  ``MNISTIter``, ``CSVIter``, ``ResizeIter`` and
``PrefetchingIter`` are the JAX package's (:303-680).  The io-bytes
telemetry of its fetch path and the ``PrefetchingIter::wait`` profiler
span wait for ROADMAP A11; ``LibSVMIter`` (sparse storage) and the
record iterators ``ImageRecordIter`` / ``ImageDetRecordIter`` (which
need ``recordio``) for A10.
"""
from __future__ import annotations

import gzip
import os
import queue as _queue
import struct
import threading
from collections import namedtuple
from typing import List, Optional

import numpy as _np

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "MNISTIter",
           "CSVIter", "ResizeIter", "PrefetchingIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """A (name, shape) 2-tuple carrying dtype/layout as attributes."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = _np.dtype(dtype)
        ret.layout = layout
        return ret

    def __getnewargs__(self):
        # keep dtype/layout across pickle/copy
        return (self.name, self.shape, self.dtype, self.layout)


class DataBatch:
    """One batch: ``data`` and ``label`` lists, the pad count, the
    sample index."""

    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data if isinstance(data, (list, tuple)) else [data]
        if label is None:
            self.label = []
        else:
            self.label = label if isinstance(label, (list, tuple)) \
                else [label]
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        return "DataBatch: data shapes %s label shapes %s" % (
            [d.shape for d in self.data], [lb.shape for lb in self.label])


class DataIter:
    """The iterator contract: ``reset``, ``iter_next``, ``getdata``,
    ``getlabel``, ``getpad``, ``getindex``; ``next`` builds a
    :class:`DataBatch` or raises ``StopIteration``."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def hard_reset(self):
        """Ignore any roll-over state and restart from the beginning."""
        self.reset()

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, allow_empty, default_name):
    """Normalise input data to a list of (name, numpy array)."""
    if data is None:
        if not allow_empty:
            raise ValueError("data cannot be None")
        return []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise ValueError("empty data")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {default_name + "_%d" % i: d for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        v = v.asnumpy() if isinstance(v, NDArray) else _np.asarray(v)
        out.append((k, v))
    return out


def _shard_arrays(pairs, num_parts, part_index):
    """The ``num_parts``/``part_index`` idiom: the strided row slice
    ``[part_index::num_parts]`` (parts are disjoint and exhaustive)."""
    num_parts, part_index = int(num_parts), int(part_index)
    if num_parts <= 1:
        return pairs
    if not 0 <= part_index < num_parts:
        raise ValueError("part_index %d outside [0, %d)"
                         % (part_index, num_parts))
    return [(k, v[part_index::num_parts]) for k, v in pairs]


class NDArrayIter(DataIter):
    """In-memory iterator over a dict/list of arrays: shuffle, and the
    ``pad`` / ``discard`` / ``roll_over`` last batch.  Batches are
    NDArrays on ``mx.cpu()`` (see the module docstring)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", num_parts=1, part_index=0):
        super().__init__(batch_size)
        self.data = _shard_arrays(
            _init_data(data, allow_empty=False, default_name=data_name),
            num_parts, part_index)
        self.label = _shard_arrays(
            _init_data(label, allow_empty=True, default_name=label_name),
            num_parts, part_index)
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._shuffled_idx = _np.arange(self.num_data)
        self.reset()

    @property
    def provide_data(self) -> List[DataDesc]:
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self) -> List[DataDesc]:
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self._shuffled_idx)
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def hard_reset(self):
        """Ignore roll over data and set to start."""
        self.cursor = -self.batch_size

    def iter_next(self) -> bool:
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _batch_idx(self):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            return self._shuffled_idx[self.cursor:end]
        # pad by wrapping
        return _np.concatenate([
            self._shuffled_idx[self.cursor:],
            self._shuffled_idx[:end - self.num_data],
        ])

    def _take(self, arrays):
        idx = self._batch_idx()
        return [array(v[idx], ctx=cpu()) for _, v in arrays]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def next_raw(self):
        """Host-only batch: ``(data_np_list, label_np_list, pad)`` with
        plain numpy arrays."""
        if not self.iter_next():
            raise StopIteration
        idx = self._batch_idx()
        data = [_np.ascontiguousarray(v[idx]) for _, v in self.data]
        label = [_np.ascontiguousarray(v[idx]) for _, v in self.label]
        return data, label, self.getpad()

    def getpad(self) -> int:
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


def _read_idx_images(path):
    with (gzip.open(path) if path.endswith(".gz") else open(path, "rb")) as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        data = _np.frombuffer(f.read(), dtype=_np.uint8)
        return data.reshape(num, rows, cols)


def _read_idx_labels(path):
    with (gzip.open(path) if path.endswith(".gz") else open(path, "rb")) as f:
        magic, num = struct.unpack(">II", f.read(8))
        return _np.frombuffer(f.read(), dtype=_np.uint8)


def _synthetic_mnist(n, seed):
    """Deterministic MNIST-like set: images are class-dependent Gaussian
    blobs, linearly separable enough for LeNet/MLP convergence tests.
    Used when the idx files are absent (zero-egress environments)."""
    rng = _np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(_np.uint8)
    images = _np.zeros((n, 28, 28), dtype=_np.float32)
    # each class lights up a distinct 8x8 patch + noise
    for cls in range(10):
        mask = labels == cls
        r, c = divmod(cls, 4)
        patch = _np.zeros((28, 28), dtype=_np.float32)
        patch[2 + r * 9 : 10 + r * 9, 2 + c * 6 : 10 + c * 6] = 200.0
        images[mask] = patch
    images += rng.uniform(0, 55, size=images.shape).astype(_np.float32)
    return images.astype(_np.uint8), labels


class MNISTIter(DataIter):
    """ref: src/io/iter_mnist.cc MNISTIter — reads idx files; synthesises a
    deterministic stand-in dataset when files are missing."""

    def __init__(self, image="train-images-idx3-ubyte", label="train-labels-idx1-ubyte",
                 batch_size=128, shuffle=True, flat=False, seed=0,
                 silent=False, num_parts=1, part_index=0, **kwargs):
        super().__init__(batch_size)
        if os.path.exists(image) and os.path.exists(label):
            images = _read_idx_images(image).astype(_np.float32) / 255.0
            labels = _read_idx_labels(label).astype(_np.float32)
        else:
            n = 6000 if "train" in image else 1000
            img_u8, lab = _synthetic_mnist(n, seed=42 if "train" in image else 43)
            images = img_u8.astype(_np.float32) / 255.0
            labels = lab.astype(_np.float32)
        if num_parts > 1:  # distributed sharding (ref: iter_mnist.cc part_index)
            images = images[part_index::num_parts]
            labels = labels[part_index::num_parts]
        if flat:
            images = images.reshape(len(images), -1)
        else:
            images = images.reshape(len(images), 1, 28, 28)
        self._inner = NDArrayIter(images, labels, batch_size, shuffle=shuffle,
                                  last_batch_handle="discard")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def next_raw(self):
        return self._inner.next_raw()

    def iter_next(self):
        return self._inner.iter_next()


class CSVIter(DataIter):
    """ref: src/io/iter_csv.cc.  ``num_parts``/``part_index`` shard rows
    per rank/worker like the other iterators (strided, disjoint,
    exhaustive)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, num_parts=1, part_index=0,
                 **kwargs):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=_np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        self._inner = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            label_name="label", num_parts=num_parts, part_index=part_index,
        )

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def next_raw(self):
        return self._inner.next_raw()


class ResizeIter(DataIter):
    """Resize an iterator to a fixed number of batches (ref: io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration


class PrefetchingIter(DataIter):
    """Background-thread prefetch (ref: src/io/iter_prefetcher.h
    PrefetcherIter — dmlc::ThreadedIter's double buffering, in Python).

    The worker only blocks on the queue with a timeout and re-checks the
    stop flag, so ``reset`` can always drain + join without a stale batch or
    end-sentinel leaking into the next epoch.
    """

    def __init__(self, iters, rename_data=None, rename_label=None, depth=2):
        iters = iters if isinstance(iters, (list, tuple)) else [iters]
        if len(iters) != 1:
            raise MXNetError("PrefetchingIter supports a single backing iter")
        self.iter = iters[0]
        super().__init__(self.iter.batch_size)
        self._depth = depth
        self._queue: _queue.Queue = _queue.Queue(maxsize=depth)
        self._thread = None
        self._stop = threading.Event()
        self.current_batch: Optional[DataBatch] = None
        self._start()

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label

    def _start(self):
        def worker():
            while not self._stop.is_set():
                try:
                    batch = self.iter.next()
                except StopIteration:
                    batch = None
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.05)
                        break
                    except _queue.Full:
                        continue
                if batch is None:
                    return

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def reset(self):
        self._stop.set()
        if self._thread is not None:
            while self._thread.is_alive():
                try:
                    self._queue.get_nowait()
                except _queue.Empty:
                    pass
                self._thread.join(timeout=0.05)
        self._queue = _queue.Queue(maxsize=self._depth)  # drop any stale items
        self._stop.clear()
        self.current_batch = None
        self.iter.reset()
        self._start()

    def _fetch(self) -> Optional[DataBatch]:
        return self._queue.get()

    def next(self) -> DataBatch:
        if self.current_batch is not None:
            batch, self.current_batch = self.current_batch, None
            return batch
        batch = self._fetch()
        if batch is None:
            raise StopIteration
        return batch

    def iter_next(self) -> bool:
        if self.current_batch is None:
            self.current_batch = self._fetch()
        return self.current_batch is not None

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad
