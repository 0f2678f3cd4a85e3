"""Data iterators: the ``DataIter`` contract, the in-memory
``NDArrayIter`` and the record-file image iterators.

Counterpart: ``mxnet_tpu/io.py`` ``DataDesc``, ``DataBatch``,
``DataIter``, ``NDArrayIter`` (:30-300), ``MNISTIter``, ``CSVIter``,
``ResizeIter``, ``PrefetchingIter`` (:303-680) and ``ImageRecordIter`` /
``ImageDetRecordIter`` (:680-1130), with their semantics:
``num_parts``/``part_index`` sharding (strided row or record slices,
disjoint and exhaustive), ``next_raw`` (host numpy batches: the
decode-pool worker path), the ``cursor`` that a checkpoint records for
exact resume, and the ``pad`` / ``discard`` / ``roll_over`` last-batch
modes.  ``ImageRecordIter`` runs the port's copy of the native decode
pipeline (``csrc/io/image_pipeline.cc``, built by ``_native``): the
same threads, the same per-record RNG and so the same batches as the
JAX package's for the same file and seed, with the uint8 fast path.
Departure: under an integer data dtype its ``provide_label`` declares
the labels' own dtype (float32), where the JAX package declares the
data dtype and its decode pool wraps class ids past 255.
Every fetch feeds the io-bytes counter (``mxnet_io_bytes_total``) of
``diagnostics``.

Departure: batches are host data.  The JAX iterator makes its batch
arrays with ``array(v[idx])`` on the current context, and the port's
current context is ``gpu(0)`` (the card by default), so the port builds
every batch on ``mx.cpu()`` instead, whatever the current context; the
consumer (``Module``, ``TransformerTrainStep``, a Gluon loop) moves it
to its own device, and ``io_pipeline.InputPipeline`` moves it to the
card ahead of the step.  While the profiler runs, every fetch stamps an
``<Iterator>::next`` io span and the ``io:batch_bytes`` counter, and
``PrefetchingIter`` the consumer's ``PrefetchingIter::wait`` on its
queue, under the JAX package's names.
``LibSVMIter`` streams a LibSVM file into one CSR triple on the host
and serves CSR batches (``ndarray.sparse``), never densified.
"""
from __future__ import annotations

import gzip
import os
import queue as _queue
import shutil
import struct
import threading
from collections import namedtuple
from typing import List, Optional

import numpy as _np

from . import diagnostics as _diag
from . import profiler as _profiler
from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "MNISTIter",
           "ImageRecordIter", "ImageDetRecordIter", "CSVIter", "LibSVMIter",
           "ResizeIter", "PrefetchingIter"]


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
            return _instrumented_fetch(
                self, lambda: DataBatch(self.getdata(), self.getlabel(),
                                  pad=self.getpad(),
                                  index=self.getindex()))
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


def _nbytes(a) -> int:
    from .ndarray import sparse as _sp

    if isinstance(a, _sp.BaseSparseNDArray):
        # the stored parts: a sparse batch is never densified
        return sum(t.numel() * t.element_size()
                   for t in a._parts().values())
    if isinstance(a, NDArray):
        return a._data.numel() * a._data.element_size()
    return int(getattr(a, "nbytes", 0) or 0)


def _batch_nbytes(batch) -> int:
    """Bytes materialized for one DataBatch (telemetry only)."""
    return sum(_nbytes(a) for a in list(batch.data) + list(batch.label))


def _instrumented_fetch(it, produce):
    """Input-pipeline telemetry shared by every iterator's fetch path:
    run ``produce()``, feed the batch's bytes to the io-bytes counter
    (``diagnostics.feed_io_bytes``, which never raises) and, while the
    profiler runs, stamp one ``<Iterator>::next`` io span on the
    calling thread plus the cumulative ``io:batch_bytes`` counter."""
    if not _profiler.is_running():
        batch = produce()
        _diag.feed_io_bytes(_batch_nbytes(batch))
        return batch
    start = _profiler._now_us()
    batch = produce()
    nbytes = _batch_nbytes(batch)
    _profiler.record_span(type(it).__name__ + "::next", start,
                          _profiler._now_us() - start, cat="io",
                          args={"bytes": nbytes})
    _profiler.record_bytes("io:batch_bytes", nbytes, cat="io")
    _diag.feed_io_bytes(nbytes)
    return batch


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


class LibSVMIter(DataIter):
    """LibSVM text -> CSR data batches (ref: src/io/iter_libsvm.cc:200
    LibSVMIter; counterpart ``mxnet_tpu/io.py:420-540``).

    Lines are ``<label> <index>:<value> ...`` with 0-based indices.  The
    file streams into one CSR triple, never densified, so a
    million-feature file loads in O(nnz).  Labels are dense, or CSR from
    a separate LibSVM label file.  A multi-dimensional ``data_shape``
    flattens to ``prod(shape)`` columns.  With ``round_batch`` the last
    batch wraps to the first rows and reports them as ``pad``.  Batches
    are CSR arrays on ``mx.cpu()`` (see the module docstring)."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=None, batch_size=1, round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        self._ncol = int(_np.prod([int(d) for d in data_shape]))
        labels, self._data = self._parse(data_libsvm, self._ncol)
        self._n = len(self._data[2]) - 1
        if label_libsvm is not None:
            lcol = int(_np.prod([int(d) for d in (label_shape or (1,))]))
            _, self._label_csr = self._parse(label_libsvm, lcol)
            self._lcol = lcol
            n_lab = len(self._label_csr[2]) - 1
            if n_lab != self._n:
                raise MXNetError("label file has %d rows, data file has %d"
                                 % (n_lab, self._n))
            self._label = None
        else:
            self._label_csr = None
            self._label = _np.asarray(labels, dtype=_np.float32)
        self._round_batch = round_batch
        self._cursor = 0

    @staticmethod
    def _parse(path, ncol):
        """Stream ``label idx:val ...`` lines -> (labels, (data, cols,
        indptr)) host arrays."""
        labels = []
        vals: list = []
        cols: list = []
        indptr = [0]
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                for tok in parts[1:]:
                    idx_s, _, val_s = tok.partition(":")
                    idx = int(idx_s)
                    if not 0 <= idx < ncol:
                        raise MXNetError(
                            "%s:%d: feature index %d outside [0, %d)"
                            % (path, lineno, idx, ncol))
                    cols.append(idx)
                    vals.append(float(val_s))
                indptr.append(len(vals))
        return labels, (_np.asarray(vals, _np.float32),
                        _np.asarray(cols, _np.int64),
                        _np.asarray(indptr, _np.int64))

    @staticmethod
    def _rows_to_csr(row_ids, triple, ncol):
        """The CSR matrix of rows ``row_ids`` of ``triple``: one gather
        of their stored elements."""
        from .ndarray import sparse as _sp

        d, c, p = triple
        starts = p[row_ids]
        counts = p[row_ids + 1] - starts
        indptr = _np.zeros(len(row_ids) + 1, _np.int64)
        _np.cumsum(counts, out=indptr[1:])
        pos = (_np.repeat(starts - indptr[:-1], counts)
               + _np.arange(indptr[-1], dtype=_np.int64))
        return _sp.csr_matrix((d[pos], c[pos], indptr),
                              shape=(len(row_ids), ncol), ctx=cpu())

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._ncol), "float32")]

    @property
    def provide_label(self):
        if self._label_csr is not None:
            return [DataDesc("label", (self.batch_size, self._lcol),
                             "float32")]
        return [DataDesc("label", (self.batch_size,), "float32")]

    def reset(self):
        self._cursor = 0

    def next(self) -> DataBatch:
        if self._cursor >= self._n:
            raise StopIteration
        return _instrumented_fetch(self, self._next_batch)

    def _next_batch(self) -> DataBatch:
        end = self._cursor + self.batch_size
        pad = 0
        if end > self._n:
            if not self._round_batch:
                raise StopIteration
            pad = end - self._n
        idx = _np.arange(self._cursor, end) % self._n
        self._cursor = end
        data = self._rows_to_csr(idx, self._data, self._ncol)
        if self._label_csr is not None:
            label = self._rows_to_csr(idx, self._label_csr, self._lcol)
        else:
            label = array(self._label[idx], ctx=cpu())
        return DataBatch([data], [label], pad=pad)


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
        if not _profiler.is_running():
            return self._queue.get()
        # consumer-side stall time: how long the train loop blocked on
        # the prefetch queue (the input-bound signal)
        start = _profiler._now_us()
        batch = self._queue.get()
        _profiler.record_span("PrefetchingIter::wait", start,
                              _profiler._now_us() - start, cat="io")
        return batch

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


class ImageRecordIter(DataIter):
    """Record-file image iterator backed by the native C++ pipeline
    (ref: src/io/iter_image_recordio_2.cc registered as ImageRecordIter at
    :724; threaded JPEG decode + augment + batch + bounded prefetch).

    Accepts the reference's main kwargs: ``path_imgrec``, ``data_shape``
    (c, h, w), ``batch_size``, ``shuffle``, ``rand_crop``, ``rand_mirror``,
    ``mean_r/g/b``, ``std_r/g/b``, ``resize`` (shorter side),
    ``label_width``, ``preprocess_threads``, ``round_batch``, ``seed``,
    ``prefetch_buffer``.
    """

    def __init__(self, path_imgrec, data_shape, batch_size, path_imgidx=None,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0,
                 resize=0, label_width=1, preprocess_threads=4,
                 round_batch=True, seed=0, prefetch_buffer=4,
                 data_name="data", label_name="softmax_label", ctx=None,
                 dtype="float32", num_parts=1, part_index=0, **kwargs):
        super().__init__(batch_size)
        import ctypes as _ct

        from . import _native

        # distributed/per-worker sharding (ref: dmlc InputSplit over
        # .rec shards, iter_image_recordio_2.cc part_index/num_parts):
        # the native pipeline reads one file start-to-end, so part
        # slicing materializes records [part_index::num_parts] into a
        # private temp .rec/.idx (compressed bytes copied, nothing
        # decoded) and opens THAT — disjoint and exhaustive across
        # parts, and what decode-pool workers shard on.
        self._shard_tmp = None
        if int(num_parts) > 1:
            path_imgrec, path_imgidx, self._shard_tmp = self._make_shard(
                str(path_imgrec), path_imgidx, int(num_parts),
                int(part_index))

        self._L = _native.lib()
        c, h, w = (int(s) for s in data_shape)
        self._shape = (c, h, w)
        self._label_width = int(label_width)
        self._data_name, self._label_name = data_name, label_name
        self._dtype = dtype
        mean = (_ct.c_float * 3)(mean_r, mean_g, mean_b)
        std = (_ct.c_float * 3)(std_r, std_g, std_b)
        # uint8 fast path: raw CHW bytes off the decoder, no host-side
        # float conversion, 4x smaller host->device transfer; only valid
        # when normalization is identity (normalize on device instead)
        self._native_u8 = (dtype == "uint8"
                           and mean_r == mean_g == mean_b == 0.0
                           and std_r == std_g == std_b == 1.0)
        handle = _ct.c_void_p()
        rc = self._L.MXTPUImageIterCreateEx(
            str(path_imgrec).encode(),
            str(path_imgidx).encode() if path_imgidx else b"",
            int(batch_size), c, h, w,
            int(bool(shuffle)), int(bool(rand_crop)), int(bool(rand_mirror)),
            mean, std, int(preprocess_threads), int(seed),
            self._label_width, int(resize), int(bool(round_batch)),
            int(prefetch_buffer), int(self._native_u8), _ct.byref(handle))
        if rc != 0:
            raise MXNetError(self._L.MXTPUImageIterGetLastError().decode())
        self._handle = handle
        n = _ct.c_size_t()
        self._L.MXTPUImageIterNumRecords(self._handle, _ct.byref(n))
        self.num_records = n.value
        self._first_batch = None
        self._views = {}

    @staticmethod
    def _make_shard(path_imgrec, path_imgidx, num_parts, part_index):
        """Copy records [part_index::num_parts] into a temp .rec/.idx
        pair (selective indexed reads when an .idx exists, sequential
        filter otherwise).  Bytes only — no decode."""
        import tempfile

        from . import recordio as _rio

        if not 0 <= part_index < num_parts:
            raise ValueError("part_index %d outside [0, %d)"
                             % (part_index, num_parts))
        tmpdir = tempfile.mkdtemp(prefix="mxrec_part%d_of%d_"
                                  % (part_index, num_parts))
        out_rec = os.path.join(tmpdir, "part.rec")
        out_idx = os.path.join(tmpdir, "part.idx")
        reader = writer = None
        try:
            writer = _rio.MXIndexedRecordIO(out_idx, out_rec, "w")
            n_out = 0
            if path_imgidx and os.path.exists(str(path_imgidx)):
                reader = _rio.MXIndexedRecordIO(str(path_imgidx),
                                                path_imgrec, "r")
                for key in reader.keys[part_index::num_parts]:
                    writer.write_idx(key, reader.read_idx(key))
                    n_out += 1
            else:
                reader = _rio.MXRecordIO(path_imgrec, "r")
                i = 0
                while True:
                    s = reader.read()
                    if s is None:
                        break
                    if i % num_parts == part_index:
                        writer.write_idx(i, s)
                        n_out += 1
                    i += 1
            if n_out == 0:
                raise MXNetError(
                    "ImageRecordIter: part %d/%d of %r holds zero "
                    "records" % (part_index, num_parts, path_imgrec))
        except BaseException:
            # nothing owns tmpdir yet (self._shard_tmp is assigned by
            # the caller only on success) — clean it here or it leaks
            for h in (reader, writer):
                try:
                    if h is not None:
                        h.close()
                except Exception:
                    pass
            shutil.rmtree(tmpdir, ignore_errors=True)
            raise
        reader.close()
        writer.close()
        return out_rec, out_idx, tmpdir

    @property
    def provide_data(self):
        return [DataDesc(self._data_name, (self.batch_size,) + self._shape,
                         self._dtype)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self._label_width == 1
                 else (self.batch_size, self._label_width))
        # the labels' own dtype: float32 under an integer data dtype
        # (the JAX package declares the data dtype here, so its decode
        # pool stores uint8 labels and class ids past 255 wrap)
        dt = self._dtype if _np.dtype(self._dtype).kind == "f" \
            else "float32"
        return [DataDesc(self._label_name, shape, dt)]

    def reset(self):
        self._L.MXTPUImageIterReset(self._handle)

    def _mapped_view(self, ptr, shape):
        """Cache the numpy view over each recycled C ring-buffer slot —
        ctypeslib.as_array construction costs ~1ms and the pipeline
        cycles through a fixed set of slots."""
        import ctypes as _ct

        addr = _ct.cast(ptr, _ct.c_void_p).value
        view = self._views.get((addr, shape))
        if view is None:
            view = _np.ctypeslib.as_array(ptr, shape=shape)
            self._views[(addr, shape)] = view
        return view

    def next(self) -> DataBatch:
        return _instrumented_fetch(self, self._next_batch)

    def _next_arrays(self):
        """One decoded batch as host numpy: ``(data, label, pad)``, the
        core shared by :meth:`next` and :meth:`next_raw` (decode-pool
        workers use the latter)."""
        import ctypes as _ct

        data_p = (_ct.POINTER(_ct.c_uint8)() if self._native_u8
                  else _ct.POINTER(_ct.c_float)())
        label_p = _ct.POINTER(_ct.c_float)()
        pad = _ct.c_int()
        rc = self._L.MXTPUImageIterNextEx(
            self._handle, _ct.byref(data_p), _ct.byref(label_p),
            _ct.byref(pad))
        if rc < 0:
            raise MXNetError(self._L.MXTPUImageIterGetLastError().decode())
        if rc == 0:
            raise StopIteration
        c, h, w = self._shape
        n = self.batch_size
        # fresh copies: the C ring-buffer slot is rewritten by the
        # decode threads once the next batch is requested, so it must
        # never back a returned batch
        dview = self._mapped_view(data_p, (n, c, h, w))
        lview = self._mapped_view(label_p, (n, self._label_width))
        data, label = dview.copy(), lview.copy()
        if self._label_width == 1:
            label = label.reshape(n)
        if self._dtype != "float32" and not self._native_u8:
            data = data.astype(self._dtype)
            if _np.dtype(self._dtype).kind == "f":
                # labels stay float for integer data dtypes (a uint8
                # image pipeline must not truncate class ids > 255)
                label = label.astype(self._dtype)
        return data, label, pad.value

    def _next_batch(self) -> DataBatch:
        data, label, pad = self._next_arrays()
        return DataBatch([array(data, ctx=cpu())],
                         [array(label, ctx=cpu())], pad=pad)

    def next_raw(self):
        """Host-only batch ``([data_np], [label_np], pad)``: no
        NDArray, no torch (the decode-pool worker path)."""
        data, label, pad = self._next_arrays()
        return [data], [label], pad

    def iter_next(self):
        raise NotImplementedError("ImageRecordIter uses next() directly")

    def __del__(self):
        if getattr(self, "_handle", None):
            try:
                self._L.MXTPUImageIterFree(self._handle)
            except Exception:
                pass
            self._handle = None
        tmp = getattr(self, "_shard_tmp", None)
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
            self._shard_tmp = None


class ImageDetRecordIter(DataIter):
    """Detection record iterator (ref: src/io/iter_image_det_recordio.cc,
    registered at :582 as Prefetcher(BatchLoader(Normalize(Parser)))).

    Batched label layout is the reference's exactly
    (iter_image_det_recordio.cc:455-463): each row is
    ``label_pad_width + 4`` floats filled with ``label_pad_value``, with
    ``[0]=channels [1]=rows [2]=cols [3]=len(raw_label)`` then the raw
    (augmented) label ``[header_width, object_width, extras..., objects]``
    from index 4 — the contract ``example/ssd/dataset/iterator.py
    DetRecordIter._get_batch`` parses.

    Augmentation rides :mod:`mxnet_tpu_torch.image.detection`'s pipeline (the
    SSD samplers re-derived from the paper's constraint spec).  The C
    iterator's flattened sampler knobs map onto it: ``min/max_crop_scales``
    become the crop area range, ``min_crop_overlaps`` the per-sampler
    min object coverage, ``rand_pad_prob``/``max_pad_scale`` the expand
    pad, ``rand_mirror_prob`` the flip; color-jitter magnitudes are taken
    from ``max_random_*``.  Knobs with no analogue in the Python samplers
    (crop_emit_mode, per-sampler trial counts) are accepted and ignored.
    """

    def __init__(self, path_imgrec, batch_size, data_shape=None,
                 path_imglist="", label_width=-1, label_pad_width=0,
                 label_pad_value=-1.0, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, resize_mode="force",
                 shuffle=False, seed=0, preprocess_threads=4,
                 rand_mirror_prob=0.0, min_crop_scales=(0.0,),
                 max_crop_scales=(1.0,), min_crop_aspect_ratios=(0.5,),
                 max_crop_aspect_ratios=(2.0,), min_crop_overlaps=(0.0,),
                 max_crop_overlaps=(1.0,), min_crop_sample_coverages=(0.0,),
                 max_crop_sample_coverages=(1.0,),
                 min_crop_object_coverages=(0.0,),
                 max_crop_object_coverages=(1.0,), max_crop_trials=(25,),
                 rand_pad_prob=0.0, max_pad_scale=1.0, fill_value=127,
                 random_hue_prob=0.0, max_random_hue=0,
                 random_saturation_prob=0.0, max_random_saturation=0,
                 random_illumination_prob=0.0, max_random_illumination=0,
                 random_contrast_prob=0.0, max_random_contrast=0.0,
                 inter_method=2, data_name="data", label_name="label",
                 **kwargs):
        super().__init__(batch_size)
        import random as _pyrandom

        from .image import detection as _det
        from . import recordio as _rio

        c, h, w = (int(s) for s in data_shape)
        self._shape = (c, h, w)
        self._data_name, self._label_name = data_name, label_name
        self._pad_value = float(label_pad_value)
        self._threads = max(1, int(preprocess_threads))
        self._shuffle = bool(shuffle)
        self._rng = _pyrandom.Random(seed)

        # ---- load records (bytes) + labels --------------------------
        self._records = []   # raw image bytes per record
        self._labels = []    # raw label float list per record
        rio = _rio.MXRecordIO(str(path_imgrec), "r")
        imglist_labels = self._read_imglist(path_imglist)
        i = 0
        while True:
            s = rio.read()
            if s is None:
                break
            header, img = _rio.unpack(s)
            if imglist_labels is not None:
                lab = imglist_labels.get(int(header.id))
                if lab is None:
                    lab = imglist_labels.get(i)
            else:
                lab = (list(_np.asarray(header.label).reshape(-1))
                       if header.flag > 0 else None)
            if lab is None or len(lab) < 7:
                raise MXNetError(
                    "ImageDetRecordIter: record %d carries no detection "
                    "label (need [header_width, object_width, ...objs])"
                    % i)
            self._records.append(img)
            self._labels.append([float(v) for v in lab])
            i += 1
        rio.close()
        if not self._records:
            raise MXNetError("ImageDetRecordIter: empty record file %r"
                             % path_imgrec)

        if label_pad_width is None or int(label_pad_width) <= 0:
            label_pad_width = max(len(l) for l in self._labels)
        self._pad_width = int(label_pad_width)

        # ---- augmenter pipeline (image/detection.py) ----------------
        crop_prob = 1.0 if any(float(s) > 0 for s in
                               _as_tuple(min_crop_scales)) or \
            any(float(o) > 0 for o in _as_tuple(min_crop_overlaps)) else 0.0
        area_range = [(float(lo) ** 2, float(hi) ** 2) for lo, hi in
                      zip(_as_tuple(min_crop_scales),
                          _as_tuple(max_crop_scales))]
        aspect_range = list(zip((float(v) for v in
                                 _as_tuple(min_crop_aspect_ratios)),
                                (float(v) for v in
                                 _as_tuple(max_crop_aspect_ratios))))
        if len(aspect_range) == 1:
            aspect_range = aspect_range * len(area_range)
        self._auglist = _det.CreateDetAugmenter(
            data_shape=(c, h, w),
            rand_crop=0,  # multi-sampler crop inserted below
            rand_pad=float(rand_pad_prob),
            rand_mirror=float(rand_mirror_prob) > 0,
            mean=_np.array([mean_r, mean_g, mean_b])
            if (mean_r or mean_g or mean_b) else None,
            std=_np.array([std_r, std_g, std_b])
            if (std_r != 1 or std_g != 1 or std_b != 1) else None,
            brightness=float(random_illumination_prob and
                             max_random_illumination / 255.0),
            contrast=float(random_contrast_prob and max_random_contrast),
            saturation=float(random_saturation_prob and
                             max_random_saturation / 255.0),
            hue=float(random_hue_prob and max_random_hue / 180.0),
            inter_method=int(inter_method) if int(inter_method) < 10 else 2,
            area_range=(1.0, max(1.0, float(max_pad_scale) ** 2)),
            pad_val=(fill_value,) * 3)
        if crop_prob > 0:
            crop_aug = _det.CreateMultiRandCropAugmenter(
                min_object_covered=[float(v) for v in
                                    _as_tuple(min_crop_overlaps)],
                aspect_ratio_range=aspect_range,
                area_range=area_range,
                max_attempts=int(_as_tuple(max_crop_trials)[0]),
                skip_prob=0)
            self._auglist.insert(0, crop_aug)
        self._order = list(range(len(self._records)))
        self._cursor = 0
        self.reset()

    @staticmethod
    def _read_imglist(path_imglist):
        if not path_imglist:
            return None
        out = {}
        with open(path_imglist) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) < 3:
                    continue
                out[int(float(parts[0]))] = [float(v) for v in parts[1:-1]]
        return out

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self._shape, "float32")]

    @property
    def provide_label(self):
        return [DataDesc(self._label_name,
                         (self.batch_size, self._pad_width + 4), "float32")]

    def reset(self):
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0

    def _process(self, idx):
        from .image.image import imdecode

        img = imdecode(self._records[idx]).asnumpy().astype(_np.uint8)
        raw = self._labels[idx]
        header_width = int(raw[0])
        obj_width = int(raw[1])
        objs = _np.array(raw[header_width:], dtype=_np.float32)
        objs = objs.reshape((-1, obj_width)) if objs.size else \
            _np.zeros((0, obj_width), _np.float32)
        src = img
        label = objs
        for aug in self._auglist:
            src, label = aug(src, label)
        dat = (src.asnumpy() if isinstance(src, NDArray)
               else _np.asarray(src)).astype(_np.float32)
        c, h, w = self._shape
        if dat.shape[:2] != (h, w):  # force mode guarantees this already
            from .image.image import imresize

            dat = _np.asarray(imresize(dat, w, h))
        chw = dat.transpose(2, 0, 1)
        out_label = _np.full((self._pad_width + 4,), self._pad_value,
                             _np.float32)
        flat = list(raw[:header_width]) + [float(v) for r in label
                                           for v in r]
        flat = flat[: self._pad_width]
        out_label[0] = c
        out_label[1] = h
        out_label[2] = w
        out_label[3] = len(flat)
        out_label[4: 4 + len(flat)] = flat
        return chw, out_label

    def next(self) -> DataBatch:
        n = len(self._order)
        if self._cursor >= n:
            raise StopIteration
        return _instrumented_fetch(self, self._next_batch)

    def _next_batch(self) -> DataBatch:
        n = len(self._order)
        idxs = []
        for k in range(self.batch_size):
            # round_batch semantics: wrap the tail with epoch-start
            # records (ref: iter_batchloader.h round_batch)
            idxs.append(self._order[(self._cursor + k) % n])
        # reference num_batch_padd: wrapped records of the final batch
        # are PADDING the consumer may discard (iter_batchloader.h)
        pad = max(0, self._cursor + self.batch_size - n)
        self._cursor += self.batch_size
        if self._threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            if not hasattr(self, "_pool"):
                self._pool = ThreadPoolExecutor(self._threads)
            results = list(self._pool.map(self._process, idxs))
        else:
            results = [self._process(i) for i in idxs]
        data = _np.stack([r[0] for r in results])
        label = _np.stack([r[1] for r in results])
        return DataBatch([array(data, ctx=cpu())],
                         [array(label, ctx=cpu())], pad=pad)


def _as_tuple(v):
    if isinstance(v, str):
        v = v.strip("()[] ")
        return tuple(float(x) for x in v.split(",") if x.strip())
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,)
