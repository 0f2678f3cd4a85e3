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
consumer (``TransformerTrainStep``, a Gluon loop) moves it to its own
device.  The io-bytes telemetry of the JAX package's fetch path is not
ported, nor are ``MNISTIter``, ``CSVIter``, ``ImageRecordIter`` and the
other iterators (ROADMAP A5).
"""
from __future__ import annotations

from collections import namedtuple
from typing import List

import numpy as _np

from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


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
