"""Bucketing data iterator for variable-length sequences (ref:
python/mxnet/rnn/io.py).

Counterpart: ``mxnet_tpu/rnn/io.py``, a copy.  Sentences are grouped
into a small set of length buckets; ``BucketingModule`` binds one
executor per bucket, all sharing one parameter set.  The shuffles draw
from Python's ``random`` and numpy's global stream, as the reference's
do, so the same seeds give the JAX package's batches.  Batches are
host arrays (``mx.cpu()``): a module copies them onto its context."""
from __future__ import annotations

import bisect
import random as _pyrandom

import numpy as _np

from ..base import MXNetError
from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key="\n",
                     start_label=0, unknown_token=None):
    """Map lists of tokens to lists of int ids, growing ``vocab`` (ref:
    rnn/io.py encode_sentences:33)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    if unknown_token:
                        word = unknown_token
                    else:
                        raise MXNetError("Unknown token %s" % word)
                else:
                    if idx == invalid_label:
                        idx += 1
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Batches of padded sentences bucketed by length; label is the input
    shifted one step left (ref: rnn/io.py BucketSentenceIter:71)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size=batch_size)
        if not buckets:
            counts = _np.bincount([len(s) for s in sentences])
            buckets = [i for i, j in enumerate(counts)
                       if j >= batch_size]
        buckets.sort()

        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = _np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[: len(sent)] = sent
            self.data[buck].append(buff)
        # empty buckets must still be 2-D so reset()'s label shift works
        self.data = [_np.asarray(i, dtype=dtype).reshape(-1, blen)
                     for i, blen in zip(self.data, buckets)]
        if ndiscard:
            import logging

            logging.warning("discarded %d sentences longer than the largest "
                            "bucket.", ndiscard)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)

        shape0 = (batch_size, self.default_bucket_key) \
            if self.major_axis == 0 else (self.default_bucket_key, batch_size)
        self.provide_data = [DataDesc(name=self.data_name, shape=shape0,
                                      layout=layout)]
        self.provide_label = [DataDesc(name=self.label_name, shape=shape0,
                                       layout=layout)]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1, batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        from .. import ndarray as nd

        self.curr_idx = 0
        _pyrandom.shuffle(self.idx)
        for buck in self.data:
            _np.random.shuffle(buck)

        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = _np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(nd.array(buck, ctx=cpu(), dtype=self.dtype))
            self.ndlabel.append(nd.array(label, ctx=cpu(),
                                         dtype=self.dtype))

    def next(self):
        from .. import ndarray as nd

        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1

        if self.major_axis == 1:
            data = nd.SwapAxis(self.nddata[i][j:j + self.batch_size],
                               dim1=0, dim2=1)
            label = nd.SwapAxis(self.ndlabel[i][j:j + self.batch_size],
                                dim1=0, dim2=1)
        else:
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]

        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[i],
            provide_data=[DataDesc(name=self.data_name, shape=data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(name=self.label_name, shape=label.shape,
                                    layout=self.layout)],
        )
