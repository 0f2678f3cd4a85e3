"""The port's data iterators against the JAX package's: ``MNISTIter`` on
idx files the test writes (and its synthetic stand-in), ``CSVIter`` on
CSV files the test writes, ``ResizeIter`` and ``PrefetchingIter`` give
the same batches, pads and provides; the port's batches are host data."""
import gzip
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


def _write_idx(tmp_path, n=50, gz=False, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    img = str(tmp_path / ("img-idx3-ubyte" + suffix))
    lab = str(tmp_path / ("lab-idx1-ubyte" + suffix))
    with opener(img, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with opener(lab, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return img, lab


def _batches(it):
    out = []
    for b in it:
        out.append(([d.asnumpy() for d in b.data],
                    [lb.asnumpy() for lb in b.label], b.pad))
    return out


def _same(jit, tit, epochs=2):
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    assert [tuple(d) for d in tit.provide_label] == \
        [tuple(d) for d in jit.provide_label]
    for _ in range(epochs):
        jb, tb = _batches(jit), _batches(tit)
        assert len(tb) == len(jb) > 0
        for (jd, jl, jp), (td, tl, tp) in zip(jb, tb):
            assert tp == jp
            for a, b in zip(td + tl, jd + jl):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        jit.reset()
        tit.reset()


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_mnist_iter_reads_idx_files_like_the_jax_package(tmp_path, gz, flat,
                                                         shuffle):
    img, lab = _write_idx(tmp_path, gz=gz)
    its = []
    for mx in (jmx, tmx):
        np.random.seed(5)     # shuffle draws from numpy's global state
        its.append(mx.io.MNISTIter(image=img, label=lab, batch_size=16,
                                   flat=flat, shuffle=shuffle))
    # the two iterators' shuffles interleave: reseed before each epoch
    jit, tit = its
    for _ in range(2):
        np.random.seed(9)
        jit.reset()
        np.random.seed(9)
        tit.reset()
        jb, tb = _batches(jit), _batches(tit)
        assert len(tb) == len(jb) == 3      # 50 // 16, the tail discarded
        for (jd, jl, _), (td, tl, _) in zip(jb, tb):
            np.testing.assert_array_equal(td[0], jd[0])
            np.testing.assert_array_equal(tl[0], jl[0])
    assert tit.provide_data[0].shape == ((16, 784) if flat
                                         else (16, 1, 28, 28))


def test_mnist_iter_shards_and_synthesises(tmp_path):
    img, lab = _write_idx(tmp_path, n=40)
    kw = dict(image=img, label=lab, batch_size=4, shuffle=False,
              num_parts=3, part_index=1)
    _same(jmx.io.MNISTIter(**kw), tmx.io.MNISTIter(**kw))
    # without the files: the deterministic synthetic stand-in
    kw = dict(image=str(tmp_path / "t10k-missing"), batch_size=100,
              shuffle=False)
    _same(jmx.io.MNISTIter(**kw), tmx.io.MNISTIter(**kw), epochs=1)


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_reads_like_the_jax_package(tmp_path, round_batch):
    rng = np.random.RandomState(1)
    data = rng.uniform(-5, 5, (23, 6)).astype(np.float32)
    label = rng.randint(0, 3, (23, 1)).astype(np.float32)
    dpath, lpath = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dpath, data, delimiter=",")
    np.savetxt(lpath, label, delimiter=",")
    kw = dict(data_csv=dpath, data_shape=(2, 3), label_csv=lpath,
              label_shape=(1,), batch_size=5, round_batch=round_batch)
    jit, tit = jmx.io.CSVIter(**kw), tmx.io.CSVIter(**kw)
    _same(jit, tit)
    first = tit.next()
    assert first.data[0].context == tmx.cpu()
    np.testing.assert_allclose(first.data[0].asnumpy().reshape(5, 6),
                               data[:5], rtol=1e-6)


def test_resize_and_prefetching_iters_match():
    rng = np.random.RandomState(2)
    X = rng.uniform(size=(26, 3)).astype(np.float32)
    y = np.arange(26, dtype=np.float32)

    def make(mx):
        return mx.io.NDArrayIter(X, y, batch_size=4)

    _same(jmx.io.ResizeIter(make(jmx), 9), tmx.io.ResizeIter(make(tmx), 9))
    jp = jmx.io.PrefetchingIter(make(jmx))
    tp = tmx.io.PrefetchingIter(make(tmx))
    _same(jp, tp, epochs=3)
    assert tp.provide_data[0].shape == (4, 3)
