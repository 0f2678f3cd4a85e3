"""The port's record iterators against the JAX package's on the same
files and seeds: ``ImageRecordIter`` (the native decode pipeline) and
``ImageDetRecordIter`` give bitwise-equal batches, labels and pads over
a whole epoch and into the next.  Covered: shuffle, ``rand_crop``,
``rand_mirror``, mean/std, ``resize``, the uint8 fast path,
``preprocess_threads`` 1 and 3 (the native RNG is per record, so the
thread count changes nothing), ``label_width``, ``next_raw``, and
``num_parts`` sharding (disjoint and exhaustive, and equal part for
part).  Records are seeded-numpy JPEGs of 40x48 written by the port's
``recordio``."""
import random

import numpy as np
import pytest

import mxnet_tpu.io as jio
import mxnet_tpu_torch.io as tio
from mxnet_tpu_torch import recordio as trio

N_REC = 30


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    d = tmp_path_factory.mktemp("recs")
    prefix = str(d / "data")
    rng = np.random.RandomState(3)
    w = trio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(N_REC):
        img = rng.randint(0, 256, (40, 48, 3)).astype(np.uint8)
        label = np.array([i, i % 5, 2.0 * i], np.float32)
        w.write_idx(i, trio.pack_img(trio.IRHeader(0, label, i, 0), img,
                                     quality=90))
    w.close()
    return prefix


@pytest.fixture(scope="module")
def det_rec(tmp_path_factory):
    """Detection records: [header_width=2, object_width=5, objects...]."""
    d = tmp_path_factory.mktemp("det")
    path = str(d / "det.rec")
    rng = np.random.RandomState(4)
    w = trio.MXRecordIO(path, "w")
    for i in range(12):
        img = rng.randint(0, 256, (36, 44, 3)).astype(np.uint8)
        objs = []
        for k in range(1 + i % 3):
            x0, y0 = rng.uniform(0.0, 0.5, 2)
            objs += [float(k), x0, y0, x0 + 0.3, y0 + 0.4]
        label = np.array([2, 5] + objs, np.float32)
        w.write(trio.pack_img(trio.IRHeader(0, label, i, 0), img,
                              quality=90))
    w.close()
    return path


def _epoch(it, limit=100):
    out = []
    for _ in range(limit):
        try:
            b = it.next()
        except StopIteration:
            return out
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    raise AssertionError("epoch did not end")


def _same_epochs(a, b):
    assert len(a) == len(b) and a
    for (dj, lj, pj), (dt, lt, pt) in zip(a, b):
        assert dj.dtype == dt.dtype and dj.shape == dt.shape
        np.testing.assert_array_equal(dj, dt)
        np.testing.assert_array_equal(lj, lt)
        assert pj == pt


ITER_CASES = {
    "plain": dict(),
    "shuffle_crop_mirror_t1": dict(shuffle=True, rand_crop=True,
                                   rand_mirror=True, preprocess_threads=1,
                                   seed=7),
    "shuffle_crop_mirror_t3": dict(shuffle=True, rand_crop=True,
                                   rand_mirror=True, preprocess_threads=3,
                                   seed=7),
    "mean_std_resize": dict(mean_r=123.0, mean_g=117.0, mean_b=104.0,
                            std_r=58.0, std_g=57.0, std_b=57.5, resize=36,
                            preprocess_threads=3),
    "uint8": dict(dtype="uint8", rand_crop=True, rand_mirror=True, seed=2),
    "uint8_no_round_batch": dict(dtype="uint8", round_batch=False),
    "label_width3": dict(label_width=3, shuffle=True, seed=1),
    "no_idx": dict(path_imgidx=None),
}


@pytest.mark.parametrize("case", list(ITER_CASES))
def test_image_record_iter_matches_jax(rec, case):
    kw = dict(path_imgrec=rec + ".rec", path_imgidx=rec + ".idx",
              data_shape=(3, 32, 32), batch_size=8)
    kw.update(ITER_CASES[case])
    j, t = jio.ImageRecordIter(**kw), tio.ImageRecordIter(**kw)
    _same_epochs(_epoch(j), _epoch(t))
    j.reset()
    t.reset()
    _same_epochs(_epoch(j), _epoch(t))  # the second epoch's draws too
    assert t.provide_data[0].shape == (8, 3, 32, 32)
    assert t.provide_data[0].dtype == np.dtype(kw.get("dtype", "float32"))


def test_next_raw_matches_next(rec):
    kw = dict(path_imgrec=rec + ".rec", data_shape=(3, 32, 32),
              batch_size=8, dtype="uint8", shuffle=True, seed=5)
    a, b = tio.ImageRecordIter(**kw), tio.ImageRecordIter(**kw)
    for _ in range(3):
        (d,), (lab,), pad = a.next_raw()
        nb = b.next()
        assert isinstance(d, np.ndarray)
        np.testing.assert_array_equal(d, nb.data[0].asnumpy())
        np.testing.assert_array_equal(lab, nb.label[0].asnumpy())
        assert pad == nb.pad
        assert nb.data[0].context.device_type == "cpu"


@pytest.mark.parametrize("parts", [2, 3])
def test_num_parts_disjoint_exhaustive_and_equal(rec, parts):
    seen = []
    for p in range(parts):
        kw = dict(path_imgrec=rec + ".rec", path_imgidx=rec + ".idx",
                  data_shape=(3, 32, 32), batch_size=4, num_parts=parts,
                  part_index=p, round_batch=False, dtype="uint8")
        t, j = tio.ImageRecordIter(**kw), jio.ImageRecordIter(**kw)
        et = _epoch(t)
        _same_epochs(_epoch(j), et)
        for _d, lab, pad in et:
            ids = lab[:len(lab) - pad].astype(int).tolist()
            assert all(i % parts == p for i in ids)
            seen += ids
    assert sorted(seen) == list(range(N_REC))


def test_num_parts_rejects_bad_index(rec):
    with pytest.raises(ValueError):
        tio.ImageRecordIter(path_imgrec=rec + ".rec", data_shape=(3, 32, 32),
                            batch_size=4, num_parts=2, part_index=2)


DET_CASES = {
    "mirror_t1": dict(rand_mirror_prob=0.5, preprocess_threads=1,
                      shuffle=True, seed=3),
    "crop_pad_t1": dict(min_crop_scales=(0.5,), max_crop_scales=(1.0,),
                        min_crop_overlaps=(0.3,), rand_pad_prob=0.5,
                        max_pad_scale=1.5, preprocess_threads=1),
    "mean_std_t3": dict(mean_r=120.0, mean_g=110.0, mean_b=100.0,
                        std_r=60.0, std_g=50.0, std_b=40.0,
                        preprocess_threads=3, label_pad_width=24),
}


@pytest.mark.parametrize("case", list(DET_CASES))
def test_image_det_record_iter_matches_jax(det_rec, case):
    kw = dict(path_imgrec=det_rec, batch_size=5, data_shape=(3, 32, 32))
    kw.update(DET_CASES[case])
    out = []
    for mod in (jio, tio):
        random.seed(11)  # the augmenters' host stream
        it = mod.ImageDetRecordIter(**kw)
        ep = _epoch(it)
        it.reset()
        out.append(ep + _epoch(it))
    _same_epochs(*out)
    data, label, _pad = out[1][0]
    assert data.shape == (5, 3, 32, 32)
    assert label.shape[1] == it.provide_label[0].shape[1]
    assert (label[:, :3] == [3, 32, 32]).all()
