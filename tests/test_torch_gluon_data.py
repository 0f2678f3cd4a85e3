"""The port's ``gluon.data`` against the JAX package's: ``DataLoader``
with ``num_workers`` 0 and 2 (spawned processes over shared memory) and
the thread pool gives the same batches, in order, for the same seed;
the samplers (sequential, random under numpy's seeded global generator,
batch with keep / discard / rollover), ``ArrayDataset``,
``SimpleDataset``, ``RecordFileDataset``, ``vision.ImageRecordDataset``,
``ImageFolderDataset``, the synthetic MNIST / CIFAR and the
``vision.transforms`` give the same items (float32 to 1e-6, uint8
exactly).  Batches are host data.  ``pin_memory`` is held on the card
only (``tests/test_torch_io_on_card.py``); here, without a card, it
changes nothing."""
import io as _io

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import recordio as trio

from torch_data_cases import FailingDataset, SquareDataset

JD, TD = jmx.gluon.data, tmx.gluon.data


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _eq(a, b):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
        return
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(a, b)


def _loader_batches(D, dataset, seed=3, **kw):
    np.random.seed(seed)
    return [_np(b) for b in D.DataLoader(dataset, **kw)]


@pytest.mark.parametrize("kw", [
    dict(batch_size=5),
    dict(batch_size=5, shuffle=True, last_batch="discard"),
    dict(batch_size=4, shuffle=True, num_workers=2),
    dict(batch_size=6, num_workers=2, thread_pool=True, last_batch="keep"),
    dict(batch_size=4, pin_memory=True),
], ids=["w0", "w0_shuffle_discard", "w2_processes", "w2_threads",
        "pin_memory_without_a_card"])
def test_dataloader_matches_jax(kw):
    ds = SquareDataset(22)
    j = _loader_batches(JD, ds, **kw)
    t = _loader_batches(TD, ds, **kw)
    _eq(j, t)
    assert len(t) == len(TD.DataLoader(ds, **{k: v for k, v in kw.items()
                                              if k != "num_workers"}))


def test_dataloader_batches_are_host_ndarrays():
    b = next(iter(TD.DataLoader(TD.ArrayDataset(np.ones((4, 2)),
                                                np.arange(4)),
                                batch_size=2)))
    for a in b:
        assert isinstance(a, tmx.nd.NDArray) and a.context == tmx.cpu()


def test_dataloader_worker_error_propagates():
    with pytest.raises(RuntimeError, match="boom at 5"):
        list(TD.DataLoader(FailingDataset(10), batch_size=2, num_workers=2))


def test_dataloader_early_break_then_fresh_epoch():
    loader = TD.DataLoader(SquareDataset(20), batch_size=4, num_workers=2)
    for i, _ in enumerate(loader):
        if i == 1:
            break
    got = [_np(b) for b in loader]
    want = _loader_batches(JD, SquareDataset(20), batch_size=4)
    _eq(want, got)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match(last_batch):
    for D in (JD, TD):
        np.random.seed(7)
        rs = list(D.RandomSampler(13))
        D.seeded = rs
    assert JD.seeded == TD.seeded and sorted(TD.seeded) == list(range(13))
    del JD.seeded, TD.seeded
    assert list(TD.SequentialSampler(5)) == list(range(5))
    out = []
    for D in (JD, TD):
        bs = D.BatchSampler(D.SequentialSampler(10), 4, last_batch)
        out.append((list(bs), list(bs), len(bs)))
    assert out[0] == out[1]


def test_datasets_match():
    x = np.random.RandomState(0).rand(6, 3).astype(np.float32)
    y = np.arange(6)
    for D in (JD, TD):
        ds = D.ArrayDataset(x, y)
        D.items = [ds[i] for i in range(len(ds))]
        D.tf = [ds.transform_first(lambda v: v * 2)[i] for i in range(6)]
        D.flt = list(D.SimpleDataset(list(range(10))).filter(
            lambda v: v % 3 == 0))
        D.took = list(D.SimpleDataset(list(range(10))).take(4))
    for a, b in zip(JD.items + JD.tf, TD.items + TD.tf):
        _eq([np.asarray(v) for v in a], [np.asarray(v) for v in b])
    assert JD.flt == TD.flt and JD.took == TD.took
    for D in (JD, TD):
        del D.items, D.tf, D.flt, D.took


def _jpeg(img):
    from PIL import Image

    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=92)
    return buf.getvalue()


def test_record_datasets_match(tmp_path):
    prefix = str(tmp_path / "d")
    rng = np.random.RandomState(1)
    w = trio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(5):
        img = rng.randint(0, 256, (12, 10, 3)).astype(np.uint8)
        w.write_idx(i, trio.pack(trio.IRHeader(0, float(i), i, 0),
                                 _jpeg(img)))
    w.close()
    jr, tr = JD.RecordFileDataset(prefix + ".rec"), \
        TD.RecordFileDataset(prefix + ".rec")
    assert len(jr) == len(tr) == 5
    assert [jr[i] for i in range(5)] == [tr[i] for i in range(5)]
    for flag in (0, 1):
        jd = JD.vision.ImageRecordDataset(prefix + ".rec", flag=flag)
        td = TD.vision.ImageRecordDataset(prefix + ".rec", flag=flag)
        for i in range(5):
            (ji, jl), (ti, tl) = jd[i], td[i]
            _eq(_np(ji), _np(ti))
            assert float(jl) == float(tl)
            assert ti.context == tmx.cpu()


def test_image_folder_dataset_matches(tmp_path):
    rng = np.random.RandomState(2)
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for k in range(2):
            img = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
            (tmp_path / cls / ("%d.jpg" % k)).write_bytes(_jpeg(img))
    (tmp_path / "dog" / "notes.txt").write_text("skip me")
    jd = JD.vision.ImageFolderDataset(str(tmp_path))
    td = TD.vision.ImageFolderDataset(str(tmp_path))
    assert jd.synsets == td.synsets == ["cat", "dog"]
    assert len(jd) == len(td) == 4
    for i in range(4):
        _eq(_np(jd[i][0]), _np(td[i][0]))
        assert jd[i][1] == td[i][1]


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "CIFAR10",
                                  "CIFAR100"])
def test_synthetic_vision_sets_match(tmp_path, name):
    root = str(tmp_path / "none")  # no files: the synthetic stand-in
    jd = getattr(JD.vision, name)(root=root, train=False)
    td = getattr(TD.vision, name)(root=root, train=False)
    assert len(jd) == len(td)
    for i in (0, 7, len(td) - 1):
        _eq(_np(jd[i][0]), _np(td[i][0]))
        assert jd[i][1] == td[i][1]


def test_transforms_match():
    img = np.random.RandomState(4).randint(0, 256, (30, 26, 3)).astype(
        np.uint8)
    T = {p: p.gluon.data.vision.transforms for p in (jmx, tmx)}

    def arr(p, a):
        return p.nd.array(a, dtype=a.dtype) if p is jmx else \
            tmx.nd.array(a, ctx=tmx.cpu())

    cases = [
        lambda p: T[p].ToTensor()(arr(p, img)),
        lambda p: T[p].Cast("float64")(arr(p, img)),
        lambda p: T[p].Normalize((0.4, 0.5, 0.6), (0.2, 0.25, 0.3))(
            T[p].ToTensor()(arr(p, img))),
        lambda p: T[p].Resize(16)(arr(p, img.astype(np.float32))),
        lambda p: T[p].Resize((20, 40))(arr(p, img.astype(np.float32))),
        lambda p: T[p].CenterCrop(12)(arr(p, img)),
        lambda p: T[p].Compose([T[p].Resize(20), T[p].CenterCrop(16),
                                T[p].ToTensor()])(arr(p, img)),
        lambda p: T[p].RandomFlipLeftRight()(arr(p, img)),
        lambda p: T[p].RandomResizedCrop(14)(arr(p, img)),
    ]
    for k, case in enumerate(cases):
        for seed in (0, 1):
            np.random.seed(seed)
            j = _np(case(jmx))
            np.random.seed(seed)
            t = _np(case(tmx))
            assert j.dtype == t.dtype, k
            _eq(j, t)


def test_resize_uint8_differs_only_on_integer_boundaries():
    """On uint8 both packages resize in float32 and truncate: the two
    sum the weighted pixels in other orders, so an output whose exact
    value is an integer may land on either side of it.  Every other
    output is equal."""
    img = np.random.RandomState(4).randint(0, 256, (30, 26, 3)).astype(
        np.uint8)
    T = {p: p.gluon.data.vision.transforms for p in (jmx, tmx)}
    for size in (16, (20, 40), (7, 9)):
        j = T[jmx].Resize(size)(jmx.nd.array(img, dtype="uint8")).asnumpy()
        t = T[tmx].Resize(size)(tmx.nd.array(img, ctx=tmx.cpu())).asnumpy()
        assert j.dtype == t.dtype == np.uint8 and j.shape == t.shape
        sz = (size, size) if isinstance(size, int) else size
        exact = T[tmx]._resize_axis(T[tmx]._resize_axis(
            torch.from_numpy(img.astype(np.float64)), 0, sz[0]), 1,
            sz[1]).numpy()
        diff = np.abs(j.astype(int) - t.astype(int))
        assert diff.max() <= 1
        off = diff == 1
        assert (np.abs(exact[off] - np.round(exact[off])) < 1e-4).all()
        assert off.mean() < 0.01
