"""The port's ``mx.image`` against the JAX package's: decode, resize,
crops, borders and ``color_normalize`` give the same bytes (uint8) or
agree to 1e-6 (float32); every augmenter, deterministic or drawing from
the seeded host streams (``random`` and numpy's global generator, the
streams both packages draw from), gives the same result for the same
seed; random augmenters keep their invariants (shape, dtype, range, box
validity); ``ImageIter`` and ``ImageDetIter`` over a ``.rec`` (and an
image list) give the same batches.  Synthetic JPEGs of 40x30 to
100x80."""
import io as _io
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import image as jimg
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch import recordio as trio

F32_TOL = 1e-6


def _synth(h=64, w=48, c=3, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    chans = [(yy * (i + 1) + xx * (3 - i) + seed * 17) % 256
             for i in range(c)]
    return np.stack(chans, axis=2).astype(np.uint8)


def _jpeg(img):
    from PIL import Image

    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _eq(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL * 255)
    else:
        np.testing.assert_array_equal(a, b)


def _seeded(fn, seed=5):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def test_decode_and_read_same_bytes(tmp_path):
    raw = _jpeg(_synth())
    for kw in ({}, {"flag": 0}, {"to_rgb": False}):
        j, t = jimg.imdecode(raw, **kw), timg.imdecode(raw, **kw)
        assert isinstance(t, tmx.nd.NDArray)
        assert t.context == tmx.cpu()
        _eq(j, t)
    p = tmp_path / "x.jpg"
    p.write_bytes(raw)
    _eq(jimg.imread(str(p)), timg.imread(str(p)))
    # an NDArray buffer decodes too
    buf = tmx.nd.array(np.frombuffer(raw, np.uint8), ctx=tmx.cpu())
    _eq(jimg.imdecode(raw), timg.imdecode(buf))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_geometry_ops_match(dtype):
    img = _synth(100, 80).astype(dtype)
    pairs = [
        (lambda m: m.imresize(img, 40, 50), None),
        (lambda m: m.imresize(img, 120, 90, interp=1), None),
        (lambda m: m.imresize(img, 40, 50, interp=9), None),
        (lambda m: m.resize_short(img, 60), None),
        (lambda m: m.fixed_crop(img, 10, 20, 30, 40), None),
        (lambda m: m.fixed_crop(img, 10, 20, 30, 40, size=(16, 16)), None),
        (lambda m: m.center_crop(img, (32, 24))[0], None),
        (lambda m: m.copyMakeBorder(img, 1, 2, 3, 4, values=7), None),
        (lambda m: m.color_normalize(img, np.array([1.0, 2.0, 3.0]),
                                     np.array([2.0, 3.0, 4.0])), None),
    ]
    for fn, _ in pairs:
        _eq(fn(jimg), fn(timg))
    assert timg.scale_down((30, 40), (50, 50)) == \
        jimg.scale_down((30, 40), (50, 50)) == (30, 30)


def test_ndarray_in_ndarray_out_on_the_input_context():
    img = _synth(20, 16)
    t = timg.imresize(tmx.nd.array(img, ctx=tmx.cpu()), 8, 10)
    assert isinstance(t, tmx.nd.NDArray) and t.context == tmx.cpu()
    _eq(jimg.imresize(jmx.nd.array(img, dtype="uint8"), 8, 10), t)


DETERMINISTIC = {
    "resize": lambda m: m.ResizeAug(36),
    "force_resize": lambda m: m.ForceResizeAug((30, 20)),
    "center_crop": lambda m: m.CenterCropAug((32, 24)),
    "cast": lambda m: m.CastAug(),
    "normalize": lambda m: m.ColorNormalizeAug(np.array([1.0, 2.0, 3.0]),
                                               np.array([4.0, 5.0, 6.0])),
    "flip_always": lambda m: m.HorizontalFlipAug(1.1),
    "gray_always": lambda m: m.RandomGrayAug(1.1),
    "sequential": lambda m: m.SequentialAug([m.ResizeAug(40),
                                             m.CastAug()]),
}
RANDOM = {
    "random_crop": lambda m: m.RandomCropAug((24, 20)),
    "random_sized_crop": lambda m: m.RandomSizedCropAug((24, 24), 0.3,
                                                        (0.75, 1.33)),
    "flip": lambda m: m.HorizontalFlipAug(0.5),
    "brightness": lambda m: m.BrightnessJitterAug(0.3),
    "contrast": lambda m: m.ContrastJitterAug(0.3),
    "saturation": lambda m: m.SaturationJitterAug(0.3),
    "hue": lambda m: m.HueJitterAug(0.2),
    "color_jitter": lambda m: m.ColorJitterAug(0.2, 0.2, 0.2),
    "lighting": lambda m: m.LightingAug(0.1, np.array([55.46, 4.794, 1.148]),
                                        np.eye(3)),
    "random_gray": lambda m: m.RandomGrayAug(0.5),
}


@pytest.mark.parametrize("name", list(DETERMINISTIC) + list(RANDOM))
def test_augmenter_matches_jax_for_the_same_seed(name):
    make = {**DETERMINISTIC, **RANDOM}[name]
    img = _synth(50, 44)
    for seed in (1, 2, 3):
        j = _seeded(lambda: make(jimg)(img), seed)
        t = _seeded(lambda: make(timg)(img), seed)
        _eq(j, t)
    assert make(timg).dumps()


@pytest.mark.parametrize("name", list(RANDOM))
def test_random_augmenter_invariants(name):
    aug = RANDOM[name](timg)
    img = _synth(50, 44)
    for _ in range(6):
        out = _np(aug(img))
        if name.startswith("random_") and "crop" in name:
            assert out.shape[:2] == (aug.size[1], aug.size[0])
        elif name not in ("random_gray",):
            assert out.shape == img.shape
        assert np.isfinite(out.astype(np.float64)).all()
        if name == "flip":
            assert (out == img).all() or (out == img[:, ::-1]).all()


def test_create_augmenter_full_list_matches():
    kw = dict(resize=40, rand_crop=True, rand_mirror=True, mean=True,
              std=True, brightness=0.1, contrast=0.1, saturation=0.1,
              hue=0.1, pca_noise=0.1, rand_gray=0.5)
    img = _synth(70, 60)

    def run(m):
        out = img
        for a in m.CreateAugmenter((3, 32, 32), **kw):
            out = a(out)
        return out

    for seed in (0, 1):
        j, t = _seeded(lambda: run(jimg), seed), _seeded(lambda: run(timg),
                                                         seed)
        _eq(j, t)
        assert _np(t).shape == (32, 32, 3) and _np(t).dtype == np.float32
    assert [type(a).__name__ for a in timg.CreateAugmenter((3, 32, 32),
                                                           **kw)] == \
        [type(a).__name__ for a in jimg.CreateAugmenter((3, 32, 32), **kw)]


def _make_rec(tmp_path, n=12, det=False):
    rec_path = str(tmp_path / "data.rec")
    idx_path = str(tmp_path / "data.idx")
    w = trio.MXIndexedRecordIO(idx_path, rec_path, "w")
    for i in range(n):
        img = _synth(40 + i, 30 + i, seed=i)
        if det:
            label = np.array([2, 5, i % 4, 0.1, 0.2, 0.8, 0.9]
                             + ([1, 0.3, 0.1, 0.6, 0.5] if i % 2 else []),
                             np.float32)
            header = trio.IRHeader(0, label, i, 0)
        else:
            header = trio.IRHeader(0, float(i % 4), i, 0)
        w.write_idx(i, trio.pack(header, _jpeg(img)))
    w.close()
    return rec_path, idx_path


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        for b in it:
            out.append((_np(b.data[0]), _np(b.label[0]), b.pad))
        it.reset()
    return out


def _same_batches(a, b):
    assert len(a) == len(b) and a
    for (dj, lj, pj), (dt, lt, pt) in zip(a, b):
        _eq(dj, dt)
        _eq(lj, lt)
        assert pj == pt


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, rand_crop=True, rand_mirror=True),
    dict(last_batch_handle="roll_over", resize=32),
    dict(last_batch_handle="discard", num_parts=2, part_index=1),
    dict(use_idx=False),
], ids=["shuffle_aug", "roll_over", "discard_parts", "sequential_rec"])
def test_image_iter_over_rec_matches(tmp_path, kw):
    rec_path, idx_path = _make_rec(tmp_path, n=14)
    kw = dict(kw)
    use_idx = kw.pop("use_idx", True)
    args = dict(batch_size=4, data_shape=(3, 28, 28), path_imgrec=rec_path,
                path_imgidx=idx_path if use_idx else None, **kw)
    j = _seeded(lambda: _epochs(jimg.ImageIter(**args)), 9)
    t = _seeded(lambda: _epochs(timg.ImageIter(**args)), 9)
    _same_batches(j, t)
    assert t[0][0].shape == (4, 3, 28, 28)


def test_image_iter_imglist_matches(tmp_path):
    root = tmp_path / "imgs"
    root.mkdir()
    lines = []
    for i in range(6):
        (root / ("%d.jpg" % i)).write_bytes(_jpeg(_synth(36, 36, seed=i)))
        lines.append("%d\t%d\t%d.jpg" % (i, i % 3, i))
    lst = tmp_path / "list.lst"
    lst.write_text("\n".join(lines) + "\n")
    args = dict(batch_size=3, data_shape=(3, 24, 24),
                path_imglist=str(lst), path_root=str(root), shuffle=True)
    j = _seeded(lambda: _epochs(jimg.ImageIter(**args)))
    t = _seeded(lambda: _epochs(timg.ImageIter(**args)))
    _same_batches(j, t)


DET_AUGS = {
    "flip": lambda m: m.DetHorizontalFlipAug(0.5),
    "crop": lambda m: m.DetRandomCropAug(min_object_covered=0.3,
                                         area_range=(0.3, 1.0)),
    "pad": lambda m: m.DetRandomPadAug(area_range=(1.0, 2.0)),
    "select": lambda m: m.CreateMultiRandCropAugmenter(
        min_object_covered=[0.1, 0.5], area_range=(0.2, 1.0),
        skip_prob=0.2),
    "borrow": lambda m: m.DetBorrowAug(m.ForceResizeAug((20, 20))),
}
LABEL = np.array([[0, 0.1, 0.2, 0.5, 0.6], [1, 0.4, 0.3, 0.9, 0.8]],
                 np.float32)


@pytest.mark.parametrize("name", list(DET_AUGS))
def test_det_augmenter_matches_and_keeps_boxes_valid(name):
    img = _synth(60, 50)
    for seed in (0, 1, 2, 3):
        j = _seeded(lambda: DET_AUGS[name](jimg)(img, LABEL.copy()), seed)
        t = _seeded(lambda: DET_AUGS[name](timg)(img, LABEL.copy()), seed)
        _eq(j[0], t[0])
        np.testing.assert_array_equal(j[1], t[1])
        boxes = t[1][:, 1:5]
        assert ((boxes >= 0) & (boxes <= 1)).all()
        assert (boxes[:, 2] > boxes[:, 0]).all()
        assert (boxes[:, 3] > boxes[:, 1]).all()


def test_create_det_augmenter_matches():
    kw = dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True, mean=True,
              std=True, brightness=0.1, hue=0.1)
    img = _synth(60, 50)

    def run(m):
        src, lab = img, LABEL.copy()
        for a in m.CreateDetAugmenter((3, 32, 32), **kw):
            src, lab = a(src, lab)
        return src, lab

    for seed in (0, 1, 2):
        j, t = _seeded(lambda: run(jimg), seed), _seeded(lambda: run(timg),
                                                         seed)
        _eq(j[0], t[0])
        np.testing.assert_array_equal(j[1], t[1])
        assert _np(t[0]).shape == (32, 32, 3)


def test_image_det_iter_over_rec_matches(tmp_path):
    rec_path, idx_path = _make_rec(tmp_path, n=10, det=True)
    args = dict(batch_size=4, data_shape=(3, 32, 32), path_imgrec=rec_path,
                path_imgidx=idx_path, shuffle=True, rand_crop=0.5,
                rand_mirror=True)
    jit = _seeded(lambda: jimg.ImageDetIter(**args), 4)
    tit = _seeded(lambda: timg.ImageDetIter(**args), 4)
    assert tit.label_shape == jit.label_shape == (2, 5)
    random.seed(6)
    j = _epochs(jit)
    random.seed(6)
    t = _epochs(tit)
    _same_batches(j, t)
    assert t[0][1].shape == (4, 2, 5)
