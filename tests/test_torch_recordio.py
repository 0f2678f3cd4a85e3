"""The port's ``recordio`` against the JAX package's: a ``.rec`` / ``.idx``
written by either package is read by the other byte for byte (plain,
indexed, payloads holding the wire magic), ``pack`` / ``unpack`` give the
same bytes and headers (scalar and array labels), ``pack_img`` /
``unpack_img`` the same encoded and decoded bytes, and an open reader
pickles while an open writer refuses.  The cases mirror
``tests/test_recordio.py``.  Exact equality throughout."""
import pickle
import struct

import numpy as np
import pytest

import mxnet_tpu.recordio as jrio
import mxnet_tpu_torch.recordio as trio

PKGS = {"jax": jrio, "torch": trio}
DIRECTIONS = [("jax", "torch"), ("torch", "jax")]
MAGIC = struct.pack("<I", 0xced7230a)
PAYLOADS = [b"hello", b"", b"x" * 1000, b"odd123", MAGIC,
            b"ab" + MAGIC + b"cd", MAGIC * 3, b"z" * 7 + MAGIC]


def _read_all(r):
    out = []
    while True:
        rec = r.read()
        if rec is None:
            return out
        out.append(rec)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_rec_crosses_packages(tmp_path, writer, reader):
    path = str(tmp_path / "a.rec")
    w = PKGS[writer].MXRecordIO(path, "w")
    for p in PAYLOADS:
        w.write(p)
    w.close()
    r = PKGS[reader].MXRecordIO(path, "r")
    assert _read_all(r) == PAYLOADS
    r.reset()
    assert r.read() == PAYLOADS[0]
    r.close()


def test_both_packages_write_the_same_bytes(tmp_path):
    files = {}
    for name, pkg in PKGS.items():
        rec, idx = str(tmp_path / (name + ".rec")), str(tmp_path / (name + ".idx"))
        w = pkg.MXIndexedRecordIO(idx, rec, "w")
        for i, p in enumerate(PAYLOADS):
            w.write_idx(i, p)
        w.close()
        files[name] = (open(rec, "rb").read(), open(idx).read())
    assert files["jax"] == files["torch"]


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_indexed_seeks_cross_packages(tmp_path, writer, reader):
    rec, idx = str(tmp_path / "b.rec"), str(tmp_path / "b.idx")
    w = PKGS[writer].MXIndexedRecordIO(idx, rec, "w")
    for i in range(20):
        w.write_idx(i, b"record-%d" % i)
    w.close()
    r = PKGS[reader].MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == list(range(20))
    for i in [7, 0, 19, 3, 3]:
        assert r.read_idx(i) == b"record-%d" % i
    r.close()


@pytest.mark.parametrize("label", [3.0, np.float32(3.0),
                                   np.array([1.0, 2.5, -3.0], np.float32),
                                   [4.0, 5.0]],
                         ids=["float", "np_scalar", "array", "list"])
def test_pack_unpack_same_bytes(label):
    h = (0, label, 42, 7)
    s_j = jrio.pack(jrio.IRHeader(*h), b"payload")
    s_t = trio.pack(trio.IRHeader(*h), b"payload")
    assert s_j == s_t
    hj, pj = jrio.unpack(s_t)
    ht, pt = trio.unpack(s_j)
    assert pj == pt == b"payload"
    assert (hj.flag, hj.id, hj.id2) == (ht.flag, ht.id, ht.id2)
    np.testing.assert_array_equal(np.asarray(hj.label), np.asarray(ht.label))


@pytest.mark.parametrize("fmt,quality", [(".jpg", 90), (".png", 95)])
def test_pack_img_unpack_img_same_bytes(fmt, quality):
    yy, xx = np.mgrid[0:32, 0:24]
    img = np.stack([yy * 8, xx * 10, (yy + xx) * 4], -1).astype(np.uint8)
    h = (0, np.array([1.0, 2.0], np.float32), 3, 0)
    s_j = jrio.pack_img(jrio.IRHeader(*h), img, quality=quality, img_fmt=fmt)
    s_t = trio.pack_img(trio.IRHeader(*h), img, quality=quality, img_fmt=fmt)
    assert s_j == s_t
    for iscolor in (-1, 0, 1):
        hj, dj = jrio.unpack_img(s_t, iscolor)
        ht, dt = trio.unpack_img(s_j, iscolor)
        assert dj.dtype == dt.dtype == np.uint8
        np.testing.assert_array_equal(dj, dt)
        np.testing.assert_array_equal(hj.label, ht.label)
    _, decoded = trio.unpack_img(s_t)
    assert decoded.shape == (32, 24, 3)
    assert np.abs(decoded.astype(int) - img.astype(int)).mean() < 12


def test_pickle_reader_and_refuse_open_writer(tmp_path):
    path = str(tmp_path / "p.rec")
    w = trio.MXRecordIO(path, "w")
    w.write(b"keep-me")
    with pytest.raises(Exception):
        pickle.dumps(w)  # reopening a writer would truncate the file
    w.close()
    r = trio.MXRecordIO(path, "r")
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.read() == b"keep-me"
    assert trio.MXRecordIO(path, "r").read() == b"keep-me"
    idx = str(tmp_path / "p.idx")
    w = trio.MXIndexedRecordIO(idx, str(tmp_path / "q.rec"), "w")
    w.write_idx(5, b"five")
    w.close()
    r = pickle.loads(pickle.dumps(
        trio.MXIndexedRecordIO(idx, str(tmp_path / "q.rec"), "r")))
    assert r.keys == [5] and r.read_idx(5) == b"five"


def test_native_library_builds_into_the_port(tmp_path):
    """The port builds its own copy of the sources into its ``_build``,
    under a name that hashes them."""
    from mxnet_tpu_torch import _native

    trio.MXRecordIO(str(tmp_path / "x.rec"), "w").close()
    path = _native.library_path()
    assert path.exists()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "mxnet_tpu_torch"
    assert _native.SRC_DIR.parts[-3:] == ("mxnet_tpu_torch", "csrc", "io")


def test_build_without_libjpeg_decodes_raw_payloads(tmp_path, monkeypatch):
    """Where ``jpeglib.h`` is missing the library builds without JPEG:
    raw HWC payloads still decode (the same bytes as the JPEG build), a
    JPEG payload fails with a message that says why."""
    import ctypes

    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch import io as tio

    prefix = str(tmp_path / "raw")
    rng = np.random.RandomState(0)
    w = trio.MXRecordIO(prefix + ".rec", "w")
    for i in range(6):
        img = rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)
        w.write(trio.pack(trio.IRHeader(0, float(i), i, 0), img.tobytes()))
    w.close()
    kw = dict(path_imgrec=prefix + ".rec", data_shape=(3, 8, 8),
              batch_size=3, rand_mirror=True, seed=1, dtype="uint8")
    want = tio.ImageRecordIter(**kw).next_raw()
    assert _native.has_jpeg()

    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_native, "_JPEG", False)
    out = _native.library_path()
    _native._build(out)
    monkeypatch.setattr(_native, "_LIB", _native._bind(ctypes.CDLL(str(out))))
    assert not _native.has_jpeg()
    got = tio.ImageRecordIter(**kw).next_raw()
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(got[1][0], want[1][0])
    yy, xx = np.mgrid[0:16, 0:16]
    img = np.stack([yy * 8, xx * 8, yy + xx], -1).astype(np.uint8)
    w = trio.MXRecordIO(prefix + "j.rec", "w")
    w.write(trio.pack_img(trio.IRHeader(0, 1.0, 0, 0), img))
    w.close()
    it = tio.ImageRecordIter(path_imgrec=prefix + "j.rec",
                             data_shape=(3, 16, 16), batch_size=1)
    with pytest.raises(Exception, match="jpeg decode not built"):
        it.next()
