"""RecordIO: the record container of the image pipelines.

Counterpart: ``mxnet_tpu/recordio.py`` (``MXRecordIO``,
``MXIndexedRecordIO``, ``IRHeader``, ``pack``/``unpack``,
``pack_img``/``unpack_img``).  The wire format is dmlc recordio, read
and written by the port's native library (``csrc/io/recordio.cc``,
built by ``_native``); image payloads carry an ``IRHeader`` (struct
``IfQQ``), so ``.rec``/``.idx`` files cross between the two packages
byte for byte.  Open readers pickle (they reopen on the other side); an
open writer refuses to, since reopening it would truncate the file.
"""
from __future__ import annotations

import ctypes
import struct
from collections import namedtuple

import numpy as np

from . import _native
from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def _check(rc: int):
    if rc != 0:
        raise MXNetError(_native.last_error())


class MXRecordIO:
    """Sequential record reader/writer (ref: recordio.py MXRecordIO)."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.writable = None
        self.open()

    def open(self):
        L = _native.lib()
        h = ctypes.c_void_p()
        if self.flag == "w":
            _check(L.MXTPURecordIOWriterCreate(self.uri.encode(), ctypes.byref(h)))
            self.writable = True
        elif self.flag == "r":
            _check(L.MXTPURecordIOReaderCreate(self.uri.encode(), ctypes.byref(h)))
            self.writable = False
        else:
            raise ValueError("invalid flag %r" % self.flag)
        self.handle = h
        self.is_open = True

    def close(self):
        if not getattr(self, "is_open", False):
            return
        if _native is None or getattr(_native, "lib", None) is None:
            return  # interpreter shutdown: module globals already torn down
        L = _native.lib()
        if self.writable:
            L.MXTPURecordIOWriterFree(self.handle)
        else:
            L.MXTPURecordIOReaderFree(self.handle)
        self.is_open = False
        self.handle = None

    def reset(self):
        self.close()
        self.open()

    def write(self, buf: bytes):
        assert self.writable
        _check(_native.lib().MXTPURecordIOWriterWrite(
            self.handle, buf, len(buf)))

    def read(self):
        assert not self.writable
        L = _native.lib()
        ptr = ctypes.POINTER(ctypes.c_char)()
        size = ctypes.c_size_t()
        rc = L.MXTPURecordIOReaderRead(self.handle, ctypes.byref(ptr),
                                       ctypes.byref(size))
        if rc < 0:
            raise MXNetError(_native.last_error())
        if rc == 0:
            return None  # EOF
        return ctypes.string_at(ptr, size.value)

    def tell(self) -> int:
        L = _native.lib()
        pos = ctypes.c_size_t()
        if self.writable:
            _check(L.MXTPURecordIOWriterTell(self.handle, ctypes.byref(pos)))
        else:
            _check(L.MXTPURecordIOReaderTell(self.handle, ctypes.byref(pos)))
        return pos.value

    def __del__(self):
        self.close()

    def __getstate__(self):
        if getattr(self, "is_open", False) and self.writable:
            # reopening a writer truncates the .rec; refuse rather than lose
            # records (e.g. a pickled writer sent to a worker process)
            raise MXNetError("cannot pickle an open RecordIO writer")
        d = dict(self.__dict__)
        d["handle"] = None
        return d

    def __setstate__(self, d):
        was_open = d.pop("is_open", False)
        self.__dict__.update(d)
        self.is_open = False
        if was_open:
            self.open()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access records keyed by an .idx sidecar
    (ref: recordio.py MXIndexedRecordIO; format ``key\\tpos\\n``)."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        self.fidx = open(self.idx_path, self.flag)
        if not self.writable:
            for line in self.fidx.readlines():
                line = line.strip().split("\t")
                key = self.key_type(line[0])
                self.idx[key] = int(line[1])
                self.keys.append(key)

    def close(self):
        if not getattr(self, "is_open", False):
            return
        super().close()
        if self.fidx is not None and not self.fidx.closed:
            self.fidx.close()

    def seek(self, idx):
        assert not self.writable
        _check(_native.lib().MXTPURecordIOReaderSeek(self.handle, self.idx[idx]))

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf: bytes):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)

    def __getstate__(self):
        d = super().__getstate__()
        d["fidx"] = None
        return d


# ---------------------------------------------------------------------------
# header pack/unpack (byte-compatible with the reference)
# ---------------------------------------------------------------------------
def pack(header: IRHeader, s: bytes) -> bytes:
    """ref: recordio.py pack — header (+ extra float labels) + payload."""
    import numbers

    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0, label=float(header.label))
        return struct.pack(_IR_FORMAT, *header) + s
    label = np.asarray(header.label, dtype=np.float32)
    header = header._replace(flag=label.size, label=0.0)
    return struct.pack(_IR_FORMAT, *header) + label.tobytes() + s


def unpack(s: bytes):
    """ref: recordio.py unpack → (IRHeader, payload)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[: header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header: IRHeader, img, quality: int = 95, img_fmt: str = ".jpg") -> bytes:
    """Encode an HWC uint8 image and pack it (ref: recordio.py pack_img;
    PIL stands in for OpenCV — the only codec in this image)."""
    import io as _io

    from PIL import Image

    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    buf = _io.BytesIO()
    fmt = img_fmt.lower()
    if fmt in (".jpg", ".jpeg"):
        Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    elif fmt == ".png":
        Image.fromarray(img).save(buf, format="PNG",
                                  compress_level=min(9, quality // 10))
    else:
        raise ValueError("unsupported format %r" % img_fmt)
    return pack(header, buf.getvalue())


def unpack_img(s: bytes, iscolor: int = -1):
    """ref: recordio.py unpack_img → (IRHeader, HWC uint8 ndarray).
    iscolor: -1 = as stored (cv2 IMREAD_UNCHANGED), 0 = grayscale,
    1 = color (RGB here, not OpenCV BGR)."""
    import io as _io

    from PIL import Image

    header, img_bytes = unpack(s)
    im = Image.open(_io.BytesIO(img_bytes))
    if iscolor == 0:
        img = np.asarray(im.convert("L"))
    elif iscolor < 0:
        img = np.asarray(im)
    else:
        img = np.asarray(im.convert("RGB"))
    return header, img
