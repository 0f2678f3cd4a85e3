"""Build and bind the port's native IO library (``libmxtpu_io``).

Counterpart: ``mxnet_tpu/_native/__init__.py``.  The record container
(``csrc/io/recordio.cc``) and the threaded JPEG decode pipeline behind
``ImageRecordIter`` (``csrc/io/image_pipeline.cc``) are host C++, the
port's own copies of the JAX package's ``native/`` sources.  They are
compiled by one ``g++ ... -ljpeg`` at first use into ``_build/`` beside
this file and loaded with ``ctypes``; nothing is built at import.  Where
libjpeg's headers are missing the library is built without JPEG
(``-DMXTPU_IO_NO_JPEG``, a warning says so): records then decode only
raw HWC uint8 payloads, and :func:`has_jpeg` is False.

The library's file name carries a hash of its sources and flags, so an
edited source is rebuilt and an unchanged one reused.  The compiler
writes a per-process temporary file that is then renamed into place, so
processes that build at once (test workers, decode-pool workers) never
load a half-written library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["lib", "last_error", "library_path", "has_jpeg",
           "NativeBuildError"]

SRC_DIR = Path(__file__).resolve().parent / "csrc" / "io"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
_SOURCES = ("recordio.cc", "image_pipeline.cc")
_HEADERS = ("recordio.h",)
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-Wall",
          "-Wextra", "-Wno-unused-parameter")

_LOCK = threading.Lock()
_LIB = None
_JPEG = None


class NativeBuildError(RuntimeError):
    pass


def _jpeg_headers() -> bool:
    """Whether the compiler finds ``jpeglib.h``."""
    global _JPEG
    if _JPEG is None:
        proc = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                              input="#include <cstdio>\n#include <jpeglib.h>\n",
                              capture_output=True, text=True)
        _JPEG = proc.returncode == 0
    return _JPEG


def _flags():
    return _FLAGS if _jpeg_headers() else _FLAGS + ("-DMXTPU_IO_NO_JPEG",)


def library_path() -> Path:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(_flags()).encode())
    return BUILD_DIR / ("libmxtpu_io-%s.so" % h.hexdigest()[:16])


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".so.tmp%d" % os.getpid())
    link = ["-ljpeg"] if _jpeg_headers() else []
    if not link:
        import logging

        logging.getLogger(__name__).warning(
            "jpeglib.h not found: building the native IO library without "
            "JPEG decode (raw HWC uint8 payloads only)")
    cmd = ["g++", *_flags()] + [str(SRC_DIR / s) for s in _SOURCES] + [
        "-o", str(tmp), *link]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError("native IO build failed:\n%s\n%s"
                               % (" ".join(cmd), proc.stderr))
    os.replace(tmp, out)


def _bind(L: ctypes.CDLL) -> ctypes.CDLL:
    c_vp, c_sz, c_int = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    f_p = ctypes.POINTER(ctypes.c_float)
    L.MXTPURecordIOWriterCreate.argtypes = [ctypes.c_char_p,
                                            ctypes.POINTER(c_vp)]
    L.MXTPURecordIOWriterWrite.argtypes = [c_vp, ctypes.c_char_p, c_sz]
    L.MXTPURecordIOWriterTell.argtypes = [c_vp, ctypes.POINTER(c_sz)]
    L.MXTPURecordIOWriterFree.argtypes = [c_vp]
    L.MXTPURecordIOReaderCreate.argtypes = [ctypes.c_char_p,
                                            ctypes.POINTER(c_vp)]
    L.MXTPURecordIOReaderRead.argtypes = [
        c_vp, ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
        ctypes.POINTER(c_sz)]
    L.MXTPURecordIOReaderSeek.argtypes = [c_vp, c_sz]
    L.MXTPURecordIOReaderTell.argtypes = [c_vp, ctypes.POINTER(c_sz)]
    L.MXTPURecordIOReaderFree.argtypes = [c_vp]
    L.MXTPURecordIOGetLastError.restype = ctypes.c_char_p
    L.MXTPUImageIterCreateEx.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        c_int, c_int, c_int, c_int,          # batch, c, h, w
        c_int, c_int, c_int,                 # shuffle, rand_crop, mirror
        f_p, f_p,                            # mean, std
        c_int, c_int, c_int, c_int,          # threads, seed, label_w, resize
        c_int, c_int, c_int,                 # round_batch, prefetch, u8
        ctypes.POINTER(c_vp)]
    # data is ``uint8 **`` or ``float **`` by the iterator's dtype
    L.MXTPUImageIterNextEx.argtypes = [c_vp, c_vp, ctypes.POINTER(f_p),
                                       ctypes.POINTER(c_int)]
    L.MXTPUImageIterReset.argtypes = [c_vp]
    L.MXTPUImageIterFree.argtypes = [c_vp]
    L.MXTPUImageIterNumRecords.argtypes = [c_vp, ctypes.POINTER(c_sz)]
    L.MXTPUImageIterGetLastError.restype = ctypes.c_char_p
    L.MXTPUImageIterHasJpeg.restype = c_int
    return L


def lib() -> ctypes.CDLL:
    """The loaded native IO library, built first if its hash has no
    library yet."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            out = library_path()
            if not out.exists():
                _build(out)
            _LIB = _bind(ctypes.CDLL(str(out)))
        return _LIB


def has_jpeg() -> bool:
    """Whether the loaded library decodes JPEG payloads."""
    return bool(lib().MXTPUImageIterHasJpeg())


def last_error() -> str:
    return lib().MXTPURecordIOGetLastError().decode()
