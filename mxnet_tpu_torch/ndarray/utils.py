"""NDArray save/load.

Counterpart: ``mxnet_tpu/ndarray/utils.py``, whose two on-disk formats
this module reads and writes byte for byte, so files flow both ways
between the packages:

* the reference dmlc container (``.params``): ``uint64 0x112`` list
  magic, then per array the V2 magic ``0xF993FAC9`` (V1 ``0xF993FAC8``
  and pre-V1 records are read too), shape, context, mshadow type flag
  and raw little-endian data, then the name list
  (src/ndarray/ndarray.cc:860-1100).  Sparse records (storage type 1,
  row_sparse with aux ``[indices]``; 2, csr with aux ``[indptr,
  indices]``) load as ``ndarray.sparse`` arrays and save from them;
* npz, the default: one member per array, ``__mx_list_<i>`` names for a
  list.  bfloat16 is stored as its 16-bit pattern under a
  ``<name>__mx_bf16`` member, written and read through
  ``tensor.view(torch.int16)`` (the JAX package uses ``ml_dtypes``).

``load`` sniffs the magic, so a container needs no flag.
"""
from __future__ import annotations

import io
import struct
from typing import Dict, List, Optional, Union

import numpy as _np
import torch

from ..base import MXNetError, dtype_name
from ..context import Context
from .ndarray import NDArray, array

__all__ = ["save", "load", "load_frombuffer"]

_LIST_PREFIX = "__mx_list_%d"
_BF16_TAG = "__mx_bf16"

# src/ndarray/ndarray.cc:1062 / :861-864
_LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9

# mshadow type flags (mshadow/base.h kFloat32...); bfloat16 has none, so
# the container holds it widened to float32, as in the JAX package
_FLAG_TO_DTYPE = {0: _np.float32, 1: _np.float64, 2: _np.float16,
                  3: _np.uint8, 4: _np.int32, 5: _np.int8, 6: _np.int64}
_DTYPE_TO_FLAG = {_np.dtype(v): k for k, v in _FLAG_TO_DTYPE.items()}
_FLAG_NAMES = {_np.dtype(v).name for v in _FLAG_TO_DTYPE.values()}


def save(fname: str,
         data: Union[NDArray, List[NDArray], Dict[str, NDArray]],
         format: str = "auto") -> None:
    """``format``: "npz", "dmlc" (the reference container), or "auto":
    dmlc when ``fname`` ends in ``.params`` and every array fits the
    container (no bfloat16, no 0-d array), npz otherwise."""
    if isinstance(data, NDArray):
        data = [data]
    arrays = list(data.values()) if isinstance(data, dict) else list(data)
    if format == "auto":
        # the dtype attribute: a sparse array must not densify here
        representable = all(len(v.shape) > 0 and
                            dtype_name(v.dtype) in _FLAG_NAMES
                            for v in arrays)
        format = ("dmlc" if fname.endswith(".params") and representable
                  else "npz")
    if format == "dmlc":
        names = list(data.keys()) if isinstance(data, dict) else []
        with open(fname, "wb") as f:
            _write_dmlc(f, arrays, names)
        return
    if isinstance(data, dict):
        items = data.items()
    else:
        items = ((_LIST_PREFIX % i, v) for i, v in enumerate(arrays))
    payload = {}
    for k, v in items:
        t = v._data.detach()
        if t.dtype == torch.bfloat16:
            payload[k + _BF16_TAG] = (t.cpu().contiguous().view(torch.int16)
                                      .numpy().view(_np.uint16))
        else:
            payload[k] = v.asnumpy()
    with open(fname, "wb") as f:
        _np.savez(f, **payload)


def load(fname: str, ctx: Optional[Context] = None):
    """The arrays of ``fname`` (a list or a dict, as saved) on ``ctx``
    (the current context when None)."""
    with open(fname, "rb") as f:
        head = f.read(8)
        f.seek(0)
        if len(head) == 8 and struct.unpack("<Q", head)[0] == _LIST_MAGIC:
            return _read_dmlc(f, ctx)
    return _load_npz(fname, ctx)


def load_frombuffer(buf: bytes, ctx: Optional[Context] = None):
    if len(buf) >= 8 and struct.unpack("<Q", buf[:8])[0] == _LIST_MAGIC:
        return _read_dmlc(io.BytesIO(buf), ctx)
    return _load_npz(io.BytesIO(buf), ctx)


def _load_npz(f, ctx):
    def decode(z, k):
        if k.endswith(_BF16_TAG):
            bits = torch.from_numpy(z[k].view(_np.int16).copy())
            return array(bits.view(torch.bfloat16), ctx=ctx)
        return array(z[k], ctx=ctx)

    def name(k):
        return k[:-len(_BF16_TAG)] if k.endswith(_BF16_TAG) else k

    with _np.load(f, allow_pickle=False) as z:
        keys = list(z.keys())
        if keys and all(name(k).startswith("__mx_list_") for k in keys):
            keys.sort(key=lambda k: int(name(k).rsplit("_", 1)[1]))
            return [decode(z, k) for k in keys]
        return {name(k): decode(z, k) for k in keys}


# ---------------------------------------------------------------------------
# reference dmlc container (src/ndarray/ndarray.cc:860-1100)
# ---------------------------------------------------------------------------
def _read_exact(f, n):
    b = f.read(n)
    if len(b) != n:
        raise MXNetError("truncated NDArray container")
    return b


def _read_u32(f):
    return struct.unpack("<I", _read_exact(f, 4))[0]


def _read_i32(f):
    return struct.unpack("<i", _read_exact(f, 4))[0]


def _read_u64(f):
    return struct.unpack("<Q", _read_exact(f, 8))[0]


def _read_shape64(f):
    """nnvm::Tuple<int64> Save layout: uint32 ndim + int64 dims."""
    ndim = _read_u32(f)
    if ndim == 0:
        return ()
    return struct.unpack("<%dq" % ndim, _read_exact(f, 8 * ndim))


def _read_values(f, type_flag, shape):
    dtype = _FLAG_TO_DTYPE.get(type_flag)
    if dtype is None:
        raise MXNetError("unknown type flag %d" % type_flag)
    n = int(_np.prod(shape)) if len(shape) else 1
    return _np.frombuffer(_read_exact(f, n * _np.dtype(dtype).itemsize),
                          dtype=dtype).reshape(shape)


def _read_one_array(f):
    """A dense record as a numpy array, a sparse one as ``(stype, shape,
    values, aux arrays)``, a none-array slot as None."""
    magic = _read_u32(f)
    if magic == _V2_MAGIC:
        stype = _read_i32(f)
        naux = {0: 0, 1: 1, 2: 2}.get(stype)
        if naux is None:
            raise MXNetError("unknown storage type %d in container"
                             % stype)
        sshape = _read_shape64(f) if naux else None
        shape = _read_shape64(f)
        if len(shape) == 0:
            return None  # none-array slot
        _read_i32(f), _read_i32(f)  # context (dev_type, dev_id): ignored
        type_flag = _read_i32(f)
        aux = [(_read_i32(f), _read_shape64(f)) for _ in range(naux)]
        values = _read_values(f, type_flag, sshape if naux else shape)
        if not naux:
            return values
        return (stype, tuple(shape), values,
                [_read_values(f, flag, ashape) for flag, ashape in aux])
    # V1 / legacy dense layouts
    if magic == _V1_MAGIC:
        shape = _read_shape64(f)
    else:
        # pre-V1: the magic itself is ndim, dims are uint32
        ndim = magic
        if ndim > 32:
            raise MXNetError("corrupt NDArray container (ndim=%d)" % ndim)
        shape = (struct.unpack("<%dI" % ndim, _read_exact(f, 4 * ndim))
                 if ndim else ())
    if len(shape) == 0:
        return None
    _read_i32(f), _read_i32(f)  # context
    return _read_values(f, _read_i32(f), shape)


def _read_dmlc(f, ctx):
    if _read_u64(f) != _LIST_MAGIC:
        raise MXNetError("not an NDArray container (bad magic)")
    _read_u64(f)  # reserved
    count = _read_u64(f)
    arrays = [_read_one_array(f) for _ in range(count)]
    names = [_read_exact(f, _read_u64(f)).decode()
             for _ in range(_read_u64(f))]
    out = [_to_nd(a, ctx) for a in arrays]
    if names:
        if len(names) != len(out):
            raise MXNetError("container name/array count mismatch")
        return dict(zip(names, out))
    return out


def _to_nd(a, ctx):
    if a is None:
        return None
    if isinstance(a, _np.ndarray):
        return array(a, ctx=ctx)
    from . import sparse as _sp

    stype, shape, values, aux = a
    if stype == 1:  # row_sparse: aux = [indices]
        return _sp.row_sparse_array((values, aux[0]), shape=shape, ctx=ctx,
                                    dtype=values.dtype)
    # csr: aux = [indptr, indices]
    return _sp.csr_matrix((values, aux[1], aux[0]), shape=shape, ctx=ctx,
                          dtype=values.dtype)


def _write_shape64(f, shape):
    f.write(struct.pack("<I", len(shape)))
    if shape:
        f.write(struct.pack("<%dq" % len(shape), *shape))


def _write_one_array(f, nd):
    if len(nd.shape) == 0:
        # ndim=0 is the container's none-array slot marker: a 0-d save
        # would load back as None
        raise MXNetError(
            "the reference .params container cannot hold 0-d arrays; "
            "reshape to (1,) before saving (or use format='npz')")
    from . import sparse as _sp

    if isinstance(nd, _sp.RowSparseNDArray):
        stype = 1
        aux = [nd.indices.asnumpy().astype(_np.int64)]
    elif isinstance(nd, _sp.CSRNDArray):
        stype = 2
        aux = [nd.indptr.asnumpy().astype(_np.int64),
               nd.indices.asnumpy().astype(_np.int64)]
    else:
        stype, aux = 0, []
    # bfloat16 comes back as float32; a sparse array's stored values only
    values = nd.data.asnumpy() if stype else nd.asnumpy()
    if values.dtype not in _DTYPE_TO_FLAG:
        # bool, uint32, uint64 have no reference flag: widen to float32
        values = values.astype(_np.float32)
    f.write(struct.pack("<I", _V2_MAGIC))
    f.write(struct.pack("<i", stype))
    if stype:
        _write_shape64(f, values.shape)
    _write_shape64(f, tuple(nd.shape))
    f.write(struct.pack("<ii", 1, 0))  # context: cpu(0)
    f.write(struct.pack("<i", _DTYPE_TO_FLAG[values.dtype]))
    for a in aux:
        f.write(struct.pack("<i", _DTYPE_TO_FLAG[a.dtype]))
        _write_shape64(f, a.shape)
    f.write(_np.ascontiguousarray(values).tobytes())
    for a in aux:
        f.write(_np.ascontiguousarray(a).tobytes())


def _write_dmlc(f, arrays, names):
    f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
    f.write(struct.pack("<Q", len(arrays)))
    for nd in arrays:
        _write_one_array(f, nd)
    f.write(struct.pack("<Q", len(names)))
    for name in names:
        b = name.encode()
        f.write(struct.pack("<Q", len(b)) + b)
