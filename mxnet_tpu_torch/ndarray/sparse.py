"""Sparse NDArray storage: ``row_sparse`` and ``csr``.

Counterpart: ``mxnet_tpu/ndarray/sparse.py`` (ref:
include/mxnet/ndarray.h:59-63 storage types;
python/mxnet/ndarray/sparse.py CSRNDArray / RowSparseNDArray;
src/operator/tensor/cast_storage-inl.h; src/operator/tensor/dot.cc CSR
dot; src/operator/tensor/sparse_retain.cc).

Sparsity is a storage contract, as in the JAX package:

  * a sparse NDArray holds its compressed parts (``data``, ``indices``
    and, for CSR, ``indptr``) as tensors on the array's device, indices
    int64;
  * what profits from sparsity (the CSR products, the lazy row updates
    of the optimizers, ``retain``, the row merges) runs on that device
    as gathers, ``index_add_`` segment sums and row scatters;
  * everything else falls back to dense: reading ``_data`` densifies
    (the reference's storage-fallback dispatch), so every dense op and
    ``nd.invoke`` read a sparse input through that bridge; writing
    ``_data`` makes the dense tensor the truth and the parts recompress
    when next read.

The port's NDArrays are copy-on-write (``ndarray.py``): no two NDArrays
share storage.  A sparse array copies what a constructor is given, and
``data`` / ``indices`` / ``indptr`` return copies of its parts.
Departures: ``copy()`` clones the parts (the JAX package recompresses
through a dense copy, which drops stored all-zero rows: the same values
either way), and compressing a dense tensor runs on its device where
the JAX package runs numpy on the host.
"""
from __future__ import annotations

from typing import Tuple

import numpy as _np
import torch

from ..base import dtype_name, np_dtype, torch_dtype
from ..context import Context, current_context
from .ndarray import NDArray, array as _dense_array, invoke

__all__ = [
    "BaseSparseNDArray",
    "CSRNDArray",
    "RowSparseNDArray",
    "csr_matrix",
    "row_sparse_array",
    "cast_storage",
    "retain",
    "dot",
    "add",
    "subtract",
    "multiply",
    "square_sum",
    "zeros",
    "empty",
    "array",
]


def _device(ctx: Context) -> torch.device:
    return ctx.torch_device()


class BaseSparseNDArray(NDArray):
    """Base of CSRNDArray / RowSparseNDArray
    (ref: python/mxnet/ndarray/sparse.py:105 BaseSparseNDArray).

    ``_data`` is a property here: reading it densifies (cached until the
    next write), writing it stores the dense value and marks the
    compressed parts stale."""

    __slots__ = ("_sp_shape", "_sp_dtype", "_sp_parts", "_dense_cache")

    def __init__(self):  # pragma: no cover - use the constructors below
        raise TypeError("use csr_matrix / row_sparse_array / cast_storage")

    @classmethod
    def _make(cls, shape, dtype, parts, ctx):
        """A sparse array over ``parts`` (tensors it owns, on ctx's
        device)."""
        out = cls.__new__(cls)
        out._sp_shape = tuple(int(s) for s in shape)
        out._sp_dtype = torch_dtype(dtype)
        out._sp_parts = parts
        out._dense_cache = None
        out._ctx = ctx if ctx is not None else current_context()
        out._grad = None
        out._grad_req = "null"
        return out

    # -- the dense-fallback bridge --------------------------------------
    @property
    def _data(self) -> torch.Tensor:
        if self._dense_cache is None:
            self._dense_cache = self._densify()
        return self._dense_cache

    @_data.setter
    def _data(self, value: torch.Tensor) -> None:
        # a dense op wrote through this cell (invoke(out=self), x[:] = v):
        # the dense value becomes the truth, the parts recompress lazily
        self._dense_cache = value
        self._sp_parts = None

    def _parts(self) -> dict:
        if self._sp_parts is None:
            self._sp_parts = self._compress(self._dense_cache.detach())
        return self._sp_parts

    def _densify(self) -> torch.Tensor:
        raise NotImplementedError

    @classmethod
    def _compress(cls, dense: torch.Tensor) -> dict:
        raise NotImplementedError

    # -- common surface --------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return self._sp_shape

    @property
    def dtype(self):
        if self._sp_dtype == torch.bfloat16:
            return torch.bfloat16
        return np_dtype(self._sp_dtype)

    @property
    def size(self) -> int:
        n = 1
        for s in self._sp_shape:
            n *= s
        return n

    @property
    def ndim(self) -> int:
        return len(self._sp_shape)

    def _part(self, name: str) -> NDArray:
        return NDArray.from_raw(self._parts()[name].clone(), self._ctx)

    @property
    def data(self) -> NDArray:
        """A copy of the values array (ref: sparse.py CSRNDArray.data)."""
        return self._part("data")

    @property
    def indices(self) -> NDArray:
        return self._part("indices")

    @property
    def nnz(self) -> int:
        return int(self._parts()["data"].shape[0])

    def todense(self) -> NDArray:
        return NDArray.from_raw(self._data.clone(), self._ctx)

    def tostype(self, stype: str) -> NDArray:
        return cast_storage(self, stype)

    def astype(self, dtype, copy: bool = True):
        if not copy and self._sp_dtype == torch_dtype(dtype):
            return self
        parts = dict(self._parts())
        parts["data"] = parts["data"].to(torch_dtype(dtype), copy=True)
        return type(self)._make(self._sp_shape, dtype, _cloned(parts),
                                self._ctx)

    def wait_to_read(self) -> None:
        dev = (self._sp_parts["data"].device if self._sp_parts is not None
               else self._dense_cache.device)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    wait_to_write = wait_to_read

    def copyto(self, other):
        if isinstance(other, Context):
            ctx = Context(other)
            dev = _device(ctx)
            parts = {k: v.to(dev, copy=True)
                     for k, v in self._parts().items()}
            return type(self)._make(self._sp_shape, self._sp_dtype, parts,
                                    ctx)
        if isinstance(other, BaseSparseNDArray) and \
                other.stype == self.stype:
            dev = _device(other._ctx)
            other._sp_shape = self._sp_shape
            other._sp_dtype = self._sp_dtype
            other._sp_parts = {k: v.to(dev, copy=True)
                               for k, v in self._parts().items()}
            other._dense_cache = None
            return other
        return super().copyto(other)

    def copy(self):
        return type(self)._make(self._sp_shape, self._sp_dtype,
                                _cloned(self._parts()), self._ctx)

    def __setitem__(self, key, value):
        if isinstance(key, slice) and key == slice(None):
            dev = (self._sp_parts["data"].device
                   if self._sp_parts is not None
                   else self._dense_cache.device)
            src = (value._data.detach() if isinstance(value, NDArray)
                   else torch.as_tensor(_np.asarray(value)))
            self._data = src.to(dev, self._sp_dtype).expand(
                self._sp_shape).clone()
            return
        raise ValueError("sparse NDArray only supports wholesale "
                         "assignment x[:] = v (ref: sparse.py __setitem__)")

    def __repr__(self) -> str:
        return "\n<%s %s @%s, %d stored elements>" % (
            type(self).__name__, "x".join(str(s) for s in self._sp_shape),
            self._ctx, self.nnz)


def _cloned(parts: dict) -> dict:
    return {k: v.clone() for k, v in parts.items()}


def _row_ids(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Each stored element's row, from ``indptr`` (on its device; the
    known ``nnz`` spares the host a sync)."""
    counts = indptr[1:] - indptr[:-1]
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=indptr.device), counts,
        output_size=nnz)


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix
    (ref: python/mxnet/ndarray/sparse.py CSRNDArray)."""

    __slots__ = ()

    @property
    def stype(self) -> str:
        return "csr"

    @property
    def indptr(self) -> NDArray:
        return self._part("indptr")

    def _densify(self) -> torch.Tensor:
        p = self._sp_parts
        rows, cols = self._sp_shape
        data = p["data"]
        flat = torch.zeros(rows * cols, dtype=self._sp_dtype,
                           device=data.device)
        if data.shape[0]:
            pos = _row_ids(p["indptr"], data.shape[0]) * cols + p["indices"]
            flat[pos] = data.to(self._sp_dtype)
        return flat.reshape(rows, cols)

    @classmethod
    def _compress(cls, dense: torch.Tensor) -> dict:
        mask = dense != 0
        indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64,
                             device=dense.device)
        indptr[1:] = torch.cumsum(mask.sum(dim=1), 0)
        r, c = torch.nonzero(mask, as_tuple=True)
        return {"data": dense[r, c].clone(), "indices": c.to(torch.int64),
                "indptr": indptr}

    def _row_ids(self) -> torch.Tensor:
        p = self._parts()
        return _row_ids(p["indptr"], p["data"].shape[0])


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse tensor: ``data[i]`` is row ``indices[i]`` of the dense
    tensor, every other row zero
    (ref: python/mxnet/ndarray/sparse.py RowSparseNDArray).  The storage
    of sparse embedding gradients and of ``row_sparse_pull``
    (ref: src/kvstore/kvstore_dist.h:258 PullRowSparseImpl)."""

    __slots__ = ()

    @property
    def stype(self) -> str:
        return "row_sparse"

    def _densify(self) -> torch.Tensor:
        p = self._sp_parts
        data = p["data"]
        out = torch.zeros(self._sp_shape, dtype=self._sp_dtype,
                          device=data.device)
        if data.shape[0]:
            out[p["indices"]] = data.to(self._sp_dtype)
        return out

    @classmethod
    def _compress(cls, dense: torch.Tensor) -> dict:
        flat = dense.reshape(dense.shape[0], -1)
        rows = torch.nonzero((flat != 0).any(dim=1), as_tuple=True)[0]
        return {"data": dense[rows].clone(), "indices": rows.to(torch.int64)}

    def retain(self, indices) -> "RowSparseNDArray":
        return retain(self, indices)


# ---------------------------------------------------------------------------
# constructors (ref: python/mxnet/ndarray/sparse.py csr_matrix /
# row_sparse_array)
# ---------------------------------------------------------------------------
def _source_dtype(x):
    if isinstance(x, NDArray):
        return x._data.dtype
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch_dtype(_np.asarray(x).dtype)


def _as_tensor(x, dev, dtype=None) -> torch.Tensor:
    """A new tensor on ``dev`` holding a copy of ``x``."""
    if isinstance(x, NDArray):
        x = x._data.detach()
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(_np.array(x))
    return x.to(dev, dtype=dtype, copy=True)


def _dense_source(arg1, dtype):
    """A dense tensor from an NDArray / tensor / array-like, float64
    narrowed to float32 unless ``dtype`` says otherwise."""
    if isinstance(arg1, NDArray):
        t = arg1._data.detach()
    elif isinstance(arg1, torch.Tensor):
        t = arg1.detach()
    else:
        t = torch.from_numpy(_np.array(arg1))
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    elif t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t


def csr_matrix(arg1, shape=None, ctx=None, dtype=None) -> CSRNDArray:
    """A CSRNDArray from ``(data, indices, indptr)``, a dense source or
    a scipy.sparse matrix (ref: sparse.py csr_matrix)."""
    ctx = ctx if ctx is not None else current_context()
    dev = _device(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        dt = torch_dtype(dtype) if dtype is not None else _source_dtype(data)
        if dt.is_complex or dt == torch.bool:
            dt = torch.float32
        if shape is None:
            raise ValueError("shape is required for (data, indices, indptr)")
        parts = {"data": _as_tensor(data, dev, dt),
                 "indices": _as_tensor(indices, dev, torch.int64),
                 "indptr": _as_tensor(indptr, dev, torch.int64)}
        return CSRNDArray._make(shape, dt, parts, ctx)
    if hasattr(arg1, "tocsr"):  # a scipy matrix
        m = arg1.tocsr()
        return csr_matrix((m.data, m.indices, m.indptr), shape=m.shape,
                          ctx=ctx, dtype=dtype or m.dtype)
    dense = _dense_source(arg1, dtype).to(dev)
    if dense.ndim != 2:
        raise ValueError("csr requires a 2-D array")
    if shape is not None and tuple(shape) != tuple(dense.shape):
        raise ValueError("shape mismatch")
    return CSRNDArray._make(dense.shape, dense.dtype,
                            CSRNDArray._compress(dense), ctx)


def row_sparse_array(arg1, shape=None, ctx=None,
                     dtype=None) -> RowSparseNDArray:
    """A RowSparseNDArray from ``(data, indices)`` or a dense source
    (ref: sparse.py row_sparse_array)."""
    ctx = ctx if ctx is not None else current_context()
    dev = _device(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if dtype is not None:
            dt = torch_dtype(dtype)
        else:
            dt = _source_dtype(data)
            if dt.is_complex or dt == torch.bool or dt == torch.float64:
                dt = torch.float32
        if shape is None:
            raise ValueError("shape is required for (data, indices)")
        parts = {"data": _as_tensor(data, dev, dt),
                 "indices": _as_tensor(indices, dev, torch.int64).reshape(-1)}
        return RowSparseNDArray._make(shape, dt, parts, ctx)
    dense = _dense_source(arg1, dtype).to(dev)
    if shape is not None and tuple(shape) != tuple(dense.shape):
        raise ValueError("shape mismatch")
    return RowSparseNDArray._make(dense.shape, dense.dtype,
                                  RowSparseNDArray._compress(dense), ctx)


def array(source_array, ctx=None, dtype=None):
    """ref: sparse.py array(): from another sparse array or scipy."""
    if isinstance(source_array, BaseSparseNDArray):
        out = source_array
        if dtype is not None:
            out = out.astype(dtype)
        if ctx is not None and Context(ctx) != source_array._ctx:
            return out.copyto(Context(ctx))
        return out.copy() if out is source_array else out
    if hasattr(source_array, "tocsr"):
        return csr_matrix(source_array, ctx=ctx, dtype=dtype)
    raise ValueError("use csr_matrix/row_sparse_array for dense sources")


def zeros(stype: str, shape, ctx=None, dtype=None, **kwargs):
    """ref: python/mxnet/ndarray/utils.py zeros(stype=...)."""
    ctx = ctx if ctx is not None else current_context()
    dt = torch_dtype(dtype) if dtype is not None else torch.float32
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if stype == "default":
        from . import ndarray as _nd

        return _nd.zeros(shape, ctx, dtype_name(dt))
    dev = _device(ctx)
    i64 = dict(dtype=torch.int64, device=dev)
    if stype == "row_sparse":
        parts = {"data": torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
                 "indices": torch.zeros(0, **i64)}
        return RowSparseNDArray._make(shape, dt, parts, ctx)
    if stype == "csr":
        parts = {"data": torch.zeros(0, dtype=dt, device=dev),
                 "indices": torch.zeros(0, **i64),
                 "indptr": torch.zeros(shape[0] + 1, **i64)}
        return CSRNDArray._make(shape, dt, parts, ctx)
    raise ValueError("unknown storage type %r" % stype)


def empty(stype, shape, ctx=None, dtype=None):
    return zeros(stype, shape, ctx, dtype)


# ---------------------------------------------------------------------------
# storage casts (ref: src/operator/tensor/cast_storage-inl.h)
# ---------------------------------------------------------------------------
def cast_storage(arr: NDArray, stype: str):
    if stype == "default":
        if isinstance(arr, BaseSparseNDArray):
            return arr.todense()
        return arr
    cls = {"row_sparse": RowSparseNDArray, "csr": CSRNDArray}.get(stype)
    if cls is None:
        raise ValueError("unknown storage type %r" % stype)
    if isinstance(arr, cls):
        return arr
    if stype == "csr" and arr.ndim != 2:
        raise ValueError("csr requires a 2-D array")
    dense = arr._data.detach()
    return cls._make(dense.shape, dense.dtype, cls._compress(dense),
                     arr._ctx)


# ---------------------------------------------------------------------------
# sparse-aware compute: gathers, segment sums and row scatters on the
# array's device
# ---------------------------------------------------------------------------
def _index_tensor(indices, dev) -> torch.Tensor:
    if isinstance(indices, NDArray):
        t = indices._data.detach()
    elif isinstance(indices, torch.Tensor):
        t = indices.detach()
    else:
        t = torch.from_numpy(_np.asarray(indices))
    return t.to(dev, torch.int64).reshape(-1)


def retain(rsp: RowSparseNDArray, indices) -> RowSparseNDArray:
    """Keep only the listed rows (ref: src/operator/tensor/
    sparse_retain.cc): a membership test of the stored rows, then a
    gather of the kept ones."""
    if not isinstance(rsp, RowSparseNDArray):
        raise TypeError("retain expects a RowSparseNDArray")
    p = rsp._parts()
    have = p["indices"]
    want = _index_tensor(indices, have.device)
    pos = torch.nonzero(torch.isin(have, want), as_tuple=True)[0]
    parts = {"data": p["data"].index_select(0, pos),
             "indices": have.index_select(0, pos)}
    return RowSparseNDArray._make(rsp.shape, rsp._sp_dtype, parts, rsp._ctx)


def _segment_sum(vals: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    if vals.shape[0]:
        out.index_add_(0, seg_ids, vals)
    return out


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype (JAX promotes; torch refuses mixed
    operands)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def dot(lhs, rhs, transpose_a: bool = False, transpose_b: bool = False):
    """Sparse-aware matmul (ref: src/operator/tensor/dot.cc CSR dot).

    csr x dense      ->  gather of rhs rows + segment sum over the rows
    csr.T x dense    ->  gather of rhs rows + scatter-add to the columns
    rsp x dense      ->  the stored rows' product, scattered to its rows
    dense x csr[.T]  ->  through the transpose identities
    otherwise        ->  the dense ``dot`` op
    """
    if isinstance(lhs, CSRNDArray) and not isinstance(rhs,
                                                      BaseSparseNDArray):
        if transpose_b:
            raise ValueError("dot(csr, dense, transpose_b=True) unsupported "
                             "(matches reference)")
        p = lhs._parts()
        data, col_ids = p["data"], p["indices"]
        row_ids = _row_ids(p["indptr"], data.shape[0])
        rows, cols = lhs.shape
        dense = rhs._data
        if not transpose_a:
            # out[r] = sum over r's stored elements of data * rhs[col]
            gathered = dense.index_select(0, col_ids)
            out = _segment_sum(gathered * data[:, None], row_ids, rows)
        else:
            # out[c] = sum over c's stored elements of data * rhs[row]
            gathered = dense.index_select(0, row_ids)
            out = _segment_sum(gathered * data[:, None], col_ids, cols)
        return NDArray.from_raw(out.to(lhs._sp_dtype), lhs._ctx)
    if isinstance(lhs, RowSparseNDArray) and not isinstance(
            rhs, BaseSparseNDArray):
        if transpose_a:
            return invoke("dot", [NDArray.from_raw(lhs._data, lhs._ctx), rhs],
                          {"transpose_a": True, "transpose_b": transpose_b})
        p = lhs._parts()
        partial = _matmul(p["data"], rhs._data.t() if transpose_b
                          else rhs._data)
        k = rhs.shape[0] if transpose_b else rhs.shape[1]
        out = torch.zeros((lhs.shape[0], k), dtype=partial.dtype,
                          device=partial.device)
        if p["data"].shape[0]:
            out[p["indices"]] = partial
        return NDArray.from_raw(out.to(lhs._sp_dtype), lhs._ctx)
    if isinstance(rhs, BaseSparseNDArray) and not isinstance(
            lhs, BaseSparseNDArray):
        # dense @ csr == (csr.T @ dense.T).T
        if isinstance(rhs, CSRNDArray):
            inner = dot(rhs, NDArray.from_raw(
                lhs._data if transpose_a else lhs._data.t(), lhs._ctx),
                transpose_a=not transpose_b)
            return NDArray.from_raw(inner._data.t().contiguous(), lhs._ctx)
        rhs = rhs.todense()
    return invoke("dot", [lhs if isinstance(lhs, NDArray)
                          else _dense_array(lhs),
                          rhs if isinstance(rhs, NDArray)
                          else _dense_array(rhs)],
                  {"transpose_a": transpose_a, "transpose_b": transpose_b})


def _merge_rsp(a: RowSparseNDArray, b: RowSparseNDArray, op):
    """Union-of-rows elementwise combine; the result stays row_sparse
    (ref: src/operator/tensor/elemwise_binary_op_basic.cc sparse paths)."""
    pa, pb = a._parts(), b._parts()
    ia, ib = pa["indices"], pb["indices"].to(pa["indices"].device)
    union = torch.unique(torch.cat([ia, ib]))
    n = union.numel()
    da = _segment_sum(pa["data"], torch.searchsorted(union, ia), n)
    db = _segment_sum(pb["data"].to(da.device),
                      torch.searchsorted(union, ib), n)
    parts = {"data": op(da, db), "indices": union}
    return RowSparseNDArray._make(a.shape, a._sp_dtype, parts, a._ctx)


def add(lhs, rhs):
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                        RowSparseNDArray):
        return _merge_rsp(lhs, rhs, lambda x, y: x + y)
    return invoke("broadcast_add", [lhs, rhs])


def subtract(lhs, rhs):
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                        RowSparseNDArray):
        return _merge_rsp(lhs, rhs, lambda x, y: x - y)
    return invoke("broadcast_sub", [lhs, rhs])


def multiply(lhs, rhs):
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                        RowSparseNDArray):
        # the union with zero products equals the intersection
        return _merge_rsp(lhs, rhs, lambda x, y: x * y)
    return invoke("broadcast_mul", [lhs, rhs])


def square_sum(rsp, axis=None, keepdims=False):
    """The sum of squares without densifying (ref: src/operator/tensor/
    square_sum.cc)."""
    if isinstance(rsp, RowSparseNDArray):
        d = rsp._parts()["data"]
        if axis is None:
            return NDArray.from_raw(torch.sum(d * d), rsp._ctx)
        if axis in (1, (1,), -1):
            per_row = torch.sum(d * d, dim=tuple(range(1, d.ndim)),
                                keepdim=bool(keepdims))
            out = torch.zeros((rsp.shape[0],) + tuple(per_row.shape[1:]),
                              dtype=d.dtype, device=d.device)
            if d.shape[0]:
                out[rsp._parts()["indices"]] = per_row
            return NDArray.from_raw(out, rsp._ctx)
    return invoke("square_sum", [rsp], {"axis": axis, "keepdims": keepdims})
