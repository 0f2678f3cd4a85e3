"""``mx.sym.sparse`` (ref: python/mxnet/symbol/sparse.py).

Counterpart: ``mxnet_tpu/symbol/sparse.py``.  Storage types are
per-NDArray in this package and graphs run dense, so these creators
build the same registered ops as their dense names; a CSR or row-sparse
NDArray bound to a graph is read through its dense bridge (the surface
of example/sparse/linear_classification/linear_model.py:29
``mx.symbol.sparse.dot``).
"""
from .symbol import create as _create


def dot(lhs, rhs, transpose_a=False, transpose_b=False, **kwargs):
    return _create("dot", lhs, rhs, transpose_a=transpose_a,
                   transpose_b=transpose_b, **kwargs)


def zeros_like(data, **kwargs):
    return _create("zeros_like", data, **kwargs)


def retain(data, indices, **kwargs):
    return _create("_sparse_retain", data, indices, **kwargs)


def elemwise_add(lhs, rhs, **kwargs):
    return _create("elemwise_add", lhs, rhs, **kwargs)
