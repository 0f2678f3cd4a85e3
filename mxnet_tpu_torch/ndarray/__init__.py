"""``mx.nd`` — the imperative tensor namespace.

Counterpart: ``mxnet_tpu/ndarray/__init__.py``.  ``linalg`` is not
ported yet (ROADMAP A12).
"""
from .ndarray import (NDArray, invoke, array, zeros, ones, full, empty,
                      arange, eye, zeros_like, ones_like, concatenate,
                      moveaxis, maximum, minimum, waitall)
from .utils import save, load, load_frombuffer
from . import sparse
from .sparse import BaseSparseNDArray, CSRNDArray, RowSparseNDArray
from . import register as _register

# imperative random namespace: mx.nd.random.uniform(...)
from .. import random  # noqa: F401

# one function per registered op name
_register.populate(globals())

# friendly aliases matching the reference's python surface
concat = globals()["Concat"]
stack = globals()["stack"]
dot = globals()["dot"]
batch_dot = globals()["batch_dot"]


def _scalar_aware_binary(array_op, scalar_op, rscalar_op=None):
    """The reference's free functions (nd.add/subtract/...) take an
    NDArray or a Python scalar on either side."""
    bcast = globals()[array_op]
    sca = globals()[scalar_op]
    rsca = globals()[rscalar_op] if rscalar_op else sca

    def fn(lhs, rhs):
        l_nd, r_nd = isinstance(lhs, NDArray), isinstance(rhs, NDArray)
        if l_nd and r_nd:
            return bcast(lhs, rhs)
        if l_nd:
            return sca(lhs, scalar=float(rhs))
        if r_nd:
            return rsca(rhs, scalar=float(lhs))
        raise TypeError("at least one operand must be an NDArray")

    return fn


add = _scalar_aware_binary("broadcast_add", "_plus_scalar")
subtract = _scalar_aware_binary("broadcast_sub", "_minus_scalar",
                                "_rminus_scalar")
multiply = _scalar_aware_binary("broadcast_mul", "_mul_scalar")
divide = _scalar_aware_binary("broadcast_div", "_div_scalar",
                              "_rdiv_scalar")
power = _scalar_aware_binary("broadcast_power", "_power_scalar",
                             "_rpower_scalar")
modulo = _scalar_aware_binary("broadcast_mod", "_mod_scalar",
                              "_rmod_scalar")


# reference names at the nd namespace (ref: cast_storage.cc,
# sparse_retain.cc)
from .sparse import cast_storage  # noqa: E402


def _sparse_retain(data, indices):
    """ref: src/operator/tensor/sparse_retain.cc: keep only the listed
    rows of a row_sparse array."""
    return data.retain(indices)
