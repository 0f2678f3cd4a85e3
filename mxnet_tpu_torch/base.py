"""Base utilities: errors, shapes and the dtype table.

Counterpart: ``mxnet_tpu/base.py``.  The dtype table keeps mshadow's
type ids (the ids the reference's ``.params`` container and C ABI use),
so saved files stay interchangeable with the JAX package.  bfloat16
keeps id 12 and maps to ``torch.bfloat16``.

numpy has no bfloat16 without ``ml_dtypes``, which the port does not
use: :func:`np_dtype` raises for it, ``NDArray.dtype`` reports
``torch.bfloat16``, and ``NDArray.asnumpy()`` of a bfloat16 array
returns its values as float32 (exact: every bfloat16 is a float32).
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as _np
import torch

__all__ = ["MXNetError", "numeric_types", "as_shape", "np_dtype",
           "torch_dtype", "dtype_name", "dtype_id", "storage_id"]


class MXNetError(RuntimeError):
    """Error raised by the framework (ref: include/mxnet/base.h:70)."""


numeric_types = (float, int, _np.generic)

# name -> (torch dtype, mshadow type id); ids follow mshadow's enum
_DTYPES = {
    "float32": (torch.float32, 0),
    "float64": (torch.float64, 1),
    "float16": (torch.float16, 2),
    "uint8": (torch.uint8, 3),
    "int32": (torch.int32, 4),
    "int8": (torch.int8, 5),
    "int64": (torch.int64, 6),
    "bool": (torch.bool, 7),
    "uint32": (torch.uint32, 8),
    "uint64": (torch.uint64, 9),
    "bfloat16": (torch.bfloat16, 12),  # id chosen past the reference enum
}
_TORCH_TO_NAME = {t: n for n, (t, _) in _DTYPES.items()}
_ID_TO_NAME = {i: n for n, (_, i) in _DTYPES.items()}


def dtype_name(dtype: Any) -> str:
    """Canonical name of any dtype spec: a name, a numpy dtype or type,
    a ``torch.dtype`` or an mshadow id; None is float32."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        name = _TORCH_TO_NAME.get(dtype)
    elif isinstance(dtype, (int, _np.integer)) and not isinstance(dtype,
                                                                 bool):
        name = _ID_TO_NAME.get(int(dtype))
    elif isinstance(dtype, str) and dtype in _DTYPES:
        name = dtype
    else:
        name = _np.dtype(dtype).name
    if name not in _DTYPES:
        raise TypeError("unsupported dtype %r" % (dtype,))
    return name


def torch_dtype(dtype: Any) -> torch.dtype:
    return _DTYPES[dtype_name(dtype)][0]


def dtype_id(dtype: Any) -> int:
    return _DTYPES[dtype_name(dtype)][1]


def np_dtype(dtype: Any) -> _np.dtype:
    """The numpy dtype of a dtype spec.  bfloat16 has none here."""
    name = dtype_name(dtype)
    if name == "bfloat16":
        raise TypeError("bfloat16 has no numpy dtype in mxnet_tpu_torch "
                        "(asnumpy() of a bfloat16 array returns float32)")
    return _np.dtype(name)


def as_shape(shape: Any) -> Tuple[int, ...]:
    """Normalise int / sequence to a shape tuple (ref: TShape in mshadow)."""
    if shape is None:
        return ()
    if isinstance(shape, (int, _np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def storage_id(t: torch.Tensor) -> int:
    """Address of ``t``'s storage (0 when empty): two tensors with the
    same id share memory."""
    return t.untyped_storage().data_ptr() if t.numel() else 0
