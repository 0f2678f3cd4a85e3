"""Engine control API (ref: python/mxnet/engine.py set_bulk_size, bulk).

Counterpart: ``mxnet_tpu/engine.py``.  The reference's dependency
engine batches small ops into bulk segments.  PyTorch launches each op
on the card's stream as it comes, so nothing here changes how ops run:
the knobs are recorded, with the JAX package's rules, so that tuning
code runs unchanged and a bulk-capable runner can read the setting.
``fit_bulk_size`` is 1 unless the user opted in explicitly, through
:func:`set_bulk_size` or ``MXNET_MODULE_BULK_SIZE``; the environment is
read at the first query, not at import.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from . import env as _env

__all__ = ["set_bulk_size", "bulk", "current_bulk_size", "fit_bulk_size"]

_bulk_size = 15  # the reference default
# None until the environment was consulted
_bulk_explicit: Optional[bool] = None


def _consult_env() -> None:
    global _bulk_size, _bulk_explicit
    if _bulk_explicit is not None:
        return
    k = _env.get_int("MXNET_MODULE_BULK_SIZE")
    if k:
        _bulk_size = int(k)
        _bulk_explicit = True
    else:
        _bulk_explicit = False


def set_bulk_size(size: int) -> int:
    """Set the bulk segment limit; returns the previous value."""
    global _bulk_size, _bulk_explicit
    _consult_env()
    prev = _bulk_size
    _bulk_size = int(size)
    _bulk_explicit = True
    return prev


def fit_bulk_size() -> int:
    """K for a bulk-capable fit loop: 1 (per batch) unless the user
    opted in via :func:`set_bulk_size` or ``MXNET_MODULE_BULK_SIZE``."""
    _consult_env()
    return _bulk_size if _bulk_explicit else 1


@contextmanager
def bulk(size: int):
    """Scope form (ref: engine.py bulk)."""
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)


def current_bulk_size() -> int:
    """The configured bulk segment size."""
    _consult_env()
    return _bulk_size
