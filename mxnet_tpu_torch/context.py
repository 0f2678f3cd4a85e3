"""Device contexts.

Counterpart: ``mxnet_tpu/context.py``.  A ``Context`` names a device as
``(device_type, device_id)`` and resolves to a ``torch.device`` through
:meth:`Context.torch_device`:

  * ``mx.gpu(i)``  -> ``cuda:i``; the canonical name on this card
  * ``mx.tpu(i)``  -> alias of ``gpu(i)``, so scripts written for the
                      JAX package run unmodified
  * ``mx.cpu(i)``  -> the host (``cpu_pinned``/``cpu_shared`` too)

Departures from the JAX package, all deliberate:

  * the default context is ``gpu(0)``, not ``cpu(0)``: the port's entry
    points run on the card unless the caller asks for the CPU.  Without
    a CUDA device, resolving a gpu context raises and names
    ``ctx=mx.cpu()``;
  * ``gpu(i)`` with ``i >= torch.cuda.device_count()`` raises instead of
    wrapping modulo the device count;
  * a cpu context always means the host, never the accelerator.
"""
from __future__ import annotations

import threading
from typing import Any, Set

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "cpu_pinned", "current_context",
           "num_gpus", "used_cuda_devices"]

_DEVICE_TYPES = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5,
                 "tpu": 6}
_ID_TO_TYPE = {v: k for k, v in _DEVICE_TYPES.items()}
_HOST_TYPES = ("cpu", "cpu_pinned", "cpu_shared")

# CUDA device indices that some context resolved to (for waitall)
_used_cuda: Set[int] = set()


class Context:
    """A device placement tag (ref: python/mxnet/context.py Context)."""

    _default_ctx = threading.local()
    devtype2str = _ID_TO_TYPE
    devstr2type = _DEVICE_TYPES

    def __init__(self, device_type: Any, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type not in _DEVICE_TYPES:
            raise ValueError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device_typeid(self) -> int:
        return _DEVICE_TYPES[self.device_type]

    def _canonical_type(self) -> str:
        # tpu is an alias of gpu in the port (the inverse of the JAX
        # package, where gpu aliases tpu)
        return "gpu" if self.device_type == "tpu" else self.device_type

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, Context)
                and self._canonical_type() == other._canonical_type()
                and self.device_id == other.device_id)

    def __hash__(self) -> int:
        return hash((self._canonical_type(), self.device_id))

    def __repr__(self) -> str:
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    @property
    def is_host(self) -> bool:
        return self.device_type in _HOST_TYPES

    def torch_device(self) -> torch.device:
        """The ``torch.device`` of this context.  Raises for a gpu/tpu
        context without a CUDA device or past the device count."""
        if self.is_host:
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device is available for %r; pass ctx=mx.cpu() "
                "(or run inside `with mx.cpu():`) to use the CPU" % self)
        n = torch.cuda.device_count()
        if not 0 <= self.device_id < n:
            raise MXNetError("%r does not exist: %d CUDA device(s)"
                               % (self, n))
        _used_cuda.add(self.device_id)
        return torch.device("cuda", self.device_id)

    # -- scope protocol: ``with mx.cpu():`` ------------------------------
    def __enter__(self) -> "Context":
        if not hasattr(Context._default_ctx, "stack"):
            Context._default_ctx.stack = []
        Context._default_ctx.stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        Context._default_ctx.stack.pop()

    @classmethod
    def default_ctx(cls) -> "Context":
        stack = getattr(cls._default_ctx, "stack", None)
        return stack[-1] if stack else _DEFAULT


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    return Context("cpu_pinned", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """Alias of :func:`gpu`, so scripts written for the JAX package run."""
    return Context("tpu", device_id)


_DEFAULT = Context("gpu", 0)


def current_context() -> Context:
    return Context.default_ctx()


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def used_cuda_devices() -> Set[int]:
    """CUDA device indices that a context has resolved to so far."""
    return set(_used_cuda)
