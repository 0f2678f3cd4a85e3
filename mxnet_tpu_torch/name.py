"""Automatic symbol naming (ref: python/mxnet/name.py NameManager:22,
Prefix:74). `with mx.name.Prefix("net_"):` prefixes every auto-generated
op name inside the scope.

Counterpart: ``mxnet_tpu/name.py``, a copy: the same counters give the
same auto-names (``convolution0``, ``fullyconnected1``) in both
packages."""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["NameManager", "Prefix"]

_local = threading.local()


class NameManager:
    """Scope manager assigning default names to symbols
    (ref: name.py:22). Counter access is locked so the process-global
    default manager stays collision-free across threads (the behavior
    the reference gets from its module-level counter)."""

    def __init__(self):
        self._counter: Dict[str, int] = {}
        self._old: Optional["NameManager"] = None
        self._lock = threading.Lock()

    def get(self, name: Optional[str], hint: str) -> str:
        if name is not None:
            return name
        with self._lock:
            idx = self._counter.get(hint, 0)
            self._counter[hint] = idx + 1
        return "%s%d" % (hint, idx)

    def __enter__(self) -> "NameManager":
        self._old = current()
        _local.manager = self
        return self

    def __exit__(self, *exc):
        _local.manager = self._old
        return False


class Prefix(NameManager):
    """Prepend a prefix to every auto name (ref: name.py:74)."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name: Optional[str], hint: str) -> str:
        name = super().get(name, hint)
        return self._prefix + name


_default = NameManager()  # one process-global default: auto names stay
# unique even when threads build symbols concurrently


def current() -> NameManager:
    return getattr(_local, "manager", None) or _default
