"""Gradient bucket plans.

Counterpart: ``mxnet_tpu/parallel/buckets.py`` ``Bucket``,
``bucket_cap_bytes``, ``partition``, ``plan_with_tuning`` (:53-183) and
``plan_meta`` (:400).  The JAX package partitions the gradient pytree
into reverse-layer-order, size-capped, dtype-homogeneous buckets and
reduces each across the data-parallel axis.  The port runs on one
device and reduces nothing, so here the plan only shapes what a
checkpoint records (the momenta blob's ``n_buckets`` and
``bucket_elems``); it is the JAX package's plan exactly, so that
checkpoints cross-load.  The reductions themselves and the autotuned
caps (``MXNET_AUTOTUNE_PLAN`` / ``MXNET_AUTOTUNE_DIR``, which raise
here) are the multi-device tier (ROADMAP A6, A11).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from .. import env as _env

__all__ = ["Bucket", "bucket_cap_bytes", "dtype_name", "itemsize",
           "partition", "plan_with_tuning", "accounting", "plan_meta"]

_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
             "int64": 8, "int32": 4}


class Bucket(NamedTuple):
    """One reduction unit: ``keys`` in issue order, homogeneous dtype."""
    keys: Tuple
    nbytes: int
    dtype: str


def bucket_cap_bytes() -> int:
    """The size cap, ``MXNET_KVSTORE_BUCKET_BYTES`` (default 4 MiB; 0
    asks for one bucket per dtype run)."""
    return _env.get_int("MXNET_KVSTORE_BUCKET_BYTES")


def dtype_name(dtype) -> str:
    """``'float32'`` for ``torch.float32``, a numpy dtype or a string."""
    return str(dtype).replace("torch.", "")


def itemsize(dtype) -> int:
    name = dtype_name(dtype)
    if name not in _ITEMSIZE:
        raise ValueError("no bucket item size for dtype %r" % (name,))
    return _ITEMSIZE[name]


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * itemsize(dtype)


def partition(entries: Sequence[Tuple], cap_bytes: Optional[int] = None
              ) -> List[Bucket]:
    """Partition ``entries`` — ``(key, shape, dtype)`` in layer order —
    into reverse-layer-order buckets, the JAX package's greedy fill: a
    bucket closes when the next gradient would exceed the cap or change
    dtype; a gradient larger than the cap gets a bucket of its own.
    (The JAX package's separate first/last caps come from tuned plans,
    which are not ported.)"""
    if cap_bytes is None:
        cap_bytes = bucket_cap_bytes()
    cap = max(int(cap_bytes), 1)
    buckets: List[Bucket] = []
    cur_keys: List = []
    cur_bytes = 0
    cur_dtype: Optional[str] = None

    def flush():
        nonlocal cur_keys, cur_bytes, cur_dtype
        if cur_keys:
            buckets.append(Bucket(tuple(cur_keys), cur_bytes, cur_dtype))
        cur_keys, cur_bytes, cur_dtype = [], 0, None

    for key, shape, dtype in reversed(list(entries)):
        nb = _nbytes(shape, dtype)
        dt = dtype_name(dtype)
        if cur_keys and (cur_dtype != dt or cur_bytes + nb > cap):
            flush()
        cur_keys.append(key)
        cur_bytes += nb
        cur_dtype = dt
    flush()
    return buckets


def plan_with_tuning(entries: Sequence[Tuple],
                     cap_bytes: Optional[int] = None
                     ) -> Tuple[List[Bucket], Optional[Dict]]:
    """``(plan, None)``, the JAX package's ``(plan, tuning_meta)`` on its
    untuned path: an explicit ``cap_bytes`` partitions at that cap,
    otherwise at ``MXNET_KVSTORE_BUCKET_BYTES``.  A tuned plan
    (``MXNET_AUTOTUNE_PLAN`` / ``MXNET_AUTOTUNE_DIR``) raises: the
    autotuner is not ported (ROADMAP A11), and silently ignoring the
    knob would train under caps other than the ones asked for."""
    if cap_bytes is not None:
        return partition(entries, cap_bytes), None
    for knob in ("MXNET_AUTOTUNE_PLAN", "MXNET_AUTOTUNE_DIR"):
        if _env.get_str(knob):
            raise ValueError(
                "%s: tuned bucket plans are not ported to mxnet_tpu_torch "
                "yet (ROADMAP A11); unset it or pin bucket_bytes" % knob)
    return partition(list(entries), None), None


def accounting(plan: Sequence[Bucket]) -> List[Dict]:
    """Per-bucket rows: index, gradient count, bytes, dtype."""
    return [{"bucket": i, "n_grads": len(b.keys), "bytes": int(b.nbytes),
             "dtype": b.dtype} for i, b in enumerate(plan)]


def plan_meta(plan: Optional[Sequence[Bucket]],
              cap_bytes: Optional[int] = None) -> Dict:
    """The self-describing summary of a plan, in the JAX package's
    format: bucket count, bytes, cap, per-bucket rows, and the
    reduction it would run under, which on one device is none: the JAX
    package's defaults (``psum``, chained) are recorded.  No
    ``autotune`` block: tuned plans are not ported."""
    plan = list(plan or ())
    return {
        "n_buckets": len(plan),
        "total_bytes": sum(int(b.nbytes) for b in plan),
        "cap_bytes": bucket_cap_bytes() if cap_bytes is None
        else int(cap_bytes),
        "impl": "psum",
        "chained": True,
        "buckets": accounting(plan),
    }
