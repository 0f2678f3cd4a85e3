"""mx.autotune — the bucket autotuner: recorded timings → searched caps →
a plan the data-parallel step applies.

Counterpart: ``mxnet_tpu/autotune/`` (the same plan format, fingerprint
and loaders, so plans and summaries cross between the packages).

  1. **extract** (``timing.py``) — a traceview summary of the port's
     torch.profiler capture, the JAX package's flight dumps and
     ``--bucket-timings`` exports, SCALING reports or raw gradient
     leaves → one replayable :class:`TimingModel`;
  2. **search** (``search.py``) — sweep bucket caps of 1–32 MiB with
     first/last-bucket asymmetry through
     ``parallel.scaling.simulate_bucketed_overlap`` and score projected
     efficiency at the target rank count, the 4 MiB default scored
     under the same model.  The link bandwidth is the evidence's or the
     caller's; the port assumes none;
  3. **apply** (``plan.py``) — persist the winning plan as JSON;
     ``parallel.buckets.plan_with_tuning`` applies it at a step's build
     through ``MXNET_AUTOTUNE_PLAN`` (a file) or ``MXNET_AUTOTUNE_DIR``
     (a fingerprint-matched directory), and the caps ride
     ``plan_meta``'s ``autotune`` block into the traceview summary.

CLI: ``python -m mxnet_tpu_torch.autotune --self-test | --tune <file>
[--apply]``.
"""
from __future__ import annotations

from . import plan, search, timing
from .plan import load_plan, resolve_caps, save_plan
from .search import tune
from .timing import TimingModel, from_bucket_timings, from_flight_dump, \
    from_leaf_bytes, from_scaling_json, from_trace, load_any

__all__ = [
    "timing", "search", "plan",
    "TimingModel", "from_flight_dump", "from_bucket_timings",
    "from_scaling_json", "from_leaf_bytes", "from_trace", "load_any",
    "tune", "save_plan", "load_plan", "resolve_caps",
]
