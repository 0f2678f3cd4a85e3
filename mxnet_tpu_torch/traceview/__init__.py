"""mxnet_tpu_torch.traceview — the measured device timeline.

Counterpart: ``mxnet_tpu/traceview/``.  capture.py is the one
``torch.profiler`` wrapper of the package (env-armed by
``MXNET_TRACE_DIR`` / ``MXNET_TRACE_STEPS``), parse.py the stdlib-only
walker that classifies a kineto (or XLA) trace's device ops into step
phases (H2D / forward / backward / per-bucket reduce / optimizer / D2H)
and computes measured per-bucket collective occupancy and compute/comm
overlap, in the JAX package's summary format.  Consumers:
``profiler.summary()``'s phase table, the
``mxnet_step_phase_seconds{phase}`` histograms, and the JAX package's
readers of a summary (``autotune.timing``, ``merge_traces --health``).

``python -m mxnet_tpu_torch.traceview --self-test`` replays the
committed fixtures through the walker against golden attribution.
"""
from .capture import (annotation, enabled, last_summary,  # noqa: F401
                      last_summary_path, reset, start_device_trace,
                      step_window, stop_device_trace)
from .parse import (SUMMARY_FORMAT, SUMMARY_VERSION,  # noqa: F401
                    attribute, classify_op, device_op_counts,
                    find_trace_file, is_traceview_summary, load_trace)

__all__ = [
    "SUMMARY_FORMAT", "SUMMARY_VERSION", "attribute", "classify_op",
    "device_op_counts", "find_trace_file", "is_traceview_summary",
    "load_trace", "annotation", "enabled", "last_summary",
    "last_summary_path", "reset", "start_device_trace", "step_window",
    "stop_device_trace",
]
