"""mx.analysis — the step auditor: checks over the op log of one step.

Counterpart: ``mxnet_tpu/analysis/`` (its jaxpr auditor).  The port
audits what one eager step dispatched, recorded by a
``TorchDispatchMode`` (:mod:`mxnet_tpu_torch.analysis.auditor`):
collective uniformity and the bucket plan, dtype, host syncs, donation
(state replaced instead of updated in place), remat effectiveness,
sparse gradients and the decode-bucket plan.  The JAX package's
repo-wide lint (``tools/mxlint.py``) reads the JAX package and has no
counterpart here.

``python -m mxnet_tpu_torch.analysis --self-test`` verifies the auditor
flags every seeded fixture violation and passes a clean in-place step;
``--demo-audit`` audits a small ``FusedTrainStep`` built in-process.
"""
from .auditor import (            # noqa: F401
    AuditReport, Finding, OpLog, apply_baseline, audit_decode_buckets,
    audit_recorded_steps, audit_step, check_bucket_plan,
    check_collective_uniformity, check_decode_buckets, check_donation,
    check_dtype, check_host_sync, check_remat_effectiveness,
    check_sparse_gradients, collective_signature, count_remat_eqns,
    iter_eqns, load_baseline, peak_live_bytes, record_op_log,
    DEFAULT_BASELINE,
)
from . import fixtures            # noqa: F401
