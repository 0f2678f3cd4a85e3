"""The step auditor's op log on the card.

Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_analysis_on_card.py

The op log of a bf16 ``FusedTrainStep`` on the card holds its
convolutions in bfloat16 (forward and backward, the backward recorded
from autograd's device thread) and the allocator's peak; on a one-rank
NCCL group the step's log holds its ``c10d`` collectives (sync
BatchNorm's and the loss mean), which ``audit_recorded_steps`` reports
for the recorded step.
"""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the audited step runs on the "
                    "card)")
    return torch.device("cuda")


def _step(mx, mesh=None):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    ctx = mx.gpu(0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(8, 3, padding=1), gluon.nn.BatchNorm(),
            gluon.nn.Activation("relu"), gluon.nn.GlobalAvgPool2D(),
            gluon.nn.Dense(10))
    np.random.seed(0)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    step = FusedTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                          mesh=mesh, dtype="bfloat16")
    x = mx.nd.array(np.random.RandomState(0).rand(8, 3, 16, 16)
                    .astype("float32"), ctx=ctx)
    y = mx.nd.array((np.arange(8) % 10).astype("float32"), ctx=ctx)
    return step, x, y


@pytest.mark.cuda
def test_bf16_step_op_log_on_the_card(cuda_device):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.analysis import auditor

    step, x, y = _step(mx)
    step(x, y)
    _out, log = auditor.record_op_log(step._step, x._data, y._data)
    convs = [r for r in log if r.op.startswith("aten.convolution")
             or r.op.startswith("aten.cudnn_convolution")]
    assert convs, sorted({r.op for r in log})
    assert all(m[1] == "bfloat16" for r in convs for m in r.inputs[:2])
    assert all(m[2].startswith("cuda") for r in convs for m in r.inputs)
    assert log.device_peak_bytes and log.device_peak_bytes > 0
    assert not auditor.check_host_sync(log, "card.bf16")


def _nccl_rank():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.analysis import auditor
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh

    step, x, y = _step(mx, data_parallel_mesh())
    step(x, y)
    rep = auditor.audit_recorded_steps(names=["FusedTrainStep.step"])
    _out, log = auditor.record_op_log(step._step, x._data, y._data)
    return {"sites": rep.sites,
            "collectives": [r["prim"] for r in
                            auditor.collective_signature(log)]}


@pytest.mark.cuda
def test_one_rank_nccl_step_logs_its_collectives(cuda_device):
    from mxnet_tpu_torch import dist

    out = dist.launch(_nccl_rank, 1, backend="nccl", timeout_s=300)[0]
    site = out["sites"]["FusedTrainStep.step"]
    assert "audit_error" not in site, site
    assert site["n_collectives"] >= 1, site
    assert any(c.startswith("c10d.") for c in out["collectives"]), out
