"""Seeded-violation fixtures proving the auditor catches each defect
class.

Counterpart: ``mxnet_tpu/analysis/fixtures.py``.  Every fixture is a
tiny torch step carrying exactly one planted bug, recorded as an op log
(``auditor.record_op_log``) on the CPU; the self-test and
``tests/test_torch_analysis.py`` assert the matching check flags it and
that the clean in-place step passes everything.  The collectives run
on a one-rank gloo group (:func:`one_rank_group`): their ops appear in
the log whatever the group's size.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from typing import Dict

from . import auditor

__all__ = [
    "one_rank_group", "rank_dependent_traces", "undonated_step",
    "donated_step", "upcast_log", "host_sync_log", "clean_step",
    "UNDONATED_BYTES", "remat_twin_logs", "noop_remat_log",
    "decode_bucket_violation", "decode_bucket_clean",
    "sparse_gradient_violation", "sparse_gradient_clean",
    "SPARSE_FIXTURE_VOCAB", "SPARSE_FIXTURE_DIM",
]

UNDONATED_BYTES = 4 * 1024 * 1024   # the planted replaced parameter
SPARSE_FIXTURE_VOCAB = 512          # the planted dense-scatter table
SPARSE_FIXTURE_DIM = 8


@contextlib.contextmanager
def one_rank_group():
    """A one-rank gloo process group on the CPU for the fixtures'
    collectives (``dist.initialize``, so a ``data_parallel_mesh`` builds
    over it; the existing group when there is one)."""
    import torch.distributed as tdist

    from .. import dist

    if tdist.is_initialized():
        yield
        return
    tmp = tempfile.mkdtemp(prefix="mxaudit_")
    dist.initialize(init_method="file://" + os.path.join(tmp, "rendezvous"),
                    num_processes=1, process_id=0, backend="gloo",
                    device="cpu")
    try:
        yield
    finally:
        dist.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


def rank_dependent_traces() -> Dict[str, auditor.OpLog]:
    """Two logs of 'the same' step whose gradient dict arrived in a
    different insertion order on each rank — the way a bucket plan
    emits a rank-dependent collective order; check_collective_uniformity
    must flag the divergence."""
    import torch
    import torch.distributed as dist

    def step_for(key_order):
        def step(a, b):
            grads = {"w_small": a.clone(), "w_big": b.clone()}
            for k in key_order:   # per-rank iteration order
                dist.all_reduce(grads[k])
            return sum(g.sum() for g in grads.values())

        return step

    a, b = torch.ones(4), torch.ones(128)
    with one_rank_group():
        return {
            "rank0": auditor.record_op_log(
                step_for(("w_small", "w_big")), a, b)[1],
            "rank1": auditor.record_op_log(
                step_for(("w_big", "w_small")), a, b)[1],
        }


class _SGD:
    """A parameter and its SGD update, replacing the tensor (the bug)
    or updating it in place."""

    def __init__(self, in_place: bool):
        import torch

        self.in_place = in_place
        self.w = torch.zeros(UNDONATED_BYTES // 4)

    def step(self, g):
        if self.in_place:
            self.w.sub_(0.05 * g)
        else:
            self.w = self.w - 0.05 * g   # a new tensor every step
        return self.w.sum()

    def audit_state(self):
        return {"param:w": self.w}


def undonated_step():
    """``(fn, specs)``: an SGD step that replaces its 4 MiB parameter
    with a new tensor each call — old and new held at once."""
    import torch

    opt = _SGD(in_place=False)
    return opt.step, (torch.ones(UNDONATED_BYTES // 4),)


def donated_step():
    """The fixed twin of :func:`undonated_step`: the update in place."""
    import torch

    opt = _SGD(in_place=True)
    return opt.step, (torch.ones(UNDONATED_BYTES // 4),)


def upcast_log() -> auditor.OpLog:
    """A declared-bf16 matmul whose operands were silently cast to f32
    first."""
    import torch

    def fwd(x):
        y = x.float()             # the silent upcast
        return (y @ y.t()).to(torch.bfloat16)

    return auditor.record_op_log(fwd, torch.ones(8, 8,
                                                 dtype=torch.bfloat16))[1]


def host_sync_log() -> auditor.OpLog:
    """A step reading a value back to the host inside its loop: one
    round trip per iteration."""
    import torch

    def steps(xs):
        c = 0.0
        for x in xs:
            c += float(x.sum().item())   # the planted read-back
        return c

    return auditor.record_op_log(steps, torch.ones(4, 3))[1]


def _stage_chain_grad(checkpoint_stages):
    """The gradient of a 6-layer matmul chain, each 2-layer stage under
    ``remat.checkpoint`` or not: without it every layer's activation is
    kept for backward, with it only the 3 stage boundaries."""
    import torch

    from .. import remat

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1024, 256, generator=gen)
    ws = [(torch.randn(256, 256, generator=gen) * 0.05).requires_grad_()
          for _ in range(6)]

    def stage(h, w1, w2):
        return torch.tanh(torch.tanh(h @ w1) @ w2)

    def grad_fn(x, *ws):
        h = x
        for i in range(0, 6, 2):
            h = remat.checkpoint(stage, h, ws[i], ws[i + 1]) \
                if checkpoint_stages else stage(h, ws[i], ws[i + 1])
        return torch.autograd.grad(h.sum(), ws)

    return auditor.record_op_log(grad_fn, x, *ws)[1]


def remat_twin_logs():
    """(remat_log, twin_log): the same stage-chain gradient with per-
    stage checkpoints and without; the remat log must enter regions
    and keep a lower peak of live bytes."""
    return _stage_chain_grad(True), _stage_chain_grad(False)


def noop_remat_log() -> auditor.OpLog:
    """A step whose build declared a remat policy but that entered no
    checkpoint region (the planted no-op)."""
    return _stage_chain_grad(False)


def decode_bucket_violation():
    """A decode history with two planted bugs: a (batch=3,
    cache_len=48) that is no cell of the declared 2x2 plan, and 6
    compiles against 4 plan cells.  Returns (plan, observed,
    compile_counts)."""
    plan = [(1, 16), (1, 32), (4, 16), (4, 32)]
    observed = [(1, 16), (4, 32), (3, 48)]   # the rogue shape
    counts = {"gen_decode:fx:v1:1x16": 1, "gen_decode:fx:v1:1x32": 1,
              "gen_decode:fx:v1:4x16": 3,   # recompiled under traffic
              "gen_decode:fx:v1:4x32": 1}
    return plan, observed, counts


def decode_bucket_clean():
    """The fixed twin: every observed shape a plan cell, every cell
    compiled once."""
    plan = [(1, 16), (1, 32), (4, 16), (4, 32)]
    observed = [(1, 16), (4, 32), (4, 16)]
    counts = {"gen_decode:fx:v1:1x16": 1, "gen_decode:fx:v1:1x32": 1,
              "gen_decode:fx:v1:4x16": 1, "gen_decode:fx:v1:4x32": 1}
    return plan, observed, counts


def sparse_gradient_violation() -> auditor.OpLog:
    """A 'sparse' embedding step built wrong: the gather runs over the
    whole (vocab, dim) table, so its backward builds a vocab-row dense
    gradient."""
    import torch

    V, D = SPARSE_FIXTURE_VOCAB, SPARSE_FIXTURE_DIM
    table = torch.zeros(V, D, requires_grad=True)
    ids = torch.arange(32) % V

    def grad_fn(table, ids):
        loss = (torch.nn.functional.embedding(ids, table) ** 2).sum()
        return torch.autograd.grad(loss, table)

    return auditor.record_op_log(grad_fn, table, ids)[1]


def sparse_gradient_clean() -> auditor.OpLog:
    """The fixed twin, shaped like the recommender's sparse step: the
    gather runs over the pulled unique rows (<= batch) through the
    inverse map, so its gradient has batch rows, not vocab rows."""
    import torch

    D = SPARSE_FIXTURE_DIM
    rows = torch.zeros(32, D, requires_grad=True)
    inverse = torch.arange(32)

    def grad_fn(rows, inverse):
        loss = (torch.nn.functional.embedding(inverse, rows) ** 2).sum()
        return torch.autograd.grad(loss, rows)

    return auditor.record_op_log(grad_fn, rows, inverse)[1]


class _CleanStep:
    """A well-formed step: a bf16 matmul, its gradient all-reduced over
    the group, the parameter updated in place."""

    def __init__(self):
        import torch

        self.w = torch.zeros(16, 16, dtype=torch.bfloat16)

    def step(self, data):
        import torch
        import torch.distributed as dist

        w = self.w.detach().requires_grad_()
        loss = (data @ w).float().sum()
        (g,) = torch.autograd.grad(loss, w)
        dist.all_reduce(g)
        with torch.no_grad():
            self.w.sub_(g, alpha=0.05)
        return loss.detach()

    def audit_state(self):
        return {"param:w": self.w}


def clean_step():
    """``(fn, specs)`` for ``audit_step``: every check must pass (run it
    inside :func:`one_rank_group`)."""
    import torch

    step = _CleanStep()
    return step.step, (torch.ones(8, 16, dtype=torch.bfloat16),)
