"""Rank-side cases of ``tests/test_torch_grad_accum.py``: gradient
accumulation (``FusedTrainStep(accum_steps=...)``) over a dp mesh of two
gloo ranks on the CPU, started once for that file
(``mxnet_tpu_torch.dist.launch``).  Each case returns numpy results (or
its traceback) to the test process, which holds them against the port's
one-device step.  This module imports no JAX.
"""
import contextlib
import os

import numpy as np

from torch_dp_cases import params_of, port_conv_net, run_cases


def exact_net(w0):
    """tests/test_grad_accum.py:38-51's BN-free Dense net in the port on
    the CPU, with the quantized weights ``w0``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert

    nn = mx.gluon.nn
    with mx.cpu():
        net = nn.HybridSequential(prefix="ex_")
        with net.name_scope():
            net.add(nn.Dense(16, in_units=8, activation="relu"),
                    nn.Dense(4, in_units=16))
        net.initialize(mx.init.Xavier())
    convert.load_block_params(net, w0)
    return net


def marked_bn_net(seed=3):
    """A conv net with BatchNorm (sync BN on a mesh) and Dropout inside
    two ``stage`` scopes of two ``conv_block`` units, Xavier from numpy
    ``seed``, settled on the CPU."""
    import mxnet_tpu_torch as mx

    nn = mx.gluon.nn

    def unit(f):
        u = nn.HybridSequential()
        with u.name_scope():
            u.add(nn.Conv2D(f, 3, padding=1), nn.BatchNorm(),
                  nn.Activation("relu"), nn.Dropout(0.25))
        u._remat_scope = "conv_block"
        return u

    def stage(f):
        s = nn.HybridSequential()
        with s.name_scope():
            s.add(unit(f), unit(f))
        s._remat_scope = "stage"
        return s

    np.random.seed(seed)
    with mx.cpu():
        net = nn.HybridSequential(prefix="mk_")
        with net.name_scope():
            net.add(stage(4), stage(8), nn.GlobalAvgPool2D(), nn.Dense(5))
        net.initialize(mx.init.Xavier())
        with mx.autograd.pause():
            net(mx.nd.zeros((2, 3, 8, 8)))
    return net


@contextlib.contextmanager
def policy(name):
    old = os.environ.get("MXNET_REMAT_POLICY")
    os.environ["MXNET_REMAT_POLICY"] = name
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MXNET_REMAT_POLICY", None)
        else:
            os.environ["MXNET_REMAT_POLICY"] = old


def exact_run(spec, accum, mesh=True, fault=False, cap=256, **kw):
    """One ``__call__`` of the exact net on the global batch of
    ``spec``: loss, logits, parameters, and the collectives it issued
    by kind.  ``fault`` plants the bucket hooks armed for every
    microbatch's backward: each reduces a partial sum, and re-arming
    drops the earlier ones."""
    import torch.distributed as dist

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import mesh as _mesh
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    net = exact_net(spec["w0"])
    m = _mesh.data_parallel_mesh() if mesh else None
    with mx.cpu():
        step = FusedTrainStep(net, mx.gluon.loss.L2Loss(), mesh=m,
                              learning_rate=0.25, momentum=0.5,
                              accum_steps=accum, bucket_bytes=cap, **kw)
        if fault:
            step._arms = lambda k: True
        X, y = mx.nd.array(spec["X"]), mx.nd.array(spec["y"])
        step._build(mx.nd.array(spec["X"][:2]))
        counts = {}
        saved = {}
        for name in ("all_reduce", "reduce_scatter_tensor",
                     "all_gather_into_tensor", "broadcast"):
            real = getattr(dist, name)
            saved[name] = real

            def counted(*a, _real=real, _name=name, **k):
                counts[_name] = counts.get(_name, 0) + 1
                return _real(*a, **k)

            setattr(dist, name, counted)
        try:
            loss, logits = step(X, y)
        finally:
            for name, real in saved.items():
                setattr(dist, name, real)
    return {"loss": loss.asnumpy(), "logits": logits.asnumpy(),
            "params": params_of(net), "collectives": counts,
            "n_buckets": len(step._plan) if m is not None else 0,
            "issue_order": list(step._reducer.issue_order)
            if m is not None else []}


def bn_run(spec, accum, steps=2, **kw):
    """``steps`` float64 steps of the sync-BN conv net (the data-parallel
    parity net) with ``accum`` microbatches."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import mesh as _mesh
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    net = port_conv_net(spec["bn_w0"], spec["bn_data"][0][:2])
    with mx.cpu():
        step = FusedTrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              mesh=_mesh.data_parallel_mesh(),
                              learning_rate=0.1, momentum=0.9,
                              dtype="float64", accum_steps=accum,
                              bucket_bytes=512, **kw)
        losses = step.run_steps(mx.nd.array(spec["bn_data"][:steps]),
                                mx.nd.array(spec["bn_label"][:steps]))
    return {"losses": losses.asnumpy(), "params": params_of(net)}


def marked_run(spec, knob, accum=2):
    """Two float64 steps of the marked BN + Dropout net under the remat
    policy ``knob``: sync BN inside a scope reduces again in the
    recompute, on every rank in the same order."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import mesh as _mesh
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    net = marked_bn_net()
    with policy(knob), mx.cpu():
        step = FusedTrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              mesh=_mesh.data_parallel_mesh(),
                              learning_rate=0.1, momentum=0.9,
                              dtype="float64", accum_steps=accum,
                              bucket_bytes=512)
        mx.random.seed(11)
        losses = step.run_steps(mx.nd.array(spec["bn_data"][:2]),
                                mx.nd.array(spec["bn_label"][:2]))
    return {"losses": losses.asnumpy(), "params": params_of(net)}


def accum_cases(spec) -> dict:
    """Every rank-side case of tests/test_torch_grad_accum.py."""
    return run_cases([
        ("exact_bucketed_a1", lambda s: exact_run(s, 1)),
        ("exact_bucketed_a4", lambda s: exact_run(s, 4)),
        ("exact_zero1_a1", lambda s: exact_run(s, 1, zero_stage=1)),
        ("exact_zero1_a4", lambda s: exact_run(s, 4, zero_stage=1)),
        ("exact_monolithic_a4", lambda s: exact_run(s, 4, cap=0)),
        ("exact_armed_every_microbatch",
         lambda s: exact_run(s, 4, fault=True)),
        ("bn_bucketed_a2", lambda s: bn_run(s, 2)),
        ("bn_zero1_a2", lambda s: bn_run(s, 2, zero_stage=1)),
        ("marked_none", lambda s: marked_run(s, "none")),
        ("marked_stage", lambda s: marked_run(s, "stage")),
        ("marked_conv_block", lambda s: marked_run(s, "conv_block")),
    ], spec)
