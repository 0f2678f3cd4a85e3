"""Rank-side cases of the port's tensor-parallel parity tests.

``tests/test_torch_tp.py`` starts 2 gloo ranks (a dp=1 x mp=2 mesh) and
4 (dp=2 x mp=2) on the CPU once each (``mxnet_tpu_torch.dist.launch``)
and runs every case of this module there; the results come back as
numpy arrays and are held against the JAX package's ``FusedTrainStep``
on the same meshes of host devices.  This module imports no JAX.
"""
import numpy as np

from chip_smoke import tp_net, tp_spec  # the net and spec of tp_numerics
from torch_dp_cases import params_of, run_cases


def dense_spec(P):
    """``tests/test_parallel.py:104-125``'s spec: the weight over
    ``mp`` by output features."""
    def spec(name, shape):
        return P("mp", None) if name.endswith("weight") else None
    return spec


def dense_net(pkg):
    net = pkg.gluon.nn.Dense(8, in_units=6, prefix="tpd_")
    return net


def _port_net(kind, w0, sample):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert

    with mx.cpu():
        net = tp_net(mx) if kind == "conv" else dense_net(mx)
        net.initialize(mx.init.Xavier())
        with mx.autograd.pause():
            net(mx.nd.array(sample))
    convert.load_block_params(net, w0)
    return net


def tp_run(spec, kind="conv", mesh_shape=None, spec_fn=None, ckpt=None,
           fault=None, **kw):
    """``FusedTrainStep`` with a spec over the K global batches of
    ``spec[kind]``: the losses, the parameters (a global read), the
    bytes a rank and the layouts."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.parallel import tensor
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    s = spec[kind]
    data, label = s["data"], s["label"]
    n = dist.num_processes()
    shape = mesh_shape or (n // 2, 2)
    mesh = make_mesh(shape, ("dp", "mp"))
    net = _port_net(kind, s["w0"], data[0][:2])
    fn = spec_fn or (tp_spec if kind == "conv" else dense_spec)(tensor.P)
    step_kw = dict(spec["step"])
    step_kw.update(kw)
    if fault:
        tensor.FAULTS.add(fault)
    try:
        with mx.cpu():
            step = FusedTrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                  mesh=mesh, param_spec_fn=fn, **step_kw)
            losses = step.run_steps(mx.nd.array(data),
                                    mx.nd.array(label)).asnumpy()
    finally:
        tensor.FAULTS.discard(fault)
    cells = net.collect_params()
    sharded = {k: tuple(p._data._shard.shape) for k, p in cells.items()
               if isinstance(p._data, tensor.ShardedArray)}
    out = dict(losses=losses, sharded=sharded,
               param_bytes=step.param_bytes_per_rank(),
               state_bytes=step.optimizer_state_bytes_per_rank(),
               moms={p.name: tuple(m.shape)
                     for p, m in zip(step._cells, step._moms)},
               bucketed=step.bucketed, zero1=step.zero1)
    out["params"] = params_of(net)      # the global read: a collective
    out["full_param_bytes"] = sum(v.nbytes for v in out["params"].values())
    if ckpt is not None:
        from mxnet_tpu_torch.checkpoint import CheckpointManager

        CheckpointManager(ckpt).save(2, params=out["params"])
    return out


def _spec_errors(spec):
    """The specs the mesh cannot hold, on ``dense1``'s (5, 8) weight:
    each raises MXNetError; returns the messages (None: no raise)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import tensor
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    P = tensor.P
    mesh = make_mesh((1, 2), ("dp", "mp"))
    s = spec["conv"]
    bad = {"dp": P("dp", None), "missing": P("tp", None),
           "indivisible": P("mp", None), "twice": P("mp", "mp"),
           "too_long": P(None, None, "mp"), "entry": P(3, None)}
    out = {}
    for name, sp in bad.items():
        net = _port_net("conv", s["w0"], s["data"][0][:2])

        def fn(n, shape, sp=sp):
            return sp if n.endswith("dense1_weight") else None
        try:
            with mx.cpu():
                FusedTrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                               mesh=mesh, param_spec_fn=fn,
                               **spec["step"]).run_steps(
                    mx.nd.array(s["data"]), mx.nd.array(s["label"]))
            out[name] = None
        except mx.MXNetError as e:
            out[name] = str(e)
    return out


def _with_env(env, fn, *args, **kw):
    import os

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn(*args, **kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mp2_cases(spec) -> dict:
    """dp=1 x mp=2 on two ranks."""
    return run_cases([
        ("conv", lambda s: tp_run(s, "conv", ckpt=s["ckpt_mp2"])),
        ("conv_mirror", lambda s: _with_env(
            {"MXNET_BACKWARD_DO_MIRROR": "1"}, tp_run, s, "conv")),
        ("dense", lambda s: tp_run(s, "dense")),
        ("conv_accum", lambda s: tp_run(s, "conv", accum_steps=2)),
        ("conv_zero1", lambda s: tp_run(s, "conv", zero_stage=1)),
        ("errors", _spec_errors),
    ], spec)


def _reload(spec):
    """Another mesh's checkpoint (dp=1 x mp=2's) written into the
    sharded cells of a built dp=2 x mp=2 step: the global read gives it
    back, and the next step (momentum 0) starts from it."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.checkpoint import load_checkpoint
    from mxnet_tpu_torch.parallel import tensor
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    s = spec["conv"]
    data, label = s["data"], s["label"]
    net = _port_net("conv", s["w0"], data[0][:2])
    step_kw = dict(spec["step"], momentum=0.0)
    saved = load_checkpoint(spec["ckpt_mp2"], rank=0, num_ranks=1)["params"]
    # rounded to float32 values, which the JAX side's float32 cells take
    # exactly
    saved = {k: np.asarray(v, np.float32) for k, v in saved.items()}
    with mx.cpu():
        step = FusedTrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              mesh=make_mesh((2, 2), ("dp", "mp")),
                              param_spec_fn=tp_spec(tensor.P), **step_kw)
        step.run_steps(mx.nd.array(data[:1]), mx.nd.array(label[:1]))
        convert.load_block_params(net, saved)
        read = params_of(net)
        losses = step.run_steps(mx.nd.array(data[1:]),
                                mx.nd.array(label[1:])).asnumpy()
    return {"read": read, "saved": saved, "losses": losses,
            "params": params_of(net)}


def dp2_mp2_cases(spec) -> dict:
    """dp=2 x mp=2 on four ranks."""
    return run_cases([
        ("conv", lambda s: tp_run(s, "conv", ckpt=s["ckpt"])),
        ("reload", _reload),
        ("dense", lambda s: tp_run(s, "dense")),
    ], spec)
