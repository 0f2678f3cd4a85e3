"""Rank-side cases of the port's data-parallel parity tests.

``tests/test_torch_dp.py`` and ``tests/test_torch_transformer_dp.py``
start two ranks of a gloo process group on the CPU once per file
(``mxnet_tpu_torch.dist.launch``, rendezvous through a file) and run
every case of this module in them; each case's result, or its
traceback, comes back to the test process, which holds it against the
JAX package's two-device mesh and the port's one-device step.  This
module imports no JAX: the inputs (weights, batches, checkpoint
directories) cross as numpy arrays and paths.
"""
import traceback

import numpy as np
import torch


def run_cases(cases, spec) -> dict:
    """``{name: result or {"error": traceback}}`` of every case."""
    out = {}
    for name, fn in cases:
        try:
            out[name] = fn(spec)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out


def conv_net(pkg, prefix="dp_"):
    """The small conv net of the parity tests, in either package: two
    convolutions with BatchNorm (sync BN under dp), max and global-avg
    pooling, a Dense head."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2),
                nn.Conv2D(8, 3, padding=1, use_bias=False), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(), nn.Dense(5))
    return net


def port_conv_net(w0, sample):
    """The port's conv net on the CPU with the weights ``w0``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert

    with mx.cpu():
        net = conv_net(mx)
        net.initialize(mx.init.Xavier())
        with mx.autograd.pause():
            net(mx.nd.array(sample))
    convert.load_block_params(net, w0)
    return net


def params_of(net) -> dict:
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def conv_run(spec, mesh="dp", call=False, **kw):
    """``FusedTrainStep`` over the K global batches of ``spec``; returns
    the losses, the parameters and what the step reports."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import mesh as _mesh
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    data, label = spec["data"], spec["label"]
    net = port_conv_net(spec["w0"], data[0][:2])
    step_kw = dict(spec["step"])
    step_kw.update(kw)
    m = _mesh.data_parallel_mesh() if mesh == "dp" else None
    with mx.cpu():
        step = FusedTrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              mesh=m, **step_kw)
        out = {}
        if call:
            loss, logits = step(mx.nd.array(data[0]), mx.nd.array(label[0]))
            out.update(loss=loss.asnumpy(), logits=logits.asnumpy())
        else:
            out["losses"] = step.run_steps(mx.nd.array(data),
                                           mx.nd.array(label)).asnumpy()
    out.update(params=params_of(net), bucketed=step.bucketed,
               zero1=step.zero1, accounting=step.bucket_accounting(),
               state_bytes=step.optimizer_state_bytes_per_rank())
    if step.bucketed:
        out["issue_order"] = list(step._reducer.issue_order)
    return out


def _reduce_case(spec):
    """bucketed_reduce over the rank group: rank r contributes
    ``value * (r + 1)``."""
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.parallel import buckets
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh

    mesh = data_parallel_mesh()
    grads = {k: torch.from_numpy(v * (dist.rank() + 1))
             for k, v in spec["grads"].items()}
    entries = [(k, tuple(v.shape), buckets.dtype_name(v.dtype))
               for k, v in grads.items()]
    out = {}
    for name, cap, impl, mean in (("many", 512, "psum", False),
                                  ("one", 1 << 40, "psum", False),
                                  ("ring", 256, "ring", False),
                                  ("hierarchical", 256, "hierarchical",
                                   False),
                                  ("mean", 512, "psum", True)):
        plan = buckets.partition(entries, cap)
        red = buckets.bucketed_reduce(grads, plan, mesh, mean=mean,
                                      impl=impl)
        out[name] = {k: v.numpy() for k, v in red.items()}
        out[name + "_n_buckets"] = len(plan)
    out["host_local_count"] = buckets.host_local_count(mesh)
    return out


def _rank_contract(spec):
    """What one process per device means: each rank is one device of a
    two-rank mesh and trains on its rows of the global batch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import diagnostics, dist
    from mxnet_tpu_torch.parallel import dp, mesh as _mesh

    m = _mesh.data_parallel_mesh()
    rows = np.arange(8.0).reshape(4, 2)
    kv = mx.kvstore.create("local")
    out = {"rank": dist.rank(), "num_processes": dist.num_processes(),
           "local_devices": [str(d) for d in dist.local_devices()],
           "global_devices": [str(d) for d in dist.global_devices()],
           "mesh_size": m.size, "mesh_rank": m.rank,
           "mesh_shape": dict(m.shape),
           "device_count": _mesh.current_device_count(),
           "kv_rank": kv.rank, "kv_num_workers": kv.num_workers,
           "rank_info": diagnostics._rank_info(),
           "rows": dp.shard_batch(torch.from_numpy(rows), m).numpy()}
    # a dp x sp mesh: sequence parallelism builds for the transformer
    # step, with this rank's coordinates and subgroups; FusedTrainStep
    # still takes dp alone
    sp = dp.as_mesh(_mesh.make_mesh((1, 2), ("dp", "sp")), "step",
                    axes=("dp", "sp"))
    out["sp_axis"] = {"shape": dict(sp.shape),
                      "index": (sp.axis_index("dp"), sp.axis_index("sp")),
                      "sp_ranks": sp.axis_ranks("sp"),
                      "dp_ranks": sp.axis_ranks("dp"),
                      "rows": dp.shard_batch(torch.from_numpy(rows), sp,
                                             seq_axis="sp").numpy()}
    for what, call in (("mesh_too_large",
                        lambda: _mesh.data_parallel_mesh(3)),
                       ("batch_indivisible",
                        lambda: dp.shard_batch(torch.zeros(3, 2), m)),
                       ("sp_axis_fused", lambda: dp.as_mesh(sp, "step"))):
        try:
            call()
            out[what] = None
        except Exception as e:          # the message is the result
            out[what] = "%s: %s" % (type(e).__name__, e)
    return out


def _sync_bn_case(spec):
    """BatchNorm forward and backward on this rank's rows under
    ``cross_device_batch_stats``; gamma's and beta's gradients summed
    over ranks (they are per-rank partial sums)."""
    import torch.distributed as tdist

    from mxnet_tpu_torch.ops import nn as nn_ops
    from mxnet_tpu_torch.parallel.dp import shard_batch
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh

    m = data_parallel_mesh()
    x = shard_batch(torch.from_numpy(spec["bn_x"]), m).requires_grad_(True)
    w = shard_batch(torch.from_numpy(spec["bn_w"]), m)
    gamma = torch.from_numpy(spec["bn_gamma"]).requires_grad_(True)
    beta = torch.from_numpy(spec["bn_beta"]).requires_grad_(True)
    mm = torch.zeros_like(gamma)
    mv = torch.ones_like(gamma)
    with nn_ops.cross_device_batch_stats("dp", m):
        out, new_mm, new_mv = nn_ops._batch_norm(
            x, gamma, beta, mm, mv, fix_gamma=False, momentum=0.9)
        (out * w).sum().backward()
    dg, db = gamma.grad.clone(), beta.grad.clone()
    tdist.all_reduce(dg)
    tdist.all_reduce(db)
    return {"out": out.detach().numpy(), "dx": x.grad.numpy(),
            "dgamma": dg.numpy(), "dbeta": db.numpy(),
            "mm": new_mm.numpy(), "mv": new_mv.numpy()}


def resnet_cases(spec) -> dict:
    """Every rank-side case of tests/test_torch_dp.py."""
    lr0 = dict(learning_rate=0.0)
    return run_cases([
        ("reduce", _reduce_case),
        ("contract", _rank_contract),
        ("sync_bn", _sync_bn_case),
        ("bucketed", lambda s: conv_run(s, bucket_bytes=512)),
        ("monolithic", lambda s: conv_run(s, bucket_bytes=0)),
        ("per_key", lambda s: conv_run(s, bucket_bytes=512,
                                       fused_update=False)),
        ("zero1", lambda s: conv_run(s, bucket_bytes=512, zero_stage=1)),
        ("lr0", lambda s: conv_run(s, bucket_bytes=512, **lr0)),
        ("lr0_zero1", lambda s: conv_run(s, bucket_bytes=512, zero_stage=1,
                                         **lr0)),
        ("call", lambda s: conv_run(s, bucket_bytes=512, call=True)),
    ], spec)


def one_rank_cases(spec) -> dict:
    """A dp mesh over a one-rank group (the card count of a one-card
    machine) runs the dp path: hooks, collectives on one rank, ZeRO-1."""
    return run_cases([
        ("bucketed", lambda s: conv_run(s, bucket_bytes=512)),
        ("zero1", lambda s: conv_run(s, bucket_bytes=512, zero_stage=1)),
    ], spec)


def fault_cases(spec) -> dict:
    """chip_smoke.py's planted dp faults (``_DpFault``) on the conv
    net: each run's parameters, and a clean run after them (the faults
    must undo themselves)."""
    import chip_smoke as cs
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh

    mesh = data_parallel_mesh()

    def run(fault):
        with cs._DpFault(fault, mesh):
            return conv_run(spec, bucket_bytes=512)["params"]

    return run_cases([(name, lambda s, f=fault: run(f)) for name, fault in (
        ("clean", None), ("grad_not_reduced", "grad_not_reduced"),
        ("sync_bn_backward_local", "sync_bn_backward_local"),
        ("after", None))], spec)


# ---------------------------------------------------------------------------
# the transformer LM
# ---------------------------------------------------------------------------
def lm_step(spec, dtype="float64", mesh="dp", **kw):
    from mxnet_tpu_torch import transformer as tr
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh

    cfg = tr.TransformerConfig(**dict(spec["cfg"], dtype=dtype,
                                      param_dtype=dtype))
    step_kw = dict(spec["step"])
    step_kw.update(kw)
    s = tr.TransformerTrainStep(
        cfg, mesh=data_parallel_mesh() if mesh == "dp" else None,
        device="cpu", **step_kw)
    # the start parameters cross as numpy (bf16 values as float32,
    # exactly) and take the config's dtype
    p0 = {k: torch.from_numpy(np.array(v)).to(getattr(torch, dtype))
          for k, v in spec["p0_" + dtype].items()}
    s.load_state({"params": p0})
    return s


def lm_iter(spec):
    from mxnet_tpu_torch import transformer as tr

    return tr.LMTokenIter(**spec["iter"])


def lm_fit(spec, steps=3, dtype="float64", ckpt=None, every=None,
           resume=None, **kw):
    s = lm_step(spec, dtype=dtype, **kw)
    losses = s.fit(lm_iter(spec), steps, checkpoint_every_n=every,
                   checkpoint_dir=ckpt, resume_from=resume)
    return {"losses": losses, "params": s.params_numpy(),
            "zero1": s.zero1, "n_dp": s.n_dp,
            "state_bytes": s.optimizer_state_bytes_per_rank(),
            "mom_dtypes": sorted({str(m.dtype) for m in (
                s._moms if isinstance(s._moms, list)
                else s._moms.values())})}


def transformer_cases(spec) -> dict:
    """Every rank-side case of tests/test_torch_transformer_dp.py."""
    d = spec["dirs"]
    return run_cases([
        ("z0", lambda s: lm_fit(s, zero_stage=0)),
        ("z1", lambda s: lm_fit(s, zero_stage=1)),
        ("lr0_z0", lambda s: lm_fit(s, zero_stage=0, learning_rate=0.0)),
        ("lr0_z1", lambda s: lm_fit(s, zero_stage=1, learning_rate=0.0)),
        ("monolithic", lambda s: lm_fit(s, zero_stage=0, bucket_bytes=0)),
        # checkpoints for the JAX package and the port at dp=1
        ("write_z1", lambda s: lm_fit(s, zero_stage=1, ckpt=d["port_z1"],
                                      every=3)),
        ("write_bf16", lambda s: lm_fit(s, steps=2, dtype="bfloat16",
                                        zero_stage=1, ckpt=d["port_bf16"],
                                        every=2)),
        # the JAX package's dp=2 ZeRO-1 checkpoint, and the port's dp=1
        # replicated one, resumed here at dp=2
        ("from_jax", lambda s: lm_fit(s, steps=6, zero_stage=1,
                                      resume=d["jax_z1"])),
        ("from_jax_bf16", lambda s: lm_fit(s, steps=3, dtype="bfloat16",
                                           zero_stage=1,
                                           resume=d["jax_bf16"])),
        ("from_dp1", lambda s: lm_fit(s, steps=6, zero_stage=1,
                                      resume=d["port_dp1"])),
    ], spec)


# ---------------------------------------------------------------------------
# the multi-context Module (parallel.dp.DataParallelRunner)
# ---------------------------------------------------------------------------
def module_sym(mx, kind):
    """The nets of tests/test_torch_module.py, in either package."""
    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        if kind == "conv_bn":
            x = mx.sym.Convolution(x, num_filter=4, kernel=(3, 3),
                                   pad=(1, 1), name="c1")
            x = mx.sym.BatchNorm(x, fix_gamma=False, name="bn1")
            x = mx.sym.Activation(x, act_type="relu")
            x = mx.sym.Pooling(x, kernel=(2, 2), stride=(2, 2),
                               pool_type="max")
            x = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=4,
                                      name="fc")
        else:
            x = mx.sym.FullyConnected(x, num_hidden=16, name="fc1")
            x = mx.sym.Activation(x, act_type="relu")
            x = mx.sym.FullyConnected(x, num_hidden=4, name="fc2")
        return mx.sym.SoftmaxOutput(x, name="softmax")


def module_fit(spec, kind, contexts=2, kvstore="local", bulk=1,
               fault=None):
    """The port's Module over ``contexts`` cpu contexts (the ranks of
    the group, or collapsed onto one device) from the spec's start
    parameters, float64, ``fit`` 2 epochs of batch 8; the parameters,
    aux states and the per-batch training metric."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert

    X, y = spec["data"][kind]
    it = mx.io.NDArrayIter(X, y, batch_size=spec["batch"])
    ctx = [mx.cpu(i) for i in range(contexts)] if contexts > 1 \
        else mx.cpu()
    mod = mx.mod.Module(module_sym(mx, kind), context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    ex = mod._exec
    for d in (ex.arg_dict, ex.aux_dict, ex.grad_dict):
        for cell in d.values():
            if cell is not None:
                cell._data = cell._data.to(torch.float64)
    args, aux = convert.module_params_from_jax(*spec["start"][kind],
                                               ctx=mx.cpu())
    mod.init_params(arg_params=args, aux_params=aux)
    if fault == "grad_not_reduced" and mod._dp is not None \
            and mod._dp.mesh.rank == 1:
        # rank 1 joins every collective but keeps its own gradients
        reduce = mod._dp.reduce_grads

        def keep_local(grad_dict, names):
            local = {k: grad_dict[k]._data for k in names
                     if grad_dict.get(k) is not None}
            reduce(grad_dict, names)
            for k, v in local.items():
                grad_dict[k]._data = v

        mod._dp.reduce_grads = keep_local
    saved = mx.engine._bulk_size, mx.engine._bulk_explicit
    mx.engine.set_bulk_size(bulk)
    try:
        mod.fit(it, num_epoch=2, kvstore=kvstore, optimizer="sgd",
                optimizer_params=(("learning_rate", spec["lr"]),
                                  ("momentum", 0.9), ("wd", 1e-3)))
    finally:
        mx.engine._bulk_size, mx.engine._bulk_explicit = saved
    a, x = mod.get_params()
    return {"args": {k: v.asnumpy() for k, v in a.items()},
            "aux": {k: v.asnumpy() for k, v in x.items()},
            "num_device": mod._num_device,
            "ranks": 1 if mod._dp is None else mod._dp.num_ranks,
            "bulk_groups": 0 if mod._bulk_loop is None
            else mod._bulk_loop.groups}


def module_cases(spec) -> dict:
    """Every rank-side case of tests/test_torch_module_dp.py."""
    cases = []
    for kind in ("mlp", "conv_bn"):
        cases.append((kind, lambda s, k=kind: module_fit(s, k)))
    for kv in ("tpu", "nccl"):
        cases.append(("conv_bn_" + kv,
                      lambda s, v=kv: module_fit(s, "conv_bn", kvstore=v)))
    cases.append(("conv_bn_bulk2", lambda s: module_fit(s, "conv_bn",
                                                        bulk=2)))
    cases.append(("conv_bn_fault", lambda s: module_fit(
        s, "conv_bn", fault="grad_not_reduced")))
    return run_cases(cases, spec)


def sweep_net(classes):
    """The port's tiny BatchNorm conv net of the scaling sweep's parity
    test (``parallel.scaling.sweep(model="torch_dp_cases:sweep_net")``)."""
    import mxnet_tpu_torch as mx

    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="sweep_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(),
                nn.Dense(classes))
    return net
