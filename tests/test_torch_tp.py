"""Tensor parallelism in the port (``FusedTrainStep(param_spec_fn=...)``
over a ``("dp", "mp")`` mesh, ``parallel/tensor.py``) on gloo ranks on
the CPU, against the JAX package's ``FusedTrainStep`` with the same spec
function on the same mesh of host devices.

The ranks are started twice for this file, two (dp=1 x mp=2) and four
(dp=2 x mp=2), and run every rank-side case of
``tests/torch_tp_cases.py``.  Tolerance, float64: 1e-10 on the losses and
on every parameter (BatchNorm's running statistics included) after two
steps.  The specs cover a column-parallel convolution with its bias, a
column- and a row-parallel Dense, parameters gathered on use (a
convolution weight over its input channels, BatchNorm's gamma and
running mean) and ``tests/test_parallel.py:104-125``'s Dense.
"""
import numpy as np
import pytest

import jax
import mxnet_tpu as jmx
from jax.sharding import PartitionSpec as JP
from mxnet_tpu.parallel.dp import FusedTrainStep as JStep
from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from mxnet_tpu_torch import dist

import torch_dp_cases
import torch_tp_cases as cases

TOL = 1e-10
STEP = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
            dtype="float64")


def _jax_net(kind, sample):
    np.random.seed(0)
    net = cases.tp_net(jmx) if kind == "conv" else cases.dense_net(jmx)
    net.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    with jmx.autograd.pause():
        net(jmx.nd.array(sample, ctx=jmx.cpu()))
    return net


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    rng = np.random.RandomState(3)
    out = {"step": STEP,
           "ckpt": str(tmp_path_factory.mktemp("tp_ckpt")),
           "ckpt_mp2": str(tmp_path_factory.mktemp("tp_ckpt_mp2"))}
    for kind, shape, classes in (("conv", (2, 4, 3, 8, 8), 5),
                                 ("dense", (2, 8, 6), 8)):
        data = rng.uniform(-1, 1, shape).astype(np.float32)
        label = rng.randint(0, classes, shape[:2]).astype(np.float32)
        out[kind] = dict(data=data, label=label, w0=torch_dp_cases.params_of(
            _jax_net(kind, data[0][:2])))
    return out


@pytest.fixture(scope="module")
def mp2(spec):
    return dist.launch(cases.mp2_cases, 2, (spec,), device="cpu",
                       threads=1, timeout_s=300)


@pytest.fixture(scope="module")
def dp2_mp2(spec, mp2):
    # after mp2: its dp=1 x mp=2 checkpoint loads on this mesh
    return dist.launch(cases.dp2_mp2_cases, 4, (spec,), device="cpu",
                       threads=1, timeout_s=300)


_JAX_RUNS: dict = {}


def _jax_run(spec, kind, shape, **kw):
    """The JAX package's step on a ``shape`` ("dp", "mp") mesh of host
    devices (``shape`` None: one device, no spec)."""
    key = (kind, shape, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        s = spec[kind]
        net = _jax_net(kind, s["data"][0][:2])
        jmx_params = net.collect_params()
        for k, p in jmx_params.items():
            p.set_data(jmx.nd.array(s["w0"][k], ctx=jmx.cpu()))
        fn = None
        if shape is not None:
            mesh = jmake_mesh(shape, ("dp", "mp"),
                              jax.devices()[:shape[0] * shape[1]])
            fn = (cases.tp_spec if kind == "conv" else cases.dense_spec)(JP)
        else:
            mesh = None
        step = JStep(net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                     mesh=mesh, param_spec_fn=fn, **STEP, **kw)
        losses = step.run_steps(jmx.nd.array(s["data"]),
                                jmx.nd.array(s["label"])).asnumpy()
        _JAX_RUNS[key] = (losses, torch_dp_cases.params_of(net))
    return _JAX_RUNS[key]


def _got(ranks, name, rank=0):
    out = ranks[rank][name]
    if isinstance(out, dict) and "error" in out:
        pytest.fail("rank %d, case %s:\n%s" % (rank, name, out["error"]))
    return out


def _errs(got, want):
    loss = float(np.abs(got["losses"] - want[0]).max())
    par = {k: float(np.abs(got["params"][k] - v).max() /
                    max(np.abs(v).max(), 1.0))
           for k, v in want[1].items()}
    return loss, par


@pytest.mark.parametrize("mesh,kind", [
    ("mp2", "conv"), ("mp2", "dense"), ("dp2_mp2", "conv"),
    ("dp2_mp2", "dense")])
def test_trajectory_matches_jax_mesh(request, spec, mesh, kind):
    """Two steps on every rank equal the JAX package's step on the same
    mesh with the same spec: the losses and the global read of every
    parameter (each rank reads the same global values)."""
    ranks = request.getfixturevalue(mesh)
    shape = (1, 2) if mesh == "mp2" else (2, 2)
    want = _jax_run(spec, kind, shape)
    for r in range(len(ranks)):
        loss, par = _errs(_got(ranks, kind, r), want)
        assert loss <= TOL, (r, loss)
        assert max(par.values()) <= TOL, (r, par)


def test_trajectory_is_the_unsharded_step(spec, mp2):
    """The sharded step is the one-device step at the global batch (the
    JAX package's, with no spec)."""
    loss, par = _errs(_got(mp2, "conv"), _jax_run(spec, "conv", None))
    assert loss <= TOL and max(par.values()) <= TOL, (loss, par)


def test_accumulation_under_a_spec(spec, mp2):
    """``accum_steps`` runs under a spec as on one device: the JAX
    package's accumulating step on the mesh."""
    want = _jax_run(spec, "conv", (1, 2), accum_steps=2)
    loss, par = _errs(_got(mp2, "conv_accum"), want)
    assert loss <= TOL and max(par.values()) <= TOL, (loss, par)


def test_mirror_under_a_spec(spec, mp2):
    """The mirror (``MXNET_BACKWARD_DO_MIRROR``) recomputes regions whose
    layers split their compute over mp: the same trajectory."""
    loss, par = _errs(_got(mp2, "conv_mirror"), _jax_run(spec, "conv",
                                                         (1, 2)))
    assert loss <= TOL and max(par.values()) <= TOL, (loss, par)


def test_a_rank_holds_its_shards(mp2, dp2_mp2):
    """Between steps a rank holds 1/mp of each sharded parameter and of
    its momentum; the replicated ones in full."""
    for ranks in (mp2, dp2_mp2):
        got = _got(ranks, "conv")
        full = got["params"]
        assert set(got["sharded"]) == {
            "tp_conv2d0_weight", "tp_conv2d0_bias", "tp_batchnorm0_gamma",
            "tp_batchnorm0_running_mean", "tp_conv2d1_weight",
            "tp_dense0_weight", "tp_dense0_bias", "tp_dense1_weight"}
        for k, shard in got["sharded"].items():
            assert np.prod(shard) * 2 == full[k].size, (k, shard)
        sharded = sum(full[k].nbytes for k in got["sharded"])
        want = got["full_param_bytes"] - sharded // 2
        assert got["param_bytes"] == want
        # the momenta take the parameters' layout
        assert got["state_bytes"] == want
        assert got["moms"]["tp_dense1_weight"] == (5, 4)
        assert not got["bucketed"] and not got["zero1"]


def test_zero1_under_a_spec_stays_replicated(spec, mp2):
    """``zero_stage=1`` under a spec warns and keeps the momenta in the
    parameters' layout (the JAX step is monolithic there): the same
    trajectory."""
    got = _got(mp2, "conv_zero1")
    assert not got["zero1"]
    loss, par = _errs(got, _jax_run(spec, "conv", (1, 2)))
    assert loss <= TOL and max(par.values()) <= TOL, (loss, par)


def test_checkpoint_under_dp2_mp2_loads_on_one_device_and_in_jax(
        spec, dp2_mp2):
    """A checkpoint of the global read under dp=2 x mp=2 (one shard a
    rank) loads on one device in the port and in the JAX package, into
    nets that then hold the trained parameters."""
    from mxnet_tpu import checkpoint as jckpt
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import checkpoint as tckpt, convert

    want = _got(dp2_mp2, "conv")["params"]
    port = tckpt.load_checkpoint(spec["ckpt"], rank=0, num_ranks=1)
    with mx.cpu():
        net = cases.tp_net(mx)
        net.initialize(mx.init.Xavier())
        with mx.autograd.pause():
            net(mx.nd.zeros((2, 3, 8, 8)))
        net.cast("float64")
    convert.load_block_params(net, port["params"])
    got = torch_dp_cases.params_of(net)
    jax_side = jckpt.load_checkpoint(spec["ckpt"], rank=0, num_ranks=1)
    jnet = _jax_net("conv", spec["conv"]["data"][0][:2])
    jnet.cast("float64")
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(np.asarray(jax_side["params"][k]),
                                ctx=jmx.cpu()))
    jgot = torch_dp_cases.params_of(jnet)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(jgot[k], v, err_msg=k)


def test_checkpoint_of_another_mesh_loads_into_sharded_cells(spec,
                                                             dp2_mp2):
    """dp=1 x mp=2's checkpoint written into a built dp=2 x mp=2 step's
    sharded cells reads back bitwise on every rank, and the next step
    starts from it: the JAX package's one-device step from the same
    values (momentum 0)."""
    s = spec["conv"]
    net = _jax_net("conv", s["data"][0][:2])
    got0 = _got(dp2_mp2, "reload")
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(np.asarray(got0["saved"][k]),
                                ctx=jmx.cpu()))
    step = JStep(net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                 **dict(STEP, momentum=0.0))
    losses = step.run_steps(jmx.nd.array(s["data"][1:]),
                            jmx.nd.array(s["label"][1:])).asnumpy()
    want = (losses, torch_dp_cases.params_of(net))
    for r in range(4):
        got = _got(dp2_mp2, "reload", r)
        for k, v in got["saved"].items():
            np.testing.assert_array_equal(got["read"][k], v, err_msg=k)
        loss, par = _errs(got, want)
        assert loss <= TOL and max(par.values()) <= TOL, (r, loss, par)


@pytest.mark.parametrize("name,why", [
    ("dp", "non-dp axes"), ("missing", "no axis 'tp'"),
    ("indivisible", "does not divide"), ("twice", "shards two"),
    ("too_long", "3 entries"), ("entry", "spec entry")])
def test_specs_the_mesh_cannot_hold_raise(mp2, name, why):
    msg = _got(mp2, "errors")[name]
    assert msg is not None and why in msg, msg
