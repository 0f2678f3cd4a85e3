"""Data-parallel training in the port (``mxnet_tpu_torch.dist``,
``parallel.mesh``, ``parallel.buckets``, ``parallel.dp.FusedTrainStep``
over a dp mesh, sync BatchNorm) on two gloo ranks on the CPU, against
the JAX package's two-device CPU mesh and the port's one-device step.

The two ranks are started once for this file (``dist.launch``, the
``spawn`` method, rendezvous through a file) and run every rank-side case
of ``tests/torch_dp_cases.py``; the JAX package runs here on two of the
eight host devices.  Tolerances, fp64: the trajectory and every
parameter (BatchNorm's running statistics included) 1e-9 relative to
the largest magnitude (the ResNet tolerance: XLA and ATen sum in other
orders); bucketed against monolithic and the per-key against the fused
update bitwise (at two ranks a + b is exact in either order); ZeRO-1
against replicated bitwise at lr 0 and within 1e-12 otherwise.
"""
import numpy as np
import pytest

import jax
import mxnet_tpu as jmx
from mxnet_tpu.parallel import buckets as jbuckets
from mxnet_tpu.parallel.dp import FusedTrainStep as JStep
from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from mxnet_tpu_torch import dist
from mxnet_tpu_torch.parallel import buckets as tbuckets
from mxnet_tpu_torch.parallel import mesh as tmesh

import torch_dp_cases as cases

TOL = 1e-9
STEP = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
            dtype="float64")
CAP = 512


def _jax_net(sample):
    np.random.seed(0)
    net = cases.conv_net(jmx)
    net.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    with jmx.autograd.pause():
        net(jmx.nd.array(sample, ctx=jmx.cpu()))
    return net


@pytest.fixture(scope="module")
def spec():
    rng = np.random.RandomState(1)
    data = rng.uniform(-1, 1, (3, 4, 3, 8, 8)).astype(np.float32)
    label = rng.randint(0, 5, (3, 4)).astype(np.float32)
    return dict(
        data=data, label=label, step=STEP,
        w0=cases.params_of(_jax_net(data[0][:2])),
        grads={i: rng.randn(*shape) for i, shape in
               enumerate([(33,), (8, 9), (120,), (5, 5, 5)])},
        bn_x=rng.randn(4, 3, 5, 5), bn_w=rng.randn(4, 3, 5, 5),
        bn_gamma=rng.rand(3) + 0.5, bn_beta=rng.randn(3))


@pytest.fixture(scope="module")
def ranks(spec):
    """Every rank-side case, run once on two gloo ranks."""
    return dist.launch(cases.resnet_cases, 2, (spec,), device="cpu",
                       threads=1, timeout_s=600)


def _got(ranks, name, rank=0):
    out = ranks[rank][name]
    if isinstance(out, dict) and "error" in out:
        pytest.fail("rank %d, case %s:\n%s" % (rank, name, out["error"]))
    return out


@pytest.fixture(scope="module")
def jax_dp2(spec):
    """The JAX package's FusedTrainStep on a two-device dp mesh, bucketed
    at the same cap: three steps, then one through ``__call__``."""
    data, label = spec["data"], spec["label"]
    net = _jax_net(data[0][:2])
    mesh = jmake_mesh((2,), ("dp",), jax.devices()[:2])
    step = JStep(net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), mesh=mesh,
                 bucket_bytes=CAP, **STEP)
    losses = step.run_steps(jmx.nd.array(data, ctx=jmx.cpu()),
                            jmx.nd.array(label, ctx=jmx.cpu())).asnumpy()
    params = cases.params_of(net)
    net2 = _jax_net(data[0][:2])
    step2 = JStep(net2, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), mesh=mesh,
                  bucket_bytes=CAP, **STEP)
    loss, logits = step2(jmx.nd.array(data[0], ctx=jmx.cpu()),
                         jmx.nd.array(label[0], ctx=jmx.cpu()))
    return dict(losses=losses, params=params, loss=loss.asnumpy(),
                logits=logits.asnumpy(), accounting=step.bucket_accounting())


def _close(got, want, what, tol=TOL):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * scale, "%s: %g" % (what, err)


def _same(a, b, what):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg="%s %s" % (what, k))


# ---------------------------------------------------------------------------
# the bucket plan and its reduction
# ---------------------------------------------------------------------------
def _kb(i):
    return ("w%d" % i, (256,), "float32")    # 1 KB each


@pytest.mark.parametrize("entries,cap", [
    ([_kb(i) for i in range(10)], 3 * 1024),
    ([("small", (4,), "float32"), ("huge", (10000,), "float32"),
      ("tail", (4,), "float32")], 1024),
    ([("a", (8,), "float32"), ("b", (8,), "bfloat16"),
      ("c", (8,), "bfloat16")], 1 << 20),
    ([(i, (3, 5), "float64") for i in range(7)], 0),
], ids=["reverse_layer_order", "oversize", "dtype_split", "cap_zero"])
def test_partition_is_the_jax_plan(entries, cap):
    want = jbuckets.partition(entries, cap)
    got = tbuckets.partition(entries, cap)
    assert [tuple(b) for b in got] == [tuple(b) for b in want]
    arrays = {k: np.zeros(s, np.float64) for k, s, _ in entries}
    assert tbuckets.partition(
        [(k, v.shape, "float64") for k, v in arrays.items()], cap) == \
        jbuckets.plan_for_arrays(arrays, cap)


def test_impl_and_chain_knobs(monkeypatch):
    assert tbuckets.impl_name() == jbuckets.impl_name() == "psum"
    assert tbuckets.chain_enabled() is jbuckets.chain_enabled() is True
    for name in ("ring", "hierarchical"):
        monkeypatch.setenv("MXNET_KVSTORE_BUCKET_IMPL", name)
        assert tbuckets.impl_name() == name
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_IMPL", "butterfly")
    with pytest.raises(ValueError, match="psum, ring, hierarchical"):
        tbuckets.impl_name()
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_CHAIN", "0")
    assert tbuckets.chain_enabled() is False
    assert tbuckets.DEFAULT_BUCKET_BYTES == jbuckets.DEFAULT_BUCKET_BYTES


def test_host_local_count_topologies(ranks):
    class _Mesh:
        def __init__(self, hosts):
            self.hosts = hosts

    assert tbuckets.host_local_count(_Mesh(["a", "a", "b", "b"])) == 2
    assert tbuckets.host_local_count(_Mesh(["a"] * 4)) == 4
    assert tbuckets.host_local_count(_Mesh(["a", "a", "a", "b"])) is None
    assert tbuckets.host_local_count(_Mesh(["a", "b", "a", "b"])) is None
    assert tbuckets.host_local_count(_Mesh(["a"])) is None
    # the two ranks on this host
    assert _got(ranks, "reduce")["host_local_count"] == 2


def _jax_reduce(grads, plan, impl, mean):
    """The reference's bucketed_reduce under shard_map on two devices;
    device d contributes ``value * (d + 1)``."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = jmake_mesh((2,), ("dp",), jax.devices()[:2])
    args = {k: np.stack([v * (d + 1) for d in range(2)])
            for k, v in grads.items()}

    def local(a):
        return jbuckets.bucketed_reduce(
            {k: v.reshape(v.shape[1:]) for k, v in a.items()}, plan, "dp",
            n=2, mean=mean, impl=impl, local_n=2)

    fn = shard_map(local, mesh=mesh, in_specs=(P("dp"),), out_specs=P(),
                   check_rep=False)
    return {k: np.asarray(v) for k, v in jax.jit(fn)(args).items()}


@pytest.mark.parametrize("case,cap,impl,mean", [
    ("many", 512, "psum", False), ("one", 1 << 40, "psum", False),
    ("ring", 256, "ring", False), ("hierarchical", 256, "hierarchical",
                                   False),
    ("mean", 512, "psum", True)])
def test_bucketed_reduce_matches_the_jax_reduction(ranks, spec, case, cap,
                                                   impl, mean):
    grads = spec["grads"]
    entries = [(k, v.shape, str(v.dtype)) for k, v in grads.items()]
    plan = jbuckets.partition(entries, cap)
    want = _jax_reduce(grads, plan, impl, mean)
    for r in (0, 1):
        got = _got(ranks, "reduce", r)
        assert got[case + "_n_buckets"] == len(plan)
        if impl == "psum":
            # a + 2a is exact in either order: bitwise the psum
            _same(got[case], want, case)
        else:
            # the JAX ring is the oracle of test_ring_impl_matches_psum;
            # the port runs the backend's all-reduce for it
            for k in want:
                np.testing.assert_allclose(got[case][k], want[k],
                                           rtol=1e-5, atol=1e-5)
    _same(_got(ranks, "reduce")["many"], _got(ranks, "reduce")["one"],
          "many vs one bucket")


# ---------------------------------------------------------------------------
# sync BatchNorm
# ---------------------------------------------------------------------------
def test_sync_batchnorm_is_the_global_batch_op(ranks, spec):
    """Forward and backward of BatchNorm on each rank's rows under
    ``cross_device_batch_stats`` equal the op on the whole batch:
    outputs, input gradients, gamma/beta gradients (summed over ranks)
    and the moving statistics."""
    import torch

    from mxnet_tpu_torch.ops import nn as nn_ops

    x = torch.from_numpy(spec["bn_x"]).requires_grad_(True)
    gamma = torch.from_numpy(spec["bn_gamma"]).requires_grad_(True)
    beta = torch.from_numpy(spec["bn_beta"]).requires_grad_(True)
    out, mm, mv = nn_ops._batch_norm(
        x, gamma, beta, torch.zeros(3, dtype=torch.float64),
        torch.ones(3, dtype=torch.float64), fix_gamma=False, momentum=0.9)
    (out * torch.from_numpy(spec["bn_w"])).sum().backward()
    got = [_got(ranks, "sync_bn", r) for r in (0, 1)]
    _close(np.concatenate([g["out"] for g in got]), out.detach().numpy(),
           "out", 1e-12)
    _close(np.concatenate([g["dx"] for g in got]), x.grad.numpy(), "dx",
           1e-12)
    for g in got:
        _close(g["dgamma"], gamma.grad.numpy(), "dgamma", 1e-12)
        _close(g["dbeta"], beta.grad.numpy(), "dbeta", 1e-12)
        _close(g["mm"], mm.numpy(), "moving_mean", 1e-12)
        _close(g["mv"], mv.numpy(), "moving_var", 1e-12)


# ---------------------------------------------------------------------------
# FusedTrainStep over the dp mesh
# ---------------------------------------------------------------------------
def test_dp2_step_matches_jax_dp2_and_one_device(ranks, spec, jax_dp2):
    one = cases.conv_run(spec, mesh=None)
    for r in (0, 1):
        got = _got(ranks, "bucketed", r)
        assert got["bucketed"] and not got["zero1"]
        _close(got["losses"], jax_dp2["losses"], "losses vs JAX dp=2")
        _close(got["losses"], one["losses"], "losses vs one device")
        assert sorted(got["params"]) == sorted(jax_dp2["params"])
        for k in got["params"]:
            _close(got["params"][k], jax_dp2["params"][k], k + " vs JAX")
            _close(got["params"][k], one["params"][k], k + " vs one")
    assert any(k.endswith("running_mean") for k in one["params"])
    _same(_got(ranks, "bucketed", 0)["params"],
          _got(ranks, "bucketed", 1)["params"], "rank 0 vs rank 1")
    assert _got(ranks, "bucketed")["accounting"] == jax_dp2["accounting"]


def test_bucketed_equals_monolithic_bitwise(ranks):
    b, m = _got(ranks, "bucketed"), _got(ranks, "monolithic")
    np.testing.assert_array_equal(b["losses"], m["losses"])
    _same(b["params"], m["params"], "bucketed vs monolithic")
    assert len(b["accounting"]) > 1
    assert not m["bucketed"] and m["accounting"] is None


def test_buckets_issue_once_each_in_backward_order(ranks):
    """Every bucket's all-reduce is issued exactly once a step, from the
    backward hooks, in the order the buckets complete — which is not the
    plan's order (BatchNorm's gamma/beta land late): the update must not
    depend on it, and does not (the test above)."""
    got = _got(ranks, "bucketed")
    order = got["issue_order"]
    assert sorted(order) == list(range(len(got["accounting"])))
    assert _got(ranks, "bucketed", 1)["issue_order"] == order


def test_per_key_update_is_bitwise_the_fused_update(ranks):
    b, p = _got(ranks, "bucketed"), _got(ranks, "per_key")
    np.testing.assert_array_equal(b["losses"], p["losses"])
    _same(b["params"], p["params"], "per-key vs fused")


def test_zero1_matches_replicated(ranks):
    z, b = _got(ranks, "lr0_zero1"), _got(ranks, "lr0")
    assert z["zero1"] and not b["zero1"]
    np.testing.assert_array_equal(z["losses"], b["losses"])
    _same(z["params"], b["params"], "ZeRO-1 vs replicated at lr 0")
    z, b = _got(ranks, "zero1"), _got(ranks, "bucketed")
    _close(z["losses"], b["losses"], "ZeRO-1 losses", 1e-12)
    for k in b["params"]:
        _close(z["params"][k], b["params"][k], k, 1e-12)
    # momenta: each rank holds its half of every bucket (padded to 2);
    # replicated momenta cover every cell, aux included
    half = sum((a["bytes"] // 8 + 1) // 2 * 8 for a in b["accounting"])
    assert z["state_bytes"] == half
    assert b["state_bytes"] == sum(v.nbytes for v in b["params"].values())


def test_call_returns_the_global_batch_logits(ranks, jax_dp2):
    for r in (0, 1):
        got = _got(ranks, "call", r)
        assert got["logits"].shape == jax_dp2["logits"].shape == (4, 5)
        _close(got["logits"], jax_dp2["logits"], "logits")
        _close(got["loss"], jax_dp2["loss"], "loss")


# ---------------------------------------------------------------------------
# one process per device (the departure) and the refusals
# ---------------------------------------------------------------------------
def test_one_process_per_device(ranks):
    """The JAX package runs one controller over a two-device mesh; the
    port runs two processes, each the one device of its rank, each fed
    the global batch and training on its rows."""
    for r in (0, 1):
        got = _got(ranks, "contract", r)
        assert got["rank"] == got["mesh_rank"] == got["kv_rank"] == r
        assert got["num_processes"] == got["mesh_size"] == \
            got["kv_num_workers"] == got["device_count"] == 2
        assert tuple(got["rank_info"]) == (r, 2)
        assert got["local_devices"] == ["cpu"]
        assert got["global_devices"] == ["cpu", "cpu"]
        assert got["mesh_shape"] == {"dp": 2}
        np.testing.assert_array_equal(
            got["rows"], np.arange(8.0).reshape(4, 2)[2 * r:2 * r + 2])


def test_meshes_never_collapse_and_refuse_what_is_queued(ranks):
    got = _got(ranks, "contract")
    assert got["mesh_too_large"].startswith("ValueError: mesh shape (3,) "
                                            "needs 3 ranks")
    assert got["batch_indivisible"].startswith("ValueError")
    # a dp x sp mesh builds for sequence parallelism (rank r at (0, r),
    # the whole sequence axis its line, the batch's columns split) and
    # FusedTrainStep takes dp alone
    for r in (0, 1):
        sp = _got(ranks, "contract", r)["sp_axis"]
        assert sp["shape"] == {"dp": 1, "sp": 2}
        assert tuple(sp["index"]) == (0, r)
        assert sp["sp_ranks"] == [0, 1] and sp["dp_ranks"] == [r]
        np.testing.assert_array_equal(
            sp["rows"], np.arange(8.0).reshape(4, 2)[:, r:r + 1])
    assert "mesh axes {'sp': 2} are not taken here" in got["sp_axis_fused"]
    # no process group here: one device, and two devices raise
    assert tmesh.current_device_count() == 1
    assert tmesh.data_parallel_mesh(1).size == 1
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.data_parallel_mesh(2)


def test_a_one_rank_group_runs_the_dp_path_bitwise_one_device(spec):
    """At one rank (one card) the dp path still runs — bucket hooks,
    the all-reduce, sync BN's collectives, ZeRO-1's reduce-scatter and
    all-gather, each over one rank — and equals the one-device step bit
    for bit (a sum over one rank and a multiply by 1 are exact)."""
    ranks = dist.launch(cases.one_rank_cases, 1, (spec,), device="cpu",
                        threads=1, timeout_s=300)
    one = cases.conv_run(spec, mesh=None)
    for name in ("bucketed", "zero1"):
        got = _got(ranks, name)
        assert got["bucketed"] and got["zero1"] == (name == "zero1")
        np.testing.assert_array_equal(got["losses"], one["losses"])
        _same(got["params"], one["params"], name)
    assert _got(ranks, "zero1")["state_bytes"] == sum(
        a["bytes"] for a in _got(ranks, "bucketed")["accounting"])
