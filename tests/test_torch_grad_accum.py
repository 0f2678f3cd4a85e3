"""Microbatch gradient accumulation in the port's ``FusedTrainStep``
(``accum_steps=`` / ``MXNET_GRAD_ACCUM_STEPS``), after
``tests/test_grad_accum.py``: on one device, and on two gloo ranks of a
dp mesh (bucketed, ZeRO-1, monolithic) started once for this file
(``dist.launch``; the rank side is ``tests/torch_accum_cases.py``).

The exact-arithmetic net of ``tests/test_grad_accum.py:38-56``
(integer data, 1/4-quantized weights, power-of-two lr, momentum and
batch) makes ``accum=4`` equal the full-batch step bit for bit: loss,
logits and parameters.  With BatchNorm the moving statistics move once
per microbatch (the JAX package's scan carry), so there the oracle is
the JAX package's own ``accum_steps`` step (fp64, 1e-9 relative to the
largest magnitude), and over a mesh the one-device accumulation over
the same microbatches (sync BN takes each microbatch's moments over the
ranks: rank r's k-th slice together).  The bucket collectives run once
a step whatever the accumulation; a planted fault (the hooks armed for
every microbatch) leaves the full batch.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.parallel.dp import FusedTrainStep as JStep
from mxnet_tpu_torch import dist
from mxnet_tpu_torch.parallel.dp import FusedTrainStep as TStep

import torch_accum_cases as cases
import torch_dp_cases as dp_cases

TOL = 1e-9


def _jax_exact_weights(seed=0):
    """tests/test_grad_accum.py:38-51's draw, under a fixed prefix."""
    jmx.random.seed(seed)
    np.random.seed(seed)
    nn = jmx.gluon.nn
    net = nn.HybridSequential(prefix="ex_")
    with net.name_scope():
        net.add(nn.Dense(16, in_units=8, activation="relu"),
                nn.Dense(4, in_units=16))
    net.initialize(jmx.init.Xavier())
    return {k: np.round(p.data().asnumpy() * 4.0) / 4.0
            for k, p in net.collect_params().items()}


def _exact_batch(n=32):
    rng = np.random.RandomState(1)
    return (rng.randint(-1, 2, (n, 8)).astype("float32"),
            rng.randint(-1, 2, (n, 4)).astype("float32"))


def _jax_bn_net(sample):
    np.random.seed(0)
    net = dp_cases.conv_net(jmx)
    net.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    with jmx.autograd.pause():
        net(jmx.nd.array(sample, ctx=jmx.cpu()))
    return net


@pytest.fixture(scope="module")
def spec():
    X, y = _exact_batch()
    rng = np.random.RandomState(4)
    bn_data = rng.uniform(-1, 1, (2, 8, 3, 8, 8)).astype(np.float32)
    bn_label = rng.randint(0, 5, (2, 8)).astype(np.float32)
    return dict(w0=_jax_exact_weights(), X=X, y=y, bn_data=bn_data,
                bn_label=bn_label,
                bn_w0=dp_cases.params_of(_jax_bn_net(bn_data[0][:2])))


@pytest.fixture(scope="module")
def ranks(spec):
    """Every rank-side case, run once on two gloo ranks."""
    return dist.launch(cases.accum_cases, 2, (spec,), device="cpu",
                       threads=1, timeout_s=600)


def _got(ranks, name, rank=0):
    out = ranks[rank][name]
    if isinstance(out, dict) and "error" in out:
        pytest.fail("rank %d, case %s:\n%s" % (rank, name, out["error"]))
    return out


def _same_params(a, b, what=""):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg="%s %s" % (what, k))


def _close_params(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1.0)
        err = float(np.abs(np.asarray(got[k], np.float64) - want[k]).max())
        assert err <= tol * scale, (k, err)


def _one_device_exact(spec, accum, steps=1, **kw):
    net = cases.exact_net(spec["w0"])
    with tmx.cpu():
        step = TStep(net, tmx.gluon.loss.L2Loss(), learning_rate=0.25,
                     momentum=0.5, accum_steps=accum, **kw)
        X, y = tmx.nd.array(spec["X"]), tmx.nd.array(spec["y"])
        outs = [step(X, y) for _ in range(steps)]
    return ([float(o[0].asnumpy()) for o in outs], outs[-1][1].asnumpy(),
            dp_cases.params_of(net), step)


# ---------------------------------------------------------------------------
# one device
# ---------------------------------------------------------------------------
def test_accum_matches_full_batch_single_device(spec):
    l1, o1, p1, s1 = _one_device_exact(spec, 1)
    l4, o4, p4, s4 = _one_device_exact(spec, 4)
    assert (s1._grad_accum, s4._grad_accum) == (1, 4)
    assert l1 == l4
    np.testing.assert_array_equal(o1, o4)
    _same_params(p1, p4)


def test_accum_multi_step_trajectory(spec):
    """Past step 1 the update's dyadic denominators deepen beyond
    float32, so the trajectories track at float tolerance (as the JAX
    package's do)."""
    t1 = _one_device_exact(spec, 1, steps=4)[0]
    t4 = _one_device_exact(spec, 4, steps=4)[0]
    assert t1[0] == t4[0]
    np.testing.assert_allclose(t1, t4, rtol=1e-6)


def test_accum_env_knob(spec, monkeypatch):
    """``MXNET_GRAD_ACCUM_STEPS`` is read at the build; an explicit
    ``accum_steps`` beats it."""
    monkeypatch.setenv("MXNET_GRAD_ACCUM_STEPS", "4")
    l_env, _, _, s_env = _one_device_exact(spec, None)
    l_ctl, _, _, s_ctl = _one_device_exact(spec, 1)
    assert (s_env._grad_accum, s_ctl._grad_accum) == (4, 1)
    assert l_env == l_ctl


@pytest.mark.parametrize("accum", [5, 3])
def test_accum_must_divide_batch(spec, accum):
    with pytest.raises(ValueError, match="does not divide"):
        _one_device_exact(spec, accum)


def test_accum_resume_at_step_boundary_bitwise(spec):
    """A step is one whole accumulation window: restoring parameters and
    momenta after step 2 replays steps 3-4 bit for bit."""
    cont, _, p_cont, _ = _one_device_exact(spec, 4, steps=4)
    first, _, p_mid, s_mid = _one_device_exact(spec, 4, steps=2)
    assert cont[:2] == first
    moms = [m.clone() for m in s_mid._moms]
    net = cases.exact_net(spec["w0"])
    with tmx.cpu():
        step = TStep(net, tmx.gluon.loss.L2Loss(), learning_rate=0.25,
                     momentum=0.5, accum_steps=4)
        step._build(tmx.nd.array(spec["X"][:2]))
        for k, p in net.collect_params().items():
            p.set_data(tmx.nd.array(p_mid[k]))
        step._moms = moms
        X, y = tmx.nd.array(spec["X"]), tmx.nd.array(spec["y"])
        resumed = [float(step(X, y)[0].asnumpy()) for _ in range(2)]
    assert cont[2:] == resumed
    _same_params(dp_cases.params_of(net), p_cont)


@pytest.fixture(scope="module")
def bn_jax(spec):
    """The JAX package's accum_steps=4 step on the BN net, float64, two
    steps."""
    net = _jax_bn_net(spec["bn_data"][0][:2])
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(spec["bn_w0"][k]))
    step = JStep(net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                 learning_rate=0.1, momentum=0.9, dtype="float64",
                 accum_steps=4)
    losses = step.run_steps(jmx.nd.array(spec["bn_data"]),
                            jmx.nd.array(spec["bn_label"])).asnumpy()
    return losses, dp_cases.params_of(net)


def _one_device_bn(spec, accum, data=None, label=None, **kw):
    net = dp_cases.port_conv_net(spec["bn_w0"], spec["bn_data"][0][:2])
    with tmx.cpu():
        step = TStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                     learning_rate=0.1, momentum=0.9, dtype="float64",
                     accum_steps=accum, **kw)
        losses = step.run_steps(
            tmx.nd.array(spec["bn_data"] if data is None else data),
            tmx.nd.array(spec["bn_label"] if label is None else label))
    return losses.asnumpy(), dp_cases.params_of(net)


def test_batchnorm_accum_matches_the_jax_accum_step(spec, bn_jax):
    """BatchNorm's moving statistics move once per microbatch, in order,
    as in the JAX package's scan; the full-batch step moves them once
    (a different result)."""
    jl, jp = bn_jax
    tl, tp = _one_device_bn(spec, 4)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=0)
    _close_params(tp, jp)
    _, full = _one_device_bn(spec, 1)
    moving = [k for k in tp if "running" in k]
    assert moving
    assert all(np.abs(full[k] - tp[k]).max() > 1e-6 for k in moving)


def test_stage_with_accum_equals_none_with_accum():
    """Remat inside every microbatch: the marked BN + Dropout net, two
    steps at accum 2, ``stage`` / ``conv_block`` against ``none``."""
    rng = np.random.RandomState(4)
    data = rng.uniform(-1, 1, (2, 8, 3, 8, 8)).astype(np.float32)
    label = rng.randint(0, 5, (2, 8)).astype(np.float32)
    runs = {}
    for knob in ("none", "stage", "conv_block"):
        net = cases.marked_bn_net()
        with cases.policy(knob), tmx.cpu():
            step = TStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         learning_rate=0.1, momentum=0.9, dtype="float64",
                         accum_steps=2)
            tmx.random.seed(11)
            runs[knob] = (step.run_steps(tmx.nd.array(data),
                                         tmx.nd.array(label)).asnumpy(),
                          dp_cases.params_of(net))
    for knob in ("stage", "conv_block"):
        np.testing.assert_array_equal(runs[knob][0], runs["none"][0])
        _same_params(runs[knob][1], runs["none"][1], knob)


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", ["bucketed", "zero1"])
def test_accum_matches_full_batch_dp2(ranks, spec, path):
    """accum=4 over each rank's 16 rows equals the full-batch step bit
    for bit, and both equal the one-device step, on every rank."""
    one = _one_device_exact(spec, 1)
    for r in (0, 1):
        a1 = _got(ranks, "exact_%s_a1" % path, r)
        a4 = _got(ranks, "exact_%s_a4" % path, r)
        for got in (a1, a4):
            assert float(got["loss"]) == one[0][0]
            np.testing.assert_array_equal(got["logits"], one[1])
            _same_params(got["params"], one[2], path)


def test_accum_matches_full_batch_dp2_monolithic(ranks, spec):
    one = _one_device_exact(spec, 1)
    got = _got(ranks, "exact_monolithic_a4")
    assert float(got["loss"]) == one[0][0]
    _same_params(got["params"], one[2], "monolithic")


@pytest.mark.parametrize("path", ["bucketed", "zero1"])
def test_collectives_once_a_step_whatever_the_accumulation(ranks, path):
    """One collective per bucket a step (issued from the last
    microbatch's backward), not one per bucket and microbatch."""
    a1 = _got(ranks, "exact_%s_a1" % path)
    a4 = _got(ranks, "exact_%s_a4" % path)
    n = a4["n_buckets"]
    assert n > 1
    assert a4["collectives"] == a1["collectives"]
    if path == "bucketed":
        # the buckets, the loss; the logits' all-gather
        assert a4["collectives"] == {"all_reduce": n + 1,
                                     "all_gather_into_tensor": 1}
    else:
        # the reduce-scatters, the loss; the parameter and logits gathers
        assert a4["collectives"] == {"reduce_scatter_tensor": n,
                                     "all_reduce": 1,
                                     "all_gather_into_tensor": n + 1}
    assert sorted(a4["issue_order"]) == list(range(n))


def test_hooks_armed_every_microbatch_is_caught(ranks, spec):
    """The planted fault: hooks armed for every microbatch reduce four
    partial sums a bucket and keep the last; the update leaves the
    full batch's."""
    one = _one_device_exact(spec, 1)
    bad = _got(ranks, "exact_armed_every_microbatch")
    n = bad["n_buckets"]
    assert bad["collectives"]["all_reduce"] == 4 * n + 1
    err = max(float(np.abs(bad["params"][k] - one[2][k]).max())
              for k in one[2])
    assert err > 1e-3


def _microbatch_order(b, n, a):
    """The global rows in the order one device must see them for its
    microbatch k to be the ranks' k-th microbatches together."""
    per, mb = b // n, b // n // a
    return [r * per + k * mb + i for k in range(a) for r in range(n)
            for i in range(mb)]


@pytest.mark.parametrize("path", ["bucketed", "zero1"])
def test_batchnorm_accum_dp2_matches_one_device(ranks, spec, path):
    """Sync BN over each microbatch: dp=2 at accum 2 equals one device
    at accum 2 over the same microbatches (float64)."""
    order = _microbatch_order(8, 2, 2)
    data, label = spec["bn_data"][:, order], spec["bn_label"][:, order]
    want_l, want_p = _one_device_bn(spec, 2, data, label)
    for r in (0, 1):
        got = _got(ranks, "bn_%s_a2" % path, r)
        np.testing.assert_allclose(got["losses"], want_l, rtol=TOL, atol=0)
        _close_params(got["params"], want_p)


@pytest.mark.parametrize("knob", ["stage", "conv_block"])
def test_stage_with_sync_bn_dp2_equals_none(ranks, knob):
    """Sync BN inside a remat scope all-reduces again in the recompute,
    paired on both ranks: the trajectory is none's bit for bit."""
    for r in (0, 1):
        none = _got(ranks, "marked_none", r)
        got = _got(ranks, "marked_%s" % knob, r)
        np.testing.assert_array_equal(got["losses"], none["losses"])
        _same_params(got["params"], none["params"], knob)
