"""The port's memory tier (``mxnet_tpu_torch.remat``): the conv remat
scopes ``stage`` / ``conv_block``, the ``MXNET_BACKWARD_DO_MIRROR``
mirror and their recompute guard, in ``FusedTrainStep``, hybridized
Gluon blocks, the symbolic executor (``Module.fit``, bulk fit) and the
transformer, against the port's own ``none`` run and the JAX package's.

A remat scope runs the same operations on the same inputs twice, so
every policy's trajectory equals ``none`` bit for bit in the port, with
BatchNorm and Dropout inside a scope: the recompute skips the aux
write-back (the moving statistics move once) and replays the random
state (the mask is the forward's).  Oracles are the JAX package's own
``none`` runs (fp64: ResNet-style nets 1e-9, the executor's fit 1e-10,
Gluon gradients 1e-10), never ``tests/test_remat.py``'s
``test_conv_policies_rematerialize_at_their_tier`` or
``test_symbol_path_stage_trajectory_matches_none``.  The JAX package's
remat trades memory only (its ``none`` is its oracle), so a port
policy's distance to it is its ``none``'s.

Deliberate departure pinned here: the mirror is not one selective
checkpoint around the program (the JAX package's ``jax.checkpoint``
with a save policy), whose eager recompute would run the whole forward
at once and lower no peak; it cuts regions that end at convolution and
dense layers, each recomputed when the backward reaches it
(``test_the_mirror_keeps_less_and_its_regions_end_at_conv_and_dense``,
``test_each_policy_lowers_the_cpu_peak``).  As in the JAX package, an
eager call of a block that is not hybridized runs no scope
(``test_eager_blocks_that_are_not_hybridized_run_no_scope``).
"""
import contextlib
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import remat as jremat
from mxnet_tpu_torch import convert, remat as tremat
from mxnet_tpu_torch.parallel.dp import FusedTrainStep as TStep

RESNET_TOL = 1e-9
FIT_TOL = 1e-10
GRAD_TOL = 1e-10
# FusedTrainStep's knobs: the exact-arithmetic construction of
# tests/test_remat.py:183-213 (integer inputs, 1/4-quantized weights,
# power-of-two lr, momentum and pooling windows), run in float64
STEP = dict(learning_rate=0.25, momentum=0.5, dtype="float64")

POLICIES = {"none": ("none", "0"), "stage": ("stage", "0"),
            "conv_block": ("conv_block", "0"), "mirror": ("none", "1"),
            "stage_mirror": ("stage", "1")}


@contextlib.contextmanager
def _knobs(policy="none", mirror="0"):
    old = {k: os.environ.get(k) for k in ("MXNET_REMAT_POLICY",
                                          "MXNET_BACKWARD_DO_MIRROR")}
    os.environ["MXNET_REMAT_POLICY"] = policy
    os.environ["MXNET_BACKWARD_DO_MIRROR"] = mirror
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _marked_conv_net(pkg, bn=False, dropout=0.0, prefix="rm_"):
    """Two stages of two conv units, markers at both tiers (the shape
    the zoo's ResNets carry), in either package; ``bn`` adds a
    BatchNorm to every unit and ``dropout`` a Dropout to the first
    stage's units.  Names are fixed by ``prefix``."""
    nn = pkg.gluon.nn

    def unit(f, drop):
        u = nn.HybridSequential()
        with u.name_scope():
            u.add(nn.Conv2D(f, 3, padding=1, activation=None if bn
                            else "relu"))
            if bn:
                u.add(nn.BatchNorm(), nn.Activation("relu"))
            if drop:
                u.add(nn.Dropout(drop))
        u._remat_scope = "conv_block"
        return u

    def stage(f, drop):
        s = nn.HybridSequential()
        with s.name_scope():
            s.add(unit(f, drop), unit(f, drop))
        s._remat_scope = "stage"
        return s

    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(stage(4, dropout), stage(8, 0.0),
                nn.GlobalAvgPool2D(),   # 8x8 window: /64, exact
                nn.Dense(4))
    return net


def _jax_weights(bn=False, dropout=0.0, seed=13):
    """The JAX package's Xavier draw for the marked net, quantized to
    multiples of 1/4 (float32 numpy, by name)."""
    jmx.random.seed(seed)
    np.random.seed(seed)
    net = _marked_conv_net(jmx, bn, dropout)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(np.zeros((1, 3, 8, 8), "float32")))
    return {k: np.round(p.data().asnumpy() * 4.0) / 4.0
            for k, p in net.collect_params().items()}


def _port_net(w0, bn=False, dropout=0.0):
    with tmx.cpu():
        net = _marked_conv_net(tmx, bn, dropout)
        net.initialize(tmx.init.Xavier())
        with tmx.autograd.pause():
            net(tmx.nd.array(np.zeros((1, 3, 8, 8), "float32")))
    convert.load_block_params(net, w0)
    return net


def _batch(n=8):
    rng = np.random.RandomState(2)
    return (rng.randint(-1, 2, (n, 3, 8, 8)).astype("float32"),
            rng.randint(-1, 2, (n, 4)).astype("float32"))


def _params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _port_traj(w0, knobs, steps=3, bn=False, dropout=0.0, accum=None,
               counts=None):
    """``steps`` FusedTrainStep steps of the port's marked net under the
    ``knobs`` (policy, mirror); returns (losses, parameters)."""
    X, y = _batch()
    with _knobs(*knobs), tmx.cpu():
        net = _port_net(w0, bn, dropout)
        step = TStep(net, tmx.gluon.loss.L2Loss(), accum_steps=accum,
                     **STEP)
        if counts is not None:
            # after the build's settle forward
            step._build(tmx.nd.array(X))
            _count_forwards(net, counts)
        tmx.random.seed(5)
        losses = [float(step(tmx.nd.array(X), tmx.nd.array(y))[0]
                        .asnumpy()) for _ in range(steps)]
    return np.array(losses), _params(net)


def _jax_traj(w0, steps=3, bn=False, accum=None):
    X, y = _batch()
    net = _marked_conv_net(jmx, bn)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(np.zeros((1, 3, 8, 8), "float32")))
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(w0[k]))
    from mxnet_tpu.parallel.dp import FusedTrainStep as JStep

    step = JStep(net, jmx.gluon.loss.L2Loss(), accum_steps=accum, **STEP)
    losses = [float(step(jmx.nd.array(X), jmx.nd.array(y))[0].asnumpy())
              for _ in range(steps)]
    return np.array(losses), _params(net)


def _same(a, b):
    (la, pa), (lb, pb) = a, b
    np.testing.assert_array_equal(la, lb)
    assert sorted(pa) == sorted(pb)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def _close(got, want, tol):
    (lg, pg), (lw, pw) = got, want
    np.testing.assert_allclose(lg, lw, rtol=tol, atol=0)
    assert sorted(pg) == sorted(pw)
    for k in pw:
        scale = max(float(np.abs(pw[k]).max()), 1.0)
        err = float(np.abs(np.asarray(pg[k], np.float64) - pw[k]).max())
        assert err <= tol * scale, (k, err)


# ---------------------------------------------------------------------------
# the knobs
# ---------------------------------------------------------------------------
def test_policy_names_match_the_jax_package():
    assert tremat.REMAT_POLICIES == jremat.REMAT_POLICIES
    assert tremat.CONV_SCOPES == jremat.CONV_SCOPES
    for pol in tremat.REMAT_POLICIES:
        assert tremat.remat_policy(pol) == jremat.remat_policy(pol) == pol
    for mod in (tremat, jremat):
        with pytest.raises(ValueError, match="unknown remat policy"):
            mod.remat_policy("everything")
        with pytest.raises(ValueError, match=">= 1"):
            mod.grad_accum_steps(0)
        assert mod.grad_accum_steps(3) == 3


@pytest.mark.parametrize("value", ["0", "", "false", "FALSE", "no", "Off",
                                   "1", "2", "true", "yes", "on", "x"])
def test_mirror_truthiness_matches_the_jax_package(value, monkeypatch):
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", value)
    assert tremat.mirror_enabled() is jremat.mirror_enabled()


def test_maybe_checkpoint_is_identity_with_the_mirror_off(monkeypatch):
    def f(x):
        return x * 2

    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "0")
    assert tremat.maybe_checkpoint(f) is f
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    wrapped = tremat.maybe_checkpoint(f)
    assert wrapped is not f
    x = torch.ones(3, dtype=torch.float64, requires_grad=True)
    torch.autograd.grad(wrapped(x).sum(), x)


# ---------------------------------------------------------------------------
# FusedTrainStep: every policy's trajectory is none's, bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def plain():
    """The marked net's weights, the JAX package's none trajectory and
    the port's (3 steps, float64)."""
    w0 = _jax_weights()
    return w0, _jax_traj(w0), _port_traj(w0, POLICIES["none"])


def test_port_none_matches_the_jax_none(plain):
    w0, jax_none, port_none = plain
    _close(port_none, jax_none, RESNET_TOL)


@pytest.mark.parametrize("policy", ["stage", "conv_block", "mirror",
                                    "stage_mirror"])
def test_conv_policy_trajectory_equals_none_bitwise(plain, policy):
    w0, jax_none, port_none = plain
    got = _port_traj(w0, POLICIES[policy])
    _same(got, port_none)
    _close(got, jax_none, RESNET_TOL)


@pytest.fixture(scope="module")
def bn_drop():
    """BatchNorm in every unit and Dropout(0.5) in the first stage's:
    the weights and the port's none trajectory (3 steps)."""
    w0 = _jax_weights(bn=True, dropout=0.5)
    return w0, _port_traj(w0, POLICIES["none"], bn=True, dropout=0.5)


@pytest.mark.parametrize("policy", ["stage", "conv_block", "mirror",
                                    "stage_mirror"])
def test_batchnorm_and_dropout_inside_a_scope_equal_none(bn_drop, policy):
    """The moving statistics (in the parameters compared) move once a
    step, and the recompute draws the forward's mask."""
    w0, none = bn_drop
    got = _port_traj(w0, POLICIES[policy], bn=True, dropout=0.5)
    _same(got, none)
    moving = [k for k in got[1] if "running" in k]
    assert moving and all(np.abs(got[1][k] - w0[k]).max() > 0
                          for k in moving)


@pytest.mark.parametrize("fault", ["aux_written_twice", "mask_redrawn"])
def test_the_recompute_guard_is_what_keeps_them_equal(bn_drop, fault,
                                                      monkeypatch):
    """Without the guard the same run leaves none: a second write-back
    moves the statistics again; a generator not replayed redraws the
    mask in backward (a wrong gradient of the right shape)."""
    w0, none = bn_drop
    if fault == "aux_written_twice":
        monkeypatch.setattr(tremat, "recomputing", lambda: False)
    else:
        monkeypatch.setattr(tmx.random, "set_state", lambda state: None)
    got = _port_traj(w0, POLICIES["stage"], bn=True, dropout=0.5)
    errs = [float(np.abs(got[1][k] - none[1][k]).max()) for k in none[1]]
    assert max(errs) > 1e-3


# ---------------------------------------------------------------------------
# the wrap fires where it should
# ---------------------------------------------------------------------------
def _count_forwards(net, counts):
    """Count each stage's and unit's ``forward`` calls in ``counts``."""
    stages = list(net._children.values())[:2]
    for si, s in enumerate(stages):
        for ui, u in enumerate(s._children.values()):
            _count(u, counts, "unit%d%d" % (si, ui))
        _count(s, counts, "stage%d" % si)


def _count(block, counts, name):
    fwd = block.forward
    counts[name] = 0

    def counted(*a):
        counts[name] += 1
        return fwd(*a)

    block.forward = counted


@pytest.mark.parametrize("policy,stage_runs,unit_runs", [
    ("none", 1, 1), ("stage", 2, 2), ("conv_block", 1, 2)])
def test_each_scope_runs_twice_a_step_under_its_policy(plain, policy,
                                                       stage_runs,
                                                       unit_runs):
    counts = {}
    _port_traj(plain[0], POLICIES[policy], steps=1, counts=counts)
    assert {k: v for k, v in counts.items() if k.startswith("stage")} == \
        {"stage0": stage_runs, "stage1": stage_runs}
    assert {k: v for k, v in counts.items() if k.startswith("unit")} == \
        {k: unit_runs for k in ("unit00", "unit01", "unit10", "unit11")}


@pytest.mark.parametrize("hybridize,runs", [(False, 1), (True, 2)])
def test_eager_blocks_that_are_not_hybridized_run_no_scope(plain,
                                                           hybridize,
                                                           runs):
    """The JAX package fires a scope inside a CachedOp trace only; its
    eager forward is concrete.  The port's counterpart of the trace is a
    hybridized block's call (or FusedTrainStep): an eager call of a
    block that is not hybridized runs its scopes once."""
    w0 = plain[0]
    X, _ = _batch()
    counts = {}
    with _knobs("stage"), tmx.cpu():
        net = _port_net(w0)
        if hybridize:
            net.hybridize()
        _count_forwards(net, counts)
        x = tmx.nd.array(X.astype("float64"))
        net.cast("float64")
        with tmx.autograd.record():
            loss = (net(x) ** 2).mean()
        loss.backward()
    assert counts["stage0"] == counts["stage1"] == runs


# ---------------------------------------------------------------------------
# the mirror keeps convolution and matmul outputs and lowers the peak
# ---------------------------------------------------------------------------
def _kept_bytes(net, x, mirror, monkeypatch):
    """What a recorded forward keeps for backward, by storage: the
    tensors autograd saves outside a checkpoint (saved_tensors_hooks)
    and the inputs each mirror region holds for its recompute; and each
    region's leaf blocks."""
    kept, runs = {}, []
    real_ckpt, real_run = tremat.checkpoint, tremat._mirror_run

    def region(fn, *args):
        for t in args:
            kept[t.data_ptr()] = t.numel() * t.element_size()
        return real_ckpt(fn, *args)

    def run(blocks, x):
        runs.append([type(b).__name__ for b in blocks])
        return real_run(blocks, x)

    monkeypatch.setattr(tremat, "checkpoint", region)
    monkeypatch.setattr(tremat, "_mirror_run", run)

    def pack(t):
        kept[t.data_ptr()] = t.numel() * t.element_size()
        return t

    with _knobs("none", mirror), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with tmx.autograd.record():
            loss = (net(x) ** 2).mean()
    monkeypatch.undo()
    loss.backward()
    return sum(kept.values()), [r for r in runs if r]


def _cpu_peak_bytes(fn):
    """The peak of the CPU allocator's live bytes over ``fn()``, from
    torch.profiler's memory events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) \
            as prof:
        fn()
    cur = peak = 0
    for ev in sorted((e for e in prof.events() if e.self_cpu_memory_usage),
                     key=lambda e: e.time_range.start):
        cur += ev.self_cpu_memory_usage
        peak = max(peak, cur)
    return peak


def _mirror_net(w0):
    """tests/test_remat.py:45-56's conv net (hybridized, float64): the
    mirror's regions are [BN, relu, conv] and [BN, relu, pool, dense];
    the first conv runs as itself."""
    with tmx.cpu():
        net = _small_conv_net(tmx)
        net.initialize(tmx.init.Xavier())
        with tmx.autograd.pause():
            net(tmx.nd.array(np.zeros((1, 3, 8, 8), "float32")))
        convert.load_block_params(net, w0)
        net.cast("float64")
        net.hybridize()
    return net


def test_the_mirror_keeps_less_and_its_regions_end_at_conv_and_dense(
        jax_gluon, monkeypatch):
    """Each region ends at a layer whose output the mirror keeps (or at
    the sequence's end); the first conv runs as itself.  What the
    forward keeps drops to the conv and dense outputs and the input."""
    net = _mirror_net(jax_gluon[0])
    with tmx.cpu():
        x = tmx.nd.array(np.random.RandomState(3).uniform(
            -1, 1, (8, 3, 16, 16)))
        off, off_runs = _kept_bytes(net, x, "0", monkeypatch)
        on, on_runs = _kept_bytes(net, x, "1", monkeypatch)
    assert off_runs == []
    assert on_runs == [["Conv2D"], ["BatchNorm", "Activation", "Conv2D"],
                       ["BatchNorm", "Activation", "GlobalAvgPool2D",
                        "Dense"]]
    assert on < off * 0.75, (on, off)


@pytest.mark.parametrize("knobs", [("none", "1"), ("stage", "0"),
                                   ("conv_block", "0")],
                         ids=["mirror", "stage", "conv_block"])
def test_each_policy_lowers_the_cpu_peak(jax_gluon, knobs):
    """The recompute is local (a region when the backward reaches it),
    so the peak of a forward and backward drops below none's: the
    mirror on the conv net, the scopes on the marked net with
    BatchNorm."""
    if knobs[1] == "1":
        net = _mirror_net(jax_gluon[0])
    else:
        with tmx.cpu():
            net = _port_net(_jax_weights(bn=True), bn=True)
            net.cast("float64")
            net.hybridize()
    x = np.random.RandomState(3).randint(-1, 2, (16, 3, 32, 32)) \
        .astype("float64")

    def step():
        with tmx.cpu():
            with tmx.autograd.record():
                loss = (net(tmx.nd.array(x)) ** 2).mean()
            loss.backward()

    peaks = {}
    for k in (("none", "0"), knobs):
        with _knobs(*k):
            step()
            peaks[k] = _cpu_peak_bytes(step)
    assert peaks[knobs] < 0.9 * peaks[("none", "0")], peaks


# ---------------------------------------------------------------------------
# Gluon: the hybridized mirror (tests/test_remat.py:45-71 construction)
# ---------------------------------------------------------------------------
def _small_conv_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="mir_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.Conv2D(8, 3, padding=1),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.GlobalAvgPool2D(), nn.Dense(4))
    return net


def _gluon_x():
    return np.random.RandomState(7).uniform(0, 1, (2, 3, 8, 8))


@pytest.fixture(scope="module")
def jax_gluon():
    """The JAX package's hybridized gradients (mirror off) in float64,
    and its start weights."""
    jmx.random.seed(7)
    np.random.seed(7)
    net = _small_conv_net(jmx)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(np.zeros((1, 3, 8, 8), "float32")))
    w0 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    net.cast("float64")
    net.hybridize()
    x = jmx.nd.array(_gluon_x(), dtype="float64")
    with _knobs("none", "0"):
        with jmx.autograd.record():
            loss = (net(x) ** 2).mean()
        loss.backward()
    return w0, {k: p.grad().asnumpy() for k, p in
                net.collect_params().items() if p.grad_req != "null"}


def _port_gluon_grads(w0, mirror):
    with _knobs("none", mirror), tmx.cpu():
        net = _small_conv_net(tmx)
        net.initialize(tmx.init.Xavier())
        with tmx.autograd.pause():
            net(tmx.nd.array(np.zeros((1, 3, 8, 8), "float32")))
        convert.load_block_params(net, w0)
        net.cast("float64")
        net.hybridize()
        x = tmx.nd.array(_gluon_x())
        with tmx.autograd.record():
            loss = (net(x) ** 2).mean()
        loss.backward()
    return {k: p.grad().asnumpy() for k, p in net.collect_params().items()
            if p.grad_req != "null"}


def test_gluon_hybridized_mirror_grads(jax_gluon):
    w0, jgrads = jax_gluon
    off, on = _port_gluon_grads(w0, "0"), _port_gluon_grads(w0, "1")
    assert sorted(off) == sorted(on) == sorted(jgrads)
    for k in off:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
        scale = max(float(np.abs(jgrads[k]).max()), 1.0)
        assert float(np.abs(on[k] - jgrads[k]).max()) <= GRAD_TOL * scale, k


# ---------------------------------------------------------------------------
# the executor: stage segments and the mirror (Module.fit, bulk fit)
# ---------------------------------------------------------------------------
def _stage_symbol(mx, p=0.5):
    """tests/test_remat.py:287-302's symbol, with a BatchNorm and a
    Dropout (``p``) inside stage 1."""
    with mx.name.NameManager():
        d = mx.sym.Variable("data")
        x = mx.sym.Activation(
            mx.sym.Convolution(d, num_filter=4, kernel=(3, 3), pad=(1, 1),
                               name="stem_conv"), act_type="relu")
        for s in (1, 2):
            x = mx.sym.Convolution(x, num_filter=4, kernel=(3, 3),
                                   pad=(1, 1), name="stage%d_unit1_conv1" % s)
            if s == 1:
                x = mx.sym.BatchNorm(x, fix_gamma=False,
                                     name="stage1_unit1_bn1")
            x = mx.sym.Activation(x, act_type="relu",
                                  name="stage%d_unit1_relu1" % s)
            if s == 1:
                x = mx.sym.Dropout(x, p=p, name="stage1_unit1_drop1")
        fc = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=2,
                                   name="head_fc")
        return mx.sym.SoftmaxOutput(fc, name="softmax")


def _fit_data():
    rng = np.random.RandomState(5)
    return (rng.rand(32, 3, 8, 8) - 0.5,
            (rng.rand(32) > 0.5).astype(np.float64))


def _cast(mod):
    ex = mod._exec
    for d in (ex.arg_dict, ex.aux_dict, ex.grad_dict):
        for cell in d.values():
            if cell is None:
                continue
            if isinstance(cell._data, torch.Tensor):
                cell._data = cell._data.to(torch.float64)
            else:
                cell._data = cell._data.astype("float64")


@pytest.fixture(scope="module")
def sym_start():
    """Xavier parameters drawn by the JAX package's Module (float64
    cells), as numpy dicts."""
    X, y = _fit_data()
    it = jmx.io.NDArrayIter(X, y, batch_size=8, label_name="softmax_label")
    mod = jmx.mod.Module(_stage_symbol(jmx), context=jmx.cpu(),
                         label_names=("softmax_label",))
    mod.bind(it.provide_data, it.provide_label)
    _cast(mod)
    np.random.seed(3)
    mod.init_params(jmx.init.Xavier(magnitude=2.0))
    a, x = mod.get_params()
    return ({k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x.items()})


def _fit(mx, start, knobs=("none", "0"), bulk=1, epochs=3, monitor=None,
         p=0.5):
    """``Module.fit`` of the stage symbol from ``start`` (float64, lr
    0.125, momentum 0.9) under the ``knobs``; the parameters and the
    module.  The JAX package draws other masks: held to it at p=0."""
    X, y = _fit_data()
    sym = _stage_symbol(mx, p)
    with _knobs(*knobs):
        it = mx.io.NDArrayIter(X, y, batch_size=8,
                               label_name="softmax_label")
        mod = mx.mod.Module(sym, context=mx.cpu(),
                            label_names=("softmax_label",))
        mod.bind(it.provide_data, it.provide_label)
        _cast(mod)
        if mx is tmx:
            args, aux = convert.module_params_from_jax(*start, ctx=tmx.cpu())
        else:
            args = {k: jmx.nd.array(v, dtype=v.dtype)
                    for k, v in start[0].items()}
            aux = {k: jmx.nd.array(v, dtype=v.dtype)
                   for k, v in start[1].items()}
        mod.init_params(arg_params=args, aux_params=aux)
        mx.engine.set_bulk_size(bulk)
        mx.random.seed(9)
        mod.fit(it, num_epoch=epochs, monitor=monitor,
                optimizer_params=(("learning_rate", 0.125),
                                  ("momentum", 0.9)))
    a, x = mod.get_params()
    out = {k: v.asnumpy() for k, v in a.items()}
    out.update({k: v.asnumpy() for k, v in x.items()})
    return out, mod


@pytest.fixture(autouse=True)
def _restore_bulk_size():
    saved = [(e, e._bulk_size, e._bulk_explicit)
             for e in (jmx.engine, tmx.engine)]
    yield
    for e, size, explicit in saved:
        e._bulk_size, e._bulk_explicit = size, explicit


def test_executor_remat_plan_segments_the_stages(sym_start):
    with _knobs("stage"):
        ex = _stage_symbol(tmx).simple_bind(ctx=tmx.cpu(), data=(8, 3, 8, 8))
        plan = ex._eval.remat_plan
        assert [s.key for kind, s in plan if kind == "seg"] == \
            ["stage1", "stage2"]
        assert ex._eval_monitored().remat_plan is None   # the Monitor tap
    with _knobs("conv_block"):
        ex = _stage_symbol(tmx).simple_bind(ctx=tmx.cpu(), data=(8, 3, 8, 8))
        assert len([1 for kind, _ in ex._eval.remat_plan
                    if kind == "seg"]) == 2
    with _knobs("none"):
        ex = _stage_symbol(tmx).simple_bind(ctx=tmx.cpu(), data=(8, 3, 8, 8))
        assert ex._eval.remat_plan is None


@pytest.mark.parametrize("knobs", [("stage", "0"), ("conv_block", "0"),
                                   ("none", "1"), ("stage", "1")],
                         ids=["stage", "conv_block", "mirror",
                              "stage_mirror"])
def test_executor_fit_under_a_policy_equals_none_bitwise(sym_start, knobs):
    """With the BatchNorm and the Dropout inside stage 1."""
    none, _ = _fit(tmx, sym_start)
    got, _ = _fit(tmx, sym_start, knobs)
    assert sorted(got) == sorted(none)
    for k in none:
        np.testing.assert_array_equal(got[k], none[k], err_msg=k)


def test_executor_stage_fit_matches_the_jax_none_fit(sym_start):
    want, _ = _fit(jmx, sym_start, p=0.0)
    got, _ = _fit(tmx, sym_start, ("stage", "0"), p=0.0)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1.0)
        assert float(np.abs(got[k] - want[k]).max()) <= FIT_TOL * scale, k


def test_executor_monitor_keeps_the_inline_walk(sym_start):
    """A Monitor tap needs every internal: its walk is the inline one
    under any policy, and the trajectory stays none's."""
    none, _ = _fit(tmx, sym_start, epochs=1,
                   monitor=tmx.monitor.Monitor(1, pattern=".*stage1.*"))
    got, mod = _fit(tmx, sym_start, ("stage", "0"), epochs=1,
                    monitor=tmx.monitor.Monitor(1, pattern=".*stage1.*"))
    assert mod._exec._eval.remat_plan is not None
    assert mod._exec._eval_monitored().remat_plan is None
    for k in none:
        np.testing.assert_array_equal(got[k], none[k], err_msg=k)


@pytest.mark.parametrize("bulk", [1, 2])
def test_executor_mirror_and_bulk_fit_equal_mirror_off(sym_start, bulk):
    """The bulk loop's steps are the executor's: the mirror wraps them
    too (the JAX package's bulk scan honours it)."""
    off, _ = _fit(tmx, sym_start, bulk=bulk)
    on, mod = _fit(tmx, sym_start, ("none", "1"), bulk=bulk)
    assert mod._exec._eval.remat_plan is not None     # the mirror's cuts
    if bulk > 1:
        assert mod._bulk_loop.groups > 0
    for k in off:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)


# ---------------------------------------------------------------------------
# the transformer: stage / conv_block are no-ops, the mirror is ignored
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("knobs", [("stage", "0"), ("conv_block", "0"),
                                   ("none", "1")],
                         ids=["stage", "conv_block", "mirror"])
def test_transformer_ignores_the_conv_scopes_and_the_mirror(knobs):
    from mxnet_tpu_torch import transformer as ttr

    def run(k):
        with _knobs(*k):
            cfg = ttr.TransformerConfig(vocab_size=64, n_layers=2,
                                        d_model=32, n_heads=2, d_ff=64,
                                        dtype="float64",
                                        param_dtype="float64")
            s = ttr.TransformerTrainStep(cfg, device="cpu", seed=0,
                                         learning_rate=0.05)
            it = ttr.LMTokenIter(batch_size=4, seq_len=16, vocab_size=64,
                                 num_sequences=16)
            return s.fit(it, 2), s.params_numpy()

    (l0, p0), (l1, p1) = run(("none", "0")), run(knobs)
    assert l0 == l1
    for k in p0:
        np.testing.assert_array_equal(p1[k], p0[k], err_msg=k)
