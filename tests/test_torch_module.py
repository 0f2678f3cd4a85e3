"""The port's Module API against the JAX package's, in float64: ``fit``
trajectories (an MLP and a small conv-BN net) to 1e-10, the bulk K-step
loop (bitwise equal to per-batch in the port, and to the JAX package's
bulk scan), a quantized lr scheduler, the order of callbacks, metric
values, checkpoints that cross-load both ways, ``BucketingModule``,
``SequentialModule``, ``PythonLossModule``, ``predict`` / ``score``,
fixed parameters, exact resume, and the bf16 optimizer-state round trip.

Both packages' ``Module`` bind float32 cells; the float64 runs cast every
cell of the bound executor (``_cast``) before the parameters go in."""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError

TRAJ_TOL = 1e-10
# the JAX package's bulk scan takes the learning rate as a float32
# scalar (mxnet_tpu/module/bulk.py:420): a float32-exact rate keeps its
# float64 comparison about the trajectory, not about that rounding
LR = 0.125


@pytest.fixture(autouse=True)
def _restore_bulk_size():
    """Any engine.set_bulk_size leaks an explicit bulk size into later
    tests of the process (ROADMAP C): restore both packages' engines."""
    saved = [(e, e._bulk_size, e._bulk_explicit)
             for e in (jmx.engine, tmx.engine)]
    yield
    for e, size, explicit in saved:
        e._bulk_size, e._bulk_explicit = size, explicit


def _mlp(mx):
    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        x = mx.sym.FullyConnected(x, num_hidden=16, name="fc1")
        x = mx.sym.Activation(x, act_type="relu")
        x = mx.sym.FullyConnected(x, num_hidden=4, name="fc2")
        return mx.sym.SoftmaxOutput(x, name="softmax")


def _conv_bn(mx):
    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        x = mx.sym.Convolution(x, num_filter=4, kernel=(3, 3), pad=(1, 1),
                               name="c1")
        x = mx.sym.BatchNorm(x, fix_gamma=False, name="bn1")
        x = mx.sym.Activation(x, act_type="relu")
        x = mx.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
        x = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=4,
                                  name="fc")
        return mx.sym.SoftmaxOutput(x, name="softmax")


NETS = {"mlp": (_mlp, (6,)), "conv_bn": (_conv_bn, (2, 6, 6))}


def _data(kind, n=40, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-1, 1, (n,) + NETS[kind][1])
    y = rng.randint(0, 4, n).astype(np.float64)
    return X, y


def _cast(mod, dtype):
    """Every cell of a bound module's executor in ``dtype``."""
    ex = mod._exec
    for d in (ex.arg_dict, ex.aux_dict, ex.grad_dict):
        for cell in d.values():
            if cell is None:
                continue
            if isinstance(cell._data, torch.Tensor):
                cell._data = cell._data.to(getattr(torch, dtype))
            else:
                cell._data = cell._data.astype(dtype)


def _host(params):
    return {k: v.asnumpy() for k, v in params.items()}


def _start(kind, seed=3):
    """Xavier parameters drawn by the JAX package's Module (numpy's
    global generator), as numpy dicts."""
    X, y = _data(kind)
    it = jmx.io.NDArrayIter(X, y, batch_size=8)
    mod = jmx.mod.Module(NETS[kind][0](jmx), context=jmx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    _cast(mod, "float64")
    np.random.seed(seed)
    mod.init_params(jmx.init.Xavier(magnitude=2.0))
    a, x = mod.get_params()
    return _host(a), _host(x)


def _module(mx, kind, start, batch=8, n=40, dtype="float64", **mod_kw):
    X, y = _data(kind, n)
    it = mx.io.NDArrayIter(X, y, batch_size=batch)
    kw = dict(mod_kw)
    kw.setdefault("context", mx.cpu())
    mod = mx.mod.Module(NETS[kind][0](mx), **kw)
    mod.bind(it.provide_data, it.provide_label)
    _cast(mod, dtype)
    if mx is tmx:
        args, aux = convert.module_params_from_jax(*start, ctx=tmx.cpu())
    else:
        args = {k: jmx.nd.array(v, dtype=v.dtype)
                for k, v in start[0].items()}
        aux = {k: jmx.nd.array(v, dtype=v.dtype)
               for k, v in start[1].items()}
    mod.init_params(arg_params=args, aux_params=aux)
    return mod, it


def _fit(mx, kind, start, bulk=1, epochs=2, opt=None, n=40, **fit_kw):
    mod, it = _module(mx, kind, start, n=n)
    mx.engine.set_bulk_size(bulk)
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params=opt or (("learning_rate", LR),
                                     ("momentum", 0.9), ("wd", 1e-3)),
            **fit_kw)
    a, x = mod.get_params()
    return _host(a), _host(x), mod


def _rel(got, want):
    return max((float(np.abs(got[k] - w).max()) /
                max(1.0, float(np.abs(w).max())) for k, w in want.items()),
               default=0.0)


@pytest.mark.parametrize("kind", sorted(NETS))
def test_fit_trajectory_matches_the_jax_package(kind):
    start = _start(kind)
    ja, jx, _ = _fit(jmx, kind, start)
    ta, tx, _ = _fit(tmx, kind, start)
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    assert _rel(ta, ja) <= TRAJ_TOL and _rel(tx, jx) <= TRAJ_TOL
    # and the run moved: 10 updates away from the start
    assert _rel(ta, start[0]) > 1e-3


@pytest.mark.parametrize("kind", sorted(NETS))
def test_bulk_with_a_tail_group_is_per_batch_bitwise(kind):
    start = _start(kind)
    # 5 batches an epoch at K=3: groups of 3 and 2
    pa, px, _ = _fit(tmx, kind, start, bulk=1)
    ba, bx, mod = _fit(tmx, kind, start, bulk=3)
    assert mod._bulk_loop is not None and mod._bulk_loop.groups == 4
    assert mod._bulk_loop.steps == 10
    for k in pa:
        np.testing.assert_array_equal(ba[k], pa[k], err_msg=k)
    for k in px:
        np.testing.assert_array_equal(bx[k], px[k], err_msg=k)
    # and equal to the JAX package's bulk scan
    ja, jx, _ = _fit(jmx, kind, start, bulk=3)
    assert _rel(ba, ja) <= TRAJ_TOL and _rel(bx, jx) <= TRAJ_TOL


def test_quantized_lr_scheduler_matches_the_jax_bulk():
    start = _start("mlp")
    runs = {}
    for mx in (jmx, tmx):
        sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5, base_lr=LR)
        runs[mx] = _fit(mx, "mlp", start, bulk=3, epochs=3,
                        opt=(("learning_rate", LR), ("momentum", 0.9),
                             ("lr_scheduler", sched)))
    ta, _, tmod = runs[tmx]
    ja = runs[jmx][0]
    assert _rel(ta, ja) <= TRAJ_TOL
    # the lr changed at group boundaries only: per-batch differs
    pa = _fit(tmx, "mlp", start, bulk=1, epochs=3,
              opt=(("learning_rate", LR), ("momentum", 0.9),
                   ("lr_scheduler", tmx.lr_scheduler.FactorScheduler(
                       step=2, factor=0.5, base_lr=LR))))[0]
    assert _rel(ta, pa) > 1e-6
    assert tmod._active_updater().optimizer.num_update == 15


@pytest.mark.parametrize("bulk", [1, 3])
def test_callbacks_fire_in_the_same_order(bulk):
    logs = {}
    start = _start("mlp")
    for mx in (jmx, tmx):
        log = logs[mx] = []

        def batch_cb(p, log=log):
            log.append(("batch", p.epoch, p.nbatch,
                        round(p.eval_metric.get()[1], 12)))

        def epoch_cb(epoch, sym, arg, aux, log=log):
            log.append(("epoch", epoch, sorted(arg), sorted(aux)))

        _fit(mx, "mlp", start, bulk=bulk, batch_end_callback=batch_cb,
             epoch_end_callback=epoch_cb, eval_metric="acc")
    assert logs[tmx] == logs[jmx]
    assert [e[:3] for e in logs[tmx] if e[0] == "batch"] == \
        [("batch", e, b) for e in range(2) for b in range(5)]


def test_metric_values_match():
    rng = np.random.RandomState(4)
    pred = rng.uniform(0.05, 1, (12, 4))
    pred /= pred.sum(1, keepdims=True)
    label = rng.randint(0, 4, 12).astype(np.float64)
    reg, reg_label = rng.uniform(-1, 1, (2, 12, 4))
    names = ["acc", "ce", "nll_loss", "mae", "mse", "rmse", "perplexity",
             "loss", ("top_k_accuracy", {"top_k": 2})]
    for spec in names:
        name, kw = spec if isinstance(spec, tuple) else (spec, {})
        p, lab = (reg, reg_label) if name in ("mae", "mse", "rmse") \
            else (pred, label)
        vals = []
        for mx, nd in ((jmx, lambda a: jmx.nd.array(a, dtype=a.dtype)),
                       (tmx, lambda a: tmx.nd.array(a, ctx=tmx.cpu(),
                                                    dtype=a.dtype))):
            m = mx.metric.create(name, **kw)
            m.update([nd(lab)], [nd(p)])
            vals.append(m.get())
        assert vals[1][0] == vals[0][0]
        np.testing.assert_allclose(vals[1][1], vals[0][1], rtol=1e-12)
    comp = [mx.metric.create(["acc", "ce"]) for mx in (jmx, tmx)]
    assert type(comp[1]).__name__ == type(comp[0]).__name__


def test_checkpoints_cross_load_both_ways(tmp_path):
    start = _start("conv_bn")
    _, _, jmod = _fit(jmx, "conv_bn", start, epochs=1)
    _, _, tmod = _fit(tmx, "conv_bn", start, epochs=1)
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    jmod.save_checkpoint(jp, 1)
    tmod.save_checkpoint(tp, 1, save_optimizer_states=True)
    X, y = _data("conv_bn")
    outs = {}
    for name, prefix in (("t_from_j", jp), ("j_from_t", tp)):
        mx = tmx if name.startswith("t") else jmx
        sym, args, aux = mx.model.load_checkpoint(prefix, 1)
        assert sorted(args) == sorted(tmod.get_params()[0])
        mod = mx.mod.Module(sym, context=mx.cpu())
        it = mx.io.NDArrayIter(X, y, batch_size=8)
        mod.bind(it.provide_data, it.provide_label, for_training=False)
        _cast(mod, "float64")
        mod.set_params(args, aux)
        outs[name] = mod.predict(it).asnumpy()
    np.testing.assert_allclose(outs["t_from_j"], outs["j_from_t"],
                               rtol=0, atol=1e-12)
    # Module.load with optimizer states, in the port
    mod = tmx.mod.Module.load(tp, 1, load_optimizer_states=True,
                              context=tmx.cpu())
    it = tmx.io.NDArrayIter(X, y, batch_size=8)
    mod.bind(it.provide_data, it.provide_label)
    _cast(mod, "float64")
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", LR),
                                         ("momentum", 0.9)))
    st = mod._active_updater().states
    assert len(st) == len(tmod._active_updater().states)


def test_predict_and_score_match():
    start = _start("conv_bn")
    res = {}
    for mx in (jmx, tmx):
        mod, it = _module(mx, "conv_bn", start, n=36)   # a padded tail
        pred = mod.predict(it).asnumpy()
        score = dict(mod.score(it, ["acc", "ce"]))
        res[mx] = pred, score
    np.testing.assert_allclose(res[tmx][0], res[jmx][0], rtol=0,
                               atol=1e-12)
    assert res[tmx][0].shape == (36, 4)
    for k, v in res[jmx][1].items():
        np.testing.assert_allclose(res[tmx][1][k], v, rtol=1e-12)


def test_fixed_params_stay_and_the_rest_matches():
    start = _start("mlp")
    got = {}
    for mx in (jmx, tmx):
        mod, it = _module(mx, "mlp", start, fixed_param_names=["fc1_weight"])
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=(("learning_rate", LR),))
        got[mx] = _host(mod.get_params()[0])
    np.testing.assert_array_equal(got[tmx]["fc1_weight"],
                                  start[0]["fc1_weight"])
    assert _rel(got[tmx], got[jmx]) <= TRAJ_TOL


def _bucket_sym(mx):
    def gen(key):
        with mx.name.NameManager():
            x = mx.sym.Variable("data")
            x = mx.sym.FullyConnected(x, num_hidden=4, name="fc",
                                      flatten=False)
            x = mx.sym.mean(x, axis=1)
            return (mx.sym.SoftmaxOutput(x, name="softmax"), ("data",),
                    ("softmax_label",))
    return gen


def test_bucketing_module_matches():
    rng = np.random.RandomState(2)
    batches = [(k, rng.uniform(-1, 1, (4, k, 3)),
                rng.randint(0, 4, 4).astype(np.float64))
               for k in (5, 3, 5, 2)]
    w0 = {"fc_weight": rng.uniform(-0.5, 0.5, (4, 3)),
          "fc_bias": np.zeros(4)}
    got = {}
    for mx in (jmx, tmx):
        nd = (lambda a: jmx.nd.array(a, dtype=a.dtype)) if mx is jmx else \
            (lambda a: tmx.nd.array(a, ctx=tmx.cpu(), dtype=a.dtype))
        mod = mx.mod.BucketingModule(_bucket_sym(mx), default_bucket_key=5,
                                     context=mx.cpu())
        mod.bind([("data", (4, 5, 3))], [("softmax_label", (4,))])
        mod.init_params(arg_params={k: nd(v) for k, v in w0.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=(("learning_rate", LR),))
        for key, x, y in batches:
            b = mx.io.DataBatch([nd(x)], [nd(y)], bucket_key=key,
                                provide_data=[mx.io.DataDesc("data",
                                                             x.shape)],
                                provide_label=[mx.io.DataDesc(
                                    "softmax_label", y.shape)])
            mod.forward_backward(b)
            mod.update()
        got[mx] = _host(mod.get_params()[0])
    # float32 cells (BucketingModule binds per bucket): float32 tolerance
    for k in w0:
        np.testing.assert_allclose(got[tmx][k], got[jmx][k], rtol=0,
                                   atol=1e-6)
    assert np.abs(got[tmx]["fc_weight"] - w0["fc_weight"]).max() > 1e-3


def _seq(mx, with_pyloss):
    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        x = mx.sym.FullyConnected(x, num_hidden=8, name="fc1")
        net1 = mx.sym.Activation(x, act_type="relu", name="relu1")
        y = mx.sym.Variable("data")
        y = mx.sym.FullyConnected(y, num_hidden=4, name="fc2")
        net2 = y if with_pyloss else mx.sym.SoftmaxOutput(y, name="softmax")
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(net1, label_names=None, context=mx.cpu()))
    seq.add(mx.mod.Module(net2, label_names=None if with_pyloss
                          else ["softmax_label"], context=mx.cpu()),
            take_labels=not with_pyloss, auto_wiring=True)
    if with_pyloss:
        seq.add(mx.mod.PythonLossModule(), take_labels=True,
                auto_wiring=True)
    return seq


@pytest.mark.parametrize("with_pyloss", [False, True])
def test_sequential_and_python_loss_modules_match(with_pyloss):
    rng = np.random.RandomState(6)
    X = rng.uniform(-1, 1, (16, 6)).astype(np.float32)
    y = rng.randint(0, 4, 16).astype(np.float32)
    np.random.seed(11)
    w0 = {"fc1_weight": rng.uniform(-.5, .5, (8, 6)), "fc1_bias":
          np.zeros(8), "fc2_weight": rng.uniform(-.5, .5, (4, 8)),
          "fc2_bias": np.zeros(4)}
    got = {}
    for mx in (jmx, tmx):
        seq = _seq(mx, with_pyloss)
        it = mx.io.NDArrayIter(X, y, batch_size=8)
        seq.bind(it.provide_data, it.provide_label)
        for m in seq._modules:
            if hasattr(m, "_exec"):
                names = m._param_names
                m.init_params(arg_params={
                    k: (jmx.nd.array(w0[k].astype(np.float32))
                        if mx is jmx else tmx.nd.array(
                            w0[k].astype(np.float32), ctx=tmx.cpu()))
                    for k in names})
        seq.params_initialized = True
        seq.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params=(("learning_rate", LR),))
        got[mx] = {k: v.asnumpy() for m in seq._modules
                   if hasattr(m, "_exec")
                   for k, v in m.get_params()[0].items()}
    for k in w0:
        np.testing.assert_allclose(got[tmx][k], got[jmx][k], rtol=0,
                                   atol=1e-5, err_msg=k)


def test_bf16_optimizer_states_round_trip(tmp_path):
    """The watch list's bf16 case for A5: a Module with bf16 parameters
    saves and loads its SGD-momentum states; after the next update the
    states' dtypes equal the JAX package's and the weights equal an
    uninterrupted port run bit for bit."""
    start = _start("mlp")
    X, y = _data("mlp", 16)
    opt = (("learning_rate", LR), ("momentum", 0.9))

    def fresh(mx, prefix=None):
        it = mx.io.NDArrayIter(X, y, batch_size=8)
        if prefix is None:
            mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
        else:
            mod = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                     context=mx.cpu())
        mod.bind(it.provide_data, it.provide_label)
        _cast(mod, "bfloat16")
        if prefix is None:
            if mx is tmx:
                args, _ = convert.module_params_from_jax(start[0], {},
                                                         ctx=tmx.cpu())
            else:
                args = {k: jmx.nd.array(v) for k, v in start[0].items()}
            mod.init_params(arg_params=args)
        else:
            mod.init_params()
        mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
        return mod, [b for b in it]

    def step(mod, batch):
        mod.forward_backward(batch)
        mod.update()

    dtypes = {}
    for mx in (jmx, tmx):
        mod, batches = fresh(mx)
        step(mod, batches[0])
        prefix = str(tmp_path / ("m_%s" % mx.__name__))
        mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
        step(mod, batches[1])
        control = _host(mod.get_params()[0])
        resumed, batches = fresh(mx, prefix)
        step(resumed, batches[1])
        states = resumed._active_updater().states
        dtypes[mx] = sorted(str(s.dtype).replace("torch.", "")
                            for s in states.values())
        if mx is tmx:
            got = _host(resumed.get_params()[0])
            for k in control:
                np.testing.assert_array_equal(got[k], control[k],
                                              err_msg=k)
            assert all(s._data.dtype == torch.bfloat16
                       for s in states.values())
    assert dtypes[tmx] == dtypes[jmx] == ["bfloat16"] * 4


def test_fit_resume_from_a_checkpoint_is_bitwise(tmp_path):
    start = _start("conv_bn")
    full_a, full_x, _ = _fit(tmx, "conv_bn", start, epochs=2)
    d = str(tmp_path / "ck")
    _fit(tmx, "conv_bn", start, epochs=1, checkpoint_every_n=3,
         checkpoint_dir=d)
    res_a, res_x, _ = _fit(tmx, "conv_bn", start, epochs=2, resume_from=d)
    for k in full_a:
        np.testing.assert_array_equal(res_a[k], full_a[k], err_msg=k)
    for k in full_x:
        np.testing.assert_array_equal(res_x[k], full_x[k], err_msg=k)


def test_nonfinite_grad_guard_skips_the_injected_step(monkeypatch):
    from mxnet_tpu_torch import chaos

    start = _start("mlp")
    clean = _fit(tmx, "mlp", start, epochs=1, n=8)[0]
    monkeypatch.setenv("MXNET_CHAOS", "nan_grad:step=1")
    monkeypatch.setenv("MXNET_SKIP_NONFINITE_GRADS", "1")
    chaos.reset()
    try:
        # without a kvstore the guard skips the step outright (with one
        # it zeroes the gradients, and weight decay still moves them)
        skipped = _fit(tmx, "mlp", start, epochs=1, n=8, kvstore=None)[0]
    finally:
        monkeypatch.delenv("MXNET_CHAOS")
        chaos.reset()
    for k in start[0]:
        np.testing.assert_array_equal(skipped[k], start[0][k])
    assert _rel(clean, start[0]) > 0


def test_the_a11_features_refuse(monkeypatch):
    from mxnet_tpu_torch import chaos

    start = _start("mlp")
    monkeypatch.setenv("MXNET_SDC_CHECK_EVERY_N", "2")
    with pytest.raises(MXNetError, match="A11"):
        _fit(tmx, "mlp", start, epochs=1)
    monkeypatch.delenv("MXNET_SDC_CHECK_EVERY_N")
    monkeypatch.setenv("MXNET_CHAOS", "bitflip_param:step=1")
    chaos.reset()
    try:
        with pytest.raises(MXNetError, match="A11"):
            _fit(tmx, "mlp", start, epochs=1)
    finally:
        monkeypatch.delenv("MXNET_CHAOS")
        chaos.reset()


def test_one_context_only_and_the_bulk_fallback_is_logged(caplog):
    # without a process group a context list collapses onto one device
    # with the JAX package's warning (the multi-rank Module is
    # tests/test_torch_module_dp.py)
    with caplog.at_level(logging.WARNING):
        mod = tmx.mod.Module(_mlp(tmx), context=[tmx.cpu(), tmx.cpu(1)])
    assert mod._num_device == 2 and mod._dp.mesh is None
    assert any("collapsing (parallelism reduced)" in r.getMessage()
               for r in caplog.records)
    start = _start("mlp")
    mod, it = _module(tmx, "mlp", start)
    mod._exec._grad_req["fc1_weight"] = "add"
    tmx.engine.set_bulk_size(4)
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params=(("learning_rate", LR),))
    msgs = [r.getMessage() for r in caplog.records
            if "bulk fit disabled" in r.getMessage()]
    assert msgs == ["bulk fit disabled: grad_req='add' accumulates across "
                    "calls (per-batch path)"]


def test_the_divergence_guard_trips_on_a_spiking_loss(monkeypatch):
    """MXNET_DIVERGENCE_WINDOW wires the guard into fit: it reads the
    per-step value of the loss-like metric and trips on a spike."""
    from mxnet_tpu_torch.diagnostics import DivergenceError

    start = _start("mlp")
    monkeypatch.setenv("MXNET_DIVERGENCE_WINDOW", "3")
    for spike_at, raises in ((4, True), (None, False)):
        seen = []

        def feval(label, pred, seen=seen):
            seen.append(1)
            return 100.0 if len(seen) == spike_at else 1.0

        metric = tmx.metric.CustomMetric(feval, name="loss")
        if raises:
            with pytest.raises(DivergenceError):
                _fit(tmx, "mlp", start, epochs=1, eval_metric=metric)
            assert len(seen) == spike_at
        else:
            _fit(tmx, "mlp", start, epochs=1, eval_metric=metric)
            assert len(seen) == 5


# ---------------------------------------------------------------------------
# the random state in checkpoints (ROADMAP C2): a resumed fit with a
# random op draws what the uninterrupted one drew
# ---------------------------------------------------------------------------
def _dropout_mlp(mx):
    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        x = mx.sym.FullyConnected(x, num_hidden=16, name="fc1")
        x = mx.sym.Activation(x, act_type="relu")
        x = mx.sym.Dropout(x, p=0.5, name="drop")
        x = mx.sym.FullyConnected(x, num_hidden=4, name="fc2")
        return mx.sym.SoftmaxOutput(x, name="softmax")


def _dropout_fit(mx, epochs, seed=4, **fit_kw):
    """FC(16), ReLU, Dropout(0.5), FC(4), SoftmaxOutput on 40 rows at
    batch 8 (5 steps an epoch), float64, from fixed start weights."""
    X, y = _data("mlp")
    it = mx.io.NDArrayIter(X, y, batch_size=8)
    mod = mx.mod.Module(_dropout_mlp(mx), context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    _cast(mod, "float64")
    start = _start("mlp")
    if mx is tmx:
        args, aux = convert.module_params_from_jax(*start, ctx=tmx.cpu())
    else:
        args = {k: jmx.nd.array(v, dtype=v.dtype)
                for k, v in start[0].items()}
        aux = {}
    mod.init_params(arg_params=args, aux_params=aux)
    mx.random.seed(seed)
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params=(("learning_rate", LR), ("momentum", 0.9)),
            **fit_kw)
    return _host(mod.get_params()[0])


def test_dropout_fit_resumes_bitwise(tmp_path):
    """2 epochs uninterrupted against 1 epoch with a checkpoint every 3
    steps, resumed (from step 3) to 2 epochs."""
    full = _dropout_fit(tmx, 2)
    d = str(tmp_path / "ck")
    _dropout_fit(tmx, 1, checkpoint_every_n=3, checkpoint_dir=d)
    # a fresh process's generator would start from the seed again
    resumed = _dropout_fit(tmx, 2, seed=99, resume_from=d)
    assert sorted(resumed) == sorted(full)
    for k in full:
        np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)
    # the masks differ between steps: a resume that redrew from the
    # seed would leave the uninterrupted run
    assert _rel(_dropout_fit(tmx, 2, seed=5), full) > 1e-3


def test_port_shards_load_in_the_jax_package_and_back(tmp_path, caplog):
    from mxnet_tpu import checkpoint as jckpt
    from mxnet_tpu_torch import checkpoint as tckpt

    d = str(tmp_path / "t")
    _dropout_fit(tmx, 1, checkpoint_every_n=3, checkpoint_dir=d)
    payload = jckpt.load_checkpoint(d)
    assert payload["step"] == 3 and payload["rng"] is None
    assert sorted(payload["rng_torch"]["generators"]) == ["cpu"]
    jckpt.set_rng_state(payload["rng"])        # nothing to restore there
    # a JAX shard carries a JAX key: the port warns and trains
    jd = str(tmp_path / "j")
    _dropout_fit(jmx, 1, checkpoint_every_n=3, checkpoint_dir=jd)
    assert jckpt.load_checkpoint(jd)["rng"]["root_key"] is not None
    with caplog.at_level(logging.WARNING):
        got = _dropout_fit(tmx, 2, resume_from=jd)
    assert any("random stream restarts" in r.getMessage()
               for r in caplog.records)
    assert all(np.isfinite(v).all() for v in got.values())
    assert tckpt.load_checkpoint(jd)["step"] == 3


def test_random_state_round_trips_bitwise():
    from mxnet_tpu_torch import random as trandom

    cpu = torch.device("cpu")
    trandom.seed(21)
    gen = trandom.generator(cpu)
    torch.rand(5, generator=gen)
    state = trandom.get_state()
    want = torch.rand(7, generator=gen, dtype=torch.float64)
    trandom.set_state(state)
    assert torch.equal(torch.rand(7, generator=gen, dtype=torch.float64),
                       want)
    # a fresh process: the generator is made, then takes the state
    trandom._generators.pop(cpu)
    trandom.seed(0)
    trandom.set_state(state)
    got = torch.rand(7, generator=trandom.generator(cpu),
                     dtype=torch.float64)
    assert torch.equal(got, want)
    # a generator the snapshot does not name restarts from its seed
    trandom.set_state({"seed": 21, "generators": {}})
    fresh = torch.Generator().manual_seed(21)
    assert torch.equal(torch.rand(3, generator=trandom.generator(cpu)),
                       torch.rand(3, generator=fresh))
    assert trandom._seed_state == 21
