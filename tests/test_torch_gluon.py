"""Parity of the port's Gluon (``mxnet_tpu_torch.gluon``: parameters,
blocks, layers, losses, ``Trainer``, the ResNet zoo), ``initializer``,
``optimizer`` and ``kvstore`` with the JAX package's.

Both nets are built with the same ``prefix=``, so their parameters carry
the same names; weights cross by name (``convert.load_block_params``)
or through a ``.params`` file.  Everything runs on the CPU in float64.

Tolerances: ResNet logits and every parameter gradient 1e-9 relative
to the largest magnitude of the JAX value (a few dozen layers of
float64 convolutions and BatchNorm statistics, each summed in another
order by XLA and ATen, about 1e-14 a layer); a Trainer step and the SGD
update 1e-12 (elementwise, after one backward).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import convert, gluon
from mxnet_tpu_torch.base import dtype_name
from mxnet_tpu_torch.gluon.model_zoo import vision

jnd, tnd = jmx.nd, mx.nd


def _rel(got, want):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _small_net(pkg, prefix):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2),
                nn.Conv2D(6, 3, strides=2, use_bias=False),
                nn.BatchNorm(scale=False), nn.GlobalAvgPool2D(),
                nn.Dense(5))
    return net


def _settled_pair(build_j, build_t, shape, dtype="float64", seed=0):
    """A JAX-package net and a port net of the same names, initialised
    with Xavier, settled (one inference forward), cast to ``dtype``, and
    the JAX weights carried into the port net by name."""
    x = np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)
    np.random.seed(seed)
    jnet = build_j()
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    with jag.pause():
        jnet(jnd.array(x, ctx=jmx.cpu()))
    jnet.cast(dtype)
    tnet = build_t()
    with mx.cpu():
        tnet.initialize(mx.init.Xavier())
        with tag.pause():
            tnet(tnd.array(x))
    tnet.cast(dtype)
    convert.load_block_params(tnet, {k: p.data().asnumpy() for k, p in
                                     jnet.collect_params().items()})
    return jnet, tnet


# ------------------------------------------------------------ parameters
def test_same_seed_gives_the_same_xavier_weights():
    x = np.random.RandomState(0).randn(2, 3, 8, 8).astype(np.float32)
    np.random.seed(11)
    jnet = _small_net(jmx, "n_")
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    jnet(jnd.array(x, ctx=jmx.cpu()))
    np.random.seed(11)
    tnet = _small_net(mx, "n_")
    with mx.cpu():
        tnet.initialize(mx.init.Xavier())
        tnet(tnd.array(x))
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(jp.keys()) == list(tp.keys())
    for k in jp.keys():
        np.testing.assert_array_equal(tp[k].data().asnumpy(),
                                      jp[k].data().asnumpy(), err_msg=k)


def test_deferred_init_cast_and_selection():
    with mx.cpu():
        d = gluon.nn.Dense(3, prefix="d_")
        d.initialize()
        with pytest.raises(gluon.DeferredInitializationError):
            d.weight.data()
        y = d(tnd.ones((2, 4, 2)))
        assert y.shape == (2, 3) and d.weight.shape == (3, 8)
        d2 = gluon.nn.Dense(3, flatten=False, prefix="e_")
        d2.initialize()
        assert d2(tnd.ones((2, 4, 2))).shape == (2, 4, 3)
        assert d2.weight.shape == (3, 2)
        d.cast("float64")
        assert d.weight.data().dtype == np.float64
        assert d.weight.grad().dtype == np.float64
        assert d(tnd.ones((2, 8), dtype="float64")).dtype == np.float64
    net = _small_net(mx, "s_")
    names = list(net.collect_params().keys())
    assert names[:2] == ["s_conv2d0_weight", "s_conv2d0_bias"]
    assert list(net.collect_params(".*batchnorm.*_running_.*").keys()) == [
        "s_batchnorm0_running_mean", "s_batchnorm0_running_var",
        "s_batchnorm1_running_mean", "s_batchnorm1_running_var"]
    assert [k for k in names if k.endswith("gamma")] == [
        "s_batchnorm0_gamma", "s_batchnorm1_gamma"]
    assert net.collect_params()["s_batchnorm1_gamma"].grad_req == "null"
    jnames = list(_small_net(jmx, "s_").collect_params().keys())
    assert names == jnames


def test_fresh_scope_names_follow_the_same_counters():
    # two nets built the same way in a fresh process scope: same names
    from mxnet_tpu.gluon import block as jblock
    from mxnet_tpu_torch.gluon import block as tblock

    jblock._naming.counters, tblock._naming.counters = {}, {}
    j = jvision.resnet18_v1(thumbnail=True, classes=10)
    t = vision.resnet18_v1(thumbnail=True, classes=10)
    assert list(j.collect_params().keys()) == \
        list(t.collect_params().keys())
    assert "resnetv10_stage1_conv2d0_weight" in t.collect_params()


def test_cached_op_keeps_cells_and_aux_positions():
    from mxnet_tpu.gluon.block import CachedOp as JCachedOp
    from mxnet_tpu_torch.gluon.block import CachedOp as TCachedOp

    jnet, tnet = _small_net(jmx, "c_"), _small_net(mx, "c_")
    jc, tc = JCachedOp(jnet), TCachedOp(tnet)
    assert [p.name for _, _, p in jc._param_cells] == \
        [p.name for _, _, p in tc._param_cells]
    assert jc._aux_positions == tc._aux_positions


def test_hybridize_stays_eager_and_writes_aux_back():
    jnet, tnet = _settled_pair(lambda: _small_net(jmx, "h_"),
                               lambda: _small_net(mx, "h_"), (2, 3, 8, 8))
    x = np.random.RandomState(1).randn(2, 3, 8, 8)
    jnet.hybridize()
    tnet.hybridize()
    with jag.record():
        jy = jnet(jnd.array(x, dtype="float64", ctx=jmx.cpu()))
    with mx.cpu(), tag.record():
        ty = tnet(tnd.array(x, dtype="float64"))
    assert _rel(ty.asnumpy(), jy.asnumpy()) < 1e-12
    for k, p in jnet.collect_params(".*running.*").items():
        got = tnet.collect_params()[k].data().asnumpy()
        assert _rel(got, p.data().asnumpy()) < 1e-12, k


def test_params_file_loads_across_packages(tmp_path):
    jnet, tnet = _settled_pair(lambda: _small_net(jmx, "f_"),
                               lambda: _small_net(mx, "f_"), (2, 3, 8, 8))
    x = np.random.RandomState(2).randn(2, 3, 8, 8)
    # the JAX package's file into a fresh port net, and back
    jnet.save_parameters(str(tmp_path / "j.params"))
    t2 = _small_net(mx, "f_")
    with mx.cpu():
        t2.initialize()
        t2.cast("float64")
        t2.load_parameters(str(tmp_path / "j.params"), ctx=mx.cpu())
        t2.save_parameters(str(tmp_path / "t.params"))
        ty = t2(tnd.array(x, dtype="float64"))
    j2 = _small_net(jmx, "f_")
    j2.initialize(ctx=jmx.cpu())
    j2.cast("float64")
    j2.load_parameters(str(tmp_path / "t.params"), ctx=jmx.cpu())
    jy = jnet(jnd.array(x, dtype="float64", ctx=jmx.cpu()))
    assert _rel(ty.asnumpy(), jy.asnumpy()) < 1e-12
    assert _rel(j2(jnd.array(x, dtype="float64", ctx=jmx.cpu())).asnumpy(),
                jy.asnumpy()) < 1e-12
    for k, p in jnet.collect_params().items():
        np.testing.assert_array_equal(
            t2.collect_params()[k].data().asnumpy(), p.data().asnumpy())


def test_load_block_params_checks_names_and_shapes():
    with mx.cpu():
        net = gluon.nn.Dense(3, in_units=4, prefix="l_")
        net.initialize()
    good = {"l_weight": np.ones((3, 4)), "l_bias": np.zeros(3)}
    with pytest.raises(ValueError, match="names differ"):
        convert.load_block_params(net, {"l_weight": good["l_weight"]})
    with pytest.raises(ValueError, match="shape"):
        convert.load_block_params(net, dict(good, l_bias=np.zeros(4)))
    convert.load_block_params(net, good)
    np.testing.assert_array_equal(net.weight.data().asnumpy(), 1.0)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    for net in (gluon.nn.Dense(3, in_units=4), gluon.nn.Dense(3),
                vision.resnet18_v1(thumbnail=True, classes=10)):
        with pytest.raises(mx.MXNetError, match=r"ctx=mx\.cpu\(\)"):
            net.initialize()


# ------------------------------------------------------------------ zoo
# ResNet-50 at 64x64, not 32x32: at 32x32 its last stage is 1x1, so each
# BatchNorm there normalises 2 values a channel, which is ill-conditioned
# (float64 XLA and ATen already differ by 2e-10 after that stage and by
# 1e-6 at the logits, each within its own rounding); at 64x64 it
# normalises 8, and the packages agree to ~1e-13
@pytest.mark.parametrize("arch", [
    dict(fn="resnet18_v1", kw=dict(thumbnail=True, classes=10),
         shape=(2, 3, 32, 32)),
    dict(fn="resnet50_v1", kw=dict(classes=10), shape=(2, 3, 64, 64)),
], ids=["resnet18_v1_thumbnail", "resnet50_v1"])
def test_resnet_logits_and_gradients_match(arch):
    shape = arch["shape"]
    build = lambda z: getattr(z, arch["fn"])(prefix="r_",  # noqa: E731
                                             **arch["kw"])
    jnet, tnet = _settled_pair(lambda: build(jvision),
                               lambda: build(vision), shape)
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, shape)
    cot = rng.standard_normal((shape[0], 10))
    with jag.record():
        jy = jnet(jnd.array(x, dtype="float64", ctx=jmx.cpu()))
        jl = (jy * jnd.array(cot, dtype="float64", ctx=jmx.cpu())).sum()
    jl.backward()
    with mx.cpu():
        with tag.record():
            ty = tnet(tnd.array(x, dtype="float64"))
            tl = (ty * tnd.array(cot, dtype="float64")).sum()
        tl.backward()
    assert _rel(ty.asnumpy(), jy.asnumpy()) < 1e-9
    tp = tnet.collect_params()
    jp = jnet.collect_params()
    # a convolution's bias before a BatchNorm has a gradient that is 0 in
    # exact arithmetic, so its float64 values are rounding noise: every
    # gradient is held to 1e-9 of its own scale, or of 1e-3 of the net's
    # largest gradient where that is larger
    big = max(float(np.abs(p.grad().asnumpy()).max())
              for p in jp.values() if p.grad_req != "null")
    for k, p in jp.items():
        if p.grad_req == "null":
            # BatchNorm running statistics, moved by the recorded forward
            assert _rel(tp[k].data().asnumpy(), p.data().asnumpy()) < 1e-9, k
            continue
        want = p.grad().asnumpy()
        err = np.abs(tp[k].grad().asnumpy() - want).max()
        assert err <= 1e-9 * max(np.abs(want).max(), 1e-3 * big), k


# ------------------------------------------------- trainer and optimizer
def test_trainer_step_matches(tmp_path):
    jnet, tnet = _settled_pair(lambda: _small_net(jmx, "t_"),
                               lambda: _small_net(mx, "t_"), (4, 3, 8, 8))
    rng = np.random.RandomState(4)
    x, y = rng.randn(4, 3, 8, 8), rng.randint(0, 5, (4,)).astype(np.float64)
    opts = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", opts)
    ttr = gluon.Trainer(tnet.collect_params(), "sgd", opts)
    assert ttr._kvstore_spec == "device"
    jloss, tloss = (jgluon.loss.SoftmaxCrossEntropyLoss(),
                    gluon.loss.SoftmaxCrossEntropyLoss())
    for _ in range(2):
        with jag.record():
            jl = jloss(jnet(jnd.array(x, dtype="float64", ctx=jmx.cpu())),
                       jnd.array(y, dtype="float64", ctx=jmx.cpu()))
        jl.backward()
        jtr.step(4)
        with mx.cpu():
            with tag.record():
                tl = tloss(tnet(tnd.array(x, dtype="float64")),
                           tnd.array(y, dtype="float64"))
            tl.backward()
            ttr.step(4)
        assert _rel(tl.asnumpy(), jl.asnumpy()) < 1e-12
    tp = tnet.collect_params()
    for k, p in jnet.collect_params().items():
        # absolute for values below 1: a conv bias before a BatchNorm has a
        # gradient of ~0, and its values after the steps are rounding noise
        np.testing.assert_allclose(tp[k].data().asnumpy(),
                                   p.data().asnumpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    # the optimizer states cross in the JAX package's format
    ttr.save_states(str(tmp_path / "t.states"))
    jtr2 = jgluon.Trainer(jnet.collect_params(), "sgd", opts)
    jtr2.load_states(str(tmp_path / "t.states"))
    jst = jtr._kvstore._opt_updater.states
    for i, s in jtr2._kvstore._opt_updater.states.items():
        np.testing.assert_allclose(s.asnumpy(), jst[i].asnumpy(),
                                   rtol=1e-12, atol=1e-12)


def test_sgd_update_matches_the_jax_op():
    rng = np.random.RandomState(5)
    w, g, m = rng.randn(4, 3), rng.randn(4, 3), rng.randn(4, 3)
    opt = mx.optimizer.create("sgd", learning_rate=0.2, momentum=0.9,
                              wd=1e-3, rescale_grad=0.5, clip_gradient=1.0,
                              param_idx2name={0: "w_weight"})
    with mx.cpu():
        tw, tm = tnd.array(w, dtype="float64"), tnd.array(m, dtype="float64")
        opt.update(0, tw, tnd.array(g, dtype="float64"), tm)
    jm = jnd.array(m, dtype="float64", ctx=jmx.cpu())
    jw = jnd.sgd_mom_update(jnd.array(w, dtype="float64", ctx=jmx.cpu()),
                            jnd.array(g, dtype="float64", ctx=jmx.cpu()), jm,
                            lr=0.2, momentum=0.9, wd=1e-3, rescale_grad=0.5,
                            clip_gradient=1.0)
    assert _rel(tw.asnumpy(), jw.asnumpy()) < 1e-15
    assert _rel(tm.asnumpy(), jm.asnumpy()) < 1e-15


def test_queued_kinds_raise_and_name_the_queue():
    # tpu and nccl are ported (tests/test_torch_module_dp.py); the
    # parameter-server kinds too (tests/test_torch_dist_kvstore.py):
    # without the launcher's env they are the one-process store
    assert type(mx.kv.create("tpu")) is mx.kvstore.KVStore
    assert mx.kv.create("tpu").type == "tpu"
    assert mx.kv.create("nccl").type == "nccl"
    for kind in ("dist_sync", "dist_async", "dist_device_sync"):
        kv = mx.kv.create(kind)
        assert type(kv) is mx.kvstore.KVStore and kv.type == kind
        assert (kv.rank, kv.num_workers) == (0, 1)
    with pytest.raises(mx.MXNetError, match="A10 sparse"):
        mx.kv.create("dist_sync").row_sparse_pull("k", row_ids=[0])
    with pytest.raises(mx.MXNetError, match="A12"):
        mx.optimizer.create("adam")
    # SymbolBlock landed with the symbol path; the sparse symbols wait
    with pytest.raises(mx.MXNetError, match="A10"):
        mx.sym.sparse.dot


def test_kvstore_push_sums_and_pull_copies():
    with mx.cpu():
        kv = mx.kv.create("local")
        kv.init(3, tnd.zeros((2,)))
        kv.push(3, [tnd.ones((2,)), tnd.ones((2,)) * 2])
        out = tnd.zeros((2,))
        kv.pull(3, out)
        np.testing.assert_array_equal(out.asnumpy(), [3.0, 3.0])
        kv.pushpull(3, tnd.ones((2,)), out)
        np.testing.assert_array_equal(out.asnumpy(), [1.0, 1.0])


# ------------------------------------------------- every layer and loss
def _layer(pkg, name, kw):
    nn = pkg.gluon.nn
    if name == "HybridLambda":
        return nn.HybridLambda("relu", prefix="lay_")
    if name == "Lambda":
        return nn.Lambda("tanh", prefix="lay_")
    return getattr(nn, name)(prefix="lay_", **kw)


LAYERS = [
    ("Dense", dict(units=4, activation="tanh"), (2, 3, 5)),
    ("Dense", dict(units=4, flatten=False), (2, 3, 5)),
    ("Activation", dict(activation="softrelu"), (2, 6)),
    ("LeakyReLU", dict(alpha=0.2), (2, 6)),
    ("PReLU", {}, (2, 3, 4)),
    ("ELU", dict(alpha=0.7), (2, 6)),
    ("SELU", {}, (2, 6)),
    ("GELU", {}, (2, 6)),
    ("Swish", dict(beta=1.5), (2, 6)),
    ("Dropout", dict(rate=0.0), (2, 6)),
    ("BatchNorm", dict(momentum=0.8, center=False), (3, 4, 2, 2)),
    ("Embedding", dict(input_dim=7, output_dim=3), (2, 4)),
    ("Flatten", {}, (2, 3, 2)),
    ("LayerNorm", {}, (2, 3, 5)),
    ("InstanceNorm", dict(scale=True), (2, 3, 4, 4)),
    ("Lambda", {}, (2, 6)),
    ("HybridLambda", {}, (2, 6)),
    ("Conv1D", dict(channels=4, kernel_size=3, strides=2, padding=1),
     (2, 3, 9)),
    ("Conv2D", dict(channels=4, kernel_size=3, groups=2, dilation=2),
     (2, 4, 7, 7)),
    ("Conv3D", dict(channels=2, kernel_size=2), (1, 2, 3, 4, 3)),
    ("Conv1DTranspose", dict(channels=3, kernel_size=3, strides=2,
                             output_padding=1), (2, 2, 5)),
    ("Conv2DTranspose", dict(channels=3, kernel_size=3, strides=2,
                             padding=1), (2, 2, 4, 4)),
    ("Conv3DTranspose", dict(channels=2, kernel_size=2), (1, 2, 2, 3, 2)),
    ("MaxPool1D", dict(pool_size=3, strides=2, ceil_mode=True), (2, 3, 8)),
    ("MaxPool3D", dict(pool_size=2), (1, 2, 4, 4, 4)),
    ("AvgPool1D", dict(pool_size=2, padding=1, count_include_pad=False),
     (2, 3, 7)),
    ("AvgPool2D", dict(pool_size=3, strides=2, ceil_mode=True),
     (2, 3, 8, 8)),
    ("AvgPool3D", dict(pool_size=2), (1, 2, 4, 4, 4)),
    ("GlobalMaxPool1D", {}, (2, 3, 5)),
    ("GlobalMaxPool2D", {}, (2, 3, 4, 5)),
    ("GlobalMaxPool3D", {}, (1, 2, 3, 3, 2)),
    ("GlobalAvgPool1D", {}, (2, 3, 5)),
    ("GlobalAvgPool3D", {}, (1, 2, 3, 3, 2)),
    ("ReflectionPad2D", dict(padding=2), (1, 2, 4, 5)),
]


@pytest.mark.parametrize("name,kw,shape", LAYERS,
                         ids=["%s%d" % (l[0], i) for i, l in
                              enumerate(LAYERS)])
def test_layer_matches(name, kw, shape):
    rng = np.random.RandomState(6)
    if name == "Embedding":
        x = rng.randint(0, 7, shape).astype(np.float64)
    else:
        x = rng.choice([-1.0, 1.0], shape) * rng.uniform(0.1, 2.0, shape)
    np.random.seed(1)
    jl = _layer(jmx, name, kw)
    jl.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    jl.cast("float64")
    jx = jnd.array(x, dtype="float64", ctx=jmx.cpu())
    jx.attach_grad()
    with jag.record():
        jy = jl(jx)
    tl = _layer(mx, name, kw)
    with mx.cpu():
        tl.initialize(mx.init.Xavier())
        tl.cast("float64")
        if jl.collect_params():
            with tag.pause():
                tl(tnd.array(x, dtype="float64"))
            convert.load_block_params(tl, {k: p.data().asnumpy() for k, p
                                           in jl.collect_params().items()})
        tx = tnd.array(x, dtype="float64")
        tx.attach_grad()
        with tag.record():
            ty = tl(tx)
    assert _rel(ty.asnumpy(), jy.asnumpy()) < 1e-12
    if name == "Embedding":
        return
    cot = rng.standard_normal(jy.shape)
    jy.backward(jnd.array(cot, dtype="float64", ctx=jmx.cpu()))
    with mx.cpu():
        ty.backward(tnd.array(cot, dtype="float64"))
    assert _rel(tx.grad.asnumpy(), jx.grad.asnumpy()) < 1e-12


LOSSES = [
    ("L2Loss", {}, "dense"), ("L1Loss", dict(weight=0.5), "dense"),
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary"),
    ("SigmoidBCELoss", dict(from_sigmoid=True), "prob"),
    ("SoftmaxCrossEntropyLoss", {}, "sparse"),
    ("SoftmaxCELoss", dict(sparse_label=False), "dist"),
    ("KLDivLoss", dict(from_logits=False), "dist"),
    ("HuberLoss", dict(rho=0.5), "dense"), ("HingeLoss", {}, "signed"),
    ("SquaredHingeLoss", {}, "signed"), ("LogisticLoss", {}, "signed"),
    ("TripletLoss", {}, "triplet"), ("CosineEmbeddingLoss", {}, "cosine"),
]


@pytest.mark.parametrize("name,kw,kind", LOSSES, ids=[l[0] for l in LOSSES])
def test_loss_matches(name, kw, kind):
    rng = np.random.RandomState(8)
    pred = rng.uniform(0.05, 0.95, (4, 5)) if kind == "prob" else \
        rng.randn(4, 5)
    extra = {
        "dense": [rng.randn(4, 5)],
        "binary": [rng.randint(0, 2, (4, 5)).astype(np.float64)],
        "prob": [rng.randint(0, 2, (4, 5)).astype(np.float64)],
        "sparse": [rng.randint(0, 5, (4,)).astype(np.float64)],
        "dist": [rng.dirichlet(np.ones(5), 4)],
        "signed": [rng.choice([-1.0, 1.0], (4, 5))],
        "triplet": [rng.randn(4, 5), rng.randn(4, 5)],
        "cosine": [rng.randn(4, 5), rng.choice([-1.0, 1.0], (4,))],
    }[kind]
    jx = jnd.array(pred, dtype="float64", ctx=jmx.cpu())
    jx.attach_grad()
    with jag.record():
        jl = getattr(jgluon.loss, name)(**kw)(
            jx, *[jnd.array(a, dtype="float64", ctx=jmx.cpu())
                  for a in extra])
    jl.backward()
    with mx.cpu():
        tx = tnd.array(pred, dtype="float64")
        tx.attach_grad()
        with tag.record():
            tl = getattr(gluon.loss, name)(**kw)(
                tx, *[tnd.array(a, dtype="float64") for a in extra])
        tl.backward()
    assert _rel(tl.asnumpy(), jl.asnumpy()) < 1e-12
    assert _rel(tx.grad.asnumpy(), jx.grad.asnumpy()) < 1e-12


def test_dense_without_bias_runs():
    # the JAX package's eager Dense(use_bias=False) fails on its None
    # bias (ROADMAP C); the port drops the absent input
    with mx.cpu():
        d = gluon.nn.Dense(3, use_bias=False, in_units=4, prefix="nb_")
        d.initialize()
        x = tnd.array(np.arange(8.0, dtype=np.float32).reshape(2, 4))
        np.testing.assert_allclose(
            d(x).asnumpy(), x.asnumpy() @ d.weight.data().asnumpy().T,
            rtol=1e-6)
    assert list(d.collect_params().keys()) == ["nb_weight"]


def test_bf16_trainer_state_roundtrip(tmp_path):
    """A bf16 Trainer (SGD, momentum 0.9) saved and reloaded mid-run
    keeps its momentum in bf16, as the JAX package's does, and goes on
    bitwise on the trajectory of a run that was never interrupted."""
    rng = np.random.RandomState(11)
    x = rng.randn(4, 6).astype(np.float32)
    y = rng.randint(0, 3, (4,)).astype(np.float32)
    w0 = {"d_weight": rng.randn(3, 6).astype(np.float32) * 0.3,
          "d_bias": rng.randn(3).astype(np.float32) * 0.1}
    opts = {"learning_rate": 0.1, "momentum": 0.9}

    def jax_states():
        net = jgluon.nn.Dense(3, in_units=6, prefix="d_")
        net.initialize(ctx=jmx.cpu())
        net.cast("bfloat16")
        for k, p in net.collect_params().items():
            p.set_data(jnd.array(w0[k], ctx=jmx.cpu()).astype("bfloat16"))
        tr = jgluon.Trainer(net.collect_params(), "sgd", opts)
        loss = jgluon.loss.SoftmaxCrossEntropyLoss()

        def step(trainer):
            with jag.record():
                out = loss(net(jnd.array(x, ctx=jmx.cpu()).astype(
                    "bfloat16")), jnd.array(y, ctx=jmx.cpu()).astype(
                        "bfloat16"))
            out.backward()
            trainer.step(4)
        step(tr)
        tr.save_states(str(tmp_path / "j.states"))
        tr2 = jgluon.Trainer(net.collect_params(), "sgd", opts)
        tr2.load_states(str(tmp_path / "j.states"))
        step(tr2)
        return {i: str(s.dtype) for i, s in
                tr2._kvstore._opt_updater.states.items()}

    def port_run(interrupt):
        with mx.cpu():
            net = gluon.nn.Dense(3, in_units=6, prefix="d_")
            net.initialize()
            net.cast("bfloat16")
            for k, p in net.collect_params().items():
                p.set_data(tnd.array(w0[k]).astype("bfloat16"))
            tr = gluon.Trainer(net.collect_params(), "sgd", opts)
            loss = gluon.loss.SoftmaxCrossEntropyLoss()

            def step(trainer):
                with tag.record():
                    out = loss(net(tnd.array(x).astype("bfloat16")),
                               tnd.array(y).astype("bfloat16"))
                out.backward()
                trainer.step(4)
            step(tr)
            if interrupt:
                tr.save_states(str(tmp_path / "t.states"))
                tr = gluon.Trainer(net.collect_params(), "sgd", opts)
                tr.load_states(str(tmp_path / "t.states"))
            for _ in range(2):
                step(tr)
            states = {i: dtype_name(s.dtype) for i, s in
                      tr._kvstore._opt_updater.states.items()}
            return states, {k: p.data()._data.clone() for k, p in
                            net.collect_params().items()}

    want_dtypes = jax_states()
    got_dtypes, resumed = port_run(interrupt=True)
    _, control = port_run(interrupt=False)
    assert set(want_dtypes.values()) == {"bfloat16"}
    assert got_dtypes == want_dtypes
    for k in control:
        assert resumed[k].dtype == torch.bfloat16
        assert torch.equal(resumed[k], control[k]), k
