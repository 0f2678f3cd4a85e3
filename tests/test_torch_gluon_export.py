"""Gluon's symbolic side in the port against the JAX package's: a
``HybridBlock`` called on a ``Symbol`` composes the same graph;
``export`` writes the same symbol file; a port export loads into the
JAX package's ``SymbolBlock.imports`` (and a JAX export into the port's)
with equal outputs; an export runs through ``mx.sym.load`` + ``Module``
(``for_training=False``) in the port."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert


def _small(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="exp_")
    with net.name_scope():
        net.add(nn.Conv2D(6, 3, padding=1, use_bias=False), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2),
                nn.Conv2D(4, 3, padding=1), nn.GlobalAvgPool2D(),
                nn.Dense(5))
    return net


def _resnet(mx):
    return mx.gluon.model_zoo.vision.resnet18_v1(classes=7, thumbnail=True,
                                                 prefix="r18_")


NETS = {"small": _small, "resnet18": _resnet}


def _pair(kind, dtype="float64"):
    """The JAX package's net (Xavier, numpy seed 0, shapes settled) and
    the port's with the same parameters, both in ``dtype``."""
    x = np.random.RandomState(1).uniform(-1, 1, (3, 3, 16, 16))
    np.random.seed(0)
    jnet = NETS[kind](jmx)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    jnet(jmx.nd.array(x.astype(np.float32)))
    jnet.cast(dtype)
    tnet = NETS[kind](tmx)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    with tmx.autograd.pause():
        tnet(tmx.nd.array(x.astype(np.float32), ctx=tmx.cpu()))
    tnet.cast(dtype)
    convert.load_block_params(tnet, {k: p.data().asnumpy() for k, p in
                                     jnet.collect_params().items()})
    return jnet, tnet, x.astype(dtype)


@pytest.mark.parametrize("kind", sorted(NETS))
def test_symbolic_composition_and_export_match(kind, tmp_path):
    jnet, tnet, _ = _pair(kind)
    with jmx.name.NameManager():
        js = jnet(jmx.sym.Variable("data"))
    with tmx.name.NameManager():
        ts = tnet(tmx.sym.Variable("data"))
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    with jmx.name.NameManager():
        jnet.export(jp)
    with tmx.name.NameManager():
        tnet.export(tp)
    with open(jp + "-symbol.json") as f1, open(tp + "-symbol.json") as f2:
        assert f2.read() == f1.read()
    jparams = jmx.nd.load(jp + "-0000.params")
    tparams = tmx.nd.load(tp + "-0000.params", ctx=tmx.cpu())
    assert sorted(tparams) == sorted(jparams)
    assert any(k.startswith("aux:") for k in tparams)
    for k in jparams:
        np.testing.assert_array_equal(tparams[k].asnumpy(),
                                      jparams[k].asnumpy())


@pytest.mark.parametrize("kind", sorted(NETS))
def test_exports_load_across_packages_with_equal_outputs(kind, tmp_path):
    # float32: SymbolBlock.imports makes float32 parameters in both
    # packages, so the outputs are held to 1e-5 of each row's largest
    jnet, tnet, x = _pair(kind, "float32")
    want = jnet(jmx.nd.array(x, dtype=x.dtype)).asnumpy()
    got = tnet(tmx.nd.array(x, ctx=tmx.cpu(), dtype=x.dtype)).asnumpy()
    tol = 1e-5 * np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= tol).all()
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    jnet.export(jp)
    tnet.export(tp)
    # the port's file in the JAX package, the JAX package's in the port
    jblk = jmx.gluon.SymbolBlock.imports(tp + "-symbol.json", ["data"],
                                         tp + "-0000.params")
    tblk = tmx.gluon.SymbolBlock.imports(jp + "-symbol.json", ["data"],
                                         jp + "-0000.params",
                                         ctx=tmx.cpu())
    a = jblk(jmx.nd.array(x, dtype=x.dtype)).asnumpy()
    b = tblk(tmx.nd.array(x, ctx=tmx.cpu(), dtype=x.dtype)).asnumpy()
    assert a.dtype == b.dtype == np.float32
    assert (np.abs(a - want) <= tol).all() and (np.abs(b - want) <= tol).all()


def test_an_export_runs_through_module_for_inference(tmp_path):
    _, tnet, x = _pair("resnet18")
    want = tnet(tmx.nd.array(x, ctx=tmx.cpu(), dtype=x.dtype)).asnumpy()
    path = str(tmp_path / "m")
    tnet.export(path, epoch=3)
    sym = tmx.sym.load(path + "-symbol.json")
    _, args, aux = tmx.model.load_checkpoint(path, 3)
    mod = tmx.mod.Module(sym, label_names=None, context=tmx.cpu())
    mod.bind([("data", x.shape)], for_training=False)
    for d in (mod._exec.arg_dict, mod._exec.aux_dict):
        for cell in d.values():
            cell._data = cell._data.double()
    mod.set_params(args, aux)
    it = tmx.io.NDArrayIter(x, batch_size=3)
    np.testing.assert_allclose(mod.predict(it).asnumpy(), want, rtol=0,
                               atol=1e-12)


def test_symbol_block_settles_deferred_shapes_and_trains_its_stats():
    with tmx.name.NameManager():
        data = tmx.sym.Variable("data")
        out = tmx.sym.BatchNorm(tmx.sym.FullyConnected(
            data, num_hidden=3, name="fc"), name="bn")
    blk = tmx.gluon.SymbolBlock(out, data)
    assert sorted(blk.collect_params().keys()) == [
        "bn_beta", "bn_gamma", "bn_moving_mean", "bn_moving_var",
        "fc_bias", "fc_weight"]
    blk.initialize(ctx=tmx.cpu())
    x = tmx.nd.array(np.ones((4, 5), np.float32), ctx=tmx.cpu())
    assert blk(x).shape == (4, 3)
    assert blk.collect_params()["fc_weight"].shape == (3, 5)
    before = blk.collect_params()["bn_moving_var"].data().asnumpy()
    with tmx.autograd.train_mode():
        blk(x)
    after = blk.collect_params()["bn_moving_var"].data().asnumpy()
    assert not np.array_equal(before, after)
