"""The port's symbol layer against the JAX package's: the same graphs
list the same arguments, outputs and aux states, infer the same shapes
and dtypes (the full-width symbolic ResNet-50 of ``bench.py`` included,
inference only), serialise to byte-equal JSON and load in either
package; the legacy-JSON upgrade, ``AttrScope`` / ``ctx_group``
attributes, auto-names and the refusals of what is not ported yet."""
import importlib.util
from pathlib import Path

import pytest

import bench
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

REPO = Path(__file__).resolve().parent.parent


def _mlp(mx):
    x = mx.sym.Variable("data")
    x = mx.sym.FullyConnected(x, num_hidden=16, name="fc1")
    x = mx.sym.Activation(x, act_type="relu")
    x = mx.sym.FullyConnected(x, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(x, name="softmax")


def _conv_bn(mx):
    # auto-named nodes (no name=): the NameManager counters decide
    x = mx.sym.Variable("data")
    x = mx.sym.Convolution(x, num_filter=4, kernel=(3, 3), pad=(1, 1))
    x = mx.sym.BatchNorm(x, fix_gamma=False)
    y = mx.sym.Activation(x, act_type="relu")
    x = mx.sym.Pooling(y + x, kernel=(2, 2), stride=(2, 2),
                       pool_type="max")
    x = mx.sym.Dropout(mx.sym.Flatten(x), p=0.25)
    x = mx.sym.FullyConnected(x * 2.0 - 1.0, num_hidden=3)
    return mx.sym.SoftmaxOutput(x, name="softmax")


def _multi_out(mx):
    x = mx.sym.Variable("data")
    parts = mx.sym.SliceChannel(x, num_outputs=2, axis=1)
    bn = mx.sym.BatchNorm(parts[0], output_mean_var=True, name="bn")
    return mx.sym.Group([bn[0], mx.sym.sum(parts[1], axis=1), bn[2]])


def _resnet(mx):
    # bench._sym_resnet50 builds through the JAX package; its port twin
    # is chip_smoke.sym_resnet50
    if mx is jmx:
        return bench._sym_resnet50(1000)
    import chip_smoke

    return chip_smoke.sym_resnet50(1000)


BUILDERS = {"mlp": _mlp, "conv_bn": _conv_bn, "multi_out": _multi_out,
            "resnet50": _resnet}
SHAPES = {"mlp": {"data": (8, 10)},
          "conv_bn": {"data": (4, 2, 8, 8)},
          "multi_out": {"data": (4, 6, 5)},
          "resnet50": {"data": (32, 3, 224, 224)}}


def _pair(kind):
    out = []
    for mx in (jmx, tmx):
        with mx.name.NameManager():
            out.append(BUILDERS[kind](mx))
    return out


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_listings_are_equal(kind):
    j, t = _pair(kind)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    assert t.attr_dict() == j.attr_dict()


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_infer_shape_is_equal(kind):
    j, t = _pair(kind)
    assert t.infer_shape(**SHAPES[kind]) == j.infer_shape(**SHAPES[kind])


@pytest.mark.parametrize("kind", sorted(BUILDERS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_infer_type_is_equal(kind, dtype):
    j, t = _pair(kind)
    assert t.infer_type(data=dtype) == j.infer_type(data=dtype)


def test_infer_shape_partial_and_the_deferred_marker():
    j, t = _pair("mlp")
    assert t.infer_shape_partial() == j.infer_shape_partial()

    # a 0 dim is the deferred-init marker: the rule fills only the 0s
    def pinned(mx):
        with mx.name.NameManager():
            w = mx.sym.Variable("w", shape=(5, 0))
            return mx.sym.FullyConnected(mx.sym.Variable("data"), weight=w,
                                         num_hidden=5, name="fc")

    js, ts = pinned(jmx), pinned(tmx)
    assert ts.infer_shape(data=(3, 7)) == js.infer_shape(data=(3, 7))
    assert ts.infer_shape(data=(3, 7))[0][1] == (5, 7)
    with pytest.raises(MXNetError, match="cannot infer"):
        ts.infer_shape()


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_tojson_is_byte_equal_and_cross_loads(kind, tmp_path):
    j, t = _pair(kind)
    assert t.tojson() == j.tojson()
    # files cross-load both ways and write the same bytes again
    jf, tf = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    j.save(jf)
    t.save(tf)
    assert tmx.sym.load(jf).tojson() == j.tojson()
    assert jmx.sym.load(tf).tojson() == t.tojson()
    assert tmx.sym.load(jf).infer_shape(**SHAPES[kind]) == \
        j.infer_shape(**SHAPES[kind])


def test_the_legacy_json_fixture_loads():
    spec = importlib.util.spec_from_file_location(
        "_legacy", REPO / "tests" / "test_legacy_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    text = mod._legacy_mlp_json()
    j, t = jmx.sym.load_json(text), tmx.sym.load_json(text)
    assert t.list_arguments() == j.list_arguments() == [
        "data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"]
    assert t.attr_dict() == j.attr_dict()
    assert t.tojson() == j.tojson()
    assert t.infer_shape(data=(2, 5)) == j.infer_shape(data=(2, 5))


def test_attr_scope_and_ctx_group_round_trip():
    def build(mx):
        with mx.name.NameManager():
            with mx.AttrScope(ctx_group="dev1", lr_mult="2"):
                a = mx.sym.Variable("a")
                b = mx.sym.FullyConnected(a, num_hidden=3, name="fc")
            with mx.AttrScope(ctx_group="dev2"):
                c = mx.sym.Activation(b, act_type="tanh", name="act")
            return c

    j, t = build(jmx), build(tmx)
    assert t.tojson() == j.tojson()
    back = tmx.sym.load_json(j.tojson())
    assert back.attr("ctx_group") == "dev2"
    assert back.get_internals()["fc_output"].attr("__ctx_group__") == "dev1"
    assert back.attr_dict() == j.attr_dict()
    assert tmx.attribute.AttrScope is tmx.sym.AttrScope


def test_auto_names_and_prefix_match():
    def build(mx):
        with mx.name.NameManager():
            with mx.name.Prefix("net_"):
                x = mx.sym.Variable("x")
                y = mx.sym.FullyConnected(x, num_hidden=2)
                z = mx.sym.FullyConnected(y, num_hidden=2)
                w = z + y
            return w.get_internals().list_outputs()

    assert build(tmx) == build(jmx)
    assert "net_fullyconnected1_output" in build(tmx)


def test_symbol_composition_sugar_and_indexing():
    j, t = _pair("multi_out")
    assert t[1].list_outputs() == j[1].list_outputs()
    assert [s.name for s in t] == [s.name for s in j]
    internals = t.get_internals()
    assert internals["bn_output0"].list_outputs() == ["bn_output0"]


def test_ops_the_port_lacks_raise_and_name_their_item():
    create = tmx.symbol.symbol.create
    with pytest.raises(MXNetError, match="A12"):
        create("Custom", tmx.sym.Variable("d"), op_type="nope")
    # the sparse ops landed with sparse storage (A10): they resolve
    assert create("cast_storage", tmx.sym.Variable("d"),
                  stype="csr").list_arguments() == ["d"]
    with pytest.raises(MXNetError, match="A12"):
        tmx.sym.linalg.gemm2
    assert tmx.sym.sparse.dot(tmx.sym.Variable("a"), tmx.sym.Variable("b"),
                              transpose_a=True).list_arguments() == ["a", "b"]
    # a JAX-package graph with such an op names the item on load
    with jmx.name.NameManager():
        g = jmx.sym.Correlation(jmx.sym.Variable("a"),
                                jmx.sym.Variable("b"), max_displacement=1)
    with pytest.raises(MXNetError, match="Correlation.*A12"):
        tmx.sym.load_json(g.tojson())


def test_mx_sym_covers_the_registry():
    from mxnet_tpu_torch.ops import registry

    for name in registry.list_ops(include_aliases=True):
        assert callable(getattr(tmx.sym, name)), name
    assert tmx.sym.zeros((2, 3)).infer_shape()[1] == [(2, 3)]
