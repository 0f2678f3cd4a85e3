"""Parity of the port's ``gluon.rnn`` (``mxnet_tpu_torch/gluon/rnn``: the
recurrent cells and the fused ``RNN`` / ``LSTM`` / ``GRU`` layers) with
the JAX package's.

Both blocks are built with the same ``prefix=``, initialised by the JAX
package in float64, and carried into the port by name
(``convert.load_block_params``).  Outputs, final states and every
parameter's gradient of a seeded cotangent are compared, eager and
hybridized.  Everything runs on the CPU in float64.

Tolerance: 1e-10 relative to the largest magnitude of the JAX value.
``.params`` files cross both ways bit for bit, bfloat16 included.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert

TOL = 1e-10
T, N, I, H = 4, 3, 5, 6


def _err(got, want):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _cells(pkg, kind):
    rnn = pkg.gluon.rnn
    if kind == "rnn_relu":
        return rnn.RNNCell(H, activation="relu", input_size=I, prefix="c_")
    if kind == "lstm":
        return rnn.LSTMCell(H, input_size=I, prefix="c_")
    if kind == "gru":
        return rnn.GRUCell(H, input_size=I, prefix="c_")
    if kind == "stack":
        s = rnn.SequentialRNNCell(prefix="s_")
        with s.name_scope():
            s.add(rnn.LSTMCell(H, input_size=I, prefix="l0_"))
            s.add(rnn.DropoutCell(0.0, prefix="d_"))
            s.add(rnn.ResidualCell(rnn.GRUCell(H, input_size=H,
                                               prefix="l1_")))
        return s
    if kind == "bi":
        return rnn.BidirectionalCell(
            rnn.LSTMCell(H, input_size=I, prefix="bl_"),
            rnn.GRUCell(H, input_size=I, prefix="br_"))
    raise ValueError(kind)


def _pair(build):
    """The JAX block initialised in float64 and the port block carrying
    its weights."""
    np.random.seed(0)
    jb = build(jmx)
    jb.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    jb.cast("float64")
    tb = build(mx)
    with mx.cpu():
        tb.initialize()
        tb.cast("float64")
    return jb, tb


def _settle(jb, tb, call):
    """One paused call in each package settles deferred shapes; then
    the JAX weights go into the port block."""
    with jmx.autograd.pause():
        call(jmx, jb)
    with mx.cpu(), mx.autograd.pause():
        call(mx, tb)
    convert.load_block_params(
        tb, {k: p.data().asnumpy() for k, p in jb.collect_params().items()})


def _grads_of(pkg, block, call, cots):
    ctx = pkg.cpu()
    with ctx, pkg.autograd.record():
        outs = call(pkg, block)
        loss = None
        for o, c in zip(outs, cots):
            term = (o * pkg.nd.array(c, ctx=ctx, dtype="float64")).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    return ([o.asnumpy() for o in outs],
            {k: p.grad().asnumpy() for k, p in
             block.collect_params().items() if p.grad_req != "null"})


def _compare(jb, tb, call, hybridize):
    if hybridize:
        jb.hybridize()
        tb.hybridize()
    with jmx.autograd.pause():
        shapes = [o.shape for o in call(jmx, jb)]
    rng = np.random.RandomState(9)
    cots = [rng.uniform(-1, 1, s) for s in shapes]
    jo, jg = _grads_of(jmx, jb, call, cots)
    to, tg = _grads_of(mx, tb, call, cots)
    for got, want in zip(to, jo):
        assert _err(got, want) < TOL
    assert sorted(tg) == sorted(jg)
    for k in jg:
        assert _err(tg[k], jg[k]) < TOL, k


def _x(layout="NTC", seed=1):
    shape = (N, T, I) if layout == "NTC" else (T, N, I)
    return np.random.RandomState(seed).uniform(-1, 1, shape)


CELL_CASES = [(k, layout, merge, vl)
              for k in ("rnn_relu", "lstm", "gru", "stack", "bi")
              for layout, merge, vl in [("NTC", True, False),
                                        ("TNC", False, False),
                                        ("NTC", True, True)]
              if not (vl and k in ("rnn_relu", "stack"))]


@pytest.mark.parametrize("hybridize", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("kind,layout,merge,valid", CELL_CASES,
                         ids=["-".join(map(str, c)) for c in CELL_CASES])
def test_cell_unroll_matches_the_jax_package(kind, layout, merge, valid,
                                             hybridize):
    x = _x(layout)
    lengths = np.array([4.0, 2.0, 3.0])

    def call(pkg, cell):
        ctx = pkg.cpu()
        kw = {}
        if valid:
            kw["valid_length"] = pkg.nd.array(lengths, ctx=ctx,
                                              dtype="float64")
        begin = cell.begin_state(batch_size=N, ctx=ctx, dtype="float64")
        out, states = cell.unroll(T, pkg.nd.array(x, ctx=ctx,
                                                  dtype="float64"),
                                  begin_state=begin, layout=layout,
                                  merge_outputs=merge, **kw)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        return outs + list(states)

    jb, tb = _pair(lambda pkg: _cells(pkg, kind))
    _settle(jb, tb, call)
    _compare(jb, tb, call, hybridize)


LAYER_CASES = [("lstm", 2, True, "TNC", True), ("lstm", 1, False, "NTC",
                                                False),
               ("gru", 2, False, "NTC", True), ("gru", 1, True, "TNC",
                                                False),
               ("rnn_tanh", 2, True, "NTC", True),
               ("rnn_relu", 1, False, "TNC", True)]


def _layer(pkg, mode, layers, bidir, layout):
    rnn = pkg.gluon.rnn
    kw = dict(num_layers=layers, bidirectional=bidir, layout=layout,
              prefix="r_")
    if mode.startswith("rnn_"):
        return rnn.RNN(H, activation=mode[4:], **kw)
    return (rnn.LSTM if mode == "lstm" else rnn.GRU)(H, **kw)


@pytest.mark.parametrize("hybridize", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("mode,layers,bidir,layout,states", LAYER_CASES,
                         ids=["-".join(map(str, c)) for c in LAYER_CASES])
def test_layer_matches_the_jax_package(mode, layers, bidir, layout, states,
                                       hybridize):
    x = _x(layout, seed=3)

    def call(pkg, layer):
        ctx = pkg.cpu()
        data = pkg.nd.array(x, ctx=ctx, dtype="float64")
        if not states:
            if pkg is jmx:
                # the JAX package's default states are float32 zeros,
                # which its float64 scan refuses: pass them in float64
                return [layer(data, layer.begin_state(
                    batch_size=N, ctx=ctx, dtype="float64"))[0]]
            return [layer(data)]
        begin = [s + 0.25 for s in layer.begin_state(
            batch_size=N, ctx=ctx, dtype="float64")]
        out, new = layer(data, begin)
        return [out] + list(new)

    # input size deferred to the first call
    jb, tb = _pair(lambda pkg: _layer(pkg, mode, layers, bidir, layout))
    _settle(jb, tb, call)
    assert tb.l0_i2h_weight.shape[1] == I
    _compare(jb, tb, call, hybridize)


def test_layer_route_is_the_scan_on_the_cpu_and_checks_state_shapes():
    from mxnet_tpu_torch.ops import rnn as trnn

    with mx.cpu():
        layer = mx.gluon.rnn.LSTM(H, num_layers=2, input_size=I)
        layer.initialize()
        trnn.reset_counts()
        out = layer(mx.nd.array(_x("TNC"), dtype="float32"))
        assert out.shape == (T, N, H)
        assert trnn.calls() == {"scan/float32/lstm": 1}
        with pytest.raises(mx.MXNetError, match="Invalid recurrent state"):
            layer(mx.nd.array(_x("TNC"), dtype="float32"),
                  layer.begin_state(batch_size=N + 1))


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_params_files_cross_both_ways(tmp_path, writer, dtype):
    x = _x("TNC", seed=4)

    def call(pkg, layer):
        ctx = pkg.cpu()
        return [layer(pkg.nd.array(x, ctx=ctx, dtype="float64"),
                      layer.begin_state(batch_size=N, ctx=ctx,
                                        dtype="float64"))[0]]

    jb, tb = _pair(lambda pkg: _layer(pkg, "gru", 2, True, "TNC"))
    _settle(jb, tb, call)
    path = str(tmp_path / "rnn.params")
    if dtype == "bfloat16":
        jb.cast("bfloat16")
        tb.cast("bfloat16")
    src, dst_pkg = (tb, jmx) if writer == "port" else (jb, mx)
    with mx.cpu():
        src.save_parameters(path)
        dst = _layer(dst_pkg, "gru", 2, True, "TNC")
        dst.initialize(ctx=dst_pkg.cpu())
        dst.cast(dtype)
        dst.load_parameters(path, ctx=dst_pkg.cpu())
    want = {k: p.data() for k, p in src.collect_params().items()}
    got = dst.collect_params()
    assert sorted(got.keys()) == sorted(want)
    for k, v in want.items():
        g = got[k].data()
        assert str(g.dtype).endswith(dtype) and str(v.dtype).endswith(dtype)
        np.testing.assert_array_equal(
            g.astype("float32").asnumpy(), v.astype("float32").asnumpy())
