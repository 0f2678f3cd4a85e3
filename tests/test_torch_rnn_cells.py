"""Parity of the port's symbolic recurrent tier (``mxnet_tpu_torch/rnn``:
the ``mx.rnn`` cells, ``BucketSentenceIter``, the checkpoint helpers)
and of ``BucketingModule`` training a bucketed LSTM language model, with
the JAX package's.

Each cell's ``unroll`` builds the same graph in both packages (JSON byte
for byte, built under ``NameManager`` so the auto-names match); both
bind it on the CPU with the same seeded float64 arguments and run
forward and backward.  Tolerance: 1e-10 relative to the largest
magnitude of the JAX value; trajectories 1e-10 relative to max(1, |w|).
Cells that draw (dropout, zoneout) are compared as graphs only: the
random streams differ between the packages.
"""
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert

TOL = 1e-10
H = 5


@pytest.fixture(autouse=True)
def _per_batch_fit():
    """Per-batch fit in both packages whatever an earlier test of the
    process left in the engines' bulk size; restored after."""
    saved = [(e, e._bulk_size, e._bulk_explicit)
             for e in (jmx.engine, tmx.engine)]
    for e in (jmx.engine, tmx.engine):
        e.set_bulk_size(1)
    yield
    for e, size, explicit in saved:
        e._bulk_size, e._bulk_explicit = size, explicit


def _err(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / max(np.max(np.abs(want)), 1e-300))


# cell builders: pkg -> (cell, unroll kwargs)
def _lstm(mx):
    return mx.rnn.LSTMCell(H, prefix="l_")


def _stack(mx):
    s = mx.rnn.SequentialRNNCell()
    s.add(mx.rnn.LSTMCell(H, prefix="s0_"))
    s.add(mx.rnn.DropoutCell(0.0, prefix="sd_"))
    s.add(mx.rnn.ResidualCell(mx.rnn.GRUCell(H, prefix="s1_")))
    return s


def _bi(mx):
    return mx.rnn.BidirectionalCell(mx.rnn.LSTMCell(H, prefix="bl_"),
                                    mx.rnn.GRUCell(H, prefix="br_"))


def _fused(mode, layers, bidir, next_state=True):
    return lambda mx: mx.rnn.FusedRNNCell(
        H, num_layers=layers, mode=mode, bidirectional=bidir,
        get_next_state=next_state, prefix="f_")


CELLS = {
    "rnn_tanh": lambda mx: mx.rnn.RNNCell(H, prefix="r_"),
    "rnn_relu": lambda mx: mx.rnn.RNNCell(H, activation="relu",
                                          prefix="r_"),
    "lstm": _lstm,
    "gru": lambda mx: mx.rnn.GRUCell(H, prefix="g_"),
    "stack": _stack,
    "bidirectional": _bi,
    "fused_lstm_2_bi": _fused("lstm", 2, True),
    "fused_gru_1": _fused("gru", 1, False),
    "fused_rnn_relu_2": _fused("rnn_relu", 2, False, next_state=False),
}

UNROLLS = [(name, layout, merge, begin)
           for name in CELLS
           for layout, merge, begin in [("NTC", True, False),
                                        ("TNC", False, True)]]


def _graph(mx, name, layout, merge, begin, length=3):
    with mx.name.NameManager():
        cell = CELLS[name](mx)
        data = mx.sym.Variable("data")
        states = cell.begin_state() if begin else None
        out, states = cell.unroll(length, data, begin_state=states,
                                  layout=layout, merge_outputs=merge)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        return mx.sym.Group(outs + list(states))


def _run(mx, s, shapes, seed=0):
    ctx = mx.cpu()
    arg_shapes, _, _ = s.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    vals = {n: rng.uniform(-1, 1, sh)
            for n, sh in zip(s.list_arguments(), arg_shapes)}
    args = {n: mx.nd.array(v, ctx=ctx, dtype="float64")
            for n, v in vals.items()}
    grads = {n: mx.nd.zeros(v.shape, ctx=ctx, dtype="float64")
             for n, v in vals.items()}
    ex = s.bind(ctx, args, args_grad=grads)
    outs = ex.forward(is_train=True)
    cots = [rng.uniform(-1, 1, o.shape) for o in outs]
    ex.backward([mx.nd.array(c, ctx=ctx, dtype="float64") for c in cots])
    return ([o.asnumpy() for o in outs],
            {n: g.asnumpy() for n, g in grads.items()})


@pytest.mark.parametrize("name,layout,merge,begin", UNROLLS,
                         ids=["-".join(map(str, u)) for u in UNROLLS])
def test_unroll_matches_the_jax_package(name, layout, merge, begin):
    js = _graph(jmx, name, layout, merge, begin)
    ts = _graph(tmx, name, layout, merge, begin)
    assert ts.tojson() == js.tojson()
    shapes = {"data": (2, 3, 4) if layout == "NTC" else (3, 2, 4)}
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    jo, jg = _run(jmx, js, shapes)
    to, tg = _run(tmx, ts, shapes)
    assert len(to) == len(jo)
    for got, want in zip(to, jo):
        assert _err(got, want) < TOL
    assert sorted(tg) == sorted(jg)
    for n in jg:
        if n.endswith("begin_state_0") or n.endswith("begin_state_1"):
            continue  # zero-init states: their gradient is not used
        assert _err(tg[n], jg[n]) < TOL, n


@pytest.mark.parametrize("name", ["dropout", "zoneout"])
def test_cells_that_draw_build_the_jax_graph(name):
    def build(mx):
        with mx.name.NameManager():
            base = mx.rnn.LSTMCell(H, prefix="z_")
            cell = (mx.rnn.ZoneoutCell(base, zoneout_outputs=0.3,
                                       zoneout_states=0.2)
                    if name == "zoneout" else mx.rnn.DropoutCell(0.4))
            if name == "dropout":
                stack = mx.rnn.SequentialRNNCell()
                stack.add(base)
                stack.add(cell)
                cell = stack
            out, _ = cell.unroll(3, mx.sym.Variable("data"),
                                 merge_outputs=True)
            return out

    assert build(tmx).tojson() == build(jmx).tojson()
    with tmx.cpu():
        out = _run(tmx, build(tmx), {"data": (2, 3, 4)})[0][0]
    assert out.shape == (2, 3, H) and np.isfinite(out).all()


@pytest.mark.parametrize("mode,bidir", [("lstm", True), ("gru", False),
                                        ("rnn_tanh", True)])
def test_fused_equals_its_unfuse_and_packs_across_packages(mode, bidir):
    """FusedRNNCell against its unfuse() stack on unpacked weights, in
    the port; the JAX package's unpack of the same blob feeds the port's
    pack, and back."""
    def fused(mx):
        return mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                   bidirectional=bidir, prefix="f_")

    shapes_in = {"data": (2, 3, 4)}

    def graph(mx, cell):
        with mx.name.NameManager():
            out, _ = cell.unroll(3, mx.sym.Variable("data"),
                                 merge_outputs=True)
            return out

    fs = graph(tmx, fused(tmx))
    blob_shape = fs.infer_shape(**shapes_in)[0][1]
    rng = np.random.RandomState(4)
    blob = rng.uniform(-0.5, 0.5, blob_shape)
    x = rng.uniform(-1, 1, shapes_in["data"])
    # the JAX package unpacks, the port packs: the same blob back
    jargs = fused(jmx).unpack_weights(
        {"f_parameters": jmx.nd.array(blob, dtype="float64")})
    targs = convert.module_params_from_jax(
        {k: v.asnumpy() for k, v in jargs.items()}, ctx=tmx.cpu())[0]
    packed = fused(tmx).pack_weights(dict(targs))["f_parameters"]
    np.testing.assert_array_equal(packed.asnumpy(), blob)
    # the port unpacks, the JAX package packs
    with tmx.cpu():
        tun = fused(tmx).unpack_weights(
            {"f_parameters": tmx.nd.array(blob, dtype="float64")})
    assert sorted(tun) == sorted(jargs)
    jpacked = fused(jmx).pack_weights(
        {k: jmx.nd.array(v.asnumpy(), dtype="float64")
         for k, v in tun.items()})["f_parameters"]
    np.testing.assert_array_equal(jpacked.asnumpy(), blob)

    def forward(s, args):
        # a non-LSTM RNN node lists an unused state_cell input in both
        # packages: it gets zeros
        ctx = tmx.cpu()
        shapes = dict(zip(s.list_arguments(), s.infer_shape(**shapes_in)[0]))
        feed = {n: tmx.nd.array(args[n] if n in args else np.zeros(sh),
                                ctx=ctx, dtype="float64")
                for n, sh in shapes.items()}
        return s.bind(ctx, feed).forward()[0].asnumpy()

    stack = fused(tmx).unfuse()
    unfused = graph(tmx, stack)
    cell_args = stack.pack_weights(dict(tun))
    got_f = forward(fs, {"data": x, "f_parameters": blob})
    got_u = forward(unfused, dict({k: v.asnumpy()
                                   for k, v in cell_args.items()}, data=x))
    assert _err(got_u, got_f) < TOL
    jfs = graph(jmx, fused(jmx))
    want = jfs.bind(jmx.cpu(), {
        n: jmx.nd.array({"data": x, "f_parameters": blob}.get(
            n, np.zeros(sh)), dtype="float64")
        for n, sh in zip(jfs.list_arguments(),
                         jfs.infer_shape(**shapes_in)[0])}).forward()[0]
    assert _err(got_f, want.asnumpy()) < TOL


# ---------------------------------------------------------------------------
# BucketSentenceIter and the bucketing LM
# ---------------------------------------------------------------------------
def _sentences(n=40, vocab=12, lo=2, hi=7, seed=1):
    rng = np.random.RandomState(seed)
    return [[int(w) for w in rng.randint(1, vocab, rng.randint(lo, hi))]
            for _ in range(n)]


def _iter(mx, sentences, seed=5, **kw):
    random.seed(seed)
    np.random.seed(seed)
    return mx.rnn.BucketSentenceIter(sentences, **kw)


def test_bucket_sentence_iter_yields_the_jax_batches():
    words = [["w%d" % i for i in s] for s in _sentences(n=60)]
    jcoded, jvocab = jmx.rnn.encode_sentences(words, invalid_label=0,
                                              start_label=1)
    tcoded, tvocab = tmx.rnn.encode_sentences(words, invalid_label=0,
                                              start_label=1)
    assert tcoded == jcoded and tvocab == jvocab
    kw = dict(batch_size=4, buckets=[3, 5, 6], invalid_label=0)
    for layout in ("NT", "TN"):
        j = _iter(jmx, jcoded, layout=layout, **kw)
        t = _iter(tmx, tcoded, layout=layout, **kw)
        assert t.provide_data == j.provide_data
        assert t.default_bucket_key == j.default_bucket_key
        for epoch in range(2):
            jb, tb = list(j), list(t)
            assert len(tb) == len(jb) > 5
            for a, b in zip(tb, jb):
                assert a.bucket_key == b.bucket_key
                np.testing.assert_array_equal(a.data[0].asnumpy(),
                                              b.data[0].asnumpy())
                np.testing.assert_array_equal(a.label[0].asnumpy(),
                                              b.label[0].asnumpy())
                assert a.provide_data == b.provide_data
                assert a.data[0].context == tmx.cpu()
            random.seed(epoch)
            np.random.seed(epoch)
            j.reset()
            random.seed(epoch)
            np.random.seed(epoch)
            t.reset()
    assert {b.bucket_key for b in tb} == {3, 5, 6}


VOCAB, EMBED = 12, 4


def _lm_sym_gen(mx, fused):
    if fused:
        stack = mx.rnn.FusedRNNCell(H, num_layers=2, prefix="lstm_")
    else:
        stack = mx.rnn.SequentialRNNCell()
        for i in range(2):
            stack.add(mx.rnn.LSTMCell(H, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        with mx.name.NameManager():
            data = mx.sym.Variable("data")
            label = mx.sym.Variable("softmax_label")
            embed = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                                     name="embed")
            stack.reset()
            outputs, _ = stack.unroll(seq_len, inputs=embed,
                                      merge_outputs=True)
            pred = mx.sym.Reshape(outputs, shape=(-1, H))
            pred = mx.sym.FullyConnected(pred, num_hidden=VOCAB, name="pred")
            label = mx.sym.Reshape(label, shape=(-1,))
            pred = mx.sym.SoftmaxOutput(pred, label, name="softmax")
        return pred, ("data",), ("softmax_label",)

    return sym_gen


def _cast(mod):
    """Every cell of a bound module's executor in float64 (both
    packages' modules bind float32 cells)."""
    ex = mod._exec
    for d in (ex.arg_dict, ex.aux_dict, ex.grad_dict):
        for cell in d.values():
            if cell is None:
                continue
            if isinstance(cell._data, torch.Tensor):
                cell._data = cell._data.to(torch.float64)
            else:
                cell._data = cell._data.astype("float64")


def _cast_buckets(mod):
    for m in mod._buckets.values():
        _cast(m)


def _bucketing_fit(mx, fused, start=None):
    """Three batches over buckets 4 and 6 (two, then one), float64."""
    sentences = ([[1 + (i + t) % (VOCAB - 1) for t in range(3 + i % 2)]
                  for i in range(8)]
                 + [[1 + (2 * i + t) % (VOCAB - 1) for t in range(6)]
                    for i in range(4)])
    it = _iter(mx, sentences, batch_size=4, buckets=[4, 6], invalid_label=0)
    mod = mx.mod.BucketingModule(_lm_sym_gen(mx, fused),
                                 default_bucket_key=it.default_bucket_key,
                                 context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    if start is None:
        np.random.seed(2)
        # the fused blob is 1-D, which Xavier refuses; neither package
        # has the reference's FusedRNN initializer
        mod.init_params(mx.init.Mixed(
            [".*parameters", ".*"],
            [mx.init.Uniform(0.1),
             mx.init.Xavier(factor_type="in", magnitude=2.34)]))
    else:
        mod.init_params(arg_params=convert.module_params_from_jax(
            start, ctx=mx.cpu())[0])
    # bind the other bucket too, then every cell in float64
    mod.switch_bucket(4, [mx.io.DataDesc("data", (4, 4))],
                      [mx.io.DataDesc("softmax_label", (4, 4))])
    _cast_buckets(mod)
    mod.switch_bucket(6, None, None)
    first, _ = mod.get_params()
    first = {k: v.asnumpy() for k, v in first.items()}
    keys = []
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.125, "momentum": 0.5,
                              "wd": 1e-5},
            eval_metric=mx.metric.Perplexity(0),
            batch_end_callback=lambda p: keys.append(mod._curr_bucket_key))
    args, _ = mod.get_params()
    return first, {k: v.asnumpy() for k, v in args.items()}, keys, mod


def _unpacked(blob_params):
    """The fused LM's parameters with its blob unpacked into the
    unrolled stack's ``lstm_l{i}_{i2h,h2h}_{weight,bias}``."""
    fused = jmx.rnn.FusedRNNCell(H, num_layers=2, prefix="lstm_")
    args = {k: jmx.nd.array(v, dtype="float64")
            for k, v in blob_params.items()}
    args = fused.unfuse().pack_weights(fused.unpack_weights(args))
    return {k: v.asnumpy() for k, v in args.items()}


@pytest.mark.parametrize("fused", [False, True], ids=["unrolled", "fused"])
def test_bucketing_module_fit_matches_the_jax_package(fused):
    """The fused LM against the JAX package's fused LM; the unrolled
    LSTMCell stack, started from the same blob unpacked, against that
    same JAX run (the JAX package's own unrolled LSTM under a
    SoftmaxOutput head has a wrong gradient, see
    test_softmax_head_gradient_over_unrolled_lstm_cells)."""
    start, jend, jkeys, _ = _bucketing_fit(jmx, True)
    if not fused:
        start, jend = _unpacked(start), _unpacked(jend)
    _, tend, tkeys, tmod = _bucketing_fit(tmx, fused, start)
    assert tkeys == jkeys and sorted(set(tkeys)) == [4, 6]
    assert sorted(tend) == sorted(jend)
    for k in jend:
        err = float(np.abs(tend[k] - jend[k]).max()
                    / max(1.0, np.abs(jend[k]).max()))
        assert err < TOL, (k, err)
        assert np.abs(tend[k] - start[k]).max() > 1e-4, k  # it moved
    # every bucket's executor holds the default bucket's parameter cells
    cells = [m._exec.arg_dict for m in tmod._buckets.values()]
    for name in tend:
        assert len({id(c[name]._data) for c in cells}) == 1, name


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_softmax_head_gradient_over_unrolled_cells(kind):
    """The bias gradient of a SoftmaxOutput head is softmax minus
    one-hot, summed over rows.  The port holds it over unrolled cells;
    the JAX package is off over LSTMCell (0.046 at this size), right
    over GRUCell, and both packages agree over GRUCell."""
    def build(mx):
        with mx.name.NameManager():
            x = mx.sym.Embedding(mx.sym.Variable("data"), input_dim=VOCAB,
                                 output_dim=EMBED, name="embed")
            cell = (mx.rnn.LSTMCell if kind == "lstm" else mx.rnn.GRUCell)(
                H, prefix="c_")
            out, _ = cell.unroll(4, x, merge_outputs=True)
            pred = mx.sym.FullyConnected(mx.sym.Reshape(out, shape=(-1, H)),
                                         num_hidden=VOCAB, name="pred")
            label = mx.sym.Reshape(mx.sym.Variable("softmax_label"),
                                   shape=(-1,))
            return mx.sym.SoftmaxOutput(pred, label, name="softmax")

    def run(mx):
        s = build(mx)
        shapes = s.infer_shape(data=(4, 4), softmax_label=(4, 4))[0]
        rng = np.random.RandomState(0)
        ctx = mx.cpu()
        args, grads = {}, {}
        for n, sh in zip(s.list_arguments(), shapes):
            v = (rng.randint(0, VOCAB, sh).astype(np.float64)
                 if n in ("data", "softmax_label")
                 else rng.uniform(-0.5, 0.5, sh))
            args[n] = mx.nd.array(v, ctx=ctx, dtype="float64")
            grads[n] = mx.nd.zeros(sh, ctx=ctx, dtype="float64")
        ex = s.bind(ctx, args, args_grad=grads)
        prob = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        onehot = np.eye(VOCAB)[args["softmax_label"].asnumpy().reshape(-1)
                               .astype(int)]
        return (prob, grads["pred_bias"].asnumpy(),
                (prob - onehot).sum(axis=0))

    prob, got, want = run(tmx)
    assert _err(got, want) < TOL
    jprob, jgot, _ = run(jmx)
    assert _err(prob, jprob) < TOL
    if kind == "gru":
        assert _err(got, jgot) < TOL


def test_the_layer_per_group_lstm_equals_one_context():
    """tests/test_model_parallel.py:162's pattern through the port's
    group2ctx: each LSTM layer and the decoder in a ctx group."""
    T, B, D, C = 5, 8, 6, 4
    rng = np.random.RandomState(0)
    X = rng.randn(16, T, D)
    y = rng.randint(0, C, (16,)).astype(np.float64)
    mx = tmx

    def build():
        data = mx.sym.Variable("data")
        stack = mx.rnn.SequentialRNNCell()
        for i in range(2):
            with mx.AttrScope(ctx_group="layer%d" % i):
                stack.add(mx.rnn.LSTMCell(12, prefix="lstm%d_" % i))
        outputs, _ = stack.unroll(T, inputs=data, layout="NTC",
                                  merge_outputs=True)
        with mx.AttrScope(ctx_group="decode"):
            last = mx.sym.SequenceLast(mx.sym.transpose(outputs,
                                                        axes=(1, 0, 2)))
            logits = mx.sym.FullyConnected(last, num_hidden=C, name="cls")
        return mx.sym.SoftmaxOutput(logits, mx.sym.Variable("softmax_label"),
                                    name="softmax")

    def train(group2ctxs):
        np.random.seed(0)
        mod = mx.mod.Module(build(), context=mx.cpu(0),
                            group2ctxs=group2ctxs)
        it = mx.io.NDArrayIter(X, y, batch_size=B,
                               label_name="softmax_label")
        mod.bind(it.provide_data, it.provide_label)
        _cast(mod)
        mod.init_params(mx.init.Xavier())
        mod.fit(it, num_epoch=3, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1})
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    g2c = {"layer0": mx.cpu(1), "layer1": mx.cpu(2), "decode": mx.cpu(3)}
    p_mp = train(g2c)
    p_sd = train(None)
    assert sorted(p_mp) == sorted(p_sd)
    for k in p_sd:
        assert p_sd[k].dtype == np.float64
        assert _err(p_mp[k], p_sd[k]) < TOL, k


# ---------------------------------------------------------------------------
# the rnn checkpoint helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_rnn_checkpoints_cross_load_both_ways(tmp_path, writer):
    def cell(mx):
        return mx.rnn.FusedRNNCell(H, num_layers=2, mode="gru",
                                   bidirectional=True, prefix="f_")

    def graph(mx):
        with mx.name.NameManager():
            out, _ = cell(mx).unroll(3, mx.sym.Variable("data"),
                                     merge_outputs=True)
            return out

    size = graph(tmx).infer_shape(data=(2, 3, 4))[0][1]
    blob = np.random.RandomState(6).uniform(-1, 1, size)
    w_pkg, r_pkg = (tmx, jmx) if writer == "port" else (jmx, tmx)
    ctx_kw = {"ctx": tmx.cpu()} if w_pkg is tmx else {}
    arg = {"f_parameters": w_pkg.nd.array(blob, dtype="float64", **ctx_kw),
           "emb_weight": w_pkg.nd.array(blob[:12].reshape(3, 4),
                                        dtype="float64", **ctx_kw)}
    prefix = str(tmp_path / "lm")
    with tmx.cpu():
        w_pkg.rnn.save_rnn_checkpoint(cell(w_pkg), prefix, 3, graph(w_pkg),
                                      arg, {})
        sym, got, aux = r_pkg.rnn.load_rnn_checkpoint(cell(r_pkg), prefix, 3)
    assert sym.tojson() == graph(r_pkg).tojson()
    assert sorted(got) == ["emb_weight", "f_parameters"] and aux == {}
    np.testing.assert_array_equal(got["f_parameters"].asnumpy(), blob)
    assert got["f_parameters"].asnumpy().dtype == np.float64
    if r_pkg is tmx:
        assert got["f_parameters"].context == tmx.cpu()


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_convert_carries_recurrent_parameters_in_their_dtypes(dtype):
    """A FusedRNNCell blob, the unrolled cells' weights and a Gluon
    layer's per-layer weights cross from the JAX package by name, each
    in its own dtype."""
    def fused(mx):
        return mx.rnn.FusedRNNCell(H, num_layers=2, bidirectional=True,
                                   prefix="f_")

    size = jmx.ops.rnn.rnn_param_size(2, 4, H, True, "lstm")
    blob = jmx.nd.array(np.random.RandomState(8).uniform(-1, 1, size),
                        dtype="float64").astype(dtype)
    jargs = {"f_parameters": blob}
    jargs.update(fused(jmx).unpack_weights(dict(jargs)))
    layer = jmx.gluon.rnn.LSTM(H, num_layers=2, bidirectional=True,
                               input_size=4, prefix="g_")
    layer.initialize(ctx=jmx.cpu())
    layer.cast(dtype)
    jargs.update({k: p.data() for k, p in layer.collect_params().items()})
    host = {k: v.asnumpy() if dtype != "bfloat16"
            else np.asarray(v._data) for k, v in jargs.items()}
    targs, _ = convert.module_params_from_jax(host, ctx=tmx.cpu())
    tens = convert.params_from_jax(host, device="cpu")
    assert sorted(targs) == sorted(jargs) == sorted(tens)
    assert {"g_r1_h2h_bias", "f_l1_i2h_f_weight", "f_r0_h2h_c_bias"} <= \
        set(targs)
    for k, v in jargs.items():
        assert str(targs[k].dtype).endswith(dtype), (k, targs[k].dtype)
        assert str(tens[k].dtype).endswith(dtype), (k, tens[k].dtype)
        np.testing.assert_array_equal(
            targs[k].astype("float32").asnumpy(),
            v.astype("float32").asnumpy())
