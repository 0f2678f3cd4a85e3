"""Parity of the port's fused ``RNN`` op and ``Sequence*`` ops
(``mxnet_tpu_torch/ops/rnn.py``, ``ops/sequence.py``) with the JAX
package's.

The same seeded float64 numpy inputs go through the JAX op body (its
``lax.scan``) and the port's, on both of the port's routes: ``scan``
(the plain loop, what a CPU tensor takes) and ``cudnn`` (torch's fused
RNN, which the op takes on CUDA; here it runs torch's CPU code on the
same weight mapping, through ``rnn_forward``).  Outputs and final
states are compared forward, and the gradients of a seeded cotangent
with respect to data, blob and initial states (``jax.vjp`` against
``torch.autograd.grad``).

Tolerance: 1e-10 relative to the largest magnitude of the JAX value
(float64).  Dropout draws are the port's own (RNG streams differ from
the JAX package's), so with ``p > 0`` the test holds the recompute of a
remat region to the first pass bit for bit instead.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import mxnet_tpu as jmx
import mxnet_tpu.ops  # noqa: F401  (registers the JAX ops)
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import remat
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import rnn as trnn

TOL = 1e-10
T, N, I, H = 5, 3, 4, 6
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


def _err(got, want):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-300))


def _inputs(mode, layers, bidir, seed=0):
    rng = np.random.RandomState(seed)
    nd_ = 2 if bidir else 1
    size = trnn.rnn_param_size(layers, I, H, bidir, mode)
    data = rng.uniform(-1, 1, (T, N, I))
    blob = rng.uniform(-0.5, 0.5, (size,))
    state = rng.uniform(-0.5, 0.5, (layers * nd_, N, H))
    cell = rng.uniform(-0.5, 0.5, (layers * nd_, N, H))
    arrays = [data, blob, state] + ([cell] if mode == "lstm" else [])
    n_out = 3 if mode == "lstm" else 2
    outs = [(T, N, H * nd_), (layers * nd_, N, H), (layers * nd_, N, H)]
    cots = [rng.uniform(-1, 1, s) for s in outs[:n_out]]
    return arrays, cots


@functools.lru_cache(maxsize=None)
def _jax_ref(mode, layers, bidir, clip=None):
    arrays, cots = _inputs(mode, layers, bidir)
    params = dict(state_size=H, num_layers=layers, bidirectional=bidir,
                  mode=mode, state_outputs=True)
    if clip is not None:
        params.update(lstm_state_clip_min=clip[0],
                      lstm_state_clip_max=clip[1])
    fn = jreg.get("RNN").fn
    key = jax.random.PRNGKey(0)

    def f(*xs):
        return fn(key, *xs, **params)

    @jax.jit
    def fwd_bwd(cts, *xs):
        outs, vjp = jax.vjp(f, *xs)
        return outs, vjp(cts)

    outs, grads = fwd_bwd(tuple(jnp.asarray(c) for c in cots),
                          *[jnp.asarray(a) for a in arrays])
    return ([np.asarray(o) for o in outs], [np.asarray(g) for g in grads])


def _port(route, mode, layers, bidir, clip=None):
    arrays, cots = _inputs(mode, layers, bidir)
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    cell = xs[3] if mode == "lstm" else None
    outs = trnn.rnn_forward(
        route, torch.Generator(), xs[0], xs[1], xs[2], cell, state_size=H,
        num_layers=layers, bidirectional=bidir, mode=mode,
        state_outputs=True, clip_min=clip and clip[0],
        clip_max=clip and clip[1])
    grads = torch.autograd.grad(outs, xs, [torch.tensor(c) for c in cots])
    return ([o.detach().numpy() for o in outs],
            [g.numpy() for g in grads])


@pytest.mark.parametrize("bidir", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("route", trnn.ROUTES)
def test_rnn_routes_match_the_jax_op(route, mode, layers, bidir):
    want_o, want_g = _jax_ref(mode, layers, bidir)
    got_o, got_g = _port(route, mode, layers, bidir)
    for name, got, want in zip(("output", "state", "state_cell"), got_o,
                               want_o):
        assert _err(got, want) < TOL, (name, _err(got, want))
    for name, got, want in zip(("data", "parameters", "state", "cell"),
                               got_g, want_g):
        assert _err(got, want) < TOL, ("d" + name, _err(got, want))


def test_the_lstm_state_clip_takes_the_scan_and_matches():
    clip = (-0.2, 0.25)
    want_o, want_g = _jax_ref("lstm", 2, True, clip)
    got_o, got_g = _port("scan", "lstm", 2, True, clip)
    for got, want in zip(got_o + got_g, want_o + want_g):
        assert _err(got, want) < TOL
    # the clip binds: without it the cell state differs
    free_o, _ = _jax_ref("lstm", 2, True)
    assert _err(free_o[2], want_o[2]) > 1e-3
    cuda = types.SimpleNamespace(device=torch.device("cuda"))
    assert trnn.choose_route(cuda) == "cudnn"
    assert trnn.choose_route(cuda, *clip) == "scan"
    assert trnn.choose_route(torch.zeros(1)) == "scan"


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_nd_rnn_records_its_route_and_matches_the_jax_nd(mode):
    arrays, _ = _inputs(mode, 2, True, seed=3)
    kw = dict(state_size=H, num_layers=2, bidirectional=True, mode=mode)
    want = jmx.nd.RNN(*[jmx.nd.array(a, dtype="float64") for a in arrays],
                      **kw)
    trnn.reset_counts()
    with mx.cpu():
        got = mx.nd.RNN(*[mx.nd.array(a, dtype="float64") for a in arrays],
                        **kw)
    # state_outputs off: one output
    assert isinstance(got, mx.nd.NDArray)
    assert _err(got.asnumpy(), want.asnumpy()) < TOL
    assert trnn.route_counts() == {"cudnn": 0, "scan": 1}
    assert trnn.calls() == {"scan/float64/%s" % mode: 1}


@pytest.mark.parametrize("mode", ["lstm", "rnn_tanh"])
def test_eval_mode_ignores_p(mode):
    arrays, _ = _inputs(mode, 2, False, seed=5)
    kw = dict(state_size=H, num_layers=2, mode=mode, state_outputs=True)
    key = jax.random.PRNGKey(1)
    want = jreg.get("RNN").fn(key, *[jnp.asarray(a) for a in arrays],
                              p=0.0, **kw)
    got = treg.get("RNN").fn(torch.Generator(),
                             *[torch.tensor(a) for a in arrays], p=0.5,
                             _training=False, **kw)
    for g, w in zip(got, want):
        assert _err(g.numpy(), w) < TOL
    # while training, p draws a mask between the layers
    drawn = treg.get("RNN").fn(torch.Generator().manual_seed(0),
                               *[torch.tensor(a) for a in arrays], p=0.5,
                               _training=True, **kw)
    assert _err(drawn[0].numpy(), want[0]) > 1e-3


def test_the_remat_recompute_replays_the_dropout_mask_bitwise():
    arrays, _ = _inputs("lstm", 3, True, seed=7)
    runs = []
    kw = dict(state_size=H, num_layers=3, bidirectional=True, mode="lstm",
              p=0.4)

    def fn(data, blob, state, cell):
        out = treg.get("RNN").fn(trandom.generator(data.device), data, blob,
                                 state, cell, _training=True, **kw)
        runs.append(out.detach().clone())
        return out

    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    # the recompute runs to its end, so it hands back its whole output
    with mx.cpu(), torch.utils.checkpoint.set_checkpoint_early_stop(False):
        mx.random.seed(11)
        out = remat.checkpoint(fn, *xs)
        out.sum().backward()
        grads = [x.grad.clone() for x in xs]
        # the same draw without remat: same output and gradients
        mx.random.seed(11)
        for x in xs:
            x.grad = None
        plain = fn(*xs)
        plain.sum().backward()
    assert len(runs) == 3  # forward, recompute, the plain run
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], runs[2])
    for g, x in zip(grads, xs):
        assert torch.equal(g, x.grad)
    # the mask is live: p = 0 gives another output
    nodrop = treg.get("RNN").fn(torch.Generator(), *[x.detach() for x in xs],
                                **dict(kw, p=0.0))
    assert not torch.allclose(nodrop, runs[0])


@pytest.mark.parametrize("fault,route", [("scan_reverse_unflipped", "scan"),
                                         ("cudnn_swap_if", "cudnn")])
def test_planted_faults_are_caught(fault, route):
    want_o, _ = _jax_ref("lstm", 2, True)
    trnn.FAULTS.add(fault)
    try:
        got_o, _ = _port(route, "lstm", 2, True)
        clean_other, _ = _port("cudnn" if route == "scan" else "scan",
                               "lstm", 2, True)
    finally:
        trnn.FAULTS.discard(fault)
    assert _err(got_o[0], want_o[0]) > 1e-2
    # each fault lives in its own route only
    assert _err(clean_other[0], want_o[0]) < TOL


def test_rnn_infers_blob_and_state_shapes_like_the_jax_package():
    def build(S):
        x = S.Variable("data")
        return S.RNN(data=x, parameters=S.Variable("p"),
                     state=S.Variable("s"), state_cell=S.Variable("c"),
                     state_size=H, num_layers=2, mode="lstm",
                     bidirectional=True, state_outputs=True, name="rnn")

    trnn.reset_counts()
    want = build(jmx.sym).infer_shape(data=(T, N, I))
    got = build(mx.sym).infer_shape(data=(T, N, I))
    assert got == want
    assert build(mx.sym).list_outputs() == build(jmx.sym).list_outputs()
    # shape inference runs the body on meta tensors and counts no call
    assert trnn.route_counts() == {"cudnn": 0, "scan": 0}
    g = mx.sym.RNN(data=mx.sym.Variable("data"), parameters=mx.sym.Variable(
        "p"), state=mx.sym.Variable("s"), state_size=H, mode="gru")
    assert g.infer_shape(data=(T, N, I))[1] == [(T, N, H)]


# ---------------------------------------------------------------------------
# the sequence ops
# ---------------------------------------------------------------------------
SEQ_CASES = [
    ("SequenceMask", dict(), False),
    ("SequenceMask", dict(use_sequence_length=True, value=-2.5), True),
    ("SequenceMask", dict(use_sequence_length=True, axis=1), True),
    ("SequenceLast", dict(), False),
    ("SequenceLast", dict(use_sequence_length=True), True),
    ("SequenceLast", dict(use_sequence_length=True, axis=1), True),
    ("SequenceLast", dict(axis=1), False),
    ("SequenceReverse", dict(), False),
    ("SequenceReverse", dict(use_sequence_length=True), True),
]


@pytest.mark.parametrize("op,params,with_len", SEQ_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(SEQ_CASES)])
def test_sequence_ops_match_the_jax_package(op, params, with_len):
    rng = np.random.RandomState(2)
    data = rng.uniform(-1, 1, (6, 4, 3, 2))
    n = data.shape[1 if params.get("axis", 0) == 0 else 0]
    lengths = rng.randint(1, 7, (n,)).astype(np.float64)
    lengths[0] = 6
    ins = [data] + ([lengths] if with_len else [])
    want, vjp = jax.vjp(
        lambda d: jreg.get(op).fn(d, *[jnp.asarray(a) for a in ins[1:]],
                                  **params), jnp.asarray(data))
    cot = rng.uniform(-1, 1, want.shape)
    (want_g,) = vjp(jnp.asarray(cot))
    d = torch.tensor(data, requires_grad=True)
    got = treg.get(op).fn(d, *[torch.tensor(a) for a in ins[1:]], **params)
    (got_g,) = torch.autograd.grad(got, d, torch.tensor(cot))
    assert _err(got.detach().numpy(), want) < TOL
    assert _err(got_g.numpy(), want_g) < TOL
    # through mx.nd and its shape inference
    with mx.cpu():
        nd_out = getattr(mx.nd, op)(*[mx.nd.array(a, dtype="float64")
                                      for a in ins], **params)
    assert _err(nd_out.asnumpy(), want) < TOL
    s = getattr(mx.sym, op)(*[mx.sym.Variable("x%d" % i)
                              for i in range(len(ins))], **params)
    shapes = {"x%d" % i: a.shape for i, a in enumerate(ins)}
    assert s.infer_shape(**shapes)[1] == [tuple(want.shape)]
