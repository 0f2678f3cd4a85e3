"""The port's multi-context ``Module`` (``parallel.dp.
DataParallelRunner``), ``kvstore('tpu'/'nccl')`` and ``group2ctx``
placement, against the JAX package's.

``Module(context=[cpu(0), cpu(1)])`` runs on two gloo ranks on the CPU
(``tests/torch_dp_cases.py`` ``module_cases``, once for this file), each
rank on its rows of the global batch, against the JAX package's
multi-context ``Module`` on its two-device CPU mesh, from the same
parameters, in float64: ``fit`` 2 epochs of batch 8 (10 updates),
BatchNorm included, within 1e-10 of each parameter's scale (aux
included), as ``tests/test_torch_module.py``.  Without a process group
the list collapses onto one device with the JAX package's warning and
equals the one-context run bit for bit.  ``kvstore('tpu')``'s multi-key
push (the port's per-key sum) against the JAX package's ``KVStoreTPU``
(its bucketed merge), and the
``group2ctx`` cases of ``tests/test_model_parallel.py`` against the JAX
package (every cpu context is the host here).
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import dist

import torch_dp_cases as cases

TOL = 1e-10
LR = 0.125
BATCH = 8
SHAPES = {"mlp": (6,), "conv_bn": (2, 6, 6)}


def _data(kind, n=40, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n,) + SHAPES[kind]),
            rng.randint(0, 4, n).astype(np.float64))


def _cast(mod):
    for d in (mod._exec.arg_dict, mod._exec.aux_dict,
              mod._exec.grad_dict):
        for cell in d.values():
            if cell is not None:
                cell._data = cell._data.astype("float64")


def _host(params):
    return {k: v.asnumpy() for k, v in params.items()}


def _jmodule(kind, start, contexts):
    X, y = _data(kind)
    it = jmx.io.NDArrayIter(X, y, batch_size=BATCH)
    mod = jmx.mod.Module(cases.module_sym(jmx, kind), context=contexts)
    mod.bind(it.provide_data, it.provide_label)
    _cast(mod)
    if start is None:
        np.random.seed(3)
        mod.init_params(jmx.init.Xavier(magnitude=2.0))
    else:
        mod.init_params(
            arg_params={k: jmx.nd.array(v, dtype=v.dtype)
                        for k, v in start[0].items()},
            aux_params={k: jmx.nd.array(v, dtype=v.dtype)
                        for k, v in start[1].items()})
    return mod, it


@pytest.fixture(scope="module")
def spec():
    start = {}
    for kind in SHAPES:
        mod, _ = _jmodule(kind, None, jmx.cpu())
        a, x = mod.get_params()
        start[kind] = (_host(a), _host(x))
    return {"start": start, "data": {k: _data(k) for k in SHAPES},
            "batch": BATCH, "lr": LR}


@pytest.fixture(scope="module")
def ranks(spec):
    return dist.launch(cases.module_cases, 2, (spec,), device="cpu",
                       threads=1, timeout_s=300)


def _jfit(spec, kind, contexts, kvstore="local"):
    mod, it = _jmodule(kind, spec["start"][kind], contexts)
    if mod._dp is not None:
        # the JAX package lays the cells over its mesh at the first
        # forward, after fit has given the store its copies of the
        # weights; float64 cells set by hand are committed to one
        # device, so lay them out before the store copies them
        mod._dp.place()
    mod.fit(it, num_epoch=2, kvstore=kvstore, optimizer="sgd",
            optimizer_params=(("learning_rate", LR), ("momentum", 0.9),
                              ("wd", 1e-3)))
    a, x = mod.get_params()
    return {"args": _host(a), "aux": _host(x)}


def _got(ranks, name, rank=0):
    out = ranks[rank][name]
    if isinstance(out, dict) and "error" in out:
        pytest.fail("rank %d, case %s:\n%s" % (rank, name, out["error"]))
    return out


def _rel(got, want):
    return max(float(np.abs(got[k] - w).max()) /
               max(1.0, float(np.abs(w).max())) for k, w in want.items())


def _err(got, want):
    assert sorted(got["args"]) == sorted(want["args"])
    assert sorted(got["aux"]) == sorted(want["aux"])
    return max(_rel(got["args"], want["args"]),
               _rel(got["aux"], want["aux"]) if want["aux"] else 0.0)


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_two_context_module_matches_jax(ranks, spec, kind):
    """Two ranks, each on its rows with the global batch's BatchNorm
    moments and gradients, equal the JAX package's two-context Module
    and the one-device Module at the global batch."""
    want = _jfit(spec, kind, [jmx.cpu(0), jmx.cpu(1)])
    for r in (0, 1):
        got = _got(ranks, kind, r)
        assert (got["num_device"], got["ranks"]) == (2, 2)
        assert _err(got, want) <= TOL
        # and the run moved away from the start
        assert _rel(got["args"], spec["start"][kind][0]) > 1e-3
    one = cases.module_fit(spec, kind, contexts=1)
    assert _err(_got(ranks, kind), one) <= TOL


@pytest.mark.parametrize("kv", ["tpu", "nccl"])
def test_two_context_module_under_kvstore_kinds(ranks, spec, kv):
    want = _jfit(spec, "conv_bn", [jmx.cpu(0), jmx.cpu(1)], kvstore=kv)
    assert _err(_got(ranks, "conv_bn_" + kv), want) <= TOL


def test_bulk_fit_over_ranks_is_per_batch_bitwise(ranks):
    got, per_batch = _got(ranks, "conv_bn_bulk2"), _got(ranks, "conv_bn")
    assert got["bulk_groups"] == 6      # 5 batches an epoch: 2 + 2 + 1
    assert _err(got, per_batch) == 0.0


def test_a_rank_gradient_left_unreduced_is_caught(ranks, spec):
    want = _jfit(spec, "conv_bn", [jmx.cpu(0), jmx.cpu(1)])
    assert _err(_got(ranks, "conv_bn_fault", 1), want) > 1e-3


def test_context_list_collapses_without_a_group(spec, caplog):
    """No process group: the list collapses onto one device, with the
    JAX package's warning, and equals one context bit for bit."""
    with caplog.at_level(logging.WARNING):
        got = cases.module_fit(spec, "conv_bn", contexts=2)
    assert any("requested 2 devices, runtime has 1 - collapsing" in
               r.getMessage() for r in caplog.records)
    assert (got["num_device"], got["ranks"]) == (2, 1)
    assert _err(got, cases.module_fit(spec, "conv_bn", contexts=1)) == 0.0
    with pytest.raises(ValueError, match="group2ctxs model parallelism"):
        tmx.mod.Module(cases.module_sym(tmx, "mlp"),
                       context=[tmx.cpu(0), tmx.cpu(1)],
                       group2ctxs={"dev1": tmx.cpu(1)})


@pytest.mark.parametrize("n_vals", [2, 3])
@pytest.mark.parametrize("cap", [0, 64, 1 << 20])
def test_kvstore_tpu_multikey_push_matches_jax(monkeypatch, n_vals, cap):
    """A multi-key push of several values a key, then a pull: the JAX
    package merges over the bucket plan (cap 0: its per-key sum), the
    port sums per key under every cap; with an optimizer the update runs
    on the summed values."""
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_BYTES", str(cap))
    rng = np.random.RandomState(n_vals)
    shapes = [(3, 4), (5,), (2, 2, 2), (7,)]
    vals = [[rng.randn(*s) for _ in range(n_vals)] for s in shapes]
    w0 = [rng.randn(*s) for s in shapes]
    keys = list(range(len(shapes)))
    got = {}
    for name, mx, ctx in (("jax", jmx, jmx.cpu()), ("port", tmx,
                                                    tmx.cpu())):
        out = []
        for with_opt in (False, True):
            kv = mx.kv.create("tpu")
            assert kv.type == "tpu"
            for k, w in zip(keys, w0):
                kv.init(k, mx.nd.array(w, ctx=ctx, dtype="float64"))
            if with_opt:
                kv.set_optimizer(mx.optimizer.create(
                    "sgd", learning_rate=0.1, momentum=0.9))
            kv.push(keys, [[mx.nd.array(v, ctx=ctx, dtype="float64")
                            for v in vs] for vs in vals])
            res = [mx.nd.zeros(s, ctx=ctx, dtype="float64")
                   for s in shapes]
            kv.pull(keys, res)
            out.append([r.asnumpy() for r in res])
        got[name] = out
    for a, b in zip(got["port"], got["jax"]):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(got["port"][0][0], sum(vals[0]), rtol=1e-15)
    for kind in ("tpu", "nccl"):
        assert type(tmx.kv.create(kind)) is tmx.kvstore.KVStore
        assert tmx.kv.create(kind).type == kind


def _chain(mx):
    data1, data2, data3 = (mx.sym.Variable("data%d" % i) for i in (1, 2, 3))
    with mx.AttrScope(ctx_group="dev1"):
        net = (data1 + data2) * 3.0
    with mx.AttrScope(ctx_group="dev2"):
        net = net + data3
    return net


def test_chain_forward_backward_matches_jax_placed():
    """tests/test_model_parallel.py test_chain: two groups on two
    contexts, forward and backward equal the JAX package's and the
    unplaced run."""
    n, m = 4, 5
    res = {}
    for name, mx in (("jax", jmx), ("port", tmx)):
        for placed in (True, False):
            arr = [mx.nd.ones((n, m), ctx=mx.cpu()) * (i + 1)
                   for i in range(3)]
            grad = [mx.nd.zeros((n, m), ctx=mx.cpu()) for _ in range(3)]
            names = ["data1", "data2", "data3"]
            ex = _chain(mx).bind(
                mx.cpu(), args=dict(zip(names, arr)),
                args_grad=dict(zip(names, grad)),
                group2ctx={"dev1": mx.cpu(0), "dev2": mx.cpu(1)}
                if placed else None)
            out = ex.forward(is_train=True)[0].asnumpy()
            ex.backward([mx.nd.ones((n, m), ctx=mx.cpu()) * 2.0])
            res[name, placed] = [out] + [g.asnumpy() for g in grad]
    for k in res:
        for a, b in zip(res[k], res["jax", True]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res["port", True][0],
                                  ((1 + 2) * 3.0 + 3) * np.ones((n, m)))


def test_placement_is_real_and_own_group_wins():
    """Arguments land on their group's context (the consumer's for an
    ungrouped variable, its own group's where it has one), gradients
    come back on the argument's context, and the placement equals the
    JAX package's."""
    a, b = tmx.sym.Variable("a"), tmx.sym.Variable("b")
    with tmx.AttrScope(ctx_group="dev1"):
        h = tmx.sym.FullyConnected(a, num_hidden=8, name="fc1")
    with tmx.AttrScope(ctx_group="dev2"):
        out = tmx.sym.FullyConnected(h + b, num_hidden=4, name="fc2")
    ex = out.simple_bind(tmx.cpu(0), a=(2, 16), b=(2, 8),
                         group2ctx={"dev1": tmx.cpu(2), "dev2": tmx.cpu(3)})
    assert ex.arg_dict["fc1_weight"].context == tmx.cpu(2)
    assert ex.arg_dict["a"].context == tmx.cpu(2)
    assert ex.arg_dict["fc2_weight"].context == tmx.cpu(3)
    assert ex.arg_dict["b"].context == tmx.cpu(3)
    outs = ex.forward(is_train=True)
    assert outs[0].shape == (2, 4)
    ex.backward([tmx.nd.ones((2, 4), ctx=tmx.cpu())])
    assert ex.grad_dict["fc1_weight"].context == tmx.cpu(2)
    with tmx.AttrScope(ctx_group="wgroup"):
        w = tmx.sym.Variable("w")
    x = tmx.sym.Variable("x")
    with tmx.AttrScope(ctx_group="opgroup"):
        o = tmx.sym.dot(x, w)
    ex = o.simple_bind(tmx.cpu(0), x=(3, 4), w=(4, 5),
                       group2ctx={"wgroup": tmx.cpu(4),
                                  "opgroup": tmx.cpu(5)})
    assert ex.arg_dict["w"].context == tmx.cpu(4)
    assert ex.arg_dict["x"].context == tmx.cpu(5)
    # a group mapped to the executor's own context is no placement
    assert ex._placement is not None
    ex2 = o.simple_bind(tmx.cpu(0), x=(3, 4), w=(4, 5),
                        group2ctx={"wgroup": tmx.cpu(0),
                                   "opgroup": tmx.cpu(0)})
    assert ex2._placement is None


def test_monitor_on_placed_executor():
    a = tmx.sym.Variable("a")
    with tmx.AttrScope(ctx_group="dev1"):
        h = tmx.sym.FullyConnected(a, num_hidden=4, name="fcm1")
    with tmx.AttrScope(ctx_group="dev2"):
        o = tmx.sym.Activation(h, act_type="tanh", name="actm")
    ex = o.simple_bind(tmx.cpu(0), a=(2, 3),
                       group2ctx={"dev1": tmx.cpu(1), "dev2": tmx.cpu(2)})
    seen = []
    ex.set_monitor_callback(lambda name, arr: seen.append(name))
    ex.forward(is_train=True)
    assert any(n.startswith("fcm1") for n in seen)
    assert any(n.startswith("actm") for n in seen)


def _mp_mlp(mx):
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        with mx.AttrScope(ctx_group="dev1"):
            h = mx.sym.Activation(mx.sym.FullyConnected(
                data, num_hidden=16, name="fc1"), act_type="relu")
        with mx.AttrScope(ctx_group="dev2"):
            out = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
            return mx.sym.SoftmaxOutput(out, name="softmax")


def test_module_group2ctxs_trains_as_unplaced_and_as_jax():
    """tests/test_model_parallel.py test_module_group2ctxs_trains: an MLP
    split over two groups trains through Module equal to the unplaced
    run and to the JAX package's placed run (float64, 1e-10)."""
    rng = np.random.RandomState(0)
    X = rng.randn(32, 10)
    y = (X @ rng.randn(10, 3)).argmax(axis=1).astype(np.float64)
    res = {}
    for name, mx in (("jax", jmx), ("port", tmx)):
        for placed in (True, False):
            it = mx.io.NDArrayIter(X, y, batch_size=8)
            mod = mx.mod.Module(
                _mp_mlp(mx), context=mx.cpu(),
                group2ctxs={"dev1": mx.cpu(1), "dev2": mx.cpu(2)}
                if placed else None)
            mod.bind(it.provide_data, it.provide_label)
            if mx is jmx:
                _cast(mod)
            else:
                for d in (mod._exec.arg_dict, mod._exec.grad_dict):
                    for c in d.values():
                        if c is not None:
                            c._data = c._data.to(torch.float64)
            np.random.seed(1)
            mod.init_params(mx.init.Xavier())
            res[name, placed] = mod
    start = {k: v.asnumpy() for k, v in
             res["jax", True].get_params()[0].items()}
    out = {}
    for key, mod in res.items():
        mx = jmx if key[0] == "jax" else tmx
        mod.set_params({k: mx.nd.array(v, ctx=mx.cpu(), dtype="float64")
                        for k, v in start.items()}, {})
        it = mx.io.NDArrayIter(X, y, batch_size=8)
        mod.fit(it, num_epoch=3, optimizer="sgd",
                optimizer_params=(("learning_rate", LR),))
        out[key] = _host(mod.get_params()[0])
    for key in out:
        assert _rel(out[key], out["jax", True]) <= TOL, key
    assert _rel(out["port", True], start) > 1e-3
