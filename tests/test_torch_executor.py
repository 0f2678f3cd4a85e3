"""The port's Executor against the JAX package's, in float64 on a
conv-BN-FC-SoftmaxOutput net, to 1e-12: forward and backward, the
``grad_req`` kinds, partial and ``(1,)`` head gradients, the aux states
after a manual ``forward(is_train=True)`` + ``backward()`` (two moves of
the moving statistics) and after the fused ``run_train_step`` (one), the
monitor tap, ``reshape`` and the one-device refusals."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-12


def _net(mx, head="softmax"):
    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        x = mx.sym.Convolution(x, num_filter=4, kernel=(3, 3), pad=(1, 1),
                               name="conv")
        x = mx.sym.BatchNorm(x, fix_gamma=False, momentum=0.8, name="bn")
        x = mx.sym.Activation(x, act_type="relu", name="relu")
        fc = mx.sym.FullyConnected(x, num_hidden=5, name="fc")
        if head == "softmax":
            return mx.sym.SoftmaxOutput(fc, name="softmax")
        # two plain outputs: head gradients come from the caller
        return mx.sym.Group([fc, mx.sym.sum(fc * fc, axis=1, name="sq")])


def _values(sym, seed=0, batch=4):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(batch, 2, 6, 6))
    args = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name.endswith("label"):
            args[name] = rng.randint(0, 5, shape).astype(np.float64)
        else:
            args[name] = rng.uniform(-1, 1, shape)
    aux = {name: (rng.uniform(0.5, 1.5, s) if name.endswith("var")
                  else rng.uniform(-0.2, 0.2, s))
           for name, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _jnd(a):
    return jmx.nd.array(a, dtype=a.dtype)


def _tnd(a):
    return tmx.nd.array(a, ctx=tmx.cpu(), dtype=a.dtype)


def _bind(mx, nd, head, args, aux, grad_req="write", no_grad=()):
    sym = _net(mx, head)
    grads = {k: nd(np.zeros_like(v)) for k, v in args.items()
             if k not in no_grad}
    ctx = mx.cpu()
    return sym.bind(ctx=ctx, args={k: nd(v) for k, v in args.items()},
                    args_grad=grads, grad_req=grad_req,
                    aux_states={k: nd(v) for k, v in aux.items()})


def _pair(head="softmax", **kw):
    args, aux = _values(_net(jmx, head))
    return (_bind(jmx, _jnd, head, args, aux, **kw),
            _bind(tmx, _tnd, head, args, aux, **kw))


def _close(t, j, tol=TOL):
    t, j = np.asarray(t.asnumpy()), np.asarray(j.asnumpy())
    assert t.shape == j.shape and t.dtype == j.dtype == np.float64
    scale = max(1.0, float(np.abs(j).max()))
    assert float(np.abs(t - j).max()) <= tol * scale


def _state(ex):
    return ({k: v for k, v in ex.grad_dict.items() if v is not None},
            dict(ex.aux_dict), list(ex.outputs))


def _same_state(jx, tx):
    jg, ja, jo = _state(jx)
    tg, ta, to = _state(tx)
    assert sorted(tg) == sorted(jg) and sorted(ta) == sorted(ja)
    for k in jg:
        _close(tg[k], jg[k])
    for k in ja:
        _close(ta[k], ja[k])
    assert len(to) == len(jo)
    for t, j in zip(to, jo):
        _close(t, j)


@pytest.mark.parametrize("is_train", [False, True])
def test_forward(is_train):
    jx, tx = _pair()
    for t, j in zip(tx.forward(is_train=is_train),
                    jx.forward(is_train=is_train)):
        _close(t, j)
    _same_state(jx, tx)


def test_forward_then_backward_moves_the_aux_twice():
    jx, tx = _pair()
    before = tx.aux_dict["bn_moving_mean"].asnumpy()
    jx.forward(is_train=True)
    tx.forward(is_train=True)
    once = tx.aux_dict["bn_moving_mean"].asnumpy()
    jx.backward()
    tx.backward()
    _same_state(jx, tx)
    twice = tx.aux_dict["bn_moving_mean"].asnumpy()
    # the same batch statistic m folded in twice: twice - once equals
    # momentum * (once - before)
    np.testing.assert_allclose(twice - once, 0.8 * (once - before),
                               rtol=1e-10, atol=1e-15)


def test_fused_train_step_moves_the_aux_once():
    jx, tx = _pair()
    jx.run_train_step()
    tx.run_train_step()
    _same_state(jx, tx)
    # the same as one training forward
    _, tx2 = _pair()
    tx2.forward(is_train=True)
    np.testing.assert_array_equal(tx.aux_dict["bn_moving_var"].asnumpy(),
                                  tx2.aux_dict["bn_moving_var"].asnumpy())


def test_grad_req_add_accumulates_and_null_leaves_no_buffer():
    args, aux = _values(_net(jmx))
    req = {k: ("add" if k.startswith("conv") else
               "null" if k.startswith("fc") else "write") for k in args}
    jx = _bind(jmx, _jnd, "softmax", args, aux, grad_req=req)
    tx = _bind(tmx, _tnd, "softmax", args, aux, grad_req=req)
    for _ in range(2):
        jx.run_train_step()
        tx.run_train_step()
    _same_state(jx, tx)
    # "add" holds two steps' worth; "null" buffers stay untouched zeros
    assert np.abs(tx.grad_dict["conv_weight"].asnumpy()).max() > 0
    assert not tx.grad_dict["fc_weight"].asnumpy().any()
    assert tx._grad_names == jx._grad_names


def test_args_grad_dict_grants_gradients_only_to_its_names():
    jx, tx = _pair(no_grad=("data", "softmax_label"))
    assert tx.grad_dict["data"] is None and jx.grad_dict["data"] is None
    jx.forward(is_train=True)
    tx.forward(is_train=True)
    jx.backward()
    tx.backward()
    _same_state(jx, tx)


@pytest.mark.parametrize("case", ["full", "partial", "broadcast"])
def test_head_gradients(case):
    jx, tx = _pair(head="plain")
    rng = np.random.RandomState(5)
    g0 = rng.uniform(-1, 1, (4, 5))
    if case == "full":
        heads = [g0, rng.uniform(-1, 1, (4,))]
    elif case == "partial":
        heads = [g0]            # the second output gets no gradient
    else:
        heads = [np.array([0.5]), np.array([2.0])]   # (1,) broadcasts
    jx.forward(is_train=True)
    tx.forward(is_train=True)
    jx.backward([_jnd(h) for h in heads])
    tx.backward([_tnd(h) for h in heads])
    _same_state(jx, tx)


def test_backward_without_head_gradients_is_ones():
    jx, tx = _pair(head="plain")
    jx.run_train_step()
    tx.run_train_step()
    _same_state(jx, tx)


def test_output_cells_keep_their_identity():
    _, tx = _pair()
    cells = list(tx.outputs)
    tx.forward(is_train=False)
    tx.run_train_step()
    assert all(a is b for a, b in zip(cells, tx.outputs))
    assert list(tx.output_dict) == ["softmax_output"]


@pytest.mark.parametrize("fused", [False, True])
def test_monitor_tap_names_and_values(fused):
    jx, tx = _pair()
    seen = {}
    for key, ex in (("j", jx), ("t", tx)):
        got = seen[key] = {}
        ex.set_monitor_callback(
            lambda n, a, got=got: got.__setitem__(n, a.asnumpy()),
            monitor_all=True)
        if fused:
            ex.run_train_step()
        else:
            ex.forward(is_train=True)
    assert sorted(seen["t"]) == sorted(seen["j"])
    assert "bn_output" in seen["t"] and "conv_weight_data" in seen["t"]
    for k, v in seen["j"].items():
        np.testing.assert_allclose(seen["t"][k], v, rtol=0,
                                   atol=TOL * max(1.0, np.abs(v).max()))


def test_reshape_shares_unchanged_cells():
    # simple_bind cells are float32 in both packages (a float64 cell
    # would be copied into the new float32 one, not shared), so this
    # forward is float32: held to 1e-6 of its magnitude
    args, aux = _values(_net(jmx))
    exs = []
    for mx, nd in ((jmx, _jnd), (tmx, _tnd)):
        ex = _net(mx).simple_bind(ctx=mx.cpu(), data=(4, 2, 6, 6))
        ex.copy_params_from({k: nd(v) for k, v in args.items()},
                            {k: nd(v) for k, v in aux.items()})
        exs.append(ex)
    jx, tx = exs
    jr = jx.reshape(data=(2, 2, 6, 6), softmax_label=(2,))
    tr = tx.reshape(data=(2, 2, 6, 6), softmax_label=(2,))
    assert tr.arg_dict["conv_weight"] is tx.arg_dict["conv_weight"]
    assert tr.aux_dict["bn_moving_mean"] is tx.aux_dict["bn_moving_mean"]
    assert tr.arg_dict["data"].shape == (2, 2, 6, 6)
    data = np.random.RandomState(9).uniform(-1, 1, (2, 2, 6, 6))
    for t, j in zip(tr.forward(data=_tnd(data)),
                    jr.forward(data=_jnd(data))):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=0,
                                   atol=1e-6)


def test_simple_bind_allocates_like_the_jax_package():
    for mx in (jmx, tmx):
        sym = _net(mx)
        ex = sym.simple_bind(ctx=mx.cpu(), data=(4, 2, 6, 6),
                             grad_req={"conv_weight": "write"})
        assert [k for k, v in ex.grad_dict.items() if v is not None] == \
            ["conv_weight"]
        assert ex.arg_dict["fc_weight"].shape == (5, 144)
        assert str(ex.aux_dict["bn_moving_var"].dtype) == "float32"
    assert "MB allocated" in ex.debug_str().splitlines()[-2]


def test_copy_params_from():
    jx, tx = _pair()
    w = np.full((5, 144), 0.01)
    jx.copy_params_from({"fc_weight": _jnd(w)})
    tx.copy_params_from({"fc_weight": _tnd(w)})
    for t, j in zip(tx.forward(), jx.forward()):
        _close(t, j)
    with pytest.raises(MXNetError, match="unknown argument"):
        tx.copy_params_from({"nope": _tnd(w)})


def test_one_device_refusals(monkeypatch):
    sym = _net(tmx)
    with tmx.name.NameManager():
        with tmx.AttrScope(ctx_group="dev2"):
            placed = tmx.sym.FullyConnected(tmx.sym.Variable("data"),
                                            num_hidden=3, name="fc")
    # a group mapped to the executor's own device is no placement
    ex = placed.simple_bind(ctx=tmx.cpu(), data=(2, 4),
                            group2ctx={"dev2": tmx.cpu()})
    assert ex.arg_dict["fc_weight"].shape == (3, 4)
    # a group on another device is placed there (model parallelism,
    # tests/test_torch_module_dp.py); a device that does not exist (no
    # card here) raises at bind and names it
    with pytest.raises(MXNetError, match="gpu\\(1\\)"):
        placed.simple_bind(ctx=tmx.cpu(), data=(2, 4),
                           group2ctx={"dev2": tmx.gpu(1)})
    # the memory tier binds (tests/test_torch_remat.py runs it); an
    # unknown policy still raises at bind
    for knob, val in (("MXNET_REMAT_POLICY", "stage"),
                      ("MXNET_REMAT_POLICY", "conv_block"),
                      ("MXNET_BACKWARD_DO_MIRROR", "1")):
        monkeypatch.setenv(knob, val)
        sym.simple_bind(ctx=tmx.cpu(), data=(4, 2, 6, 6))
        monkeypatch.delenv(knob)
    monkeypatch.setenv("MXNET_REMAT_POLICY", "everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        sym.simple_bind(ctx=tmx.cpu(), data=(4, 2, 6, 6))


def test_random_ops_draw_from_the_seeded_device_generator():
    with tmx.name.NameManager():
        net = tmx.sym.Dropout(tmx.sym.Variable("data"), p=0.5, name="drop")
    x = tmx.nd.array(np.ones((64, 8)), ctx=tmx.cpu(), dtype="float64")
    ex = net.bind(tmx.cpu(), args={"data": x})
    np.testing.assert_array_equal(ex.forward(is_train=False)[0].asnumpy(),
                                  x.asnumpy())
    draws = []
    for _ in range(2):
        tmx.random.seed(3)
        draws.append(ex.forward(is_train=True)[0].asnumpy())
    np.testing.assert_array_equal(draws[0], draws[1])
    assert set(np.unique(draws[0])) == {0.0, 2.0}
