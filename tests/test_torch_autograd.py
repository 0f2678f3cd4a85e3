"""Parity of the port's imperative autograd (``mxnet_tpu_torch.autograd``,
on ``torch.autograd``) with the JAX package's tape of ``jax.vjp``
pullbacks (``mxnet_tpu.autograd``).

Each case builds the same recorded graph in both packages from the same
seeded float64 arrays (the port on ``ctx=mx.cpu()``) and compares the
gradients written into the attached buffers, or returned by
``autograd.grad``.  Tolerance 1e-12 relative and absolute: the two
frameworks differentiate ``exp``/``sigmoid``/``tanh`` and take sums
with other formulas and orders, a few float64 ulps apart.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

TOL = 1e-12
PKGS = {"jax": jmx, "torch": mx}


def _vars(pkg, arrays, req="write"):
    xs = [pkg.nd.array(a, ctx=pkg.cpu()) for a in arrays]
    for x in xs:
        x.attach_grad(req)
    return xs


def _inputs(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1.5, 1.5, s) for s in shapes]


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def _mlp(mx_, xs):
    x, w, b = xs
    with mx_.autograd.record():
        h = mx_.nd.dot(x, w) + b
        y = (mx_.nd.sigmoid(h) * mx_.nd.tanh(h)).sum(axis=1)
        loss = (y * y).mean() + mx_.nd.exp(w * 0.5).sum()
    loss.backward()
    return loss


def _index_and_reshape(mx_, xs):
    (x,) = xs
    with mx_.autograd.record():
        y = x[1:, ::2].reshape((-1,))
        z = (mx_.nd.softmax(x, axis=1) * 3.0).max(axis=0)
        loss = (y * y).sum() + z.sum() + mx_.nd.log_softmax(x).sum()
    loss.backward()
    return loss


def _out_grad_and_two_heads(mx_, xs):
    x, y = xs
    with mx_.autograd.record():
        a = x * y + mx_.nd.square(x)
        b = mx_.nd.broadcast_mul(x, y).sum(axis=0)
    head = mx_.nd.array(np.arange(12.0).reshape(3, 4) / 7, ctx=mx_.cpu())
    mx_.autograd.backward([a, b], [head, mx_.nd.ones((4,), ctx=mx_.cpu(),
                                                     dtype="float64")])
    return a


GRAPHS = {
    "mlp": (_mlp, [(3, 4), (4, 5), (1, 5)]),
    "index_and_reshape": (_index_and_reshape, [(3, 4)]),
    "out_grad_and_two_heads": (_out_grad_and_two_heads, [(3, 4), (3, 4)]),
}


@pytest.mark.parametrize("req", ["write", "add"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_recorded_graph_gradients_match(graph, req):
    fn, shapes = GRAPHS[graph]
    arrays = _inputs(*shapes)
    grads = {}
    for name, pkg in PKGS.items():
        xs = _vars(pkg, arrays, req)
        out = fn(pkg, xs)
        if req == "add":
            fn(pkg, xs)         # a second pass accumulates
        grads[name] = ([x.grad.asnumpy() for x in xs], out.asnumpy())
    for gj, gt in zip(grads["jax"][0], grads["torch"][0]):
        assert gt.dtype == np.float64
        _close(gt, gj)
    _close(grads["torch"][1], grads["jax"][1])


def test_pause_records_nothing_and_builds_no_graph():
    (a,) = _inputs((2, 3))
    res = {}
    for name, pkg in PKGS.items():
        (x,) = _vars(pkg, [a])
        with pkg.autograd.record():
            with pkg.autograd.pause():
                assert not pkg.autograd.is_recording()
                c = x * 3.0          # a constant for the graph below
            y = (x * c).sum()
        y.backward()
        res[name] = x.grad.asnumpy()
        if pkg is mx:
            assert not c._data.requires_grad
            # outside record() no op builds graph either
            assert not (x * 2.0)._data.requires_grad
    _close(res["torch"], res["jax"])
    _close(res["torch"], 3.0 * a)


def test_autograd_grad_leaves_the_buffers_alone():
    x0, y0 = _inputs((3, 4), (3, 4))
    res = {}
    for name, pkg in PKGS.items():
        x, y = _vars(pkg, [x0, y0])
        with pkg.autograd.record():
            z = (pkg.nd.exp(x) * y).sum()
        gx, gy = pkg.autograd.grad(z, [x, y])
        res[name] = (gx.asnumpy(), gy.asnumpy())
        np.testing.assert_array_equal(x.grad.asnumpy(), 0.0)
        np.testing.assert_array_equal(y.grad.asnumpy(), 0.0)
    for a, b in zip(res["torch"], res["jax"]):
        _close(a, b)


def _custom_function(pkg):
    class Scaled(pkg.autograd.Function):
        """exp forward; a backward that is deliberately not exp's, so
        the test shows that the user's backward ran."""

        def forward(self, x):
            self.y = pkg.nd.exp(x)
            return self.y

        def backward(self, dy):
            return dy * self.y * 2.0

    return Scaled()


def test_custom_function_backward_runs():
    (a,) = _inputs((2, 3))
    res = {}
    for name, pkg in PKGS.items():
        (x,) = _vars(pkg, [a])
        f = _custom_function(pkg)
        with pkg.autograd.record():
            y = f(x * 1.5)
            loss = (y * y).sum()
        loss.backward()
        res[name] = x.grad.asnumpy()
    _close(res["torch"], res["jax"])
    _close(res["torch"], 1.5 * 2 * np.exp(1.5 * a) * 2 * np.exp(1.5 * a))


@pytest.mark.parametrize("update", ["iadd", "setitem", "copyto"])
def test_gradient_through_a_read_taken_before_an_inplace_update(update):
    x0, w0 = _inputs((3, 4), (3, 4))
    res = {}
    for name, pkg in PKGS.items():
        x, w = _vars(pkg, [x0, w0])
        with pkg.autograd.record():
            y = pkg.nd.sin(x) * w        # reads the current x
            a = y * 2.0                  # an intermediate
            loss = (a * x).sum()
        # the cells change after the reads, outside record()
        if update == "iadd":
            x += 10.0
            a += 1.0
        elif update == "setitem":
            x[:] = 0.0
            a[0] = 5.0
        else:
            pkg.nd.ones((3, 4), ctx=pkg.cpu()).copyto(x)
        loss.backward()
        res[name] = (x.grad.asnumpy(), w.grad.asnumpy())
    for a, b in zip(res["torch"], res["jax"]):
        _close(a, b)
    # d/dx sum(2 sin(x) w x) = 2 w (cos(x) x + sin(x)) at the OLD x
    _close(res["torch"][0], 2 * w0 * (np.cos(x0) * x0 + np.sin(x0)))


def test_modes_and_heads_that_cannot_be_differentiated():
    for pkg in PKGS.values():
        assert not pkg.autograd.is_recording()
        with pkg.autograd.record():
            assert pkg.autograd.is_recording() and pkg.autograd.is_training()
            with pkg.autograd.predict_mode():
                assert not pkg.autograd.is_training()
        with pkg.autograd.train_mode():
            assert pkg.autograd.is_training()
        c = pkg.nd.ones((2,), ctx=pkg.cpu())
        with pytest.raises(ValueError):
            c.backward()


def test_marked_variable_new_value_is_a_fresh_leaf():
    # after an update outside record() the cell's value is a new leaf:
    # the next recorded pass differentiates the new value
    (a,) = _inputs((4,))
    (x,) = _vars(mx, [a])
    x += 1.0
    assert x._data.is_leaf and x._data.requires_grad
    with mx.autograd.record():
        y = (x * x).sum()
    y.backward()
    _close(x.grad.asnumpy(), 2 * (a + 1.0))
