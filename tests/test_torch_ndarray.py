"""Parity of the port's imperative NDArray layer (``mxnet_tpu_torch.nd``,
its op registry, save/load) with the JAX package's (``mxnet_tpu.nd``).

Every name that ``mxnet_tpu.ops.{elemwise,reduce,matrix,init_ops}``
registers (aliases included), and ``softmax``/``log_softmax``, runs on
the same seeded numpy inputs through the JAX op body and through the
port's ``invoke`` on ``ctx=mx.cpu()``.  Inputs are float64 wherever the
op takes a float.

Tolerances, per family:
  * exact (bitwise) for arithmetic, comparisons, rounding, casts,
    indexing, shape ops, sorting and creation: one IEEE operation per
    element, the same in XLA and in PyTorch (one exception:
    ``_rdiv_scalar``, where XLA's quotient is 1 ulp off on some
    elements, is held at 1e-12);
  * 1e-12 relative and absolute for transcendentals, powers and every
    reduction (sums, norms, products, dot): XLA and PyTorch evaluate
    them with other polynomials or in another order, a few float64 ulps
    apart (about 1e-15 relative).
"""
import struct
from typing import Callable, NamedTuple, Sequence

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu.ops  # noqa: F401  (registers the JAX ops)
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch.ops import registry as treg

EXACT, NUM = 0.0, 1e-12
CORE = ("elemwise", "reduce", "matrix", "init_ops")


class Spec(NamedTuple):
    inputs: Sequence[Callable]     # rng -> numpy array, one per input
    params: dict = {}
    tol: float = EXACT


def U(*shape, lo=-2.0, hi=2.0):
    return lambda r: r.uniform(lo, hi, shape)


def P(*shape):                      # positive, away from 0
    return U(*shape, lo=0.5, hi=3.0)


def NZ(*shape):                     # either sign, away from 0
    return lambda r: r.choice([-1.0, 1.0], shape) * r.uniform(0.5, 2.0,
                                                              shape)


def INT(*shape, lo=0, hi=3):        # small integers as floats (ties)
    return lambda r: r.randint(lo, hi, shape).astype(np.float64)


def HALVES(*shape):                 # exact .5 ties for round/rint
    return lambda r: np.round(r.uniform(-4, 4, shape) * 2) / 2


def CONST(a):
    return lambda r: np.asarray(a, dtype=np.float64)


def _unary(tol, gen=None):
    return Spec([gen or U(3, 4)], {}, tol)


SPECS = {
    # -- elementwise unary
    **{n: _unary(NUM) for n in (
        "exp", "expm1", "sin", "cos", "tan", "arctan", "sinh", "cosh",
        "tanh", "arcsinh", "sigmoid", "erf", "cbrt", "degrees",
        "radians")},
    **{n: _unary(NUM, P(3, 4)) for n in (
        "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "rcbrt",
        "gamma", "gammaln")},
    **{n: _unary(NUM, U(3, 4, lo=-0.9, hi=0.9)) for n in (
        "arcsin", "arccos", "arctanh", "erfinv")},
    "arccosh": _unary(NUM, U(3, 4, lo=1.1, hi=3.0)),
    **{n: _unary(EXACT) for n in (
        "abs", "floor", "ceil", "trunc", "fix", "square", "relu",
        "softsign", "negative", "identity", "zeros_like", "ones_like",
        "shape_array", "size_array", "stop_gradient")},
    "reciprocal": _unary(EXACT, NZ(3, 4)),
    "sign": _unary(EXACT, INT(3, 4, lo=-1, hi=2)),
    "logical_not": _unary(EXACT, INT(3, 4, lo=-1, hi=2)),
    "round": _unary(EXACT, HALVES(3, 4)),
    "rint": _unary(EXACT, HALVES(3, 4)),
    "_identity_with_attr_like_rhs": Spec([U(3, 4), U(3, 4)]),
    "make_loss": Spec([U(3, 4)], {"grad_scale": 2.0,
                                  "normalization": "batch"}),
    "Cast": Spec([U(3, 4)], {"dtype": "float32"}),
    "amp_cast": Spec([U(3, 4)], {"dtype": "float16"}),
    "clip": Spec([U(3, 4)], {"a_min": -0.5, "a_max": 1.0}),
    # -- binary, broadcasting (3, 4) against (1, 4)
    **{"_binary_" + n: Spec([U(3, 4), U(1, 4)]) for n in (
        "add", "sub", "mul", "maximum", "minimum")},
    "_binary_div": Spec([U(3, 4), NZ(1, 4)]),
    "_binary_mod": Spec([U(3, 4), NZ(1, 4)]),
    "_binary_pow": Spec([P(3, 4), U(1, 4)], {}, NUM),
    "_binary_hypot": Spec([U(3, 4), U(1, 4)], {}, NUM),
    "_binary_arctan2": Spec([U(3, 4), U(1, 4)], {}, NUM),
    **{"_cmp_" + n: Spec([INT(3, 4), INT(1, 4)]) for n in (
        "equal", "not_equal", "greater", "greater_equal", "lesser",
        "lesser_equal")},
    **{"_logical_op_" + n: Spec([INT(3, 4), INT(1, 4)]) for n in (
        "logical_and", "logical_or", "logical_xor")},
    # -- scalar forms
    **{n: Spec([U(3, 4)], {"scalar": 1.5}) for n in (
        "_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
        "_div_scalar", "_mod_scalar", "_maximum_scalar",
        "_minimum_scalar")},
    # XLA's CPU code for a constant over an array is 1 ulp off the
    # correctly rounded quotient on some elements (measured 4.4e-16)
    "_rdiv_scalar": Spec([NZ(3, 4)], {"scalar": 1.5}, NUM),
    "_rmod_scalar": Spec([NZ(3, 4)], {"scalar": 1.5}),
    "_power_scalar": Spec([P(3, 4)], {"scalar": 1.5}, NUM),
    "_rpower_scalar": Spec([U(3, 4)], {"scalar": 1.5}, NUM),
    "_hypot_scalar": Spec([U(3, 4)], {"scalar": 1.5}, NUM),
    **{n: Spec([INT(3, 4)], {"scalar": 1.0}) for n in (
        "_equal_scalar", "_not_equal_scalar", "_greater_scalar",
        "_greater_equal_scalar", "_lesser_scalar",
        "_lesser_equal_scalar")},
    "smooth_l1": Spec([U(3, 4)], {"scalar": 1.5}),
    "where": Spec([INT(3, 4, lo=0, hi=2), U(3, 4), U(3, 4)]),
    "_scatter_elemwise_div": Spec([U(3, 4), NZ(3, 4)]),
    "add_n": Spec([U(3, 4), U(3, 4), U(3, 4)]),
    # -- reductions and broadcasts
    "sum": Spec([U(3, 4, 5)], {"axis": 1}, NUM),
    "mean": Spec([U(3, 4, 5)], {"axis": (0, 2), "keepdims": True}, NUM),
    "prod": Spec([U(3, 4, 5)], {"axis": (0, 2)}, NUM),
    "nansum": Spec([lambda r: np.where(r.rand(3, 4) < 0.3, np.nan,
                                       r.randn(3, 4))], {"axis": 0}, NUM),
    "nanprod": Spec([lambda r: np.where(r.rand(3, 4) < 0.3, np.nan,
                                        r.randn(3, 4))], {"axis": 1}, NUM),
    "max": Spec([U(3, 4, 5)], {"axis": -1}),
    "min": Spec([U(3, 4, 5)], {"axis": (0, 1), "exclude": True}),
    "norm": Spec([U(3, 4)], {"ord": 2, "axis": 1}, NUM),
    "argmax": Spec([U(3, 4)], {"axis": 1, "keepdims": True}),
    "argmin": Spec([U(3, 4)], {"axis": 0}),
    "argmax_channel": Spec([U(3, 4)]),
    "broadcast_to": Spec([U(1, 4)], {"shape": (3, 0)}),
    "broadcast_axis": Spec([U(3, 1)], {"axis": 1, "size": 4}),
    "broadcast_like": Spec([U(1, 4), U(3, 4)]),
    "L2Normalization": Spec([U(2, 3, 4)], {"mode": "channel"}, NUM),
    "square_sum": Spec([U(3, 4)], {"axis": 1}, NUM),
    # -- shape, indexing, ordering, joining, products
    "Reshape": Spec([U(2, 3, 4)], {"shape": (0, -1)}),
    "reshape_like": Spec([U(2, 6), U(3, 4)]),
    "Flatten": Spec([U(2, 3, 4)]),
    "transpose": Spec([U(2, 3, 4)], {"axes": (2, 0, 1)}),
    "expand_dims": Spec([U(2, 3)], {"axis": 1}),
    "squeeze": Spec([U(2, 1, 4)], {"axis": 1}),
    "SwapAxis": Spec([U(2, 3, 4)], {"dim1": 0, "dim2": 2}),
    "slice": Spec([U(4, 5)], {"begin": (1, 4), "end": (3, 0),
                              "step": (1, -2)}),
    "slice_axis": Spec([U(4, 5)], {"axis": 1, "begin": 1, "end": 4}),
    "slice_like": Spec([U(4, 5), U(2, 3)], {"axes": (1,)}),
    "repeat": Spec([U(2, 3)], {"repeats": 2, "axis": 1}),
    "tile": Spec([U(2, 3)], {"reps": (2, 1)}),
    "reverse": Spec([U(2, 3)], {"axis": 1}),
    "Concat": Spec([U(2, 3), U(2, 2)], {"dim": 1}),
    "stack": Spec([U(2, 3), U(2, 3)], {"axis": 1}),
    "SliceChannel": Spec([U(2, 6)], {"num_outputs": 3, "axis": 1}),
    "space_to_depth": Spec([U(1, 2, 4, 4)], {"block_size": 2}),
    "depth_to_space": Spec([U(1, 8, 2, 2)], {"block_size": 2}),
    "take": Spec([U(5, 3), INT(2, 3, lo=-2, hi=7)], {"axis": 0}),
    "Embedding": Spec([INT(2, 3, lo=0, hi=5), U(5, 4)],
                      {"input_dim": 5, "output_dim": 4}),
    "one_hot": Spec([INT(2, 3, lo=0, hi=5)], {"depth": 5, "on_value": 2.0,
                                              "off_value": -1.0}),
    "pick": Spec([U(3, 4), INT(3, lo=0, hi=4)], {"axis": 1}),
    "gather_nd": Spec([U(3, 4), CONST([[0, 2, 1], [3, 0, 1]])]),
    "scatter_nd": Spec([U(3), CONST([[0, 2, 1], [3, 0, 1]])],
                       {"shape": (3, 4)}),
    "_scatter_set_nd": Spec([U(3, 4), U(3), CONST([[0, 2, 1], [3, 0, 1]])],
                            {"shape": (3, 4)}),
    "batch_take": Spec([U(3, 4), INT(3, lo=0, hi=4)]),
    "sort": Spec([U(3, 5)], {"axis": 1, "is_ascend": False}),
    "argsort": Spec([U(3, 5)], {"axis": 1}),
    "topk": Spec([U(3, 5)], {"axis": 1, "k": 2, "ret_typ": "both"}),
    "dot": Spec([U(3, 4), U(5, 4)], {"transpose_b": True}, NUM),
    "batch_dot": Spec([U(2, 3, 4), U(2, 4, 5)], {}, NUM),
    "khatri_rao": Spec([U(3, 2), U(4, 2)]),
    # -- creation
    "_zeros": Spec([], {"shape": (2, 3), "dtype": "float64"}),
    "_ones": Spec([], {"shape": (2, 3)}),
    "_full": Spec([], {"shape": (2, 3), "value": 1.5}),
    "_arange": Spec([], {"start": 1, "stop": 7, "step": 1.5, "repeat": 2,
                         "dtype": "float64"}),
    "_eye": Spec([], {"N": 3, "M": 4, "k": 1}),
    # -- nn: the softmax pair
    "softmax": Spec([U(3, 4)], {"axis": 1}, NUM),
    "log_softmax": Spec([U(3, 4)], {"axis": 0}, NUM),
}


def _names(registry, package):
    mods = {"%s.ops.%s" % (package, m) for m in CORE}
    return sorted(n for n, op in registry._REGISTRY.items()
                  if op.fn.__module__ in mods)


# every name the four JAX modules register, aliases included
JAX_NAMES = _names(jreg, "mxnet_tpu")
OP_NAMES = JAX_NAMES + ["softmax", "log_softmax"]


def test_port_registers_every_core_name():
    assert len(JAX_NAMES) == 154 + 21 + 38 + 5
    assert _names(treg, "mxnet_tpu_torch") == JAX_NAMES
    assert {"softmax", "log_softmax"} <= set(treg._REGISTRY)
    # every JAX op has a parity case below
    assert {jreg.get(n).name for n in OP_NAMES} == set(SPECS)
    # and the generated namespace carries every name
    assert all(callable(getattr(mx.nd, n)) for n in OP_NAMES)


def _as_list(out):
    if isinstance(out, (tuple, list)):
        return list(out)
    return [out]


@pytest.mark.parametrize("name", OP_NAMES)
def test_op_matches_jax(name):
    spec = SPECS[jreg.get(name).name]
    rng = np.random.RandomState(0)
    ins = [f(rng) for f in spec.inputs]
    want = _as_list(jreg.get(name).fn(*[jnp.asarray(a) for a in ins],
                                      **spec.params))
    with mx.cpu():
        got = _as_list(mx.nd.invoke(name, [mx.nd.array(a) for a in ins],
                                    spec.params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert isinstance(g, mx.nd.NDArray) and g.context == mx.cpu()
        g = g.asnumpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        if spec.tol == EXACT:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=spec.tol, atol=spec.tol)


# ---------------------------------------------------------------- NDArray
def _both(a, dtype=None):
    """The same numpy value as a JAX-package and a port NDArray."""
    return (jmx.nd.array(a, dtype=dtype),
            mx.nd.array(a, ctx=mx.cpu(), dtype=dtype))


def test_getitem_copies_and_setitem_leaves_other_arrays_alone():
    a = np.arange(12.0).reshape(3, 4)
    for nd, x in zip((jmx.nd, mx.nd), _both(a)):
        row = x[1]
        col = x[:, ::-2]
        flat = x.reshape((12,))
        t = x.T
        x[1] = 100.0
        x[:, 0] = nd.array(np.array([7.0, 8.0, 9.0]), ctx=x.context)
        np.testing.assert_array_equal(row.asnumpy(), a[1])
        np.testing.assert_array_equal(col.asnumpy(), a[:, ::-2])
        np.testing.assert_array_equal(flat.asnumpy(), a.reshape(12))
        np.testing.assert_array_equal(t.asnumpy(), a.T)
    jx, tx = _both(a)
    for x in (jx, tx):
        x[1] = 100.0
        x[::-1, 1:3] = 5.0
        x[:] = x * 2
    np.testing.assert_array_equal(tx.asnumpy(), jx.asnumpy())


def test_inplace_operators_swap_the_value():
    a = np.arange(6.0).reshape(2, 3)
    for x in _both(a):
        y = x.reshape((3, 2))
        z = x
        x += 1
        x *= 2
        x -= 0.5
        x /= 2
        np.testing.assert_array_equal(y.asnumpy(), a.reshape(3, 2))
        assert z is x
        np.testing.assert_array_equal(x.asnumpy(), ((a + 1) * 2 - 0.5) / 2)


def test_out_writes_into_the_given_array_in_its_dtype():
    a = np.arange(6.0).reshape(2, 3)
    res = []
    for nd, x in zip((jmx.nd, mx.nd), _both(a)):
        with (mx.cpu() if nd is mx.nd else jmx.cpu()):
            o = nd.zeros((2, 3), dtype="float32")
        keep = o.copy()
        r = nd.broadcast_add(x, x, out=o)
        assert r is o
        res.append(o.asnumpy())
        np.testing.assert_array_equal(keep.asnumpy(), 0.0)
    assert res[0].dtype == res[1].dtype == np.float32
    np.testing.assert_array_equal(res[1], res[0])


@pytest.mark.parametrize("src,dtype", [
    ([1, 2, 3], None), ([1.5, 2.5], None), (7, None),
    (np.arange(3, dtype=np.float64), None),
    (np.arange(3, dtype=np.int32), None),
    (np.arange(3, dtype=np.int64), None),
    (np.ones(3, np.float16), None), ([1, 2], "int64"),
    (np.arange(3.0), "float16")], ids=str)
def test_array_dtype_defaults_match(src, dtype):
    j, t = _both(src, dtype)
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_bfloat16_keeps_id_12_and_asnumpy_is_exact_float32():
    from mxnet_tpu import base as jbase

    assert tbase.dtype_id("bfloat16") == jbase.dtype_id("bfloat16") == 12
    assert tbase.dtype_name(12) == "bfloat16"
    assert tbase.torch_dtype(12) is torch.bfloat16
    for name in ("float32", "float64", "float16", "uint8", "int32", "int8",
                 "int64", "bool", "uint32", "uint64"):
        assert tbase.dtype_id(name) == jbase.dtype_id(name), name
    vals = np.array([1.0, -2.5, 3.140625, 1e-3, 65504.0], np.float32)
    j, t = _both(vals, "bfloat16")
    assert t.dtype is torch.bfloat16
    got = t.asnumpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, j.asnumpy().astype(np.float32))


def test_free_functions_and_namespace():
    a = np.arange(1.0, 7.0).reshape(2, 3)
    with mx.cpu():
        x = mx.nd.array(a)
        np.testing.assert_array_equal(mx.nd.subtract(1.0, x).asnumpy(),
                                      1.0 - a)
        np.testing.assert_array_equal(mx.nd.divide(x, 2).asnumpy(), a / 2)
        np.testing.assert_array_equal(mx.nd.maximum(x, 3.0).asnumpy(),
                                      np.maximum(a, 3.0))
        np.testing.assert_array_equal(
            mx.nd.concat(x, x, dim=0).asnumpy(), np.concatenate([a, a]))
        np.testing.assert_array_equal(mx.nd.dot(x, x.T).asnumpy(), a @ a.T)
        np.testing.assert_array_equal(mx.nd.clip(x, a_min=2, a_max=4)
                                      .asnumpy(), np.clip(a, 2, 4))
        assert mx.nd.zeros((2,)).context == mx.cpu()
        np.testing.assert_array_equal(mx.nd.moveaxis(x, 0, 1).asnumpy(),
                                      a.T)
    mx.nd.waitall()


def test_engine_bulk_api():
    # set_bulk_size leaves the size explicit, which would turn every
    # later Module.fit of this process into a bulk fit: restore it
    saved = mx.engine._bulk_size, mx.engine._bulk_explicit
    try:
        prev = mx.engine.set_bulk_size(30)
        assert mx.engine.set_bulk_size(prev) == 30
        with mx.engine.bulk(5):
            assert mx.engine.current_bulk_size() == 5
            x = mx.nd.ones((4,), ctx=mx.cpu()) + 1
        assert float(x.sum().asnumpy()) == 8.0
        assert mx.engine.current_bulk_size() == prev
    finally:
        mx.engine._bulk_size, mx.engine._bulk_explicit = saved


# ------------------------------------------------------------ save / load
def _payloads(nd, ctx):
    rng = np.random.RandomState(3)
    arrs = {"w": rng.randn(3, 4), "b": rng.randn(4).astype(np.float32),
            "i": rng.randint(0, 9, (2, 2)).astype(np.int64),
            "h": rng.randn(5).astype(np.float16)}
    return {k: nd.array(v, ctx=ctx) for k, v in arrs.items()}


def _bits(x):
    if isinstance(x, mx.nd.NDArray):
        t = x._data
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = x.asnumpy()
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same(a, b):
    pa, pb = _bits(a), _bits(b)
    assert pa.dtype == pb.dtype and pa.shape == pb.shape
    assert pa.tobytes() == pb.tobytes()


@pytest.mark.parametrize("fname", ["p.params", "p.npz"])
def test_files_cross_load_bitwise(tmp_path, fname):
    tpay = _payloads(mx.nd, mx.cpu())
    jpay = _payloads(jmx.nd, jmx.cpu())
    if fname.endswith(".npz"):
        bf = np.array([1.0, -0.0078125, 3.0], np.float32)
        tpay["bf"] = mx.nd.array(bf, ctx=mx.cpu(), dtype="bfloat16")
        jpay["bf"] = jmx.nd.array(bf, dtype="bfloat16")
    tp, jp = str(tmp_path / ("t_" + fname)), str(tmp_path / ("j_" + fname))
    mx.nd.save(tp, tpay)
    jmx.nd.save(jp, jpay)
    if fname.endswith(".params"):
        # the reference container: byte for byte the same file
        with open(tp, "rb") as f, open(jp, "rb") as g:
            assert f.read() == g.read()
    into_jax = jmx.nd.load(tp)
    into_port = mx.nd.load(jp, ctx=mx.cpu())
    assert set(into_jax) == set(into_port) == set(tpay)
    for k in tpay:
        _same(into_jax[k], tpay[k])
        _same(into_port[k], jpay[k])
    # lists too, and load_frombuffer
    mx.nd.save(tp, [tpay["w"], tpay["b"]])
    with open(tp, "rb") as f:
        lst = mx.nd.load_frombuffer(f.read(), ctx=mx.cpu())
    assert len(lst) == 2 and len(jmx.nd.load(tp)) == 2
    _same(lst[0], jmx.nd.load(tp)[0])


def test_container_refuses_0d_and_reads_legacy_v1(tmp_path):
    p = str(tmp_path / "z.params")
    with pytest.raises(mx.MXNetError):
        mx.nd.save(p, [mx.nd.array(1.0, ctx=mx.cpu())], format="dmlc")
    # a V1 record: magic, int64 shape, context, type flag, data
    vals = np.arange(6, dtype=np.float32).reshape(2, 3)
    blob = struct.pack("<QQQ", 0x112, 0, 1) + struct.pack("<I", 0xF993FAC8)
    blob += struct.pack("<I", 2) + struct.pack("<2q", 2, 3)
    blob += struct.pack("<iii", 1, 0, 0) + vals.tobytes()
    blob += struct.pack("<Q", 0)
    (got,) = mx.nd.load_frombuffer(blob, ctx=mx.cpu())
    np.testing.assert_array_equal(got.asnumpy(), vals)
    (jgot,) = jmx.nd.load_frombuffer(blob)
    np.testing.assert_array_equal(jgot.asnumpy(), vals)
