"""Parity of the port's neural-network ops (``mxnet_tpu_torch.ops.nn``,
``random_ops``, ``optimizer_ops``) with the JAX package's.

Every op that ``mxnet_tpu/ops/nn.py`` registers (``FullyConnected``
through ``Dropout``, ``Pad`` and the spatial tail up to ``Crop``) runs
on the same seeded float64 numpy inputs through the JAX
op body and the port's.  The first output gets a seeded cotangent and
both packages' gradients of it with respect to every float input are
compared (``jax.vjp`` against ``torch.autograd.grad``); every output
(BatchNorm's moving statistics and ``output_mean_var`` included) is
compared forward.

Tolerance: 1e-10, relative to the largest magnitude of the JAX value:
XLA and cuDNN/ATen sum convolution windows, pooling windows and
statistics in other orders, a few float64 ulps apart (about 1e-15).
The samplers are held to their distributions, never to the JAX draws.
"""
from typing import Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu.ops  # noqa: F401  (registers the JAX ops)
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry as treg

TOL = 1e-10


class Case(NamedTuple):
    op: str
    inputs: Sequence[Callable]   # rng -> numpy array
    params: dict = {}
    diff: Sequence[int] = (0,)   # inputs whose gradient is compared


def U(*shape, lo=-2.0, hi=2.0):
    return lambda r: r.uniform(lo, hi, shape)


def P(*shape):
    return U(*shape, lo=0.5, hi=2.0)


def AWAY0(*shape):                 # either sign, away from 0 (kinks)
    return lambda r: r.choice([-1.0, 1.0], shape) * r.uniform(0.1, 2.0,
                                                              shape)


def LABELS(*shape, n=5, lo=0):
    return lambda r: r.randint(lo, n, shape).astype(np.float64)


def _pool_cases():
    out = []
    for pool_type in ("max", "avg", "sum"):
        for conv in ("valid", "full"):
            for cip in (True, False):
                if pool_type != "avg" and not cip:
                    continue
                p = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                         pool_type=pool_type, pooling_convention=conv,
                         count_include_pad=cip)
                out.append(Case("Pooling", [U(2, 3, 8, 8)], p))
                # an odd input: 'full' adds a right padding column
                out.append(Case("Pooling", [U(2, 3, 7, 6)],
                                dict(p, kernel=(2, 3), pad=(0, 1))))
        out.append(Case("Pooling", [U(2, 3, 5, 6)],
                        dict(kernel=(1, 1), global_pool=True,
                             pool_type=pool_type)))
        out.append(Case("Pooling", [U(2, 3, 9)],
                        dict(kernel=(3,), stride=(2,), pad=(1,),
                             pool_type=pool_type,
                             pooling_convention="full")))
        out.append(Case("Pooling", [U(1, 2, 5, 4, 6)],
                        dict(kernel=(2, 2, 3), stride=(2, 1, 2),
                             pool_type=pool_type,
                             pooling_convention="full")))
    # padding past half the kernel: the explicit -inf/zero route
    out.append(Case("Pooling", [U(2, 2, 6, 6)],
                    dict(kernel=(2, 2), stride=(2, 2), pad=(1, 1),
                         pool_type="max")))
    out.append(Case("Pooling", [U(2, 2, 7, 7)],
                    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                         pool_type="avg", count_include_pad=False,
                         pooling_convention="full")))
    return out


def _bn_cases():
    out = []
    base = [U(4, 3, 5, 5), P(3), U(3), U(3), P(3)]
    for fix_gamma in (True, False):
        for training in (True, False):
            for omv in (False, True):
                out.append(Case("BatchNorm", base,
                                dict(fix_gamma=fix_gamma, eps=1e-3,
                                     momentum=0.9, output_mean_var=omv,
                                     _training=training), (0, 1, 2)))
    out.append(Case("BatchNorm", base,
                    dict(fix_gamma=False, use_global_stats=True,
                         _training=True), (0, 1, 2)))
    out.append(Case("BatchNorm", [U(6, 4), P(4), U(4), U(4), P(4)],
                    dict(fix_gamma=False, eps=1e-5, momentum=0.8,
                         _training=True), (0, 1, 2)))
    out.append(Case("BatchNorm", [U(3, 5, 4), P(4), U(4), U(4), P(4)],
                    dict(fix_gamma=False, axis=-1, _training=True),
                    (0, 1, 2)))
    return out


def _softmax_output_cases():
    out = []
    lab = LABELS(6, n=5, lo=-1)            # -1 is the ignore label
    for norm in ("null", "batch", "valid"):
        for ign in (False, True):
            out.append(Case("SoftmaxOutput", [U(6, 5), lab],
                            dict(normalization=norm, use_ignore=ign,
                                 grad_scale=1.5)))
    out.append(Case("SoftmaxOutput", [U(2, 4, 3, 3), LABELS(2, 3, 3, n=4)],
                    dict(multi_output=True, use_ignore=True,
                         ignore_label=2, normalization="valid")))
    out.append(Case("SoftmaxOutput", [U(2, 3, 5), LABELS(2, 3, n=5)],
                    dict(preserve_shape=True, normalization="batch")))
    out.append(Case("SoftmaxOutput", [U(4, 2, 3), LABELS(4, n=6)],
                    dict(smooth_alpha=0.1)))
    return out


CASES = [
    # FullyConnected: flatten, no flatten, no bias
    Case("FullyConnected", [U(2, 3, 4), U(5, 12), U(5)],
         dict(num_hidden=5), (0, 1, 2)),
    Case("FullyConnected", [U(2, 3, 4), U(5, 4), U(5)],
         dict(num_hidden=5, flatten=False), (0, 1, 2)),
    Case("FullyConnected", [U(3, 6), U(2, 6)],
         dict(num_hidden=2, no_bias=True), (0, 1)),
    # Convolution: 1-D, 2-D with stride / dilation / groups / bias, 3-D
    Case("Convolution", [U(2, 3, 11), U(4, 3, 3), U(4)],
         dict(kernel=(3,), stride=(2,), pad=(1,), num_filter=4),
         (0, 1, 2)),
    Case("Convolution", [U(2, 4, 9, 8), U(6, 2, 3, 3), U(6)],
         dict(kernel=(3, 3), stride=(2, 1), dilate=(1, 2), pad=(1, 2),
              num_filter=6, num_group=2), (0, 1, 2)),
    Case("Convolution", [U(2, 3, 7, 7), U(4, 3, 1, 1)],
         dict(kernel=(1, 1), stride=(2, 2), num_filter=4, no_bias=True),
         (0, 1)),
    Case("Convolution", [U(1, 2, 5, 6, 5), U(3, 2, 2, 3, 2)],
         dict(kernel=(2, 3, 2), stride=(1, 2, 1), pad=(1, 0, 1),
              num_filter=3, no_bias=True), (0, 1)),
    # Deconvolution: conv_transpose, and the explicit route (adj >=
    # max(stride, dilation))
    Case("Deconvolution", [U(2, 4, 5, 5), U(4, 3, 3, 3)],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
              num_filter=3), (0, 1)),
    Case("Deconvolution", [U(2, 4, 5, 4), U(4, 3, 3, 2), U(3)],
         dict(kernel=(3, 2), stride=(2, 3), dilate=(2, 1), pad=(2, 0),
              adj=(1, 2), num_filter=3, no_bias=False), (0, 1, 2)),
    Case("Deconvolution", [U(1, 2, 4, 4), U(2, 2, 3, 3)],
         dict(kernel=(3, 3), stride=(2, 2), adj=(3, 2), num_filter=2),
         (0, 1)),
    Case("Deconvolution", [U(2, 3, 6), U(3, 2, 4)],
         dict(kernel=(4,), stride=(3,), pad=(1,), num_filter=2), (0, 1)),
    *_pool_cases(),
    *[Case("Activation", [AWAY0(3, 4)], dict(act_type=a))
      for a in ("relu", "sigmoid", "tanh", "softrelu", "softsign")],
    *[Case("LeakyReLU", [AWAY0(2, 3, 4)], dict(act_type=a, slope=0.3))
      for a in ("leaky", "elu", "selu", "gelu", "rrelu")],
    Case("LeakyReLU", [AWAY0(2, 3, 4), P(3)], dict(act_type="prelu"),
         (0, 1)),
    Case("softmin", [U(3, 5)], dict(axis=1)),
    Case("SoftmaxActivation", [U(2, 3, 4)], dict(mode="instance")),
    Case("SoftmaxActivation", [U(2, 3, 4)], dict(mode="channel")),
    *_softmax_output_cases(),
    Case("LinearRegressionOutput", [U(4, 3), U(4, 3)],
         dict(grad_scale=2.0)),
    Case("LogisticRegressionOutput", [U(4, 3), P(4, 3)]),
    Case("MAERegressionOutput", [U(5), U(5)], dict(grad_scale=0.5)),
    *_bn_cases(),
    Case("LayerNorm", [U(3, 4, 5), P(5), U(5)], dict(eps=1e-5),
         (0, 1, 2)),
    Case("LayerNorm", [U(3, 4, 5), P(4), U(4)],
         dict(axis=1, output_mean_var=True), (0, 1, 2)),
    Case("InstanceNorm", [U(2, 3, 4, 5), P(3), U(3)], dict(eps=1e-3),
         (0, 1, 2)),
    Case("LRN", [U(2, 6, 3, 3)], dict(nsize=3, alpha=1e-2)),
    Case("Dropout", [U(3, 4)], dict(p=0.0, _training=True)),
    Case("Dropout", [U(3, 4)], dict(p=0.5, _training=False)),
    Case("Pad", [U(1, 2, 3, 4)],
         dict(mode="constant", pad_width=(0, 0, 1, 0, 1, 2, 2, 1),
              constant_value=1.5)),
    Case("Pad", [U(1, 2, 3, 4)],
         dict(mode="edge", pad_width=(0, 0, 0, 0, 1, 2, 2, 1))),
    Case("Pad", [U(1, 2, 3, 4)],
         dict(mode="reflect", pad_width=(0, 0, 0, 0, 2, 1, 1, 2))),
    # the spatial tail (:532-688)
    Case("UpSampling", [U(2, 3, 3, 4)],
         dict(scale=2, sample_type="nearest", num_args=1)),
    Case("UpSampling", [U(1, 2, 4, 4), U(1, 3, 2, 2)],
         dict(scale=2, sample_type="nearest", num_args=2), (0, 1)),
    Case("UpSampling", [U(2, 2, 3, 5)],
         dict(scale=2, sample_type="bilinear", num_args=1)),
    Case("BilinearSampler", [U(2, 3, 5, 6), U(2, 2, 4, 3, lo=-1.2, hi=1.2)],
         {}, (0, 1)),
    Case("GridGenerator", [U(2, 6)],
         dict(transform_type="affine", target_shape=(4, 5))),
    Case("GridGenerator", [U(2, 2, 3, 4)],
         dict(transform_type="warp", target_shape=(3, 4))),
    Case("SpatialTransformer",
         [U(2, 3, 6, 5), lambda r: np.tile([0.9, 0.1, 0.05, -0.1, 0.8,
                                            -0.05], (2, 1))
          + r.uniform(-0.1, 0.1, (2, 6))],
         dict(target_shape=(4, 4)), (0, 1)),
    Case("ROIPooling",
         [U(2, 3, 8, 9), lambda r: np.array([[0, 0.5, 1.0, 6.5, 5.0],
                                             [1, 2.0, 0.0, 8.0, 7.5],
                                             [0, 3.3, 2.5, 4.1, 3.9]])],
         dict(pooled_size=(2, 3), spatial_scale=1.0)),
    Case("Crop", [U(2, 3, 7, 8)], dict(offset=(1, 2), h_w=(4, 5))),
    Case("Crop", [U(1, 2, 7, 8), U(1, 1, 4, 4)],
         dict(num_args=2, center_crop=True)),
]

# every name of the JAX module has a case (names registered there, not
# aliases other modules add)
_NN = {n for n, op in jreg._REGISTRY.items()
       if op.fn.__module__ == "mxnet_tpu.ops.nn"
       and n in (op.name, *op.aliases)}


def _id(case):
    return case.op + "-" + "-".join("%s=%s" % kv for kv in
                                    sorted(case.params.items()))[:80]


def test_every_nn_op_up_to_pad_is_ported_with_its_flags():
    want = _NN
    assert want <= set(treg._REGISTRY)
    for n in want:
        j, t = jreg.get(n), treg.get(n)
        assert (t.name, t.mutate_aux, t.train_aware, t.rng) == \
            (j.name, j.mutate_aux, j.train_aware, j.rng), n
        assert t.input_names == j.input_names, n
    tested = {c.op for c in CASES} | {"softmax", "log_softmax"}
    assert {jreg.get(n).name for n in want} <= tested
    for n in ("sgd_update", "sgd_mom_update", "_random_uniform",
              "_random_normal", "_random_randint"):
        j, t = jreg.get(n), treg.get(n)
        assert (t.mutate_aux, t.rng, t.nondiff, sorted(t.aliases)) == \
            (j.mutate_aux, j.rng, j.nondiff, sorted(j.aliases)), n


def _close(got, want, what):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_op_forward_and_gradient_match_jax(case):
    rng = np.random.RandomState(0)
    ins = [f(rng) for f in case.inputs]
    jop, top = jreg.get(case.op), treg.get(case.op)
    jfn, tfn = jop.bound(**case.params), top.bound(**case.params)
    if jop.rng:
        key, gen = jax.random.PRNGKey(0), torch.Generator()
        jfn0, tfn0 = jfn, tfn
        jfn = lambda *a: jfn0(key, *a)  # noqa: E731
        tfn = lambda *a: tfn0(gen, *a)  # noqa: E731

    jouts, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in ins])
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    cot = rng.standard_normal(np.shape(jouts[0]))
    jcots = (jnp.asarray(cot),) + tuple(jnp.zeros_like(o)
                                        for o in jouts[1:])
    jgrads = vjp(jcots if len(jouts) > 1 else jcots[0])

    tins = [torch.tensor(a, requires_grad=i in case.diff)
            for i, a in enumerate(ins)]
    touts = tfn(*tins)
    touts = touts if isinstance(touts, tuple) else (touts,)
    assert len(touts) == len(jouts)
    for k, (t, j) in enumerate(zip(touts, jouts)):
        _close(t.detach().numpy(), j, "output %d" % k)
    tgrads = torch.autograd.grad(touts[0], [tins[i] for i in case.diff],
                                 torch.tensor(cot), allow_unused=True)
    for i, g in zip(case.diff, tgrads):
        g = np.zeros(ins[i].shape) if g is None else g.numpy()
        _close(g, jgrads[i], "gradient of input %d" % i)


@pytest.mark.parametrize("opts", [dict(use_global_stats=True),
                                  dict(_training=False)])
def test_batchnorm_leaves_moving_stats_alone_outside_training(opts):
    rng = np.random.RandomState(1)
    x, g, b = rng.randn(4, 3, 2, 2), rng.rand(3) + 0.5, rng.randn(3)
    mm, mv = rng.randn(3), rng.rand(3) + 0.5
    with mx.cpu():
        cells = [mx.nd.array(a, dtype="float64") for a in (mm, mv)]
        mx.nd.BatchNorm(mx.nd.array(x, dtype="float64"),
                        mx.nd.array(g, dtype="float64"),
                        mx.nd.array(b, dtype="float64"), *cells, **opts)
    np.testing.assert_array_equal(cells[0].asnumpy(), mm)
    np.testing.assert_array_equal(cells[1].asnumpy(), mv)


def test_batchnorm_moving_stats_update_in_their_own_dtype():
    # bf16 moving stats (after a cast) update in bf16: the old stat
    # weighted by momentum, the batch stat (float32) rounded to bf16 first
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(8, 2, 3, 3), dtype=torch.bfloat16)
    mm = torch.tensor([0.5, -1.0], dtype=torch.bfloat16)
    mv = torch.tensor([2.0, 0.25], dtype=torch.bfloat16)
    one, zero = torch.ones(2, dtype=torch.bfloat16), \
        torch.zeros(2, dtype=torch.bfloat16)
    out, new_mm, new_mv = treg.get("BatchNorm").fn(
        x, one, zero, mm, mv, momentum=0.9, fix_gamma=False)
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0)
    assert new_mm.dtype == torch.bfloat16 and out.dtype == torch.bfloat16
    assert torch.equal(new_mm, mm * 0.9 + mean.to(torch.bfloat16) * 0.1)
    assert torch.equal(new_mv, mv * 0.9 + var.to(torch.bfloat16) * 0.1)


def test_deconvolution_is_conv_transpose_with_groups():
    # grouped Deconvolution: the JAX op refuses num_group > 1; the port's
    # conv_transpose route and its explicit route agree
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(2, 4, 5, 5))
    w = torch.tensor(rng.randn(4, 3, 3, 3))
    fn = treg.get("Deconvolution").fn
    a = fn(x, w, kernel=(3, 3), stride=(2, 2), adj=(1, 1), num_group=2)
    # adj 1 < stride 2 takes conv_transpose; adj 2 takes the explicit
    # route, whose output is the same plus one row and one column
    b = fn(x, w, kernel=(3, 3), stride=(2, 2), adj=(2, 2), num_group=2)
    assert a.shape == (2, 6, 12, 12) and b.shape == (2, 6, 13, 13)
    np.testing.assert_allclose(b[:, :, :12, :12].numpy(), a.numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,params,mean,var", [
    ("_random_uniform", dict(low=-1.0, high=3.0), 1.0, 16.0 / 12),
    ("_random_normal", dict(loc=0.5, scale=2.0), 0.5, 4.0),
    ("_random_randint", dict(low=2, high=7, dtype="int64"), 4.0, 2.0),
])
def test_samplers_match_the_distribution(name, params, mean, var):
    mx.random.seed(7)
    with mx.cpu():
        a = mx.nd.invoke(name, [], dict(params, shape=(200000,))).asnumpy()
    n = a.size
    assert abs(a.mean() - mean) < 5 * np.sqrt(var / n)
    assert abs(a.var() - var) < 0.02 * var
    if name == "_random_randint":
        assert set(np.unique(a)) == {2, 3, 4, 5, 6}


def test_seed_reseeds_every_generator():
    with mx.cpu():
        mx.random.seed(3)
        a = mx.nd.random.uniform(shape=(5,)).asnumpy()
        b = mx.nd.random.normal(shape=(5,)).asnumpy()
        mx.random.seed(3)
        np.testing.assert_array_equal(
            mx.nd.random.uniform(shape=(5,)).asnumpy(), a)
        np.testing.assert_array_equal(
            mx.nd.random.normal(shape=(5,)).asnumpy(), b)
        out = mx.nd.zeros((2, 3))
        mx.random.uniform(-1, 1, out=out)
        assert out.shape == (2, 3) and np.abs(out.asnumpy()).max() <= 1


def test_dropout_draws_a_scaled_mask():
    with mx.cpu():
        x = mx.nd.ones((400, 500))
        with mx.autograd.train_mode():
            y = mx.nd.Dropout(x, p=0.25).asnumpy()
    assert set(np.unique(y)) == {0.0, np.float32(1.0) / np.float32(0.75)}
    assert abs((y == 0).mean() - 0.25) < 0.01


@pytest.mark.parametrize("name,extra", [("sgd_update", {}),
                                        ("sgd_mom_update",
                                         {"momentum": 0.9})])
def test_sgd_update_ops_match_jax(name, extra):
    rng = np.random.RandomState(4)
    w, g, m = rng.randn(5, 3), rng.randn(5, 3), rng.randn(5, 3)
    params = dict(lr=0.1, wd=1e-3, rescale_grad=0.5, clip_gradient=0.3,
                  **extra)
    ins = [w, g] + ([m] if name == "sgd_mom_update" else [])
    want = jreg.get(name).fn(*[jnp.asarray(a) for a in ins], **params)
    got = treg.get(name).fn(*[torch.tensor(a) for a in ins], **params)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15,
                                   atol=1e-15)
