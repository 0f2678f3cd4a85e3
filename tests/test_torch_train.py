"""Parity of the port's single-device ``FusedTrainStep``
(``mxnet_tpu_torch.parallel.dp``) with the JAX package's.

A small conv net (Conv2D, BatchNorm, relu, MaxPool2D, GlobalAvgPool2D,
Dense) is built in both packages with the same names and weights, and
each package's ``FusedTrainStep`` (SGD with momentum and weight decay,
cast to float64 at build) takes the same three steps on the same
batches.  Tolerance: per-step losses and every parameter (the BatchNorm
running statistics included) 1e-10 relative to the largest magnitude,
absolute below 1 (a convolution bias before a BatchNorm has a gradient
of 0 in exact arithmetic, its values are rounding noise): three steps
of float64 forward, backward and update, each summed in another order
by XLA and ATen.  ``fused_update=False`` is held to the fused update
bitwise, as the JAX package pins it.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.parallel.dp import FusedTrainStep as JStep
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.parallel.dp import FusedTrainStep as TStep

TOL = 1e-10
STEP = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
            dtype="float64")


def _net(pkg, prefix="tr_"):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2),
                nn.Conv2D(8, 3, padding=1, use_bias=False), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(), nn.Dense(5))
    return net


def _pair(seed=0):
    """JAX-package and port nets, Xavier-initialised in float32 with
    their shapes still deferred, the JAX weights carried into the port
    net after one settling forward in each."""
    np.random.seed(seed)
    jnet = _net(jmx)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    x = np.random.RandomState(seed).rand(2, 3, 8, 8).astype(np.float32)
    with jmx.autograd.pause():
        jnet(jmx.nd.array(x, ctx=jmx.cpu()))
    tnet = _net(mx)
    with mx.cpu():
        tnet.initialize(mx.init.Xavier())
        with mx.autograd.pause():
            tnet(mx.nd.array(x))
    convert.load_block_params(tnet, {k: p.data().asnumpy() for k, p in
                                     jnet.collect_params().items()})
    return jnet, tnet


def _batches(k=3, b=4, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (k, b, 3, 8, 8)).astype(np.float32),
            rng.randint(0, 5, (k, b)).astype(np.float32))


def _params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _assert_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def test_three_step_trajectory_matches_jax():
    jnet, tnet = _pair()
    data, label = _batches()
    jstep = JStep(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), **STEP)
    jl = jstep.run_steps(jmx.nd.array(data, ctx=jmx.cpu()),
                         jmx.nd.array(label, ctx=jmx.cpu()))
    with mx.cpu():
        tstep = TStep(tnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(), **STEP)
        tl = tstep.run_steps(mx.nd.array(data), mx.nd.array(label))
    assert tl.shape == (3,) and tl.dtype == np.float64
    _assert_close(tl.asnumpy(), jl.asnumpy(), "losses")
    jp, tp = _params(jnet), _params(tnet)
    assert list(jp) == list(tp)
    for k in jp:
        assert tp[k].dtype == np.float64, k
        _assert_close(tp[k], jp[k], k)
    # one more step through __call__: (loss, logits)
    jloss, jlogits = jstep(jmx.nd.array(data[0], ctx=jmx.cpu()),
                           jmx.nd.array(label[0], ctx=jmx.cpu()))
    with mx.cpu():
        tloss, tlogits = tstep(mx.nd.array(data[0]), mx.nd.array(label[0]))
    _assert_close(tloss.asnumpy(), jloss.asnumpy(), "loss")
    _assert_close(tlogits.asnumpy(), jlogits.asnumpy(), "logits")


def test_same_batch_form_equals_the_repeated_leading_k_form():
    data, label = _batches(k=1)
    runs = []
    for form in ("same", "leading"):
        _, tnet = _pair()
        with mx.cpu():
            step = TStep(tnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         **STEP)
            if form == "same":
                losses = step.run_steps(mx.nd.array(data[0]),
                                        mx.nd.array(label[0]), steps=3)
            else:
                losses = step.run_steps(mx.nd.array(np.repeat(data, 3, 0)),
                                        mx.nd.array(np.repeat(label, 3, 0)))
        runs.append((losses.asnumpy(), _params(tnet)))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    for k in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][k], runs[1][1][k])


def test_per_key_update_is_bitwise_the_fused_update():
    data, label = _batches()
    runs = []
    for fused in (True, False):
        _, tnet = _pair()
        with mx.cpu():
            step = TStep(tnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         fused_update=fused, **STEP)
            losses = step.run_steps(mx.nd.array(data), mx.nd.array(label))
        runs.append((losses.asnumpy(), _params(tnet), step._moms))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    for k in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][k], runs[1][1][k])
    for a, b in zip(runs[0][2], runs[1][2]):
        assert torch.equal(a, b)


def test_settle_forward_moves_no_running_statistic():
    # shapes still deferred: the build's settling forward sizes them and
    # must leave the running statistics at their initial values
    np.random.seed(0)
    net = _net(mx)
    data, label = _batches(k=1)
    with mx.cpu():
        net.initialize(mx.init.Xavier())
        step = TStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), **STEP)
        step._build(mx.nd.array(data[0]))
    for k, p in net.collect_params(".*running_(mean|var)").items():
        want = 0.0 if k.endswith("mean") else 1.0
        np.testing.assert_array_equal(p.data().asnumpy(), want, err_msg=k)
        assert p.data().dtype == np.float64, k     # cast, stats included
    assert all(m.dtype == torch.float64 and not m.any()
               for m in step._moms)


@pytest.mark.parametrize("kwargs,env,item", [
    # a device list is not a dp mesh over a process group: no collapse
    (dict(mesh=["cuda:0", "cuda:1"]), {}, r"dist\.initialize"),
    # one device: the bucket cap and ZeRO-1 are accepted as the JAX
    # package accepts them there (nothing to reduce; ZeRO-1 warns and
    # stays replicated) — the dp path is tests/test_torch_dp.py's
    (dict(bucket_bytes=1 << 20), {}, None),
    (dict(zero_stage=1), {}, None),
    # a spec function on one device: every parameter replicated (the
    # sharded step is tests/test_torch_tp.py's)
    (dict(param_spec_fn=lambda name, shape: None), {}, None),
    # the memory tier runs (tests/test_torch_grad_accum.py and
    # tests/test_torch_remat.py hold its numbers)
    (dict(accum_steps=2), {}, None),
    ({}, {"MXNET_GRAD_ACCUM_STEPS": "4"}, None),
    ({}, {"MXNET_REMAT_POLICY": "stage"}, None),
], ids=["mesh", "bucket_bytes", "zero_stage", "param_spec_fn",
        "accum_steps", "accum_env", "remat_env"])
def test_multi_device_and_memory_options_raise(kwargs, env, item,
                                               monkeypatch, caplog):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with mx.cpu():
        net = _net(mx)
        net.initialize()
        if item is not None:
            with pytest.raises(mx.MXNetError, match=item):
                TStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                      **kwargs)
            return
        step = TStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), **STEP,
                     **kwargs)
        data, label = _batches(k=1)
        with caplog.at_level("WARNING"):
            assert np.isfinite(step.run_steps(mx.nd.array(data),
                                              mx.nd.array(label)).asnumpy()
                               ).all()
    assert step.mesh is None and not step.bucketed and not step.zero1
    assert step.bucket_accounting() is None
    assert ("momenta stay replicated" in caplog.text) == \
        ("zero_stage" in kwargs)


def test_step_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(mx.MXNetError, match=r"ctx=mx\.cpu\(\)"):
        TStep(_net(mx), mx.gluon.loss.SoftmaxCrossEntropyLoss())
