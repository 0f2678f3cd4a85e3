"""The port's recommender tier (``mxnet_tpu_torch.recommender``) against
the JAX package's on the same seeded clickstream, starting from the JAX
package's parameters (carried with ``RecommenderTrainStep(params=)``):
the clickstream bit for bit, the 8-step trajectory (losses within 1e-6,
parameters within 1e-5 of the update's largest element), the sparse
tier against the dense control, the float64 promotion, and the sparse
linear classification example through the port's ``Module``.  CPU
tensors throughout."""
import os
import sys

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.recommender as jrec
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.recommender as trec

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples.sparse.linear_classification import synthetic_libsvm  # noqa

CFG = dict(n_fields=3, vocab=500, embed_dim=4, mlp_hidden=(8,))
STEPS = 8
LOSS_TOL = 1e-6
UPDATE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _jax_params(cfg_kw=CFG, dtype="float32"):
    cfg = jrec.RecommenderConfig(dtype=dtype, **cfg_kw)
    return {n: np.array(v) for n, v in
            jrec.init_params(jax.random.PRNGKey(0), cfg).items()}


def _run(pkg, rec, sparse, lr, momentum=0.0, params=None, dtype="float32",
         batch=16, steps=STEPS, n_shards=3):
    """``steps`` of ``pkg``'s RecommenderTrainStep, then every table row
    and the head: (fit result, {name: numpy})."""
    cfg = rec.RecommenderConfig(dtype=dtype, **CFG)
    it = rec.ClickstreamIter(batch_size=batch, n_fields=3, vocab=500,
                             num_samples=256, seed=1)
    kv = pkg.kv.create("local")
    kw = {} if params is None else {"params": params}
    step = rec.RecommenderTrainStep(
        cfg, kv, optimizer=pkg.optimizer.SGD(learning_rate=lr,
                                             momentum=momentum, wd=0.0),
        n_shards=n_shards if sparse else 1, seed=0, sparse=sparse, **kw)
    res = step.fit(it, steps)
    out = {}
    for name in rec.table_names(cfg):
        if sparse:
            out[name] = step.tables[name].pull_rows(kv, np.arange(500))
        else:
            o = pkg.nd.zeros((500, 4))
            kv.pull("rec:" + name, out=o)
            out[name] = o.asnumpy()
    for name in rec.dense_param_names(cfg):
        o = pkg.nd.zeros(step.dense_params[name].shape)
        kv.pull("rec:" + name, out=o)
        out[name] = o.asnumpy()
    return res, out


def _update_err(got, want, start):
    """max |got - want| over the update's largest element, worst
    parameter."""
    return max(float(np.abs(got[k] - want[k]).max())
               / max(float(np.abs(want[k] - start[k]).max()), 1e-30)
               for k in want)


def test_clickstream_bitwise():
    kw = dict(batch_size=32, n_fields=8, vocab=65536, num_samples=512,
              seed=7)
    for parts in ({}, {"num_parts": 2, "part_index": 0},
                  {"num_parts": 2, "part_index": 1}):
        a, b = trec.ClickstreamIter(**kw, **parts), \
            jrec.ClickstreamIter(**kw, **parts)
        while True:
            try:
                ta = a.next_raw()
            except StopIteration:
                with pytest.raises(StopIteration):
                    b.next_raw()
                break
            tb = b.next_raw()
            np.testing.assert_array_equal(ta[0][0], tb[0][0])
            np.testing.assert_array_equal(ta[1][0], tb[1][0])


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_carried_trajectory_matches_jax(momentum):
    """8 sparse steps at lr 0.05 from the JAX package's parameters:
    losses within 1e-6, every table row and head parameter within 1e-5
    of the update's largest element; a skipped update would read ~1."""
    start = _jax_params()
    jres, jout = _run(jmx, jrec, True, 0.05, momentum)
    tres, tout = _run(tmx, trec, True, 0.05, momentum, params=start)
    np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=0,
                               atol=LOSS_TOL)
    assert _update_err(tout, jout, start) <= UPDATE_TOL
    assert _update_err(start, jout, start) >= 0.99
    assert tres["mean_unique_rows_per_batch"] == \
        jres["mean_unique_rows_per_batch"]


@pytest.mark.parametrize("lr", [0.0, 0.05])
def test_sparse_matches_dense_control(lr):
    """The port's sparse tier against its dense control: bitwise at lr
    0 (and the tables untouched), within 1e-6 relative / 1e-7 absolute
    in the losses and 1e-5 of the update at lr 0.05."""
    start = _jax_params()
    sres, sout = _run(tmx, trec, True, lr, params=start)
    dres, dout = _run(tmx, trec, False, lr, params=start)
    if lr == 0.0:
        np.testing.assert_array_equal(sres["losses"], dres["losses"])
        for k in start:
            np.testing.assert_array_equal(sout[k], start[k])
    else:
        np.testing.assert_allclose(sres["losses"], dres["losses"],
                                   rtol=1e-6, atol=1e-7)
        assert _update_err(sout, dout, start) <= UPDATE_TOL


def test_float64_promotion_matches_jax():
    """cfg.dtype float64: the pulled rows are padded as float32 and meet
    float64 head weights in float64 (JAX's promotion; the port casts
    where torch.matmul refuses), logloss runs in float32, and the head
    comes back float32 from the store's pull (as in the JAX package).
    Losses and parameters against the JAX package's."""
    start = _jax_params(dtype="float64")
    assert start["mlp0_w"].dtype == np.float64
    jres, jout = _run(jmx, jrec, True, 0.05, params=None, dtype="float64",
                      steps=3)
    tres, tout = _run(tmx, trec, True, 0.05, params=start, dtype="float64",
                      steps=3)
    np.testing.assert_allclose(tres["losses"], jres["losses"], rtol=0,
                               atol=LOSS_TOL)
    assert _update_err(tout, jout, start) <= UPDATE_TOL
    # one forward in float64 against JAX's to float32 rounding
    import jax.numpy as jnp

    cfg_t = trec.RecommenderConfig(dtype="float64", **CFG)
    cfg_j = jrec.RecommenderConfig(dtype="float64", **CFG)
    rows = [np.random.RandomState(f).randn(16, 4).astype(np.float32)
            for f in range(3)]
    inv = [np.random.RandomState(10 + f).randint(0, 16, 16)
           for f in range(3)]
    dense = {k: start[k] for k in trec.dense_param_names(cfg_t)}
    t = trec.apply_rows([torch.from_numpy(r) for r in rows],
                        [torch.from_numpy(i) for i in inv],
                        {k: torch.from_numpy(v) for k, v in dense.items()},
                        cfg_t)
    j = jrec.apply_rows([jnp.asarray(r) for r in rows],
                        [jnp.asarray(i) for i in inv],
                        {k: jnp.asarray(v) for k, v in dense.items()},
                        cfg_j)
    assert t.dtype == torch.float64 and np.asarray(j).dtype == np.float64
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                               atol=1e-12)


def test_train_step_gradients_match_jax():
    """One sparse and one dense step's gradients against jax's
    value_and_grad on the same inputs (float32)."""
    import jax.numpy as jnp

    start = _jax_params()
    cfg_t, cfg_j = trec.RecommenderConfig(**CFG), jrec.RecommenderConfig(
        **CFG)
    ids, clicks = trec.make_clickstream(16, 3, 500, seed=4)
    rows, invs = [], []
    for f in range(3):
        u, inv = np.unique(ids[:, f], return_inverse=True)
        pad = np.zeros((16, 4), np.float32)
        pad[:u.size] = start["emb%d" % f][u]
        rows.append(pad)
        invs.append(inv.astype(np.int32))
    dense = {k: start[k] for k in trec.dense_param_names(cfg_t)}
    tl, tdr, tdd = trec.make_sparse_train_step(cfg_t)(
        [torch.from_numpy(r) for r in rows],
        [torch.from_numpy(i) for i in invs],
        {k: torch.from_numpy(v) for k, v in dense.items()},
        torch.from_numpy(clicks))
    jl, jdr, jdd = jrec.make_sparse_train_step(cfg_j)(
        [jnp.asarray(r) for r in rows], [jnp.asarray(i) for i in invs],
        {k: jnp.asarray(v) for k, v in dense.items()}, jnp.asarray(clicks))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    for a, b in zip(tdr, jdr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    for k in dense:
        np.testing.assert_allclose(tdd[k].numpy(), np.asarray(jdd[k]),
                                   rtol=1e-5, atol=1e-7)
    tl2, tg = trec.make_dense_train_step(cfg_t)(
        {k: torch.from_numpy(v) for k, v in start.items()},
        torch.from_numpy(ids), torch.from_numpy(clicks))
    jl2, jg = jrec.make_dense_train_step(cfg_j)(
        {k: jnp.asarray(v) for k, v in start.items()}, jnp.asarray(ids),
        jnp.asarray(clicks))
    assert abs(float(tl2) - float(jl2)) <= LOSS_TOL
    for k in start:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-7)
    # ids past the table are clipped to its last row, not raised
    far = ids.copy()
    far[0, 0] = 10 ** 6
    trec.apply({k: torch.from_numpy(v) for k, v in start.items()},
               torch.from_numpy(far), cfg_t)


def test_init_params_from_generator():
    cfg = trec.RecommenderConfig(**CFG)
    a = trec.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    b = trec.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    assert list(a) == [n for n, _s, _d in trec.param_shapes(cfg)]
    for k in a:
        assert torch.equal(a[k], b[k])
        assert tuple(a[k].shape) == dict(
            (n, s) for n, s, _d in trec.param_shapes(cfg))[k]
    assert float(a["emb0"].std()) < 0.02 and float(a["mlp0_b"].abs().sum()) == 0


def test_empty_shard_pushes_keep_rounds():
    """Every shard key is pushed every step, with (0, dim) rows where the
    batch touched none: the bytes of such a push are 0, the rows it does
    not carry keep their values."""
    kv = tmx.kv.create("local")
    kv.set_optimizer(tmx.optimizer.SGD(learning_rate=1.0))
    t = trec.ShardedEmbeddingTable("e", 20, 2, n_shards=4)
    t.init(kv, np.ones((20, 2), np.float32))
    ctr = tmx.diagnostics.metrics.counter("mxnet_kvstore_bytes_total",
                                          labels={"op": "row_sparse_push"})
    base = ctr.value
    t.push_rows(kv, np.array([1, 2]), torch.ones(2, 2))
    assert ctr.value - base == 2 * (2 * 4 + 8)
    got = t.pull_rows(kv, np.arange(20))
    np.testing.assert_array_equal(got[[1, 2]], 0.0)
    np.testing.assert_array_equal(np.delete(got, [1, 2], 0), 1.0)


def _linear_model(mx, num_features):
    """The example's model (example/sparse/linear_classification/
    linear_model.py): CSR data x a row_sparse weight."""
    x = mx.symbol.Variable("data", stype="csr")
    weight = mx.symbol.Variable("weight", shape=(num_features, 2),
                                init=mx.initializer.Normal(sigma=0.01),
                                stype="row_sparse")
    bias = mx.symbol.Variable("bias", shape=(2,))
    pred = mx.symbol.broadcast_add(mx.symbol.sparse.dot(x, weight), bias)
    y = mx.symbol.Variable("softmax_label")
    return mx.symbol.SoftmaxOutput(data=pred, label=y, name="softmax")


def test_linear_classification_example_through_module(tmp_path):
    """``examples/sparse/linear_classification.py`` on the port: LibSVM
    CSR batches through ``Module`` (CSR read through the dense bridge),
    SGD over a local store, accuracy > 0.85 as the example asserts; then
    the example's row_sparse_pull of the trained weight."""
    mx = tmx
    num_features = 100
    path = synthetic_libsvm(str(tmp_path / "train.libsvm"))
    it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(num_features,),
                          batch_size=32)
    mod = mx.mod.Module(_linear_model(mx, num_features),
                        data_names=("data",),
                        label_names=("softmax_label",), context=mx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    np.random.seed(0)
    mod.init_params(mx.init.Normal(sigma=0.01))
    kv = mx.kv.create("local")
    mod.init_optimizer(kvstore=kv, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    metric = mx.metric.create("accuracy")
    for _ in range(6):
        it.reset()
        metric.reset()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
            mod.update_metric(metric, batch.label)
    assert metric.get()[1] > 0.85, metric.get()
    weight_param = mx.nd.zeros((num_features, 2), stype="row_sparse")
    kv.row_sparse_pull(0, out=weight_param,
                       row_ids=mx.nd.arange(0, num_features, dtype="int64"))
    assert weight_param.shape == (num_features, 2)
    np.testing.assert_array_equal(weight_param.asnumpy(),
                                  mod.get_params()[0]["weight"].asnumpy())
