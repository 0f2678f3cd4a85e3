"""Tuned bucket plans in the port against the JAX package's.

``buckets.partition`` with first/last caps gives the JAX package's
buckets over ResNet-50's gradient leaves at every ``(cap, first_frac,
last_mult)`` of the autotuner's ladder (and over the GPT-2-small LM's
leaves); ``resnet50_grad_leaf_bytes`` is equal across the two model
zoos; ``plan_meta`` carries the same ``autotune`` block; and at one
rank (a one-rank gloo group) a ``FusedTrainStep`` under a tuned plan
(``MXNET_AUTOTUNE_PLAN``, then ``MXNET_AUTOTUNE_DIR``) changes only the
bucket boundaries: losses and parameters bitwise the untuned step's.
"""
import os

import numpy as np
import pytest

from mxnet_tpu.autotune import search as jsearch
from mxnet_tpu.parallel import buckets as jbuckets
from mxnet_tpu.parallel import scaling as jscaling
from mxnet_tpu.transformer import model as jtm

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.analysis import fixtures as tfixtures
from mxnet_tpu_torch.autotune import plan as tplan
from mxnet_tpu_torch.autotune import search as tsearch
from mxnet_tpu_torch.autotune import timing as ttiming
from mxnet_tpu_torch.parallel import buckets as tbuckets
from mxnet_tpu_torch.parallel import scaling as tscaling
from mxnet_tpu_torch.transformer import model as ttm

MIB = 1024 * 1024
LADDER = [(c, f, m) for c in jsearch.CAPS_MIB for f in jsearch.FIRST_FRACS
          for m in jsearch.LAST_MULTS]


@pytest.fixture(scope="module")
def resnet50_entries():
    return tscaling.resnet50_grad_entries(), \
        jscaling.resnet50_grad_entries()


def test_the_ladder_is_the_jax_packages():
    assert tsearch.CAPS_MIB == jsearch.CAPS_MIB
    assert tsearch.FIRST_FRACS == jsearch.FIRST_FRACS
    assert tsearch.LAST_MULTS == jsearch.LAST_MULTS
    assert tsearch.DEFAULT_COLL_LATENCY_S == jsearch.DEFAULT_COLL_LATENCY_S


def test_resnet50_leaf_bytes_equal_across_the_zoos(resnet50_entries):
    t, j = resnet50_entries
    assert len(t) == len(j) == 193
    assert tscaling.grad_leaf_bytes(t) == jscaling.grad_leaf_bytes(j)
    assert [s for _n, s, _d in t] == [s for _n, s, _d in j]
    assert sum(tscaling.grad_leaf_bytes(t)) == \
        tscaling.resnet50_grad_bytes() == jscaling.resnet50_grad_bytes()


def _plans(entries, cap, first, last):
    t = tbuckets.partition(entries, cap, first_cap_bytes=first,
                           last_cap_bytes=last)
    j = jbuckets.partition(entries, cap, first_cap_bytes=first,
                           last_cap_bytes=last)
    return [tuple(b) for b in t], [tuple(b) for b in j]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partition_over_resnet50_at_every_ladder_point(resnet50_entries,
                                                       dtype):
    entries = [(n, s, dtype) for n, s, _d in resnet50_entries[0]]
    counts = set()
    for cap_mib, ff, lm in LADDER:
        cap = cap_mib * MIB
        t, j = _plans(entries, cap, max(int(cap * ff), 1), cap * lm)
        assert t == j, (cap_mib, ff, lm)
        counts.add(len(t))
    assert len(counts) > 5     # the ladder really moves the boundaries


def test_partition_over_the_lm_at_every_ladder_point():
    cfg = dict(vocab_size=50304, d_model=768, n_heads=12, n_layers=12)
    t_ent = ttm.param_shapes(ttm.TransformerConfig(**cfg))
    j_ent = jtm.param_shapes(jtm.TransformerConfig(**cfg))
    assert [tuple(e) for e in t_ent] == [tuple(e) for e in j_ent]
    for cap_mib, ff, lm in LADDER:
        cap = cap_mib * MIB
        t, j = _plans(t_ent, cap, max(int(cap * ff), 1), cap * lm)
        assert t == j, (cap_mib, ff, lm)


def test_mixed_dtypes_never_fold_across():
    entries = [("a%d" % i, (300000,), "float32") for i in range(4)] + \
        [("b%d" % i, (300000,), "bfloat16") for i in range(4)]
    for cap in (MIB, 2 * MIB):
        t, j = _plans(entries, cap, cap // 4, 8 * cap)
        assert t == j
        assert all(len({k[0] for k in b[0]}) == 1 for b in t)


def _net(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="tuned_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.Conv2D(8, 3, padding=1),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.GlobalAvgPool2D(), nn.Dense(6))
    return net


def _run(monkeypatch, knobs, steps=3):
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep
    from mxnet_tpu_torch.parallel.mesh import data_parallel_mesh

    for k in ("MXNET_AUTOTUNE_PLAN", "MXNET_AUTOTUNE_DIR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    with tmx.cpu():
        np.random.seed(0)
        net = _net(tmx)
        net.initialize(tmx.init.Xavier())
        step = FusedTrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              mesh=data_parallel_mesh(), dtype="float64",
                              learning_rate=0.1)
        rng = np.random.RandomState(0)
        x = tmx.nd.array(rng.rand(4, 3, 8, 8).astype("float32"))
        y = tmx.nd.array((np.arange(4) % 6).astype("float32"))
        losses = step.run_steps(x, y, steps=steps).asnumpy()
        params = {p.name: p.data().asnumpy()
                  for p in net.collect_params().values()}
    return step, losses, params


def test_a_tuned_plan_at_one_rank_is_bitwise_the_untuned_step(
        monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_BYTES", "512")
    with tfixtures.one_rank_group():
        base, l0, p0 = _run(monkeypatch, {})
        entries = base.grad_entries()
        assert base.bucket_tuning() is None and \
            "autotune" not in base.bucket_plan_meta()
        leaves = list(reversed(entries))
        model = ttiming.TimingModel(
            [(b, d) for b, (_k, _s, d) in zip(
                tscaling.grad_leaf_bytes(leaves), leaves)], "leaf",
            step_time_s=0.01)
        plan = tsearch.tune(model, chips=8, ici_GBps=50.0,
                            caps_mib=(0.004, 0.008), first_fracs=(0.5,),
                            last_mults=(1, 2))
        path = tplan.save_plan(plan, str(tmp_path / "p.json"))
        pdir = tmp_path / "plans"
        tplan.save_plan(plan, tplan.default_plan_path(plan, str(pdir)))
        for knobs, where in (({"MXNET_AUTOTUNE_PLAN": path}, path),
                             ({"MXNET_AUTOTUNE_DIR": str(pdir)},
                              tplan.default_plan_path(plan, str(pdir)))):
            tuned, l1, p1 = _run(monkeypatch, knobs)
            meta = tuned.bucket_plan_meta()
            assert meta["autotune"]["plan_path"] == where
            assert meta["autotune"]["cap_bytes"] == plan["cap_bytes"]
            assert meta["n_buckets"] == plan["n_buckets"]
            assert [b["bytes"] for b in meta["buckets"]] == \
                plan["bucket_bytes"]
            assert meta["n_buckets"] != base.bucket_plan_meta()["n_buckets"]
            assert l1.tobytes() == l0.tobytes()
            assert all(p1[k].tobytes() == p0[k].tobytes() for k in p0)
            # the JAX package's partitioner builds the same buckets
            jp = jbuckets.partition(entries, plan["cap_bytes"],
                                    first_cap_bytes=plan["first_cap_bytes"],
                                    last_cap_bytes=plan["last_cap_bytes"])
            assert [b.nbytes for b in jp] == plan["bucket_bytes"]
