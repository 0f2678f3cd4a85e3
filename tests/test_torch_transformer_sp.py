"""Sequence-parallel transformer-LM training in the port
(``transformer.TransformerTrainStep`` over a dp x sp mesh, ring and
Ulysses attention, replicated and ZeRO-1) on four gloo ranks on the
CPU, against the JAX package's step on its (2, 2) CPU mesh from the
same parameters.

Config: vocab 64, 2 layers, d_model 32, 2 heads, d_ff 64, T 16, global
batch 4 (each rank: 2 rows x 8 positions), SGD lr 0.05 momentum 0.9,
bucket cap 4096 bytes.  Tolerances, fp64: the trajectory 1e-8 relative
on the losses and 1e-8 absolute on the parameters, as
``tests/test_torch_transformer_dp.py`` (attention and RoPE run in
float32 inside both packages); ZeRO-1 against replicated bit for bit.
The ranks run once for this file (``tests/torch_sp_cases.py``).
"""
import numpy as np
import pytest

import jax

from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import transformer as jtr
from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from mxnet_tpu_torch import checkpoint as tckpt
from mxnet_tpu_torch import dist

import torch_sp_cases as cases

LOSS_RTOL = 1e-8
PARAM_ATOL = 1e-8
CFG = dict(vocab_size=64, n_layers=2, d_model=32, n_heads=2, d_ff=64)
ITER = dict(batch_size=4, seq_len=16, vocab_size=64, num_sequences=32)
STEP = dict(learning_rate=0.05, bucket_bytes=4096)
MESH = (2, 2)
IMPLS = ("ring", "ulysses")


def _jcfg():
    return jtr.TransformerConfig(**CFG, dtype="float64",
                                 param_dtype="float64")


def _jfit(impl, steps=3, mesh=MESH, resume=None, **kw):
    """The JAX package's step from seed 0 over a (dp, sp) mesh."""
    n = int(np.prod(mesh))
    m = jmake_mesh(mesh, ("dp", "sp"), jax.devices()[:n])
    s = jtr.TransformerTrainStep(_jcfg(), mesh=m, seed=0, attn_impl=impl,
                                 **dict(STEP, **kw))
    losses = s.fit(jtr.LMTokenIter(**ITER), steps, resume_from=resume)
    return {"losses": losses, "params": s.params_numpy(), "step": s}


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_sp")
    p0 = jtr.TransformerTrainStep(_jcfg(), seed=0).params_numpy()
    return dict(cfg=CFG, iter=ITER, step=STEP, mesh=MESH, p0=p0,
                dirs={"port_sp": str(root / "port_sp")})


@pytest.fixture(scope="module")
def ranks(spec):
    return dist.launch(cases.transformer_cases, int(np.prod(MESH)),
                       (spec,), device="cpu", threads=1, timeout_s=900)


@pytest.fixture(scope="module")
def ranks_sp2(spec):
    """Two ranks on a (1, 2) mesh: the sp line is the whole group."""
    return dist.launch(cases.sp_only_cases, 2, (dict(spec, mesh=(1, 2)),),
                       device="cpu", threads=1, timeout_s=600)


@pytest.fixture(scope="module")
def control():
    """The JAX package's (2, 2) runs: 3 steps, and ring ZeRO-1 6 steps
    (the resume control)."""
    out = {impl: _jfit(impl) for impl in IMPLS}
    out["ring_z1_6"] = _jfit("ring", steps=6, zero_stage=1)
    return out


def _got(ranks, name, rank=0):
    out = ranks[rank][name]
    if isinstance(out, dict) and "error" in out:
        pytest.fail("rank %d, case %s:\n%s" % (rank, name, out["error"]))
    return out


def _close(got, want, what):
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, atol=0, err_msg=what)
    assert sorted(got["params"]) == sorted(want["params"])
    for k in want["params"]:
        np.testing.assert_allclose(
            np.asarray(got["params"][k], np.float64),
            np.asarray(want["params"][k], np.float64), rtol=0,
            atol=PARAM_ATOL, err_msg="%s %s" % (what, k))


def _bitwise(a, b, what):
    assert a["losses"] == b["losses"], what
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k],
                                      err_msg="%s %s" % (what, k))


@pytest.mark.parametrize("impl", IMPLS)
def test_dp2_sp2_trajectory_matches_jax(ranks, control, impl):
    for r in range(4):
        got = _got(ranks, impl + "_z0", r)
        assert (got["n_dp"], got["n_sp"], got["impl"], got["zero1"]) == \
            (2, 2, impl, False)
        _close(got, control[impl], "%s dp=2 x sp=2, rank %d" % (impl, r))
    for r in (1, 2, 3):
        _bitwise(_got(ranks, impl + "_z0", 0), _got(ranks, impl + "_z0", r),
                 "rank 0 vs %d" % r)


@pytest.mark.parametrize("impl", IMPLS)
def test_zero1_with_sp_bitwise_at_lr0_and_fp64(ranks, control, impl):
    """ZeRO-1 over dp with sp (an all-reduce over sp, then dp's
    reduce-scatter) equals the replicated exchange bit for bit, and
    holds half the momenta a rank."""
    z0, z1 = _got(ranks, impl + "_lr0_z0"), _got(ranks, impl + "_lr0_z1")
    assert z1["zero1"] and not z0["zero1"]
    _bitwise(z0, z1, "lr 0")
    z0, z1 = _got(ranks, impl + "_z0"), _got(ranks, impl + "_z1")
    _bitwise(z0, z1, "fp64")
    _close(z1, control[impl], "%s ZeRO-1 vs JAX" % impl)
    assert abs(z1["state_bytes"] / z0["state_bytes"] - 0.5) < 0.05


def test_sp_checkpoint_resumes_across_layouts_and_in_jax(ranks, spec,
                                                          control):
    """The port's dp=2 x sp=2 ZeRO-1 checkpoint (a shard per rank, each
    with the global flat momenta) resumes in the port at dp=1 x sp=1 and
    in the JAX package on its (2, 2) mesh and on one device; each
    continues the uninterrupted JAX run."""
    d = spec["dirs"]["port_sp"]
    want = control["ring_z1_6"]
    np.testing.assert_allclose(_got(ranks, "write_z1")["losses"],
                               want["losses"][:3], rtol=LOSS_RTOL)
    assert jckpt.read_manifest(d, 3)["num_ranks"] == 4
    state = tckpt._loads_payload(tckpt.load_checkpoint(
        d, rank=0, num_ranks=1)["optimizer_states"])
    assert state["zero_stage"] == 1 and state["dp"] == 2
    tail = {"losses": want["losses"][3:], "params": want["params"]}
    t1 = cases.lm_fit(spec, "flash", steps=6, mesh=None, zero_stage=1,
                      resume=d)
    _close(t1, tail, "port dp=2 x sp=2 -> port one device")
    _close(_jfit("ring", steps=6, zero_stage=1, resume=d), tail,
           "port dp=2 x sp=2 -> JAX (2, 2)")
    j1 = _jfit("flash", steps=6, mesh=(1, 1), zero_stage=1, resume=d)
    _close(j1, tail, "port dp=2 x sp=2 -> JAX one device")



@pytest.mark.parametrize("impl", IMPLS)
def test_sp2_alone_matches_jax(ranks_sp2, impl):
    """dp=1 x sp=2: the sequence axis spans the whole group (the
    pre-reduction over sp runs on the default group, the dp axis is one
    rank); ring and Ulysses against the JAX package's (1, 2) mesh, and
    ZeRO-1 over the one-rank dp axis equal to replicated."""
    want = _jfit(impl, mesh=(1, 2))
    for r in (0, 1):
        got = _got(ranks_sp2, impl + "_z0", r)
        assert (got["n_dp"], got["n_sp"]) == (1, 2)
        _close(got, want, "%s dp=1 x sp=2, rank %d" % (impl, r))
    _bitwise(_got(ranks_sp2, "ring_z0"), _got(ranks_sp2, "ring_z1"),
             "ZeRO-1 over one dp rank")


def test_bucketed_reduce_runs_over_a_chosen_axis(ranks):
    """On the (2, 2) mesh rank r = 2d + s holds r + 1: the sp line of
    rank r sums its two ranks, the dp line its column, the whole mesh
    all four (10)."""
    for r in range(4):
        d, s = divmod(r, 2)
        got = _got(ranks, "reduce_axes", r)
        want = {"sp": (2 * d + 1) + (2 * d + 2), "dp": (s + 1) + (s + 3),
                "None": 10.0}
        for axis, total in want.items():
            for v in got[axis].values():
                np.testing.assert_array_equal(v, np.full(v.shape, total))


def test_zero1_update_with_sp_axis_reduces_over_the_whole_mesh(ranks):
    """``zero1_bucketed_update`` from unreduced gradients with
    ``sp_axis``: an all-reduce over sp, the reduce-scatter over dp, the
    mean over all four ranks; every rank ends with the replicated
    SGD-momentum step, and holds half of the momenta."""
    outs = [_got(ranks, "zero1_sp_update", r) for r in range(4)]
    p0 = outs[0]["p0"]
    for k in p0:
        g = sum(o["grads"][k] for o in outs) / 4
        for o in outs:
            np.testing.assert_allclose(o["params"][k], p0[k] - 0.5 * g,
                                       rtol=0, atol=1e-15)
    n = sum(v.size for v in p0.values())
    assert [m.size for m in outs[0]["moms"]] == [-(-n // 2)]
