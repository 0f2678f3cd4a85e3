"""Data-parallel transformer-LM training in the port
(``transformer.TransformerTrainStep`` over a dp mesh: the bucketed
exchange from backward hooks, ZeRO-1's sharded momenta, the elastic
restage across dp sizes and stages, checkpoints across world sizes) on
two gloo ranks on the CPU, against the JAX package's two-device CPU mesh.

Config: vocab 64, 2 layers, d_model 32, 2 heads, d_ff 64, T 16, global
batch 4 (2 rows a rank), SGD lr 0.05 momentum 0.9, bucket cap 4096
bytes (several buckets).  The JAX package's start parameters cross into
the port.  Tolerances, fp64: the trajectory 1e-8 relative on the losses
and 1e-8 absolute on the parameters (attention and RoPE run in float32
inside both packages, as in tests/test_torch_transformer_train.py);
ZeRO-1 against replicated and bucketed against one bucket per dtype
bitwise.  The ranks run once for this file (``tests/torch_dp_cases.py``).
"""
import pickle

import numpy as np
import pytest

import jax

from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import transformer as jtr
from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from mxnet_tpu_torch import checkpoint as tckpt
from mxnet_tpu_torch import dist
from mxnet_tpu_torch import transformer as ttr
from mxnet_tpu_torch.parallel import mesh as tmesh

import torch_dp_cases as cases

LOSS_RTOL = 1e-8
PARAM_ATOL = 1e-8
CFG = dict(vocab_size=64, n_layers=2, d_model=32, n_heads=2, d_ff=64)
ITER = dict(batch_size=4, seq_len=16, vocab_size=64, num_sequences=32)
STEP = dict(learning_rate=0.05, bucket_bytes=4096)


def _jcfg(dtype="float64"):
    return jtr.TransformerConfig(**CFG, dtype=dtype, param_dtype=dtype)


def _jfit(steps, dp=2, dtype="float64", ckpt=None, every=None, resume=None,
          **kw):
    """The JAX package's step from seed 0 on a ``dp``-device mesh."""
    mesh = jmake_mesh((dp,), ("dp",), jax.devices()[:dp])
    s = jtr.TransformerTrainStep(_jcfg(dtype), mesh=mesh, seed=0,
                                 **dict(STEP, **kw))
    losses = s.fit(jtr.LMTokenIter(**ITER), steps, checkpoint_every_n=every,
                   checkpoint_dir=ckpt, resume_from=resume)
    return {"losses": losses, "params": s.params_numpy(), "step": s}


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    """Inputs of the rank-side cases, and the checkpoints they resume:
    the JAX package's dp=2 ZeRO-1 ones (float64 at step 3, bf16 at step
    2) and the port's dp=1 one at step 3."""
    root = tmp_path_factory.mktemp("lm_dp")
    dirs = {k: str(root / k) for k in ("port_z1", "port_bf16", "jax_z1",
                                       "jax_bf16", "port_dp1")}
    p0 = jtr.TransformerTrainStep(_jcfg(), seed=0).params_numpy()
    p0_bf16 = {k: np.asarray(v, np.float32) for k, v in
               jtr.TransformerTrainStep(_jcfg("bfloat16"), seed=0)
               .params_numpy().items()}
    s = dict(cfg=CFG, iter=ITER, step=STEP, dirs=dirs,
             p0_float64=p0, p0_bfloat16=p0_bf16)
    _jfit(3, zero_stage=1, ckpt=dirs["jax_z1"], every=3)
    _jfit(2, dtype="bfloat16", zero_stage=1, ckpt=dirs["jax_bf16"],
          every=2)
    cases.lm_fit(s, mesh=None, zero_stage=1, ckpt=dirs["port_dp1"],
                 every=3)
    return s


@pytest.fixture(scope="module")
def ranks(spec):
    return dist.launch(cases.transformer_cases, 2, (spec,), device="cpu",
                       threads=1, timeout_s=900)


@pytest.fixture(scope="module")
def control():
    """The JAX package's uninterrupted dp=2 runs: replicated 3 steps,
    ZeRO-1 6 steps."""
    return {"z0": _jfit(3, zero_stage=0), "z1": _jfit(6, zero_stage=1)}


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


def _tail(run, start):
    return {"losses": run["losses"][start:], "params": run["params"]}


def test_dp2_trajectory_matches_jax_dp2(ranks, control):
    for r in (0, 1):
        got = _got(ranks, "z0", r)
        assert got["n_dp"] == 2 and not got["zero1"]
        _close(got, control["z0"], "replicated dp=2, rank %d" % r)
    _bitwise(_got(ranks, "z0", 0), _got(ranks, "z0", 1), "rank 0 vs 1")


def test_zero1_bitwise_at_lr0_and_fp64(ranks):
    """The reference's test_zero1_bitwise_lr0_and_fp64: sharded optimizer
    state matches the replicated control bit for bit, and holds half of
    it on each rank."""
    z0, z1 = _got(ranks, "lr0_z0"), _got(ranks, "lr0_z1")
    assert z1["zero1"]
    _bitwise(z0, z1, "lr 0")
    z0, z1 = _got(ranks, "z0"), _got(ranks, "z1")
    _bitwise(z0, z1, "fp64")
    assert abs(z1["state_bytes"] / z0["state_bytes"] - 0.5) < 0.05


def test_one_bucket_per_dtype_equals_the_bucketed_exchange(ranks):
    _bitwise(_got(ranks, "monolithic"), _got(ranks, "z0"), "cap 0")


def test_jax_zero1_checkpoint_resumes_in_the_port(ranks, control):
    for r in (0, 1):
        got = _got(ranks, "from_jax", r)
        assert got["zero1"]
        _close(got, _tail(control["z1"], 3), "JAX dp=2 -> port dp=2")


def test_port_zero1_checkpoint_resumes_in_jax_and_at_dp1(ranks, spec,
                                                          control):
    """The port's dp=2 ZeRO-1 checkpoint (a shard per rank, each with the
    global flat momenta) resumes in the JAX package at dp=2 and, restaged,
    at dp=1, and in the port at dp=1; each continues the uninterrupted
    run."""
    d = spec["dirs"]["port_z1"]
    np.testing.assert_allclose(_got(ranks, "write_z1")["losses"],
                               control["z1"]["losses"][:3], rtol=LOSS_RTOL)
    man = jckpt.read_manifest(d, 3)
    assert man["num_ranks"] == 2
    state = pickle.loads(jckpt.load_checkpoint(d)["optimizer_states"])
    assert state["zero_stage"] == 1 and state["dp"] == 2
    assert [int(np.asarray(m).size) for m in state["momenta"]] == \
        [e + e % 2 for e in state["bucket_elems"]]
    want = _tail(control["z1"], 3)
    _close(_jfit(6, zero_stage=1, resume=d), want, "port -> JAX dp=2")
    j1 = _jfit(6, dp=1, zero_stage=1, resume=d)
    assert not j1["step"].zero1
    _close(j1, want, "port dp=2 -> JAX dp=1")
    t1 = cases.lm_fit(spec, steps=6, mesh=None, zero_stage=1, resume=d)
    _close(t1, want, "port dp=2 -> port dp=1")


def test_replicated_dp1_checkpoint_restages_to_zero1_dp2(ranks, control):
    got = _got(ranks, "from_dp1")
    assert got["zero1"]
    _close(got, _tail(control["z1"], 3), "port dp=1 -> port dp=2")


def test_bf16_zero1_checkpoints_keep_bf16_both_ways(ranks, spec):
    # the port's, loaded by the JAX package's dp=2 ZeRO-1 step
    assert _got(ranks, "write_bf16")["mom_dtypes"] == ["torch.bfloat16"]
    d = spec["dirs"]["port_bf16"]
    s = _jfit(0, dtype="bfloat16", zero_stage=1)["step"]
    s.load_state(jckpt.load_checkpoint(d))
    assert {str(m.dtype) for m in s._moms} == {"bfloat16"}
    theirs = tckpt._loads_payload(tckpt.load_checkpoint(d)[
        "optimizer_states"])["momenta"]
    for m, t in zip(s._moms, theirs):
        np.testing.assert_array_equal(
            np.asarray(m.astype(np.float32)), t.float().numpy())
    # the JAX package's, resumed by the port at dp=2
    got = _got(ranks, "from_jax_bf16")
    assert got["zero1"] and got["mom_dtypes"] == ["torch.bfloat16"]
    assert np.isfinite(got["losses"]).all()


@pytest.mark.parametrize("w_old,w_new,nbatch,b_old,b_new", [
    (2, 1, 3, 2, 4), (1, 2, 3, 4, 2), (2, 4, 10, 4, 2), (4, 2, 7, 8, 8),
    (2, 1, 5, None, 4)])
def test_scale_resume_skip_agrees_with_jax(w_old, w_new, nbatch, b_old,
                                           b_new):
    payload = {"nbatch": nbatch, "elastic": {
        "from_num_ranks": w_old, "to_num_ranks": w_new,
        "orig_nbatch": nbatch, "orig_batch_size": b_old}}
    assert tckpt.scale_resume_skip(payload, b_new) == \
        jckpt.scale_resume_skip(payload, b_new)
    assert tckpt.scale_resume_skip({"nbatch": nbatch}, b_new) == nbatch


def test_world_size_counts_processes_in_both_packages(ranks, spec):
    """A port dp=2 step is two processes each training on 2 of the 4
    rows: its shards record world size 2 and batch 2, the JAX package's
    one process world size 1 and batch 4, so the global sample position
    (and the skip) agrees on either side of a cross-load."""
    port_d, jax_d = spec["dirs"]["port_z1"], spec["dirs"]["jax_z1"]
    for load in (tckpt.load_checkpoint, jckpt.load_checkpoint):
        p = load(port_d, rank=0, num_ranks=1)
        assert p["iterator"]["batch_size"] == 2
        assert p["elastic"]["from_num_ranks"] == 2
        assert tckpt.scale_resume_skip(p, 4) == \
            jckpt.scale_resume_skip(p, 4) == 3
        j = load(jax_d, rank=1, num_ranks=2)
        assert j["iterator"]["batch_size"] == 4
        assert j["elastic"]["source_rank"] == 0
        assert tckpt.scale_resume_skip(j, 2) == \
            jckpt.scale_resume_skip(j, 2) == 3


def test_sequence_parallel_mesh_is_refused():
    """Sequence parallelism is ported (tests/test_torch_transformer_sp.py
    trains on it): over a one-rank (1, 1) dp x sp mesh the step builds
    (an sp axis of one rank shards nothing: flash runs, ring raises);
    what stays refused is flash on an sp axis of more than one rank,
    and Ulysses whose heads do not divide over sp."""
    import torch_sp_cases

    out = dist.launch(torch_sp_cases.one_rank_sp, 1, (), device="cpu",
                      threads=1, timeout_s=300)[0]
    assert out["shape"] == {"dp": 1, "sp": 1}
    assert out["impl"] == "flash" and np.isfinite(out["loss"])
    assert "needs a sequence-parallel mesh axis" in out["ring"]
    devs = np.empty(2, dtype=object)
    devs[:] = ["cpu", "cpu"]
    mesh = tmesh.Mesh(devs.reshape(1, 2), ("dp", "sp"), collective=True)
    toks = np.zeros((2, 16), np.int64)
    with pytest.raises(ValueError, match="sequence-sharded"):
        ttr.TransformerTrainStep(ttr.TransformerConfig(**CFG), mesh=mesh,
                                 attn_impl="flash", device="cpu").step(
            toks, toks)
    with pytest.raises(ValueError, match="must divide by sp axis size 2"):
        ttr.TransformerTrainStep(
            ttr.TransformerConfig(**dict(CFG, n_heads=1)), mesh=mesh,
            attn_impl="ulysses", device="cpu").attention_impl
    # a dp mesh larger than the process group (none here) raises
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.data_parallel_mesh(2)
