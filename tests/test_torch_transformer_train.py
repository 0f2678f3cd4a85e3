"""One-device transformer-LM training in the port
(``mxnet_tpu_torch.transformer.TransformerTrainStep``, ``lm_loss``, the
remat policies, ``LMTokenIter`` / ``io.NDArrayIter``, the bucket plan)
against the JAX package's, on the CPU, at a tiny config (vocab 64, 2
layers, d_model 32, 2 heads, d_ff 64, T 16).

Parameters cross from the JAX step (``params_numpy``) into the port
with ``load_state({"params": ...})``; both train on the same
``make_corpus`` stream (numpy ``RandomState``).  Tolerances, fp64:
``lm_loss`` 1e-12; three SGD-momentum steps 1e-8 on the losses
(relative) and 1e-8 abs on the parameters (measured 1.6e-10 and 4.0e-10
against an update of 2.6e-2): not fp64 round-off, because attention and
RoPE run in float32 inside both packages.  The port's remat trajectories
equal its no-remat one bit for bit (the recompute runs the same ops),
and so does a resumed fit.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import io as jio
from mxnet_tpu import transformer as jtr
from mxnet_tpu.diagnostics import DivergenceGuard as JGuard
from mxnet_tpu.parallel.mesh import make_mesh
from mxnet_tpu_torch import checkpoint as tckpt
from mxnet_tpu_torch import diagnostics as tdiag
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import transformer as ttr
from mxnet_tpu_torch.parallel import buckets as tbuckets

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-8
PARAM_ATOL = 1e-8


def _kw(dtype="float64", **over):
    kw = dict(vocab_size=64, n_layers=2, d_model=32, n_heads=2, d_ff=64,
              dtype=dtype, param_dtype=dtype)
    kw.update(over)
    return kw


def _iters(**over):
    kw = dict(batch_size=4, seq_len=16, vocab_size=64, num_sequences=32)
    kw.update(over)
    return jtr.LMTokenIter(**kw), ttr.LMTokenIter(**kw)


def _port_step(jparams, dtype="float64", **kw):
    s = ttr.TransformerTrainStep(ttr.TransformerConfig(**_kw(dtype)),
                                 device="cpu", learning_rate=0.05, **kw)
    s.load_state({"params": jparams})
    return s


def _close_losses(got, want):
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


def _close_params(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's step from seed 0: its start parameters and 3
    fit steps (losses, parameters)."""
    js = jtr.TransformerTrainStep(jtr.TransformerConfig(**_kw()), seed=0,
                                  learning_rate=0.05)
    p0 = js.params_numpy()
    losses = js.fit(_iters()[0], 3)
    return p0, losses, js.params_numpy()


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------
def test_lm_loss_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 5, 64)
    labels = rng.randint(0, 64, size=(2, 5)).astype(np.int32)
    want = float(jtr.lm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(ttr.lm_loss(torch.from_numpy(logits),
                            torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("policy", ["none", "block", "attention"])
def test_apply_remat_policies_match_jax_loss_and_grads(jax_run, policy):
    from mxnet_tpu.transformer import model as jm
    from mxnet_tpu_torch.transformer import model as tm

    p0 = jax_run[0]
    jcfg, tcfg = (jtr.TransformerConfig(**_kw()),
                  ttr.TransformerConfig(**_kw()))
    toks = np.random.RandomState(1).randint(0, 64, size=(2, 17))
    x, y = toks[:, :-1], toks[:, 1:]

    def jloss(p):
        return jm.lm_loss(jm.apply(p, jnp.asarray(x), jcfg,
                                   attn_fn=jm.make_attn_fn("flash"),
                                   remat=policy), jnp.asarray(y))

    jl, jg = jax.value_and_grad(jloss)({k: jnp.asarray(v)
                                        for k, v in p0.items()})
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in p0.items()}
    tl = tm.lm_loss(tm.apply(tp, torch.from_numpy(x), tcfg,
                             attn_fn=tm.make_attn_fn("flash"),
                             remat=policy), torch.from_numpy(y))
    tg = torch.autograd.grad(tl, list(tp.values()))
    assert abs(tl.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    _close_params({k: g.numpy() for k, g in zip(tp, tg)},
                  {k: np.asarray(v) for k, v in jg.items()})


def test_remat_policy_refuses_what_the_port_does_not_run(monkeypatch):
    from mxnet_tpu_torch import remat

    # the conv scopes and the mirror run now; for the LM they are
    # no-ops (tests/test_torch_remat.py); unknown names still raise
    for pol in ("stage", "conv_block"):
        assert remat.remat_policy(pol) == pol
    with pytest.raises(ValueError, match="unknown remat policy"):
        remat.remat_policy("everything")
    monkeypatch.setenv("MXNET_REMAT_POLICY", "attention")
    assert remat.remat_policy() == "attention"
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    assert remat.remat_policy("none") == "none"


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def test_train_step_follows_the_jax_trajectory(jax_run):
    p0, jl, jp = jax_run
    s = _port_step(p0)
    tl = s.fit(_iters()[1], 3)
    _close_losses(tl, jl)
    _close_params(s.params_numpy(), jp)
    assert s.attention_impl == "flash" and s.zero1 is False
    assert s.optimizer_state_bytes_per_rank() == sum(
        v.nbytes for v in p0.values())


@pytest.mark.parametrize("policy", ["block", "attention"])
def test_remat_trajectories_equal_no_remat_bitwise(jax_run, policy):
    p0 = jax_run[0]
    base = _port_step(p0)
    lb = base.fit(_iters()[1], 2)
    s = _port_step(p0, remat=policy)
    assert s.fit(_iters()[1], 2) == lb
    pb, pr = base.params_numpy(), s.params_numpy()
    for k in pb:
        np.testing.assert_array_equal(pr[k], pb[k])


def test_run_steps_equals_step_by_step(jax_run):
    p0 = jax_run[0]
    a, b = _port_step(p0), _port_step(p0)
    batch = _iters()[1].next()
    x, y = batch.data[0], batch.label[0]
    got = a.run_steps(x, y, 3)
    want = torch.stack([b.step(x, y) for _ in range(3)])
    assert torch.equal(got, want)


def test_bucket_plan_equals_the_jax_plan():
    for cap in (None, 1024, 0):
        js = jtr.TransformerTrainStep(jtr.TransformerConfig(**_kw()),
                                      bucket_bytes=cap)
        ts = ttr.TransformerTrainStep(ttr.TransformerConfig(**_kw()),
                                      device="cpu", bucket_bytes=cap)
        assert ts.bucket_plan_meta() == js.bucket_plan_meta(), cap
        assert ts._bucket_plan == [tbuckets.Bucket(*b)
                                   for b in js._bucket_plan]
    # the small cap splits the plan: the comparison above saw buckets
    assert len(tbuckets.partition(
        [(k, v.shape, v.dtype) for k, v in ts._params.items()], 1024)) > 1


def test_fit_checkpoint_resume_bitwise(jax_run, tmp_path):
    p0 = jax_run[0]
    ck = str(tmp_path / "ck")
    control = _port_step(p0)
    lc = control.fit(_iters()[1], 6)
    a = _port_step(p0)
    a.fit(_iters()[1], 3, checkpoint_every_n=3, checkpoint_dir=ck)
    payload = tckpt.load_checkpoint(ck)
    state = tckpt._loads_payload(payload["optimizer_states"])
    assert (state["zero_stage"], state["dp"], state["n_buckets"]) == (0, 1, 1)
    b = ttr.TransformerTrainStep(ttr.TransformerConfig(**_kw()),
                                 device="cpu", learning_rate=0.05, seed=7)
    lb = b.fit(_iters()[1], 6, resume_from=ck)
    assert lb == lc[3:]
    pc, pb = control.params_numpy(), b.params_numpy()
    for k in pc:
        np.testing.assert_array_equal(pb[k], pc[k])
    assert tdiag.metrics.gauge(
        "mxnet_transformer_tokens_per_second").value > 0


def test_jax_checkpoint_resumes_in_the_port_and_back(jax_run, tmp_path):
    p0, jl, _ = jax_run
    # JAX writes step 2, the port resumes it to step 3
    jd = str(tmp_path / "jax")
    js = jtr.TransformerTrainStep(jtr.TransformerConfig(**_kw()), seed=0,
                                  learning_rate=0.05)
    js.fit(_iters()[0], 2, checkpoint_every_n=2, checkpoint_dir=jd)
    ts = ttr.TransformerTrainStep(ttr.TransformerConfig(**_kw()),
                                  device="cpu", learning_rate=0.05)
    _close_losses(ts.fit(_iters()[1], 3, resume_from=jd), jl[2:])
    # the port writes step 2, JAX resumes it to step 3
    td = str(tmp_path / "port")
    _port_step(p0).fit(_iters()[1], 2, checkpoint_every_n=2,
                       checkpoint_dir=td)
    js2 = jtr.TransformerTrainStep(jtr.TransformerConfig(**_kw()), seed=3,
                                   learning_rate=0.05)
    _close_losses(js2.fit(_iters()[0], 3, resume_from=td), jl[2:])


def test_bf16_checkpoint_round_trip_keeps_bf16_momenta(tmp_path):
    kw = _kw("bfloat16")
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    js = jtr.TransformerTrainStep(jtr.TransformerConfig(**kw), seed=0,
                                  learning_rate=0.05)
    js.fit(_iters()[0], 2, checkpoint_every_n=2, checkpoint_dir=jd)
    ts = ttr.TransformerTrainStep(ttr.TransformerConfig(**kw),
                                  device="cpu", learning_rate=0.05)
    ts.load_state(tckpt.load_checkpoint(jd))
    for k, m in js._moms.items():
        assert str(m.dtype) == "bfloat16"
        assert ts._moms[k].dtype == torch.bfloat16
        assert ts._params[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            ts._moms[k].float().numpy(), np.asarray(m.astype(jnp.float32)))
    ts.fit(_iters()[1], 3, checkpoint_every_n=3, checkpoint_dir=td,
           resume_from=jd)
    js2 = jtr.TransformerTrainStep(jtr.TransformerConfig(**kw), seed=1)
    js2.load_state(jckpt.load_checkpoint(td))
    for k, m in js2._moms.items():
        assert str(m.dtype) == "bfloat16" and \
            str(js2._params[k].dtype) == "bfloat16"
        np.testing.assert_array_equal(np.asarray(m.astype(jnp.float32)),
                                      ts._moms[k].float().numpy())


def test_one_device_refusals(jax_run, monkeypatch, caplog):
    p0 = jax_run[0]
    cfg = ttr.TransformerConfig(**_kw())
    # a JAX mesh is not a dp mesh over the port's process group
    mesh = make_mesh((2,), ("dp",), jax.devices()[:2])
    with pytest.raises(ValueError, match=r"dist\.initialize"):
        ttr.TransformerTrainStep(cfg, mesh=mesh, device="cpu")
    # ZeRO-1 on one device: a warning, replicated momenta
    s = ttr.TransformerTrainStep(cfg, device="cpu", zero_stage=1)
    with caplog.at_level("WARNING"):
        s._build()
    assert "momenta stay replicated" in caplog.text and s.zero1 is False
    with pytest.raises(ValueError, match="ZERO_STAGE"):
        ttr.TransformerTrainStep(cfg, device="cpu", zero_stage=3)._build()
    # ZeRO-1 and other-dp checkpoints restage
    # (tests/test_torch_transformer_dp.py); a blob whose buckets or
    # momenta do not fit this step raises
    for state, exc, match in (
            ({"zero_stage": 1, "dp": 2, "momenta": []}, ValueError,
             "momentum buckets"),
            ({"zero_stage": 0, "dp": 2, "momenta": {}}, KeyError,
             "missing params")):
        with pytest.raises(exc, match=match):
            s.load_state({"params": p0,
                          "optimizer_states": pickle.dumps(state)})
    # the SDC vote is not ported and raises; the autotuner is, and a
    # tuned plan file that cannot be read raises instead of training
    # under caps other than the ones asked for
    for knob, value, exc, match in (
            ("MXNET_SDC_CHECK_EVERY_N", "2", ValueError, "ROADMAP A11"),
            ("MXNET_AUTOTUNE_PLAN", "no-such-plan.json", OSError,
             "no-such-plan")):
        monkeypatch.setenv(knob, value)
        with pytest.raises(exc, match=match):
            ttr.TransformerTrainStep(cfg, device="cpu")._build()
        monkeypatch.delenv(knob)
    # the conv tier's scope is a no-op for the LM (scopes never nest):
    # it builds (tests/test_torch_remat.py holds the trajectory)
    monkeypatch.setenv("MXNET_REMAT_POLICY", "stage")
    ttr.TransformerTrainStep(cfg, device="cpu")._build()
    monkeypatch.delenv("MXNET_REMAT_POLICY")


def test_divergence_guard_matches_jax_and_stops_fit(monkeypatch):
    seq = [3.0, 2.9, 2.8, 2.85, 2.7, 30.0, 2.6, float("nan"), 2.5]
    jg, tg = JGuard(window=3, factor=2.0), tdiag.DivergenceGuard(
        window=3, factor=2.0)
    assert [tg.check(x) for x in seq] == [jg.check(x) for x in seq]
    monkeypatch.setenv("MXNET_DIVERGENCE_WINDOW", "2")
    s = ttr.TransformerTrainStep(ttr.TransformerConfig(**_kw()),
                                 device="cpu", learning_rate=50.0)
    with pytest.raises(tdiag.DivergenceError, match="diverged"):
        s.fit(_iters()[1], 12)


def test_chaos_kill_then_resume_matches_the_control(jax_run, tmp_path):
    """``MXNET_CHAOS=kill:step=3`` ends a fit with exit 137 after step 3,
    the last checkpoint (step 2) resumes, and the resumed run equals
    the uninterrupted one bit for bit."""
    ck = str(tmp_path / "ck")
    code = (
        "import sys, json, numpy as np\n"
        "from mxnet_tpu_torch import transformer as t\n"
        "cfg = t.TransformerConfig(vocab_size=64, n_layers=2, d_model=32,"
        " n_heads=2, d_ff=64, dtype='float64', param_dtype='float64')\n"
        "s = t.TransformerTrainStep(cfg, device='cpu', learning_rate=0.05)\n"
        "it = t.LMTokenIter(batch_size=4, seq_len=16, vocab_size=64,"
        " num_sequences=32)\n"
        "print(json.dumps(s.fit(it, 5, checkpoint_every_n=2,"
        " checkpoint_dir=sys.argv[1],"
        " resume_from=sys.argv[2] if len(sys.argv) > 2 else None)))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("MXNET_CHAOS", None)
    run = lambda *a, **kw: subprocess.run(  # noqa: E731
        [sys.executable, "-c", code, *a], capture_output=True, text=True,
        timeout=120, env=dict(env, **kw))
    control = run(str(tmp_path / "control"))
    assert control.returncode == 0, control.stderr
    victim = run(ck, MXNET_CHAOS="kill:step=3")
    assert victim.returncode == 137, victim.stderr
    assert tckpt.list_steps(ck) == [2]
    resumed = run(ck, ck)
    assert resumed.returncode == 0, resumed.stderr
    want = json.loads(control.stdout.splitlines()[-1])
    assert json.loads(resumed.stdout.splitlines()[-1]) == want[2:]


# ---------------------------------------------------------------------------
# the data path
# ---------------------------------------------------------------------------
def test_make_corpus_bitwise_equal_to_jax():
    for args in ((32, 16, 64, 0), (7, 100, 32000, 3)):
        want, got = jtr.make_corpus(*args), ttr.make_corpus(*args)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_lm_token_iter_contract():
    jit, it = _iters()
    b1 = it.next()
    assert b1.data[0].shape == (4, 16)
    assert str(b1.data[0].dtype) == "int32"
    assert b1.data[0].context.device_type == "cpu"
    d, lab = b1.data[0].asnumpy(), b1.label[0].asnumpy()
    corpus = ttr.make_corpus(32, 16, 64, seed=0)
    np.testing.assert_array_equal(d, corpus[:4, :-1])
    np.testing.assert_array_equal(lab, corpus[:4, 1:])
    np.testing.assert_array_equal(d, jit.next().data[0].asnumpy())
    it2 = _iters()[1]
    data, label, pad = it2.next_raw()
    assert isinstance(data[0], np.ndarray) and pad == 0
    np.testing.assert_array_equal(data[0], d)
    assert it.replay_spec() == jit.replay_spec()


def test_lm_token_iter_parts_disjoint_exhaustive():
    full = _iters(num_parts=1)[1].data[0][1]
    seen = [_iters(num_parts=2, part_index=p)[1].data[0][1]
            for p in range(2)]
    got = np.concatenate(seen)
    assert got.shape[0] == full.shape[0]
    assert {r.tobytes() for r in got} == {r.tobytes() for r in full}
    with pytest.raises(ValueError, match="part_index"):
        _iters(num_parts=2, part_index=2)


def test_lm_token_iter_skip_batches_replay():
    it = _iters()[1]
    it.next(), it.next()
    b3 = it.next().data[0].asnumpy()
    it2 = _iters()[1]
    it2.reset()
    it2.skip_batches(2)
    np.testing.assert_array_equal(b3, it2.next().data[0].asnumpy())


@pytest.mark.parametrize("mode", ["pad", "discard", "roll_over"])
def test_ndarray_iter_last_batch_modes_match_jax(mode):
    rng = np.random.RandomState(0)
    x = rng.randn(10, 3).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    its = [m.NDArrayIter(x, y, batch_size=4, last_batch_handle=mode)
           for m in (jio, tio)]
    for _ in range(2):          # two epochs: roll_over carries over
        got = []
        for it in its:
            rows = []
            for b in it:
                rows.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                             b.pad))
            got.append(rows)
            it.reset()
        assert len(got[0]) == len(got[1])
        for (jd, jl, jp), (td, tl, tp) in zip(*got):
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tl, jl)
            assert tp == jp
    assert its[1].cursor == its[0].cursor
    assert [tuple(d) for d in its[1].provide_data] == \
        [tuple(d) for d in its[0].provide_data]
