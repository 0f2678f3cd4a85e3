"""The port's step auditor and recompile tracking against the JAX
package's.

Each check flags its seeded fixture and passes the clean in-place step
(the CLI self-test and one case a check); ``Finding`` fingerprints,
``AuditReport`` and the decode-bucket check equal the JAX package's on
the same inputs; the baseline's entries carry notes; on a tiny bf16
``FusedTrainStep`` the port's ``audit_step`` reports the same kinds of
finding as the JAX package's on its counterpart.  Recompile tracking:
a step called under two batch shapes counts two in both packages and
warns once.  Departures pinned by name: the donation finding's
offenders (the port's update replaces parameter and momentum tensors;
the JAX package flags its undonated batch buffers), the signature
(shape, dtype and device: an eager step's cold call, not an XLA
compile) and the weakly held recorded step.
"""
import gc
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import diagnostics as jdiag
from mxnet_tpu import env as jenv
from mxnet_tpu.analysis import auditor as jaud
from mxnet_tpu.analysis import fixtures as jfx
from mxnet_tpu.parallel.dp import FusedTrainStep as JStep

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import diagnostics as tdiag
from mxnet_tpu_torch import env as tenv
from mxnet_tpu_torch.analysis import __main__ as tcli
from mxnet_tpu_torch.analysis import auditor as taud
from mxnet_tpu_torch.analysis import fixtures as tfx
from mxnet_tpu_torch.parallel.dp import FusedTrainStep as TStep


def test_self_test_passes(capsys):
    assert tcli.main(["--self-test"]) == 0
    assert "analysis self-test OK" in capsys.readouterr().out


def _checks():
    def uniform():
        return taud.check_collective_uniformity(
            tfx.rank_dependent_traces(), "fx")

    def donation():
        fn, specs = tfx.undonated_step()
        return taud.audit_step(fn, specs, site="fx")[0]

    def dtype():
        return taud.check_dtype(tfx.upcast_log(), "fx", "bfloat16")

    def host_sync():
        return taud.check_host_sync(tfx.host_sync_log(), "fx")

    def remat():
        return taud.check_remat_effectiveness(tfx.noop_remat_log(), "fx",
                                              "stage")

    def sparse():
        return taud.check_sparse_gradients(
            tfx.sparse_gradient_violation(), "fx", tfx.SPARSE_FIXTURE_VOCAB,
            embed_dim=tfx.SPARSE_FIXTURE_DIM)

    return [("collective-uniformity", uniform), ("donation", donation),
            ("dtype", dtype), ("host-sync", host_sync),
            ("remat-effectiveness", remat), ("sparse-gradients", sparse)]


@pytest.mark.parametrize("check,run", _checks(),
                         ids=[c for c, _ in _checks()])
def test_each_check_flags_its_fixture(check, run):
    with tfx.one_rank_group():
        found = run()
    assert [f.check for f in found] == [check]
    f = found[0]
    assert f.fingerprint() == "%s:fx:%s" % (check,
                                           f.details["fingerprint_key"])


def test_the_clean_step_and_the_fixed_twins_pass():
    with tfx.one_rank_group():
        fn, specs = tfx.clean_step()
        found, meta = taud.audit_step(fn, specs, site="clean",
                                      compute_dtype="bfloat16")
        assert found == [] and meta["n_collectives"] == 1
        assert meta["donation"]["undonated_bytes"] == 0
        fn, specs = tfx.donated_step()
        assert taud.audit_step(fn, specs, site="twin")[0] == []
    rl, tl = tfx.remat_twin_logs()
    assert taud.count_remat_eqns(rl) == 3 and taud.count_remat_eqns(tl) == 0
    assert taud.peak_live_bytes(rl) < taud.peak_live_bytes(tl)
    assert taud.check_remat_effectiveness(rl, "t", "stage", twin_log=tl) \
        == []
    assert taud.check_sparse_gradients(
        tfx.sparse_gradient_clean(), "t", tfx.SPARSE_FIXTURE_VOCAB) == []


def test_an_empty_op_log_raises():
    with pytest.raises(RuntimeError, match="no op"):
        taud.audit_step(lambda: None, (), site="empty")


def test_decode_buckets_match_the_jax_package():
    for fx in ("decode_bucket_violation", "decode_bucket_clean"):
        plan, observed, counts = getattr(tfx, fx)()
        assert (plan, observed, counts) == getattr(jfx, fx)()
        t = taud.check_decode_buckets(plan, observed, "s",
                                      compile_counts=counts)
        j = jaud.check_decode_buckets(plan, observed, "s",
                                      compile_counts=counts)
        assert [f.to_dict() for f in t] == [f.to_dict() for f in j]


def test_finding_and_report_formats_match():
    args = ("dtype", "perf", "S", "m", {"fingerprint_key": "k", "n": 1})
    tf, jf = taud.Finding(*args), jaud.Finding(*args)
    assert tf.to_dict() == jf.to_dict() and tf.fingerprint() == "dtype:S:k"
    tr, jr = taud.AuditReport(), jaud.AuditReport()
    for r, f in ((tr, tf), (jr, jf)):
        r.findings.append(f)
        r.sites["S"] = {"n_eqns": 3}
    assert tr.to_dict() == jr.to_dict() and tr.summary() == jr.summary()
    base = {"dtype:S:k"}
    assert [x.to_dict() for x in taud.apply_baseline([tf], base)[1]] == \
        [x.to_dict() for x in jaud.apply_baseline([jf], base)[1]]


def test_the_baseline_entries_carry_notes():
    import json

    with open(taud.DEFAULT_BASELINE) as f:
        data = json.load(f)
    assert data["fingerprints"]
    for e in data["fingerprints"]:
        assert e["note"] and e["fingerprint"].count(":") >= 2
    assert taud.load_baseline() == {e["fingerprint"]
                                    for e in data["fingerprints"]}


def _nets(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="aud_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3), nn.BatchNorm(), nn.Activation("relu"),
                nn.Dense(10))
    return net


def _data(mx):
    rng = np.random.RandomState(0)
    return (mx.nd.array(rng.uniform(size=(8, 3, 8, 8)).astype("float32")),
            mx.nd.array(rng.randint(0, 10, 8).astype("float32")))


def test_bf16_step_reports_the_jax_packages_kinds_of_finding():
    jdiag.reset_recompile_stats()
    tdiag.reset_recompile_stats()
    np.random.seed(0)
    jnet = _nets(jmx)
    jnet.initialize(jmx.init.Xavier())
    jstep = JStep(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                  dtype="bfloat16")
    jstep(*_data(jmx))
    with tmx.cpu():
        np.random.seed(0)
        tnet = _nets(tmx)
        tnet.initialize(tmx.init.Xavier())
        tstep = TStep(tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                      dtype="bfloat16")
        tstep(*_data(tmx))
        jrec = jdiag.recorded_steps()["FusedTrainStep.step"]
        trec = tdiag.recorded_steps()["FusedTrainStep.step"]
        kinds = []
        for aud, (fn, specs, meta) in ((jaud, jrec), (taud, trec)):
            found, site = aud.audit_step(
                fn, specs, site="FusedTrainStep.step",
                compute_dtype=meta["compute_dtype"],
                plan_meta=meta.get("bucket_plan"),
                remat_policy=meta.get("remat_policy"),
                donation_min_bytes=1)
            kinds.append((sorted({f.check for f in found}), found, site))
    (jk, jf, jsite), (tk, tf, tsite) = kinds
    assert tk == jk == ["donation"]
    assert trec[2]["compute_dtype"] == jrec[2]["compute_dtype"] == \
        "bfloat16"
    # departure: what the donation finding names
    j_off = {o["shape"] for o in jf[0].details["offenders"]}
    t_off = {o["shape"] for o in tf[0].details["offenders"]}
    assert "(8, 3, 8, 8)" in j_off            # the JAX step's batch
    assert "(10, 144)" in t_off and "(8, 3, 8, 8)" not in t_off
    assert tsite["n_eqns"] > 0 and tsite["n_collectives"] == 0


def test_recompile_tracking_counts_and_warns_once(caplog, monkeypatch):
    assert tenv.var("MXNET_RECOMPILE_WARN_N").default == \
        jenv.var("MXNET_RECOMPILE_WARN_N").default == 1
    monkeypatch.delenv("MXNET_RECOMPILE_WARN_N", raising=False)
    tdiag.reset_recompile_stats()
    jdiag.reset_recompile_stats()
    np.random.seed(0)
    jnet = _nets(jmx)
    jnet.initialize(jmx.init.Xavier())
    jstep = JStep(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss())
    with tmx.cpu():
        tnet = _nets(tmx)
        tnet.initialize(tmx.init.Xavier())
        tstep = TStep(tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss())
        with caplog.at_level(logging.WARNING):
            for b in (8, 8, 4, 8):
                x, y = _data(tmx)
                tstep(x[:b], y[:b])
                jx, jy = _data(jmx)
                jstep(jx[:b], jy[:b])
        t = tdiag.recompile_stats()["FusedTrainStep.step"]
        j = jdiag.recompile_stats()["FusedTrainStep.step"]
        assert t["count"] == j["count"] == 2
        storms = [r for r in caplog.records
                  if "RECOMPILATION STORM" in r.getMessage()
                  and "mxnet_tpu_torch" in r.name]
        assert len(storms) == 1
        # departure: the port's signature names the device
        assert t["avals"][-1][0][-1] == "cpu"
        assert "FusedTrainStep.step" in tdiag.recorded_steps()
    # departure: the recorded step is held weakly
    del tstep
    gc.collect()
    assert "FusedTrainStep.step" not in tdiag.recorded_steps()
    tdiag.reset_recompile_stats()
    assert tdiag.recompile_stats() == {}


def test_audit_recorded_steps_reports_each_site():
    tdiag.reset_recompile_stats()
    with tmx.cpu():
        np.random.seed(0)
        net = _nets(tmx)
        net.initialize(tmx.init.Xavier())
        step = TStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss())
        x, y = _data(tmx)
        step(x, y)
        step.run_steps(x, y, steps=2)
        rep = taud.audit_recorded_steps(baseline=set(),
                                        donation_min_bytes=1)
    assert sorted(rep.sites) == ["FusedTrainStep.multi_step_same[k=2]",
                                 "FusedTrainStep.step"]
    for site in rep.sites.values():
        assert site["findings_by_check"] == {"donation": 1}, rep.sites
        assert site["n_eqns"] > 0 and site["peak_live_bytes"] > 0
    assert rep.to_dict()["n_findings"] == 2
