"""The port's ``autotune`` against the JAX package's: the ``timing``
loaders give equal models on the same payloads (a flight dump, a
``--bucket-timings`` export, a SCALING report, leaf bytes, a traceview
summary of the port's kineto fixture); ``tune`` gives the same plan dict
with the link bandwidth given; plans cross between the packages through
``save_plan`` / ``load_plan`` / ``resolve_caps`` (fingerprint match and
mismatch, the directory cache); the CLI self-test passes.  Departures
pinned: the port assumes no link bandwidth (a tune without a measured
or given one raises, where the JAX package takes its TPU figure).
Tolerance: equal (the same arithmetic), floats to 1e-12."""
import json
import os

import numpy as np
import pytest

from mxnet_tpu.autotune import plan as jplan
from mxnet_tpu.autotune import search as jsearch
from mxnet_tpu.autotune import timing as jtiming
from mxnet_tpu.parallel import buckets as jbuckets

from mxnet_tpu_torch.autotune import __main__ as tcli
from mxnet_tpu_torch.autotune import plan as tplan
from mxnet_tpu_torch.autotune import search as tsearch
from mxnet_tpu_torch.autotune import timing as ttiming
from mxnet_tpu_torch.parallel import buckets as tbuckets
from mxnet_tpu_torch.traceview import parse as tparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIB = 1024 * 1024
BW = 120.0       # GB/s, given explicitly to both packages


def _close(a, b, path="x"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], "%s.%s" % (path, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, "%s[%d]" % (path, i))
    elif isinstance(a, float) and not isinstance(a, bool):
        assert b == pytest.approx(a, rel=1e-12, abs=1e-15), path
    else:
        assert a == b, path


def _model_dict(m):
    d = m.to_dict()
    d["measured_overlap_frac"] = getattr(m, "measured_overlap_frac", None)
    d["bucket_occupancy"] = getattr(m, "bucket_occupancy", None)
    d["fingerprint"] = m.fingerprint()
    return d


def _flight_dump():
    rng = np.random.RandomState(0)
    sizes = [int(s) for s in rng.randint(1, 8, size=5) * MIB]
    plan = {"n_buckets": 5, "total_bytes": sum(sizes), "cap_bytes": 8 * MIB,
            "impl": "psum", "chained": True,
            "buckets": [{"bucket": i, "n_grads": 2, "bytes": b,
                         "dtype": "float32"} for i, b in enumerate(sizes)]}
    entries = [{"seq": i, "op": "bucket_reduce", "bucket": i, "bytes": b,
                "dtype": "float32", "enqueue_ts": 10.0 + i,
                "complete_ts": 10.0 + i + 1e-6, "args": {"in_graph": True}}
               for i, b in enumerate(sizes)]
    entries += [{"seq": 9 + i, "op": "push", "bytes": MIB,
                 "enqueue_ts": 20.0 + i,
                 "complete_ts": 20.0 + i + float(rng.uniform(5e-4, 2e-3))}
                for i in range(4)]
    return {"header": {"flight_recorder": True, "rank": 0,
                       "bucket_plan": plan}, "entries": entries}


def _kineto_summary():
    with open(os.path.join(REPO, "mxnet_tpu_torch", "traceview",
                           "fixture_kineto.json")) as f:
        fx = json.load(f)
    return tparse.attribute(fx["trace"], plan_meta=fx["plan_meta"],
                            workload="fixture_kineto")


def _payloads():
    dump = _flight_dump()
    timings = {"format": "bucket-timings", "ranks": {
        "0": {"bucket_plan": dump["header"]["bucket_plan"],
              "timings": dump["entries"]},
        "1": {"timings": dump["entries"][:3]}}}
    scaling = {"projection_bucket_pipeline": {"bfloat16": {
        "bucket_bytes": [3 * MIB, 5 * MIB, 2 * MIB, 7 * MIB],
        "step_time_s": 0.021}}}
    return [
        ("flight", lambda t: t.from_flight_dump(dump, path="d.json",
                                                step_time_s=0.03)),
        ("bucket-timings", lambda t: t.from_bucket_timings(
            timings, step_time_s=0.03)),
        ("scaling", lambda t: t.from_scaling_json(scaling, path="s.json")),
        ("leaf", lambda t: t.from_leaf_bytes(
            [4096, 2 * MIB, 512, 3 * MIB, MIB // 2], dtype="bfloat16",
            step_time_s=0.012)),
        ("trace", lambda t: t.from_trace(_kineto_summary(), path="k.json")),
    ]


@pytest.mark.parametrize("name,load", _payloads(),
                         ids=[n for n, _ in _payloads()])
def test_loaders_give_equal_models(name, load):
    _close(_model_dict(load(ttiming)), _model_dict(load(jtiming)))


@pytest.mark.parametrize("name,load", _payloads(),
                         ids=[n for n, _ in _payloads()])
def test_tune_gives_the_same_plan(name, load):
    kw = dict(chips=16, ici_GBps=BW)
    if load(ttiming).step_time_s is None:
        kw["step_time_s"] = 0.025
    _close(tsearch.tune(load(ttiming), **kw),
           jsearch.tune(load(jtiming), **kw))


def test_tune_with_accumulation_and_ladder_matches():
    units = [(int(b), "float32") for b in
             np.random.RandomState(1).randint(1, 9, size=30) * MIB // 2]
    for accum in (1, 4):
        kw = dict(chips=64, ici_GBps=BW, accum_steps=accum,
                  coll_latency_s=2e-5)
        _close(tsearch.tune(ttiming.TimingModel(units, "bucket",
                                                step_time_s=0.05), **kw),
               jsearch.tune(jtiming.TimingModel(units, "bucket",
                                                step_time_s=0.05), **kw))


def test_tune_without_a_bandwidth_raises_in_the_port():
    # departure: the JAX package falls back to its TPU figure (45 GB/s);
    # the port assumes no link and names the argument
    units = [(4 * MIB, "float32")] * 6
    jt = jsearch.tune(jtiming.TimingModel(units, "bucket",
                                          step_time_s=0.01), chips=8)
    assert jt["assumptions"]["bandwidth_source"] == "assumed"
    with pytest.raises(ValueError, match="ici_GBps"):
        tsearch.tune(ttiming.TimingModel(units, "bucket",
                                         step_time_s=0.01), chips=8)
    assert not hasattr(tsearch, "DEFAULT_ICI_GBPS")
    # a measured bandwidth (the kineto summary's) needs none
    plan = tsearch.tune(ttiming.from_trace(_kineto_summary()), chips=8)
    assert plan["assumptions"]["bandwidth_source"] == "trace"


def _entries():
    rng = np.random.RandomState(2)
    return [("w%02d" % i, (int(n),), "float32")
            for i, n in enumerate(rng.randint(1, 400000, size=40))]


@pytest.fixture
def no_knobs(monkeypatch):
    for k in ("MXNET_AUTOTUNE_PLAN", "MXNET_AUTOTUNE_DIR",
              "MXNET_KVSTORE_BUCKET_BYTES"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_plan_written_by_one_package_applies_in_the_other(
        writer, no_knobs, tmp_path):
    entries = _entries()
    total = sum(n for _k, (n,), _d in entries) * 4
    model = jtiming.from_leaf_bytes(
        [n * 4 for _k, (n,), _d in entries], step_time_s=0.02)
    plan = jsearch.tune(model, chips=32, ici_GBps=BW)
    assert plan["fingerprint"]["total_bytes"] == total
    path = str(tmp_path / "plan.json")
    (jplan if writer == "jax" else tplan).save_plan(plan, path)
    assert tplan.load_plan(path) == jplan.load_plan(path)
    no_knobs.setenv("MXNET_AUTOTUNE_PLAN", path)
    tp, tmeta = tbuckets.plan_with_tuning(entries)
    jp, jmeta = jbuckets.plan_with_tuning(entries)
    assert [tuple(b) for b in tp] == [tuple(b) for b in jp]
    assert tmeta == jmeta and tmeta["plan_path"] == path
    assert len(tp) == plan["n_buckets"]
    _close(tbuckets.plan_meta(tp, tmeta["cap_bytes"], tuning=tmeta),
           jbuckets.plan_meta(jp, jmeta["cap_bytes"], tuning=jmeta))
    # an explicit cap bypasses the plan in both
    assert tbuckets.plan_with_tuning(entries, 1 << 20)[1] is None
    assert jbuckets.plan_with_tuning(entries, 1 << 20)[1] is None


def test_resolve_caps_and_the_directory_cache_agree(no_knobs, tmp_path):
    units = [(3 * MIB, "bfloat16")] * 7
    plan = tsearch.tune(ttiming.TimingModel(units, "bucket",
                                            step_time_s=0.02),
                        chips=8, ici_GBps=BW)
    total = plan["fingerprint"]["total_bytes"]
    d = tmp_path / "plans"
    path = tplan.save_plan(plan, tplan.default_plan_path(plan, str(d)))
    assert path == jplan.default_plan_path(plan, str(d))
    (d / "junk.json").write_text("{not json")
    (d / "other.json").write_text(json.dumps({"format": "something"}))
    for knobs, tb, want in (({}, total, None),
                            ({"MXNET_AUTOTUNE_DIR": str(d)}, total, path),
                            ({"MXNET_AUTOTUNE_DIR": str(d)}, 999, None),
                            ({"MXNET_AUTOTUNE_PLAN": path}, 999, path)):
        for k in ("MXNET_AUTOTUNE_PLAN", "MXNET_AUTOTUNE_DIR"):
            no_knobs.delenv(k, raising=False)
        for k, v in knobs.items():
            no_knobs.setenv(k, v)
        tc, tpath = tplan.resolve_caps(total_bytes=tb, n_grads=3)
        jc, jpath = jplan.resolve_caps(total_bytes=tb, n_grads=3)
        assert tc == jc and tpath == jpath == want


def test_load_plan_refusals_agree(tmp_path):
    bad = [{"format": "nope"}, {"format": tplan.PLAN_FORMAT, "version": 9,
                                "cap_bytes": 4},
           {"format": tplan.PLAN_FORMAT, "version": 1, "cap_bytes": 0}]
    for i, payload in enumerate(bad):
        p = tmp_path / ("bad%d.json" % i)
        p.write_text(json.dumps(payload))
        with pytest.raises(ValueError):
            tplan.load_plan(str(p))
        with pytest.raises(ValueError):
            jplan.load_plan(str(p))


def test_cli_self_test_passes(capsys):
    assert tcli.main(["--self-test"]) == 0
    assert "autotune self-test OK" in capsys.readouterr().out


def test_cli_tune_needs_a_bandwidth_for_a_scaling_report(tmp_path, capsys):
    p = tmp_path / "SCALING_x.json"
    p.write_text(json.dumps({"projection_bucket_pipeline": {"float32": {
        "bucket_bytes": [4 * MIB] * 5, "step_time_s": 0.02}}}))
    with pytest.raises(ValueError, match="ici_GBps"):
        tcli.main(["--tune", str(p)])
    out = tmp_path / "plan.json"
    assert tcli.main(["--tune", str(p), "--ici-gbps", str(BW), "--apply",
                      "--out", str(out)]) == 0
    assert tplan.load_plan(str(out))["assumptions"]["ici_GBps"] == BW
