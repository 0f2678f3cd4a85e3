"""The port's ``traceview`` against the JAX package's: the JAX package's
fixture trace attributes to the same summary through both walkers (to
1e-9); the port's kineto-shaped fixture (NCCL kernels, memcpys,
``mxbkt`` scopes, a backward launched from a second thread, two sync-BN
all-reduces a step that are not buckets) meets its goldens; the
self-test CLI exits 0; a live CPU capture of a 2-layer
``FusedTrainStep`` armed by ``MXNET_TRACE_DIR`` writes a summary of the
armed number of steps; and a port summary is read by the JAX package's
``autotune.timing`` reader."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx  # noqa: F401  (the reference package)
from mxnet_tpu.autotune import timing as jtiming
from mxnet_tpu.traceview import parse as jparse

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.traceview import __main__ as tcli
from mxnet_tpu_torch.traceview import capture as tcap
from mxnet_tpu_torch.traceview import parse as tparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9


def _fixture(name):
    with open(os.path.join(REPO, "mxnet_tpu_torch", "traceview",
                           name)) as f:
        return json.load(f)


def _assert_close(got, want, path="summary"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close(got[k], want[k], "%s.%s" % (path, k))
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, "%s[%d]" % (path, i))
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=TOL, abs=1e-15), path
    else:
        assert got == want, path


def test_the_port_keeps_the_jax_package_fixture():
    with open(os.path.join(REPO, "mxnet_tpu", "traceview",
                           "fixture_trace.json")) as f:
        assert json.load(f) == _fixture("fixture_trace.json")


@pytest.mark.parametrize("flight", [False, True])
def test_the_reference_fixture_attributes_identically(flight):
    fx = _fixture("fixture_trace.json")
    entries = [{"op": "bucket_reduce", "seq": 0, "bucket": 0},
               {"op": "bucket_reduce", "seq": 1, "bucket": 1,
                "injected": True, "injected_kind": "delay_collective"}] \
        if flight else None
    want = jparse.attribute(fx["trace"], plan_meta=fx["plan_meta"],
                            flight_entries=entries, workload="fixture")
    got = tparse.attribute(fx["trace"], plan_meta=fx["plan_meta"],
                           flight_entries=entries, workload="fixture")
    _assert_close(got, want)
    assert got["bucket_map"] == "issue-order" and got["plan_match"]


def test_the_kineto_fixture_meets_its_goldens():
    fx = _fixture("fixture_kineto.json")
    s = tparse.attribute(fx["trace"], plan_meta=fx["plan_meta"])
    g = fx["golden"]
    assert s["steps"]["n"] == g["n_steps"]
    for phase, want in g["phases_mean_s"].items():
        assert s["phases"][phase]["mean_s"] == pytest.approx(want,
                                                             rel=TOL)
    assert s["overlap"]["overlap_frac"] == pytest.approx(
        g["overlap_frac"], rel=TOL)
    assert [b["bucket"] for b in s["buckets"]] == [0, 1]
    for got, want in zip(s["buckets"], g["buckets"]):
        for key in ("device_s_per_step", "occupancy", "measured_GBps"):
            assert got[key] == pytest.approx(want[key], rel=TOL)
    assert s["bucket_map"] == "scope" and s["plan_match"] is True
    assert s["n_lanes"] == 1 and s["n_device_events"] == 22
    # 4 NCCL all-reduces a step: 2 buckets, and sync BN's 2 that ride
    # the forward and the backward as compute
    counts = tparse.device_op_counts(fx["trace"])
    nccl = {k: v for k, v in counts.items()
            if tparse.classify_op(k) == "comm"}
    assert sum(v["count"] for v in nccl.values()) == 4
    assert sum(b["device_s_per_step"] for b in s["buckets"]) == \
        pytest.approx(220e-6, rel=TOL)
    # the backward kernels were launched from the second thread; the
    # caller's mxnet-bwd scope claims them
    bwd = [k for k in counts if "flash_bwd" in k]
    assert len(bwd) == 2
    assert s["phases"]["backward"]["mean_s"] == pytest.approx(320e-6)


def test_without_scopes_a_kineto_trace_has_no_bucket():
    """Strip the mxbkt scopes: every NCCL kernel is then compute, and
    the plan finds no bucket (the scope is the only bucket channel)."""
    fx = _fixture("fixture_kineto.json")
    ev = [e for e in fx["trace"]["traceEvents"]
          if not str(e.get("name", "")).startswith("mxbkt")]
    s = tparse.attribute({"traceEvents": ev}, plan_meta=fx["plan_meta"])
    assert s["plan_match"] is False and s["buckets"] == []
    assert s["phases"]["bucket_reduce"]["mean_s"] == 0.0


def test_the_self_test_cli_exits_0(tmp_path):
    res = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.traceview",
                          "--self-test"], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "self-test OK" in res.stdout
    out = str(tmp_path / "s.json")
    src = str(tmp_path / "t.json")
    with open(src, "w") as f:
        json.dump(_fixture("fixture_kineto.json")["trace"], f)
    assert tcli.main(["--summary", src, "-o", out]) == 0
    with open(out) as f:
        assert tparse.is_traceview_summary(json.load(f))


def _tiny_step():
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(16, activation="relu"),
            tmx.gluon.nn.Dense(4))
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    from mxnet_tpu_torch.parallel.dp import FusedTrainStep

    return FusedTrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                          learning_rate=0.1)


def test_a_live_cpu_capture_writes_the_armed_steps(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_TRACE_STEPS", "2")
    tcap.reset()
    try:
        step = _tiny_step()
        rng = np.random.RandomState(0)
        x = tmx.nd.array(rng.rand(8, 6), ctx=tmx.cpu())
        y = tmx.nd.array(rng.randint(0, 4, 8), ctx=tmx.cpu())
        for _ in range(4):          # warmup + 2 traced + 1 after
            step(x, y)
        s = tcap.last_summary()
        path = tcap.last_summary_path()
    finally:
        tcap.reset()
    assert path == str(tmp_path / "traceview_summary_rank0.json")
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(s))
    assert s["workload"] == "FusedTrainStep" and s["steps"]["n"] == 2
    assert s["capture"]["steps_recorded"] == 2
    assert s["capture"]["device"] == "cpu"
    assert s["capture"]["lost_launches"] == [0, 0]
    assert os.path.exists(s["capture"]["trace_path"])
    assert s["n_device_events"] > 0
    for phase in ("forward", "backward", "optimizer"):
        assert s["phases"][phase]["mean_s"] > 0, phase
    assert s["phases"]["bucket_reduce"]["mean_s"] == 0.0
    # the phase histograms were fed
    from mxnet_tpu_torch import diagnostics as tdiag

    assert 'mxnet_step_phase_seconds_count{phase="forward"}' in \
        tdiag.metrics.to_prom()


def test_the_jax_reader_reads_a_port_summary(tmp_path):
    fx = _fixture("fixture_kineto.json")
    s = tparse.attribute(fx["trace"], plan_meta=fx["plan_meta"],
                         workload="fixture")
    s["rank"], s["capture"] = 0, {"trace_path": "t.json"}
    path = str(tmp_path / "traceview_summary_rank0.json")
    with open(path, "w") as f:
        json.dump(s, f)
    model = jtiming.load_any(path)
    assert model.source["kind"] == "trace"
    assert model.source["n_steps"] == 2
    assert model.measured_overlap_frac == pytest.approx(195.0 / 220.0)
    rates = sorted(b["measured_GBps"] for b in fx["golden"]["buckets"])
    assert model.measured_GBps == pytest.approx(
        jtiming._median(rates), rel=TOL)
    assert [b["occupancy"] for b in model.bucket_occupancy] == \
        pytest.approx([0.1, 0.12])


def test_a_launch_counts_in_its_window_whatever_the_device_clock():
    """The card's timestamps can read a few hundred microseconds early:
    a kernel stamped before its window's start still counts in the
    window that launched it (by its correlation id), in
    ``device_op_counts`` and in the smoke's own reading alike."""
    import copy

    import chip_smoke as cs

    fx = _fixture("fixture_kineto.json")
    want = tparse.device_op_counts(fx["trace"])
    skewed = copy.deepcopy(fx["trace"])
    for e in skewed["traceEvents"]:
        if e.get("cat") == "kernel" and "sm90_xmma_gemm" in e["name"]:
            e["ts"] -= 700.0       # before the window's 1000 us start
    assert tparse.device_op_counts(skewed) == want
    wins = cs.trace_windows(skewed)
    assert [w["launches"] for w in wins] == \
        [w["launches"] for w in cs.trace_windows(fx["trace"])]


def test_a_launch_whose_kernel_the_trace_lost_is_counted_in_its_window():
    """Kineto can lose device records at a capture's start: each window
    counts the kernel launches whose kernel the trace does not hold,
    and only those (a copy's runtime call is not a kernel launch)."""
    import copy

    fx = _fixture("fixture_kineto.json")
    n = tparse.attribute(fx["trace"])["steps"]["n"]
    assert tparse.lost_launches(fx["trace"]) == [0] * n
    launched = {(e.get("args") or {}).get("correlation"): e["ts"]
                for e in fx["trace"]["traceEvents"]
                if e.get("cat") == "cuda_runtime"}
    wins = sorted((e["ts"], e["ts"] + e["dur"])
                  for e in fx["trace"]["traceEvents"]
                  if e.get("cat") == "user_annotation"
                  and tparse.STEP_RE.match(e["name"]))
    for cat in ("kernel", "gpu_memcpy"):
        lossy = copy.deepcopy(fx["trace"])
        gone = next(e for e in lossy["traceEvents"] if e.get("cat") == cat
                    and e["args"]["correlation"] in launched)
        lossy["traceEvents"].remove(gone)
        t = launched[gone["args"]["correlation"]]
        want = [int(cat == "kernel" and t0 <= t < t1) for t0, t1 in wins]
        assert tparse.lost_launches(lossy) == want, cat
        assert sum(want) == (cat == "kernel")
    assert tparse.lost_launches({"traceEvents": []}) == []

