"""The port's ``parallel.scaling`` and ``parallel.overlap`` against the
JAX package's and against hand-computed figures.

  * the cost model: ``simulate_bucketed_overlap`` /
    ``project_efficiency_bucketed`` / ``project_efficiency`` give the
    JAX package's dicts to 1e-12 at seeded points, the link bandwidth
    given to both;
  * collectives by verb from a synthetic kineto trace (``record_param_
    comms`` events, NCCL kernels, ``mxbkt`` scopes): counts, bytes and
    issue order as computed by hand;
  * overlap on the same trace: measured 100 of 250 µs, the dataflow
    bound 110 of 250, and the measured figure equal to
    ``traceview.parse``'s ``overlap_frac``;
  * the sweep: a two-rank gloo ``sweep((1, 2))`` of a tiny BatchNorm net
    holds its trajectory against one rank;
  * departures pinned: the bandwidth is required (the JAX package's
    45 GB/s default is a TPU figure), ``mp_placement_sweep`` raises and
    names ROADMAP A12.4, the measures read a trace (no HLO helpers).
"""
import numpy as np
import pytest

from mxnet_tpu.parallel import scaling as jscaling

from mxnet_tpu_torch.parallel import overlap as toverlap
from mxnet_tpu_torch.parallel import scaling as tscaling
from mxnet_tpu_torch.traceview import parse as tparse

BW = 80.0   # GB/s, given to both packages


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


POINTS = [(n, readiness, accum, lat)
          for n, readiness, accum, lat in ((2, "uniform", 1, 0.0),
                                           (8, "bytes", 1, 5e-6),
                                           (64, "bytes", 4, 2e-5),
                                           (256, "uniform", 2, 1e-6))]


@pytest.mark.parametrize("n,readiness,accum,lat", POINTS)
def test_the_cost_model_matches(n, readiness, accum, lat):
    rng = np.random.RandomState(n)
    bb = [int(b) for b in rng.randint(1, 64, size=17) * 65536]
    step = float(rng.uniform(0.01, 0.1))
    kw = dict(backward_frac=0.6, coll_latency_s=lat, readiness=readiness,
              accum_steps=accum)
    _close(tscaling.simulate_bucketed_overlap(bb, step, n, BW, **kw),
           jscaling.simulate_bucketed_overlap(bb, step, n, BW, **kw))
    _close(tscaling.project_efficiency_bucketed(bb, step, ici_GBps=BW,
                                                chips=(2, n), **kw),
           jscaling.project_efficiency_bucketed(bb, step, ici_GBps=BW,
                                                chips=(2, n), **kw))
    _close(tscaling.project_efficiency(sum(bb), step, chips=(n,),
                                       ici_GBps=BW, overlap=0.3),
           jscaling.project_efficiency(sum(bb), step, chips=(n,),
                                       ici_GBps=BW, overlap=0.3))


def test_the_bandwidth_is_required():
    # departure: the JAX package defaults to 45 GB/s (a TPU v5e figure)
    assert jscaling.simulate_bucketed_overlap([1 << 20], 0.01, 8)
    for call in (lambda: tscaling.simulate_bucketed_overlap([1 << 20],
                                                            0.01, 8),
                 lambda: tscaling.project_efficiency_bucketed([1 << 20],
                                                              0.01),
                 lambda: tscaling.project_efficiency(1 << 20, 0.01)):
        with pytest.raises(ValueError, match="ici_GBps"):
            call()


def test_mp_placement_sweep_raises_naming_the_item():
    with pytest.raises(NotImplementedError, match="A12.4"):
        tscaling.mp_placement_sweep()


def test_grad_entries_of_a_leaf_list_and_their_bytes():
    ent = [("a", (3, 4), "float32"), ("b", (5,), "bfloat16")]
    assert tscaling.grad_entries(ent) == jscaling.grad_entries(ent)
    assert tscaling.grad_entries(ent, dtype="bfloat16") == \
        jscaling.grad_entries(ent, dtype="bfloat16")
    assert tscaling.grad_leaf_bytes(ent) == jscaling.grad_leaf_bytes(ent)


# ---------------------------------------------------------------------------
# a synthetic kineto trace: one step window [0, 1000) µs, one card with
# a compute stream (7) and an NCCL stream (20)
# ---------------------------------------------------------------------------
def _x(name, cat, ts, dur, pid, tid, **args):
    return {"name": name, "cat": cat, "ph": "X", "ts": float(ts),
            "dur": float(dur), "pid": pid, "tid": tid, "args": args}


def _trace():
    host, dev = 100, 0
    ev = [{"name": "process_name", "ph": "M", "pid": dev, "tid": 0,
           "args": {"name": "GPU 0"}},
          _x("mxnet:step:0:k=1", "user_annotation", 0, 1000, host, 1),
          _x("mxnet-fwd", "user_annotation", 0, 300, host, 1),
          _x("mxnet-bwd", "user_annotation", 300, 500, host, 1),
          _x("mxbkt000", "user_annotation", 400, 10, host, 1),
          _x("mxbkt001", "user_annotation", 600, 10, host, 1),
          _x("mxnet-opt", "user_annotation", 800, 200, host, 1)]
    corr = [0]

    def kernel(name, start, dur, launched, stream=7):
        corr[0] += 1
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", launched, 1, host,
                     1, correlation=corr[0]))
        ev.append(_x(name, "kernel", start, dur, dev, stream,
                     correlation=corr[0]))

    def comms(ts, name, nel_in, nel_out, dtype, size=4):
        ev.append(_x("record_param_comms", "cpu_op", ts, 2, host, 1,
                     **{"Collective name": name, "In msg nelems": nel_in,
                        "Out msg nelems": nel_out, "dtype": dtype,
                        "Group size": size}))

    kernel("fwd_gemm", 10, 280, 5)
    kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 295, 4, 100)
    kernel("bwd_gemm_1", 300, 150, 305)
    kernel("CatArrayBatchedCopy", 450, 10, 402)           # bucket 0 pack
    kernel("bwd_gemm_2", 460, 240, 420)
    kernel("ncclDevKernel_AllReduce_Sum_bf16_RING_LL", 500, 100, 405, 20)
    kernel("CatArrayBatchedCopy", 700, 10, 602)           # bucket 1 pack
    kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 720, 150, 605, 20)
    kernel("multi_tensor_apply_kernel", 880, 70, 805)     # the update
    kernel("ncclDevKernel_AllGather_RING_LL", 960, 10, 812)
    comms(50, "barrier", 1, 1, "Float")
    comms(100, "allreduce", 64, 64, "Float")              # sync BN
    comms(405, "allreduce", 1000, 1000, "BFloat16")       # bucket 0
    comms(605, "allreduce", 3000, 3000, "Float")          # bucket 1
    comms(810, "_allgather_base", 1000, 4000, "Float")
    return {"traceEvents": ev}


PLAN = {"buckets": [{"bucket": 0, "bytes": 2000, "dtype": "bfloat16"},
                    {"bucket": 1, "bytes": 12000, "dtype": "float32"}]}


def test_collectives_by_verb_from_a_trace():
    got = tscaling.collective_stats(_trace())
    assert got == {
        "all-reduce": {"count": 3.0, "bytes": 14256.0, "elements": 4064.0,
                       "kernels": 3.0},
        "all-gather": {"count": 1.0, "bytes": 16000.0, "elements": 4000.0,
                       "kernels": 1.0}}
    assert tscaling.reduction_accounting(_trace()) == [
        {"op": "all-reduce", "bytes": 256, "elements": 64, "bucket": None},
        {"op": "all-reduce", "bytes": 2000, "elements": 1000, "bucket": 0},
        {"op": "all-reduce", "bytes": 12000, "elements": 3000, "bucket": 1},
        {"op": "all-gather", "bytes": 16000, "elements": 4000,
         "bucket": None}]
    summ = tparse.attribute(_trace(), plan_meta=PLAN)
    assert tscaling.collective_stats(summ) == {
        "all-reduce": {"count": 2, "elements": None, "bytes": 14000.0,
                       "kernels": None}}


def test_overlap_measured_and_bound_from_a_trace():
    m = toverlap.schedule_overlap_from_trace(_trace(), PLAN)
    b = toverlap.schedulable_overlap_from_trace(_trace(), PLAN)
    summ = tparse.attribute(_trace(), plan_meta=PLAN)
    # bucket 0's reduce [500, 600) lies under the backward; bucket 1's
    # [720, 870) under nothing; as early as its gradients exist (its
    # pack at 700) it could hide 10 µs
    assert m["overlap_measured"] == pytest.approx(100 / 250, rel=1e-12)
    assert m["overlap_measured"] == pytest.approx(
        summ["overlap"]["overlap_frac"], rel=1e-12)
    assert [(r["bucket"], r["bytes"]) for r in m["buckets"]] == \
        [(0, 2000), (1, 12000)]
    assert m["buckets"][0]["hidden_s_per_step"] == pytest.approx(100e-6)
    assert m["buckets"][1]["hidden_s_per_step"] == pytest.approx(0.0)
    assert b["overlap_schedulable"] == pytest.approx(110 / 250, rel=1e-12)
    assert b["buckets"][1]["hidden_s_per_step"] == pytest.approx(10e-6)
    assert m["n_reduction_ops"] == 2
    # a summary gives the same measured figure
    s = toverlap.schedule_overlap_from_trace(summ)
    assert s["overlap_measured"] == m["overlap_measured"]


def test_one_rank_trace_reports_no_overlap_and_why():
    ev = [e for e in _trace()["traceEvents"]
          if not str(e.get("name", "")).startswith("mxbkt")]
    m = toverlap.schedule_overlap_from_trace({"traceEvents": ev})
    assert m["overlap_measured"] is None and "one-rank" in m["reason"]
    assert toverlap.main(["--self-test"]) == 0
    # the HLO walkers of the JAX package have no counterpart here
    assert not hasattr(toverlap, "hlo_bytes_in")


@pytest.fixture(scope="module")
def two_rank_sweep():
    return tscaling.sweep((1, 2), steps=3, batch=8, device="cpu",
                          model="torch_dp_cases:sweep_net", classes=4,
                          image=8, timeout=300, threads=1)


def test_two_rank_sweep_holds_its_trajectory(two_rank_sweep):
    pts = {r["n"]: r for r in two_rank_sweep["sweep"]}
    assert sorted(pts) == [1, 2]
    two = pts[2]
    assert two["numerically_consistent"], two
    assert two["first_step_rel_err"] < 5e-3
    assert all(np.isfinite(pts[1]["losses"])) and \
        len(pts[1]["losses"]) == 3
    # the traced step's exchange: the plan's bucket reduces under their
    # mxbkt scopes, in plan order, beside sync BN's all-reduces
    bucketed = [r["bucket"] for r in two["reductions"]
                if r["bucket"] is not None]
    assert bucketed == list(range(len(two["buckets"])))
    assert two["collectives"]["all-reduce"]["count"] > len(two["buckets"])
