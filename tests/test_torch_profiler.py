"""The port's ``mx.profiler`` against the JAX package's: one seeded
program (``nd`` ops, a symbolic executor's forward / backward, and a
2-epoch x 2-batch ``Module.fit`` on ``NDArrayIter`` with the local
kvstore and SGD) runs through both, and the span multiset, the counters
and their byte totals, ``summary()``'s keys and counts and ``dumps()``'s
rows agree exactly.  Also: pause / resume, a stopped profiler adds
nothing, the rank-suffixed dump, the Counter / Marker / Domain event
shapes, the memory counters on the CPU, ``tools/merge_traces.py``
merging two port rank dumps, and the input tier's lanes (the decode
pool's ``io:decode`` a worker, ``PrefetchingIter::wait``; the device
stage's ``io:wait`` / ``io:device_put``)."""
import collections
import json
import os
import re
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import merge_traces  # noqa: E402


@pytest.fixture(autouse=True)
def _stopped_profilers():
    """Each test starts and ends with both profilers stopped, unpaused
    and configured by default."""
    for mx in (jmx, tmx):
        mx.profiler.set_config()
        mx.profiler.resume()
    yield
    for mx in (jmx, tmx):
        if mx.profiler._state == "run":
            mx.profiler.set_state("stop")
        mx.profiler.resume()
        mx.profiler.set_config()


def _mlp(mx):
    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        x = mx.sym.FullyConnected(x, num_hidden=16, name="fc1")
        x = mx.sym.Activation(x, act_type="relu")
        x = mx.sym.FullyConnected(x, num_hidden=4, name="fc2")
        return mx.sym.SoftmaxOutput(x, name="softmax")


def _program(mx, path):
    """The seeded program under a running profiler; returns the dump's
    events and ``summary()``."""
    rng = np.random.RandomState(0)
    X = rng.uniform(-1, 1, (16, 6))
    y = rng.randint(0, 4, 16).astype(np.float64)
    ctx = mx.cpu()
    a = mx.nd.array(rng.rand(4, 4), ctx=ctx)
    mx.profiler.set_config(filename=path)
    mx.profiler.set_state("run")
    c = mx.nd.relu(mx.nd.dot(a, a) * 2.0 + a)
    c.asnumpy()
    sym = _mlp(mx)
    ex = sym.simple_bind(ctx, data=(8, 6), softmax_label=(8,))
    for v in ex.arg_dict.values():
        v[:] = rng.rand(*v.shape) * 0.1
    ex.forward(is_train=True)
    ex.backward()
    it = mx.io.NDArrayIter(X, y, batch_size=8)
    mod = mx.mod.Module(sym, context=ctx)
    mod.fit(it, num_epoch=2, optimizer="sgd", kvstore="local",
            optimizer_params=(("learning_rate", 0.1),),
            initializer=mx.init.Uniform(0.1))
    mx.profiler.set_state("stop")       # the run->stop transition dumps
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return events, mx.profiler.summary(), mx.profiler.dumps()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("prof")
    out = {}
    for mx in (jmx, tmx):
        out[mx] = _program(mx, str(d / ("%s.json" % mx.__name__)))
        mx.profiler.set_config()
    return out


def _spans(events):
    return collections.Counter((e["cat"], e["name"]) for e in events
                               if e.get("ph") == "X")


def _counter_totals(events):
    """Counter name -> (cat, number of samples, last value)."""
    out = {}
    for e in events:
        if e.get("ph") == "C":
            cat, n, _ = out.get(e["name"], (e["cat"], 0, None))
            out[e["name"]] = (cat, n + 1, e["args"][e["name"]])
    return out


def test_the_span_multisets_match(both):
    want, got = _spans(both[jmx][0]), _spans(both[tmx][0])
    assert got == want
    names = {n for _, n in got}
    for n in ("dot", "Forward<softmax_output>", "Backward<softmax_output>",
              "Module::update", "SGD::update", "KVStore::Push",
              "KVStore::Pull", "NDArrayIter::next"):
        assert n in names


def test_the_counters_and_byte_totals_match(both):
    want, got = _counter_totals(both[jmx][0]), _counter_totals(both[tmx][0])
    assert got == want
    # 2 epochs x 2 batches x 4 parameters pushed, float32 cells
    n_params = 16 * 6 + 16 + 4 * 16 + 4
    assert got["kvstore:push_bytes"][2] == n_params * 4 * 4
    assert got["io:batch_bytes"][1] == 4


def test_summary_keys_and_counts_match(both):
    def shape(s):
        return ({cat: {n: v["count"] for n, v in d.items()}
                 for cat, d in s["spans"].items()},
                {cat: {n: v["count"] for n, v in d.items()}
                 for cat, d in s["counters"].items()},
                sorted(s), [sorted(r) for r in s["phases"]])

    assert shape(both[tmx][1]) == shape(both[jmx][1])
    row = both[tmx][1]["spans"]["operator"]["dot"]
    assert sorted(row) == ["avg_ms", "count", "max_ms", "min_ms",
                           "total_ms"]
    assert row["min_ms"] <= row["avg_ms"] <= row["max_ms"]


def test_the_dumps_rows_match(both):
    def rows(table):
        # the row names and counts; times differ between the runs
        return [re.sub(r"\s+[-0-9.]+\s+[-0-9.]+\s+[-0-9.]+\s+[-0-9.]+"
                       r"(\s+[-0-9.]+)?$", "", line).rstrip()
                for line in table.splitlines()]

    assert rows(both[tmx][2]) == rows(both[jmx][2])
    assert both[tmx][2].startswith("Profile Statistics.")


def test_pause_resume_and_a_stopped_profiler_adds_nothing(tmp_path):
    counts = {}
    for mx in (jmx, tmx):
        path = str(tmp_path / ("%s.json" % mx.__name__))
        a = mx.nd.ones((4, 4), ctx=mx.cpu())
        (a + a).asnumpy()                    # stopped: nothing
        mx.profiler.set_config(filename=path)
        mx.profiler.set_state("run")
        (a * 2.0).asnumpy()
        mx.profiler.pause()
        assert not mx.profiler.is_running()
        (a - a).asnumpy()                    # paused: nothing
        mx.profiler.record_span("manual", 0.0, 1.0)
        mx.profiler.resume()
        mx.nd.dot(a, a).asnumpy()
        mx.profiler.set_state("stop")
        (a + a).asnumpy()                    # stopped again: nothing
        mx.profiler.record_counter("late", 1)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        counts[mx] = _spans(events)
    assert counts[tmx] == counts[jmx] == collections.Counter(
        {("operator", "_mul_scalar"): 1, ("operator", "dot"): 1})
    # the stopped hook reads one flag: no event, no accumulator
    assert tmx.profiler._events == [] or all(
        e["name"] != "late" for e in tmx.profiler._events)
    assert "late" not in str(tmx.profiler.summary()["counters"])


def test_rank_suffixed_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_WORKER_ID", "1")
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    names = {}
    for mx in (jmx, tmx):
        d = tmp_path / mx.__name__
        d.mkdir()
        mx.profiler.set_config(filename=str(d / "profile.json"))
        mx.profiler.set_state("run")
        (mx.nd.ones((4,), ctx=mx.cpu()) * 2).asnumpy()
        mx.profiler.set_state("stop")
        out = mx.profiler.dump()
        names[mx] = os.path.relpath(out, str(d))
        with open(out) as f:
            events = json.load(f)["traceEvents"]
        assert events and all(e["pid"] == 1 for e in events)
        assert [e["args"]["name"] for e in events
                if e.get("ph") == "M" and e["name"] == "process_name"] \
            == ["rank 1"]
    assert names[tmx] == names[jmx] == "profile_rank1.json"
    # set_rank wins over the launcher env, as the dist store needs
    tmx.profiler.set_rank(3, 4)
    try:
        assert tmx.profiler._dist_info() == (3, 4)
    finally:
        tmx.profiler.set_rank(None)


def test_counter_marker_domain_event_shapes(tmp_path):
    shapes = {}
    for mx in (jmx, tmx):
        path = str(tmp_path / ("%s.json" % mx.__name__))
        p = mx.profiler
        p.set_config(filename=path)
        p.set_state("run")
        domain = p.Domain("app")
        ctr = domain.new_counter("requests", 10)
        ctr.increment(5)
        ctr -= 3
        assert ctr.value == 12
        domain.new_marker("phase_end").mark(scope="thread")
        p.Marker(None, "tick").mark(scope="global")
        p.set_state("stop")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        shapes[mx] = [
            (e["ph"], e["name"], e["cat"], sorted(e),
             e.get("args"), e.get("s"))
            for e in events if e["ph"] in ("C", "i")]
    assert shapes[tmx] == shapes[jmx]
    assert [s[4]["requests"] for s in shapes[tmx] if s[0] == "C"] == \
        [10, 15, 12]


def test_memory_counters_on_the_cpu(tmp_path):
    """profile_memory on the CPU: the live NDArrays' bytes, sampled
    around forward and backward, the peak monotone."""
    path = str(tmp_path / "mem.json")
    tmx.profiler.set_config(filename=path, profile_memory=True)
    tmx.profiler.set_state("run")
    fc = tmx.sym.FullyConnected(tmx.sym.Variable("data"), name="fc",
                                num_hidden=4)
    exe = fc.simple_bind(ctx=tmx.cpu(), data=(2, 8))
    exe.forward(is_train=True)
    exe.backward(out_grads=tmx.nd.ones((2, 4), ctx=tmx.cpu()))
    tmx.profiler.set_state("stop")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    in_use = [e["args"][e["name"]] for e in events
              if e["name"] == "memory:bytes_in_use"]
    peak = [e["args"][e["name"]] for e in events
            if e["name"] == "memory:peak_bytes_in_use"]
    assert len(in_use) == len(peak) == 4
    assert min(in_use) >= (8 * 4 + 4 + 2 * 8) * 4
    assert peak == sorted(peak) and max(in_use) <= peak[-1]


def test_merge_traces_merges_two_port_rank_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    paths = []
    for rank in (0, 1):
        monkeypatch.setenv("DMLC_WORKER_ID", str(rank))
        tmx.profiler.set_config(filename=str(tmp_path / "profile.json"))
        tmx.profiler.set_state("run")
        a = tmx.nd.ones((4, 4), ctx=tmx.cpu())
        tmx.nd.dot(a, a).asnumpy()
        kv = tmx.kv.create("local")
        kv.init(3, a)
        kv.push(3, a)
        tmx.profiler.set_state("stop")
        paths.append(tmx.profiler.dump())
    assert [os.path.basename(p) for p in paths] == \
        ["profile_rank0.json", "profile_rank1.json"]
    out = str(tmp_path / "merged.json")
    merge_traces.merge_files(paths, out)
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    assert sorted({e["pid"] for e in events}) == [0, 1]
    for rank in (0, 1):
        lane = [e["name"] for e in events if e["pid"] == rank]
        assert lane.count("dot") == 1 and lane.count("KVStore::Push") == 1


def test_the_phase_table_reads_the_traceview_summary(monkeypatch):
    from mxnet_tpu_torch.traceview import capture

    rows = tmx.profiler.summary()["phases"]
    assert all(r["source"] == "spans" for r in rows)
    fake = {"phases": {"forward": {"total_s": 2.0, "pct_of_step": 40.0,
                                   "p50_s": 1.0, "p99_s": 1.0},
                       "backward": {"total_s": 3.0, "pct_of_step": 60.0,
                                    "p50_s": 1.5, "p99_s": 1.5}}}
    monkeypatch.setattr(capture._tracer, "_summary", fake)
    rows = tmx.profiler.summary()["phases"]
    assert [(r["phase"], r["source"]) for r in rows] == \
        [("backward", "trace"), ("forward", "trace")]


def _drain(it):
    n = 0
    while True:
        try:
            it.next()
        except StopIteration:
            return n
        n += 1


def test_the_input_tier_stamps_the_jax_package_lanes(tmp_path):
    """The decode pool's ``io:decode`` lanes (a trace lane a worker,
    named in the dump), the fetch spans and ``PrefetchingIter::wait``,
    in both packages over the same data."""
    from mxnet_tpu import io_pipeline as jiop
    from mxnet_tpu_torch import io_pipeline as tiop

    X = np.arange(96, dtype=np.float32).reshape(48, 2)
    Y = np.arange(48, dtype=np.float32)
    got = {}
    for mx, iop in ((jmx, jiop), (tmx, tiop)):
        path = str(tmp_path / ("%s.json" % mx.__name__))
        mx.profiler.set_config(filename=path)
        mx.profiler.set_state("run")
        fn = iop.make_ndarray_iter_fn(X, Y, batch_size=4,
                                      last_batch_handle="discard")
        with iop.InputPipeline(fn, num_workers=2, device=False) as p:
            assert _drain(p) == 12
        assert _drain(mx.io.PrefetchingIter(
            mx.io.NDArrayIter(X, Y, batch_size=8))) == 6
        mx.profiler.set_state("stop")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        decode = [e for e in events if e.get("name") == "io:decode"]
        lanes = {e["tid"]: e["args"]["name"] for e in events
                 if e.get("ph") == "M" and e["name"] == "thread_name"
                 and e["tid"] >= 100}
        got[mx] = (_spans(events), sorted({e["tid"] for e in decode}),
                   lanes, sorted(e["args"]["worker"] for e in decode))
    assert got[tmx] == got[jmx]
    spans, tids, lanes, _ = got[tmx]
    assert spans[("io", "io:decode")] == 12 and tids == [100, 101]
    assert lanes == {100: "io:decode-worker 0", 101: "io:decode-worker 1"}
    assert spans[("io", "PrefetchingIter::wait")] >= 6


def test_the_device_stage_stamps_wait_and_device_put(tmp_path):
    from mxnet_tpu_torch import io_pipeline as tiop

    X = np.arange(96, dtype=np.float32).reshape(48, 2)
    path = str(tmp_path / "dev.json")
    tmx.profiler.set_config(filename=path)
    tmx.profiler.set_state("run")
    fn = tiop.make_ndarray_iter_fn(X, np.arange(48, dtype=np.float32),
                                   batch_size=8)
    with tiop.InputPipeline(fn, num_workers=1, device="cpu") as p:
        assert _drain(p) == 6
    tmx.profiler.set_state("stop")
    with open(path) as f:
        spans = _spans(json.load(f)["traceEvents"])
    assert spans[("io", "io:wait")] == 7           # 6 batches + the end
    assert spans[("io", "io:device_put")] == 6
    assert spans[("io", "io:decode")] == 6
    assert spans[("io", "InputPipeline::next")] == 6
