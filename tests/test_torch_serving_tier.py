"""Parity of the port's serving tier (``mxnet_tpu_torch.serving``: the
predictor runtime, the metrics, the request tracer, the generation
engine's whole-batch mode and the load generator) with the JAX
package's, on the CPU at small size.  Both packages get the same numpy
inputs from a seed.

Tolerances, per test: demo-runtime logits 1e-6 in float32 (the same
two GEMMs and a tanh) and 2e-2 of the row's largest magnitude in bf16
(argmax compared where the top-2 gap exceeds it); padded against
unpadded 1e-6; stub generation, metrics counts, attribution strings and
offered request sizes exactly; greedy tokens of the real generator
exactly (fp64 against the JAX dense reference); arrival offsets within
50 ms of their schedule.
"""
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import diagnostics as jdiag
from mxnet_tpu import serving as jserving
from mxnet_tpu.serving import __main__ as jmain
from mxnet_tpu.serving import reqtrace as jreqtrace
from mxnet_tpu.transformer import model as jm
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import diagnostics as tdiag
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.serving import __main__ as tmain
from mxnet_tpu_torch.serving import reqtrace as treqtrace
from mxnet_tpu_torch.transformer import model as tm


def test_the_public_surface_covers_the_jax_package():
    assert set(jserving.__all__) <= set(tserving.__all__)
    public = {n for n in dir(jserving.ModelServer) if not n.startswith("_")}
    assert public <= set(dir(tserving.ModelServer))
    for mod in ("batching", "bucket_ladder", "errors", "generate", "http",
                "kvcache", "loadgen", "reqtrace", "runtime", "server"):
        jm_ = getattr(jserving, mod, None) or __import__(
            "mxnet_tpu.serving." + mod, fromlist=["_"])
        tm_ = __import__("mxnet_tpu_torch.serving." + mod, fromlist=["_"])
        assert set(getattr(jm_, "__all__", [])) <= set(
            getattr(tm_, "__all__", [])), mod


# ------------------------------------------------------------- runtime
@pytest.mark.parametrize("max_batch,sizes", [
    (1, None), (6, None), (32, None), (33, None), (16, [4, 8, 4]),
    (8, [3]), (64, [1, 5, 40]), (2, [7])])
def test_plan_batch_buckets_equal_jax(max_batch, sizes):
    assert tserving.plan_batch_buckets(max_batch, sizes) == \
        jserving.plan_batch_buckets(max_batch, sizes)


def _demo_pair(compute_dtype, max_batch=8, seed=0):
    j = jserving.demo_runtime(max_batch=max_batch, seed=seed,
                              compute_dtype=compute_dtype)
    t = tserving.demo_runtime(max_batch=max_batch, seed=seed,
                              compute_dtype=compute_dtype, device="cpu")
    j.compile(warmup=False)
    t.compile(warmup=True)
    return j, t


def test_demo_runtime_float32_matches():
    j, t = _demo_pair(None)
    assert t.plan == j.plan and t.compiled
    x = np.random.RandomState(0).randn(7, 16).astype(np.float32)
    jc, jl = j.execute(x)
    tc, tl = t.execute(x)
    assert tc.shape == (7,) and tl.shape == (7, 4)
    assert isinstance(tc, np.ndarray) and isinstance(tl, np.ndarray)
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=0, atol=1e-6)


def test_demo_runtime_bf16_matches():
    j, t = _demo_pair("bfloat16")
    assert t._params["w1"].dtype == torch.bfloat16
    x = np.random.RandomState(1).randn(32, 16).astype(np.float32) * 3
    jc, jl = j.execute(x[:8])
    tc, tl = t.execute(x[:8])
    jl = np.asarray(jl, dtype=np.float64)
    scale = np.abs(jl).max(axis=1, keepdims=True)
    assert (np.abs(tl - jl) <= 2e-2 * scale).all()
    top2 = np.sort(jl, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2e-2 * scale[:, 0]
    assert clear.any()
    np.testing.assert_array_equal(tc[clear], np.asarray(jc)[clear])


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_padded_equals_unpadded(compute_dtype):
    _, t = _demo_pair(compute_dtype)
    x = np.random.RandomState(2).randn(5, 16).astype(np.float32)
    cls5, logits5 = t.execute(x)             # padded to the 8 bucket
    for i in range(5):
        cls1, logits1 = t.execute(x[i:i + 1])  # bucket 1, no padding
        assert int(cls1[0]) == int(cls5[i])
        np.testing.assert_allclose(logits1[0], logits5[i], rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_checkpoint_serves_in_both_packages(tmp_path, writer):
    """The checkpoint directory is the bridge: a step written by either
    package serves through the other's ``ModelRuntime.from_checkpoint``
    with the same predictions."""
    from mxnet_tpu import checkpoint as jck
    from mxnet_tpu_torch import checkpoint as tck

    d = str(tmp_path)
    params = jserving.demo_params(seed=5)
    (jck if writer == "jax" else tck).save_checkpoint(d, 2, params=params)

    def japply(p, aux, x):
        h = jnp.tanh(x @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    def tapply(p, aux, x):
        h = torch.tanh(x @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    j = jserving.ModelRuntime.from_checkpoint(
        "ck", d, japply, sample_shape=(16,), max_batch=4,
        compute_dtype=None)
    t = tserving.ModelRuntime.from_checkpoint(
        "ck", d, tapply, sample_shape=(16,), max_batch=4,
        compute_dtype=None, device="cpu")
    assert "step2" in t.source
    x = np.random.RandomState(3).randn(3, 16).astype(np.float32)
    np.testing.assert_allclose(t.execute(x), np.asarray(j.execute(x)),
                               rtol=0, atol=1e-6)


# ------------------------------------------------------------- metrics
def _serve_family_delta(diag, before, after):
    """mxnet_serve_* families that moved: {(name+labels): value/count}."""
    out = {}
    for key, m in after["metrics"].items():
        if not key.startswith("mxnet_serve_"):
            continue
        prev = before["metrics"].get(key)
        if m["type"] == "counter":
            v = m["value"] - (prev["value"] if prev else 0.0)
        elif m["type"] == "histogram":
            v = m["count"] - (prev["count"] if prev else 0)
        else:  # gauges: the new families and labels, not the value
            v = "set" if prev is None else 0
        if v:
            out[key] = v
    return out


def _drive_stub_traffic(pkg, main, diag):
    """One deterministic request sequence: serial predicts (one batch
    each), a failing model, shed requests, and stub generations."""
    x = np.ones((1, 2), dtype="float32")
    srv = pkg.ModelServer(queue_max=8, max_batch=2, batch_deadline_ms=1,
                          default_deadline_ms=10_000, breaker_n=5)
    srv.add_model(main._StubRuntime("pm_ok", max_batch=2))
    srv.add_model(main._StubRuntime("pm_bad", fail=True, max_batch=2))
    srv.add_generator(pkg.StubGenerationRuntime(
        "pm_gen", slots=2, max_prompt=16, max_context=32, block_tokens=16,
        max_new=8, prefill_batch=2))
    for n in (1, 2, 1):
        srv.submit("pm_ok", np.ones((n, 2), dtype="float32")).wait(10.0)
    for _ in range(2):
        with pytest.raises(pkg.ExecutorFailure):
            srv.submit("pm_bad", x).wait(10.0)
    for bad in (lambda: srv.submit("pm_ok", np.ones((1, 5))),
                lambda: srv.submit("pm_ok", np.ones((3, 2))),
                lambda: srv.submit("pm_none", x),
                lambda: srv.submit_generation("pm_gen", [])):
        with pytest.raises(pkg.Rejected):
            bad()
    for p in ([1, 2, 3], [4, 5]):
        srv.submit_generation("pm_gen", p, max_new=4).wait(10.0)
    srv.drain(timeout_s=10.0)


def test_metrics_match_through_both_servers():
    delta = {}
    for name, pkg, main, diag in (("jax", jserving, jmain, jdiag),
                                  ("port", tserving, tmain, tdiag)):
        before = diag.metrics.dump_json()
        _drive_stub_traffic(pkg, main, diag)
        delta[name] = _serve_family_delta(diag, before,
                                          diag.metrics.dump_json())
    assert delta["port"] == delta["jax"]
    want = 'mxnet_serve_requests_total{model="pm_ok",outcome="ok",' \
        'version="v1"}'
    assert delta["port"][want] == 3
    assert delta["port"]['mxnet_serve_gen_tokens_total{model="pm_gen",'
                         'version="v1"}'] == 8
    text = tdiag.metrics.to_prom()
    assert not tdiag.validate_prom_text(text)
    assert not jdiag.validate_prom_text(text)


# ------------------------------------------------------------ reqtrace
class _Req:
    def __init__(self, rid, err=None):
        self.id, self.error = rid, err


def _trace_script(mod):
    tr = mod.RequestTraceRecorder(capacity=8, topk=3, window_s=60.0)
    tr.begin("a", "m")
    tr.phase("a", "queue", 0.002)
    tr.event("a", "batch_formed", bucket=4, co_riders=["b"])
    tr.phase("a", "execute", 0.020)
    tr.finish(_Req("a"))
    tr.begin("b", "m")
    tr.cache_wait("b")
    tr.event("b", "evicted", blocks=2)
    tr.phase("b", "prefill", 0.010)
    tr.tick("m", 0.04, ["b"], injected={"kind": "stall_decode_tick",
                                         "ms": 40})
    tr.finish(_Req("b", RuntimeError("x")))
    tr.reject("c", "m", "queue_full")
    tr.set_slots("m", 2)
    tr.slot_acquire("m", 1, "a")
    tr.slot_release("m", 1)
    return tr


def test_reqtrace_records_and_attribution_match():
    jt, tt = _trace_script(jreqtrace), _trace_script(treqtrace)
    jr, tr_ = list(jt._ring), list(tt._ring)
    assert len(jr) == len(tr_) == 3
    for a, b in zip(jr, tr_):
        assert set(a) == set(b)
        for k in ("id", "model", "outcome", "phases", "events",
                  "injected_any"):
            assert a.get(k) == b.get(k), k
        # attribution is a pure function of the record: pin the total
        # (the one wall-clock-dependent field) to the same value
        fa, fb = dict(a, total_s=0.1), dict(b, total_s=0.1)
        assert jreqtrace.attribution(fa) == treqtrace.attribution(fb)
        assert jreqtrace.dominant_phase(fa) == \
            treqtrace.dominant_phase(fb)
    fixed = [dict(r, total_s=0.1) for r in tr_ if "phases" in r]
    assert treqtrace.attribution_shares(fixed) == \
        jreqtrace.attribution_shares(fixed)
    js, ts = jt.snapshot(), tt.snapshot()
    assert set(js) == set(ts)
    assert set(js["header"]) == set(ts["header"])
    assert set(js["models"]) == set(ts["models"])
    assert [e["name"] for e in js["slot_timeline"]["traceEvents"]] == \
        [e["name"] for e in ts["slot_timeline"]["traceEvents"]]
    # which request is the worst sample, and its value, is timing
    def series(lines):
        return [ln.split(" request_id=")[0] for ln in lines]
    assert series(jt.exemplar_prom_lines()) == \
        series(tt.exemplar_prom_lines())


# ----------------------------------------------------------- generation
STUB = dict(slots=2, max_prompt=16, max_context=64, block_tokens=16,
            max_new=16, prefill_batch=2)
WORK = [([3, 9, 4], 2), ([7] * 11, 9), ([1, 2], 14), ([5, 6, 7, 8], 3),
        ([2] * 16, 6), ([9, 9], 12)]


def _jax_engine_run(continuous):
    rt = jserving.StubGenerationRuntime("tick_j", continuous=continuous,
                                        **STUB)
    rt.compile()
    calls = []
    for table, kind in ((rt._prefill, "prefill"), (rt._decode, "decode")):
        for cell, w in list(table.items()):
            def rec(*a, _w=w, _c=cell, _k=kind):
                calls[-1].append((_k, _c))
                return _w(*a)
            table[cell] = rec
    reqs = [jserving.GenRequest("tick_j", p, n) for p, n in WORK]
    return _run_engine(rt.engine, reqs, calls)


def _port_engine_run(continuous):
    rt = tserving.StubGenerationRuntime("tick_t", continuous=continuous,
                                        **STUB)
    rt.compile()
    calls = []
    for kind in ("prefill", "decode"):
        fn = getattr(rt, kind)

        def rec(tokens, a, tables, _fn=fn, _k=kind):
            cell = (int(tokens.shape[0]), int(tokens.shape[1]) if _k ==
                    "prefill" else int(tables.shape[1]) * rt.block_tokens)
            calls[-1].append((_k, cell))
            return _fn(tokens, a, tables)
        setattr(rt, kind, rec)
    reqs = [tserving.GenRequest("tick_t", p, n) for p, n in WORK]
    return _run_engine(rt.engine, reqs, calls)


def _run_engine(engine, reqs, calls):
    for r in reqs:
        engine.enqueue(r)
    while not engine.idle():
        calls.append([])
        rep = engine.step()
        assert rep["exec_error"] is None
        assert len(calls) < 200
    assert engine.kv.stats()["blocks_live"] == 0
    return [r.tokens for r in reqs], calls


@pytest.mark.parametrize("continuous", [True, False])
def test_stub_engine_is_tick_for_tick_equal(continuous):
    jtoks, jcalls = _jax_engine_run(continuous)
    ttoks, tcalls = _port_engine_run(continuous)
    assert ttoks == jtoks
    assert ttoks == [tserving.stub_greedy_reference(p, n) for p, n in WORK]
    assert tcalls == jcalls
    prefills = sum(1 for t in tcalls for k, _ in t if k == "prefill")
    # six requests on two slots: whole-batch admits three full pairs;
    # continuous refills each slot as it frees
    assert prefills == (5 if continuous else 3)
    if not continuous:
        # whole-batch: nothing is admitted while any rider decodes
        for tick in tcalls:
            assert [k for k, _ in tick].count("prefill") <= 1


CFG = dict(vocab_size=64, n_layers=2, d_model=32, n_heads=2, d_ff=64,
           dtype="float64", param_dtype="float64")


def _dense_greedy(jparams, jcfg, prompt, n_new, span=64):
    fwd = jax.jit(lambda p, t: jm.apply(p, t, jcfg,
                                        attn_fn=jm.dense_causal_attn))
    toks = [int(t) for t in prompt]
    out = []
    for _ in range(n_new):
        buf = np.zeros((1, span), dtype=np.int32)
        buf[0, :len(toks)] = toks
        nxt = int(np.asarray(fwd(jparams, jnp.asarray(buf)))[
            0, len(toks) - 1].argmax())
        out.append(nxt)
        toks.append(nxt)
    return out


def test_whole_batch_generator_matches_jax_dense_reference():
    jcfg = jm.TransformerConfig(**CFG)
    jparams = jm.init_params(jax.random.PRNGKey(4), jcfg)
    tparams = convert.params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    rt = tserving.GenerationRuntime(
        "wb", tparams, tm.TransformerConfig(**CFG), slots=2,
        block_tokens=16, max_prompt=16, max_context=64, max_new=24,
        prefill_batch=2, continuous=False, device="cpu")
    srv = tserving.ModelServer(default_deadline_ms=None)
    srv.add_generator(rt)
    try:
        rng = np.random.RandomState(6)
        prompts = [rng.randint(1, 64, size=n).tolist() for n in (5, 14, 3)]
        news = (20, 6, 12)
        reqs = [srv.submit_generation("wb", p, max_new=n)
                for p, n in zip(prompts, news)]
        for p, n, r in zip(prompts, news, reqs):
            assert r.wait(120.0)["tokens"] == \
                _dense_greedy(jparams, jcfg, p, n)
    finally:
        assert srv.drain(timeout_s=30.0)["left"] == 0


# -------------------------------------------------------------- loadgen
class _RecordingServer:
    """Answers every submit at once and records what was offered."""

    def __init__(self, pkg):
        self.pkg = pkg
        self._lock = threading.RLock()
        rt = types.SimpleNamespace(
            sample_shape=(3,), max_prompt=16, max_new=8,
            cfg=types.SimpleNamespace(vocab_size=64))
        self._models = {"m": types.SimpleNamespace(runtime=rt)}
        self.default_deadline_s = 1.0
        self.offers = []

    def submit(self, model, data, deadline_ms="default"):
        self.offers.append((time.monotonic(), np.asarray(data).shape))
        r = self.pkg.Request(model, data, len(data))
        r.set_result(np.zeros(len(data)))
        return r

    def submit_generation(self, model, prompt, max_new=None,
                          deadline_ms="default"):
        self.offers.append((time.monotonic(), list(map(int, prompt)),
                            max_new))
        r = self.pkg.GenRequest(model, prompt, max_new)
        for t in range(max_new):
            r._emit(t)
        r.set_result({"tokens": list(r.tokens)})
        return r


@pytest.mark.parametrize("kind", ["predict", "generate"])
def test_loadgen_offers_the_same_requests(kind):
    offers = {}
    for name, pkg in (("jax", jserving), ("port", tserving)):
        srv = _RecordingServer(pkg)
        if kind == "predict":
            rep = pkg.run_load(srv, "m", qps=50, duration_s=0.3,
                               batch_n=2)
        else:
            rep = pkg.run_generation_load(srv, "m", qps=50,
                                          duration_s=0.3, seed=3)
        assert rep["offered"] == 15 and rep["ok"] == 15, rep
        t0 = srv.offers[0][0]
        offers[name] = [(t - t0,) + tuple(rest)
                        for t, *rest in srv.offers]
    assert [o[1:] for o in offers["port"]] == \
        [o[1:] for o in offers["jax"]]
    for i, (off, *_r) in enumerate(offers["port"]):
        assert abs(off - i / 50.0) < 0.05, (i, off)
