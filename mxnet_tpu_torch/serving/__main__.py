"""CLI: ``python -m mxnet_tpu_torch.serving --self-test`` and
``--serve`` (HTTP front-end over the demo models, SIGTERM-drainable).

Counterpart: ``mxnet_tpu/serving/__main__.py``.  ``--device {cuda,cpu}``
(default ``cuda``) places the real demo models; without a card the
default raises and names the flag.  The self-test's stub runtimes are
host-only wherever ``--device`` points.

The self-test drives the robustness layer through stub runtimes whose
failure modes are deterministic (an executor gated on an Event, one
that always raises) so queue admission, deadline expiry, breaker
trip/reset and drain ordering are asserted without timing luck.
"""
from __future__ import annotations

import json
import sys
import threading
import time
from typing import Dict

from .batching import Request  # noqa: F401  (re-exported surface)
from .errors import DeadlineExceeded, ExecutorFailure, Rejected
from .runtime import demo_runtime, plan_batch_buckets
from .server import ModelServer


class _StubRuntime:
    """Deterministic executor for the self-test: optionally gated on an
    Event (a 'slow' executor the tests release), optionally failing."""

    def __init__(self, name: str, fail: bool = False,
                 gate: threading.Event = None, max_batch: int = 8):
        self.name = name
        self.sample_shape = (2,)
        self.max_batch = max_batch
        self.plan = plan_batch_buckets(max_batch)
        self.compiled = True
        self.fail = fail
        self.gate = gate
        self.executed_samples = 0
        self.executed_batches = 0

    def bucket_for(self, n: int) -> int:
        for b in self.plan:
            if n <= b:
                return b
        raise ValueError(n)

    def execute(self, batch):
        if self.gate is not None:
            self.gate.wait(10.0)
        if self.fail:
            raise ExecutorFailure("stub %r always fails" % self.name)
        import numpy as np

        arr = np.asarray(batch)
        self.executed_samples += int(arr.shape[0])
        self.executed_batches += 1
        return arr.sum(axis=-1)


def _self_test(device: str = "cuda") -> tuple:
    import numpy as np

    checks: Dict[str, bool] = {}
    x = np.ones((1, 2), dtype="float32")

    # 1) bucket ladder + padding correctness on the REAL runtime: a
    # single sample answers identically however it is padded
    rt = demo_runtime(max_batch=8, device=device)
    checks["bucket_ladder"] = plan_batch_buckets(32) == (1, 2, 4, 8, 16,
                                                        32)
    rt.compile(warmup=True)
    checks["aot_compiled_all_buckets"] = rt.compiled and \
        set(rt.compile_stats()) == {1, 2, 4, 8}
    one = np.random.RandomState(3).randn(1, 16).astype("float32")
    cls1, logits1 = rt.execute(one)
    _, logits5 = rt.execute(np.concatenate([one] * 5))
    # padding rows never reach a real row: five samples padded to the
    # 8-bucket answer exactly as inside a full batch of 8.  Across
    # buckets (1 vs 8) the card's GEMMs may round bf16 differently, so
    # that comparison allows bf16 rounding of the row (and the class,
    # whose top-2 gap here is ~1 % of the row, may flip with it)
    eight = np.random.RandomState(4).randn(8, 16).astype("float32")
    full = rt.execute(eight)
    padded = rt.execute(eight[:5])
    scale = float(np.abs(np.float64(logits5[0])).max()) or 1.0
    checks["padding_is_invisible"] = (
        cls1.shape == (1,) and logits5.shape[0] == 5
        and np.array_equal(padded[0], full[0][:5])
        and np.array_equal(padded[1], full[1][:5])
        and np.allclose(np.float64(logits1[0]), np.float64(logits5[0]),
                        rtol=0, atol=2.0 ** -7 * scale))

    # 2) queue admission: a gated executor wedges the worker; the
    # bounded queue sheds the overflow with queue_full + retry-after.
    # 8 submits against (<=2 riding the wedged batch + 3 queue slots):
    # at least 3 MUST shed whatever the take/submit interleaving
    gate = threading.Event()
    gated = _StubRuntime("gated", gate=gate, max_batch=2)
    srv = ModelServer(queue_max=3, max_batch=2, batch_deadline_ms=1,
                      default_deadline_ms=10_000, breaker_n=2,
                      breaker_reset_s=0.2)
    srv.add_model(gated)
    reqs, n_shed = [], 0
    for _ in range(8):
        try:
            reqs.append(srv.submit("gated", x))
        except Rejected as e:
            n_shed += 1
            checks.setdefault("shed_reason_queue_full",
                              e.reason == "queue_full"
                              and e.retry_after_s is not None)
    checks["shed_happened"] = n_shed >= 3
    checks["admitted_bounded"] = len(reqs) <= 5
    gate.set()  # release the worker
    outcomes = []
    for r in reqs:
        try:
            r.wait(10.0)
            outcomes.append("ok")
        except Exception as e:
            outcomes.append(type(e).__name__)
    checks["admitted_complete_on_release"] = all(
        o == "ok" for o in outcomes)

    # 3) deadline expiry: a request whose deadline passes while it is
    # QUEUED behind a wedged batch fails with DeadlineExceeded and is
    # never executed (purged before dispatch, not batched)
    gate3 = threading.Event()
    wedge_rt = _StubRuntime("wedge", gate=gate3, max_batch=2)
    srv_b = ModelServer(queue_max=8, max_batch=2, batch_deadline_ms=1,
                        default_deadline_ms=10_000)
    srv_b.add_model(wedge_rt)
    blocker = srv_b.submit("wedge", x)  # rides alone, wedges the worker
    time.sleep(0.05)                    # let the batcher take it
    victim = srv_b.submit("wedge", x, deadline_ms=30)
    time.sleep(0.08)                    # victim expires in the queue
    gate3.set()
    try:
        blocker.wait(10.0)
        checks["blocker_completes"] = True
    except Exception:
        checks["blocker_completes"] = False
    try:
        victim.wait(5.0)
        checks["deadline_expired_fails"] = False
    except DeadlineExceeded:
        checks["deadline_expired_fails"] = True
    except Exception:
        checks["deadline_expired_fails"] = False
    checks["expired_never_executed"] = wedge_rt.executed_samples == 1

    # 4) breaker: consecutive failures (one per batch: each submit is
    # waited before the next) trip it; submits fast-fail with
    # breaker_open; after reset_s the half-open probe (healthy again)
    # closes it
    flaky = _StubRuntime("flaky", fail=True, max_batch=2)
    srv2 = ModelServer(queue_max=8, max_batch=2, batch_deadline_ms=1,
                       default_deadline_ms=10_000, breaker_n=2,
                       breaker_reset_s=0.15)
    srv2.add_model(flaky)
    for _ in range(2):
        try:
            r = srv2.submit("flaky", x)
            try:
                r.wait(10.0)
            except ExecutorFailure:
                pass
        except Rejected:
            pass
    deadline = time.monotonic() + 5.0
    while srv2._get("flaky").breaker.state() == "closed" and \
            time.monotonic() < deadline:
        time.sleep(0.005)
    checks["breaker_trips"] = \
        srv2._get("flaky").breaker.state() != "closed"
    try:
        srv2.submit("flaky", x)
        checks["breaker_fast_fails"] = False
    except Rejected as e:
        checks["breaker_fast_fails"] = e.reason == "breaker_open"
    time.sleep(0.2)  # reset window passes -> half-open probe allowed
    flaky.fail = False
    try:
        probe = srv2.submit("flaky", x)
        probe.wait(10.0)
        checks["breaker_probe_closes"] = \
            srv2._get("flaky").breaker.state() == "closed"
    except Exception:
        checks["breaker_probe_closes"] = False

    # 5) drain ordering: queued work completes, post-drain submits shed
    # with reason=draining, drain reports zero left
    slow = _StubRuntime("slow", max_batch=4)
    srv3 = ModelServer(queue_max=16, max_batch=4, batch_deadline_ms=1,
                       default_deadline_ms=10_000)
    srv3.add_model(slow)
    pend = [srv3.submit("slow", x) for _ in range(9)]
    rep = srv3.drain(timeout_s=10.0)
    checks["drain_zero_left"] = rep["drained"] and rep["left"] == 0
    checks["drain_completes_admitted"] = all(r.done() and r.error is None
                                             for r in pend)
    checks["drain_executed_all_samples"] = slow.executed_samples == 9
    try:
        srv3.submit("slow", x)
        checks["post_drain_sheds"] = False
    except Rejected as e:
        checks["post_drain_sheds"] = e.reason == "draining"
    checks["drained_not_live"] = not srv3.live()

    # 6) probes + prom exposition: ready flips with drain, and the
    # registry renders valid prom text including the serving counters
    from .. import diagnostics as _diag

    srv4 = ModelServer(queue_max=4, max_batch=2, batch_deadline_ms=1)
    srv4.add_model(_StubRuntime("probe", max_batch=2))
    checks["ready_when_compiled"] = srv4.ready()["ready"] is True
    checks["live_when_healthy"] = srv4.live() is True
    srv4.drain(timeout_s=5.0)
    checks["not_ready_when_draining"] = srv4.ready()["ready"] is False
    text = _diag.metrics.to_prom()
    checks["prom_valid"] = not _diag.validate_prom_text(text)
    checks["prom_has_shed_counter"] = "mxnet_serve_rejected_total" in text
    checks["prom_has_latency_quantiles"] = \
        "mxnet_serve_latency_seconds_p99" in text

    # 7) live reload hot swap: a new version canaries, promotes, and
    # future requests answer from it — with every request during the
    # swap answered (zero admitted dropped)
    v1 = _StubRuntime("swap", max_batch=2)
    srv5 = ModelServer(queue_max=32, max_batch=2, batch_deadline_ms=1,
                       default_deadline_ms=10_000, canary_pct=50,
                       canary_min_n=4)
    srv5.add_model(v1)
    v2 = _StubRuntime("swap", max_batch=2)
    v2.offset = 100.0  # distinguishable output

    def _offset_exec(rt):
        base = rt.execute

        def run(batch):
            return base(batch) + getattr(rt, "offset", 0.0)
        return run
    v2.execute = _offset_exec(v2)
    srv5.reload("swap", runtime=v2)
    answered = 0
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        srv5.submit("swap", x).wait(10.0)
        answered += 1
        if srv5.reload_status("swap")["state"] == "promoted":
            break
    st = srv5.reload_status("swap")
    checks["reload_promotes"] = st["state"] == "promoted"
    checks["reload_zero_dropped"] = answered > 0
    out = srv5.submit("swap", x).wait(10.0)
    checks["reload_serves_new_version"] = float(out[0]) == 102.0
    checks["reload_version_bumped"] = \
        srv5.stats()["swap"]["version"] == 2

    # 8) canary rollback: a new version that always fails never hurts
    # a caller (failed canary batches re-execute on stable), and the
    # decision rolls back with the counter incremented
    rb_before = _diag.metrics.counter(
        "mxnet_serve_rollbacks_total", labels={"model": "swap"}).value
    bad = _StubRuntime("swap", fail=True, max_batch=2)
    srv5.reload("swap", runtime=bad)
    ok_during = 0
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        r = srv5.submit("swap", x)
        try:
            r.wait(10.0)
            ok_during += 1
        except Exception:
            pass
        if srv5.reload_status("swap")["state"] in ("rolled_back",
                                                   "promoted"):
            break
    st = srv5.reload_status("swap")
    checks["canary_rolls_back"] = st["state"] == "rolled_back"
    checks["canary_never_hurts_callers"] = ok_during > 0 and \
        st.get("canary_stats", {}).get("errors", 0) > 0
    checks["rollback_counter_incremented"] = _diag.metrics.counter(
        "mxnet_serve_rollbacks_total",
        labels={"model": "swap"}).value > rb_before
    checks["stable_still_serving"] = \
        float(srv5.submit("swap", x).wait(10.0)[0]) == 102.0

    # 9) checkpoint integrity wiring: the --verify CLI audits a demo
    # checkpoint clean, then detects a seeded bit flip naming the shard
    import os
    import tempfile

    from .. import checkpoint as _ckpt
    from .runtime import demo_params

    ckdir = tempfile.mkdtemp(prefix="mx-serve-selftest-ckpt-")
    _ckpt.save_checkpoint(ckdir, 1, params=demo_params())
    rep = _ckpt.verify_dir(ckdir)
    checks["ckpt_verify_clean"] = rep["ok"] and rep["n_verified"] == 1
    with open(_ckpt.shard_path(ckdir, 1, 0), "r+b") as f:
        f.seek(40)
        f.write(b"\xff\x00\xff\x00")
    rep = _ckpt.verify_dir(ckdir)
    checks["ckpt_verify_detects_corruption"] = (not rep["ok"]) and \
        rep["steps"][0]["corrupt"] == ["rank0.ckpt"]
    checks["ckpt_verify_cli_exit"] = _ckpt.main(["--verify", ckdir,
                                                 "--json"]) == 1

    # 10) generation tier: greedy decode through the paged-cache
    # continuous batcher matches the dense reference token for token,
    # slots refill mid-flight (more requests than slots all complete
    # in one server life), and every prefill/decode cell that traffic
    # reaches is one of the warmed plan cells.  All five generators here are
    # StubGenerationRuntime — the real engine/allocator/plans on a
    # host-only token rule, so the groups run in milliseconds; the
    # real-model numerics pins live in tests/test_torch_serving.py.
    from .generate import StubGenerationRuntime, stub_greedy_reference

    grt = StubGenerationRuntime("gen_st", slots=2, max_prompt=16,
                                max_context=32, block_tokens=16,
                                max_new=8, prefill_batch=2)
    gsrv = ModelServer(queue_max=16, default_deadline_ms=30_000)
    gsrv.add_generator(grt)
    checks["gen_ready"] = gsrv.ready()["ready"] is True
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 64, size=n).astype("int32")
               for n in (3, 10, 6, 14, 2)]  # 5 requests > 2 slots
    greqs = [gsrv.submit_generation("gen_st", p, max_new=6)
             for p in prompts]
    gres = [r.wait(30.0) for r in greqs]

    checks["gen_greedy_matches_dense_reference"] = all(
        res["tokens"] == stub_greedy_reference(p, 6)
        for p, res in zip(prompts, gres))
    checks["gen_continuous_slots_refill"] = \
        len(gres) == 5 and all(len(r["tokens"]) == 6 for r in gres)
    # eager torch compiles nothing: the counterpart of "zero steady-
    # state recompiles" is that traffic only reaches warmed plan cells
    gcells = {(k, c) for k in ("prefill", "decode")
              for c in (grt.prefill_plan if k == "prefill"
                        else grt.decode_plan)}
    checks["gen_traffic_only_in_warmed_cells"] = (
        grt.compiled and set(grt.cell_calls) <= gcells
        and len(grt.compile_stats()) == len(gcells))
    checks["gen_kv_blocks_reclaimed"] = \
        grt.kv.stats()["blocks_live"] == 0

    # 11) streaming + cancel: tokens cross the on_token callback in
    # result order (None marks end-of-stream); a cancel mid-stream
    # resolves the caller with Cancelled and reclaims every cache
    # block, with the co-riding sequence untouched
    crt = StubGenerationRuntime("gen_can", slots=2, max_prompt=16,
                                max_context=64, block_tokens=16,
                                max_new=32, prefill_batch=2)
    csrv = ModelServer(queue_max=16, default_deadline_ms=30_000)
    csrv.add_generator(crt)
    streamed = []
    sreq = csrv.submit_generation("gen_can", [1, 2, 3], max_new=5,
                                  on_token=streamed.append)
    sres = sreq.wait(30.0)
    checks["gen_streaming_order"] = \
        streamed == sres["tokens"] + [None]
    first_tok = threading.Event()
    victim = csrv.submit_generation(
        "gen_can", [4, 5], max_new=32,
        on_token=lambda t: (first_tok.set(), time.sleep(0.002)))
    rider = csrv.submit_generation("gen_can", [6, 7, 8], max_new=8)
    first_tok.wait(10.0)
    victim.cancel()
    try:
        victim.wait(10.0)
        checks["gen_cancel_resolves"] = False
    except Exception as ce:
        checks["gen_cancel_resolves"] = \
            type(ce).__name__ == "Cancelled"
    checks["gen_cancel_spares_corider"] = \
        len(rider.wait(30.0)["tokens"]) == 8
    deadline = time.monotonic() + 5.0
    while crt.kv.stats()["blocks_live"] and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    checks["gen_cancel_zero_leaked_blocks"] = \
        crt.kv.stats()["blocks_live"] == 0

    # 12) the robustness layer carries over: chaos fail_execute on the
    # generator trips its breaker (submits fast-fail breaker_open),
    # and a waiting sequence whose deadline passes while the only slot
    # is busy expires without executing
    import os

    from .. import chaos as _chaos

    brt = StubGenerationRuntime("gen_brk", slots=1, max_prompt=16,
                                max_context=32, block_tokens=16,
                                max_new=8, prefill_batch=1)
    bsrv = ModelServer(queue_max=16, default_deadline_ms=30_000,
                       breaker_n=2, breaker_reset_s=30.0)
    bsrv.add_generator(brt)
    _kn = "fail_execute:model=gen_brk,count=99"
    os.environ["MXNET_CHAOS"] = _kn
    _chaos.reset()
    try:
        for _ in range(2):
            fr = bsrv.submit_generation("gen_brk", [1, 2], max_new=2)
            try:
                fr.wait(15.0)
            except ExecutorFailure:
                pass
        deadline = time.monotonic() + 5.0
        while bsrv._get("gen_brk").breaker.state() == "closed" and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        checks["gen_breaker_trips"] = \
            bsrv._get("gen_brk").breaker.state() != "closed"
        try:
            bsrv.submit_generation("gen_brk", [1], max_new=1)
            checks["gen_breaker_fast_fails"] = False
        except Rejected as e:
            checks["gen_breaker_fast_fails"] = \
                e.reason == "breaker_open"
    finally:
        del os.environ["MXNET_CHAOS"]
        _chaos.reset()
    drt = StubGenerationRuntime("gen_dl", slots=1, max_prompt=16,
                                max_context=64, block_tokens=16,
                                max_new=48, prefill_batch=1)
    dsrv = ModelServer(queue_max=16, default_deadline_ms=30_000)
    dsrv.add_generator(drt)
    hog = dsrv.submit_generation(
        "gen_dl", [1, 2, 3], max_new=48,
        on_token=lambda t: time.sleep(0.005))  # ~240ms of decode ticks
    late = dsrv.submit_generation("gen_dl", [4, 5], max_new=2,
                                  deadline_ms=50)
    try:
        late.wait(15.0)
        checks["gen_waiting_deadline_expires"] = False
    except DeadlineExceeded:
        checks["gen_waiting_deadline_expires"] = True
    except Exception:
        checks["gen_waiting_deadline_expires"] = False
    checks["gen_hog_unaffected"] = \
        len(hog.wait(30.0)["tokens"]) == 48

    # 13) generation drain: queued + in-flight generations all finish,
    # zero left, post-drain submits shed with reason=draining
    qrt = StubGenerationRuntime("gen_dr", slots=2, max_prompt=16,
                                max_context=32, block_tokens=16,
                                max_new=8, prefill_batch=2)
    qsrv = ModelServer(queue_max=16, default_deadline_ms=30_000)
    qsrv.add_generator(qrt)
    dpend = [qsrv.submit_generation("gen_dr", [i + 1, i + 2],
                                    max_new=4) for i in range(5)]
    drep = qsrv.drain(timeout_s=20.0)
    checks["gen_drain_zero_left"] = \
        drep["drained"] and drep["left"] == 0
    checks["gen_drain_completes_admitted"] = all(
        r.done() and r.error is None and len(r.tokens) == 4
        for r in dpend)
    try:
        qsrv.submit_generation("gen_dr", [1], max_new=1)
        checks["gen_post_drain_sheds"] = False
    except Rejected as e:
        checks["gen_post_drain_sheds"] = e.reason == "draining"

    # 14) request tracing: ring wraparound, window top-K ordering,
    # injected-span tagging, prom exemplar validity, slot timeline —
    # then the E2E attribution pin: under stall_decode_tick chaos the
    # autopsy's slowest request names the injected phase dominant
    from . import reqtrace as _reqtrace

    class _FakeReq:
        def __init__(self, rid, err=None):
            self.id = rid
            self.error = err

    tr = _reqtrace.RequestTraceRecorder(capacity=4, topk=2,
                                        window_s=60.0)
    for i in range(6):
        rid = "r%d" % i
        tr.begin(rid, "m")
        tr.phase(rid, "execute", 0.01 * (i + 1))
        with tr._lock:  # age the record so totals are distinct
            tr._open[rid]["t0"] -= 0.01 * (i + 1)
        tr.finish(_FakeReq(rid))
    checks["reqtrace_ring_wraps"] = (
        len(tr._ring) == 4
        and [r["id"] for r in tr._ring] == ["r2", "r3", "r4", "r5"])
    rtop = tr.top_slowest()
    checks["reqtrace_topk_ordering"] = (
        [r["id"] for r in rtop] == ["r5", "r4"]
        and rtop[0]["total_s"] >= rtop[1]["total_s"])
    tr.begin("inj", "m")
    tr.tick("m", 0.05, ["inj"],
            injected={"kind": "stall_decode_tick", "ms": 40})
    tr.finish(_FakeReq("inj"))
    inj_rec = [r for r in tr._ring if r["id"] == "inj"][0]
    iname, _ishare, iinj = _reqtrace.dominant_phase(inj_rec)
    checks["reqtrace_injected_tagged"] = (
        iname == "stall:injected:stall_decode_tick" and iinj
        and inj_rec["injected_any"]
        and "[injected]" in _reqtrace.attribution(inj_rec))
    ex_lines = tr.exemplar_prom_lines()
    prom_ex = _diag.metrics.to_prom().rstrip("\n") + "\n" + \
        "\n".join(ex_lines) + "\n"
    checks["reqtrace_exemplar_prom_valid"] = (
        bool(ex_lines)
        and not _diag.validate_prom_text(prom_ex)
        and any("request_id=r5" in ln for ln in ex_lines))
    tr.set_slots("m", 2)
    tr.slot_acquire("m", 0, "r9")
    tr.slot_release("m", 0)
    tl = tr.slot_timeline()["traceEvents"]
    checks["reqtrace_slot_timeline"] = (
        any(e.get("ph") == "X" and e.get("cat") == "serving_slot"
            and e["name"] == "seq:r9" for e in tl)
        and any(e.get("ph") == "M" and e.get("name") == "thread_name"
                and e["args"]["name"] == "m/slot0" for e in tl))

    _reqtrace.reset(capacity=128, topk=4, window_s=60.0)
    ert = StubGenerationRuntime("gen_rq", slots=2, max_prompt=16,
                                max_context=64, block_tokens=16,
                                max_new=16, prefill_batch=2)
    esrv = ModelServer(queue_max=32, default_deadline_ms=30_000)
    esrv.add_generator(ert)
    _rq_kn = "stall_decode_tick:model=gen_rq,ms=25,count=999"
    os.environ["MXNET_CHAOS"] = _rq_kn
    _chaos.reset()
    try:
        # 2x slot capacity: the second wave queues behind the first,
        # and decodes long enough that its own injected stall time
        # dominates the wait it inherited
        ereqs = [esrv.submit_generation("gen_rq", [i + 1, i + 2],
                                        max_new=2 if i < 2 else 10)
                 for i in range(4)]
        for r in ereqs:
            r.wait(30.0)
    finally:
        del os.environ["MXNET_CHAOS"]
        _chaos.reset()
    eslow = _reqtrace.top_slowest(1)
    ename, eshare, einj = _reqtrace.dominant_phase(eslow[0]) \
        if eslow else (None, 0.0, False)
    checks["reqtrace_e2e_injected_dominant"] = (
        bool(eslow) and einj and eshare >= 0.5
        and ename == "stall:injected:stall_decode_tick")
    rq_dir = tempfile.mkdtemp(prefix="mx-serve-selftest-rq-")
    rq_path = _reqtrace.dump(
        path=os.path.join(rq_dir, "reqtrace_rank0.json"),
        reason="self_test")
    rq_payload = None
    if rq_path:
        with open(rq_path) as f:
            rq_payload = json.load(f)
    checks["reqtrace_dump_payload"] = bool(
        rq_payload
        and rq_payload["header"]["format"] == _reqtrace.REQTRACE_FORMAT
        and rq_payload["header"]["reason"] == "self_test"
        and any("stall:injected" in (r.get("attribution") or "")
                for r in rq_payload["slowest"]))
    _reqtrace.reset()  # back to the env-configured recorder

    return all(checks.values()), checks


def _serve(port: int, device: str = "cuda") -> int:
    """Demo server: the fixed-seed MLP and a one-layer transformer
    generator behind the HTTP front-end, SIGTERM-drainable via the
    shared preemption-hook path."""
    from .http import HttpFrontend

    from .generate import demo_generation_runtime

    rt = demo_runtime(device=device)
    srv = ModelServer()
    srv.add_model(rt)
    grt = demo_generation_runtime("demo_gen", n_layers=1, slots=2,
                                  max_prompt=16, max_context=64,
                                  max_new=32, prefill_batch=2,
                                  device=device)
    grt.compile(warmup=True)
    srv.add_generator(grt)
    srv.install_preemption_hook()
    fe = HttpFrontend(srv, port=port)
    host, bound = fe.start()
    print(json.dumps({"serving": rt.name, "host": host, "port": bound,
                      "device": str(rt.device),
                      "buckets": list(rt.plan),
                      "generating": grt.name,
                      "decode_plan": [list(c) for c in grt.decode_plan]}),
          flush=True)
    try:
        while srv.live():
            time.sleep(0.5)
    except KeyboardInterrupt:
        srv.drain()
    fe.stop()
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.serving",
        description="batching model server: self-test / demo serve")
    ap.add_argument("--self-test", action="store_true",
                    help="exercise queue admission, deadline expiry, "
                         "breaker trip/reset, drain ordering, the "
                         "generation tier (paged-cache decode "
                         "equality, continuous batching, streaming, "
                         "cancel reclaim), and request tracing (ring "
                         "wraparound, injected-stall attribution, "
                         "prom exemplars)")
    ap.add_argument("--serve", action="store_true",
                    help="serve the demo model over HTTP until SIGTERM")
    ap.add_argument("--port", type=int, default=None,
                    help="HTTP port (default MXNET_SERVE_PORT; 0 picks "
                         "a free one)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the demo models run (default cuda; "
                         "raises without a card)")
    args = ap.parse_args(argv)
    if (args.self_test or args.serve) and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass --device cpu to run "
                "the demo models on the CPU")
    if args.self_test:
        ok, checks = _self_test(args.device)
        print(json.dumps({"self_test_ok": ok, "checks": checks}))
        return 0 if ok else 1
    if args.serve:
        return _serve(args.port, args.device)
    ap.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
