"""Behaviour of the port's serving tier, case for case after the JAX
package's tests/test_serving.py (and the HTTP generate e2e of
tests/test_zz_generate_e2e.py): admission and shedding, deadlines, the
breaker, probes, the HTTP front end (predict, generate, streaming, a
disconnect that cancels), metrics, live reload with a canary and
rollback, the heartbeat, the self-test CLI, and SIGTERM -> exit 83
through ``python -m mxnet_tpu_torch.serving --serve --device cpu``.
Everything runs on the CPU (``device="cpu"``).
"""
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import chaos
from mxnet_tpu_torch import checkpoint as ckpt
from mxnet_tpu_torch import diagnostics as diag
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.serving import reqtrace

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
X1 = np.ones((1, 2), dtype="float32")


def _child_env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("MXNET_CHAOS", "MXNET_SERVE_QUEUE_MAX"):
        env.pop(k, None)
    env.update(extra or {})
    return env


def _demo(**kw):
    return serving.demo_runtime(max_batch=4, device="cpu", **kw)


class _GatedRuntime:
    """Executor gated on an event — deterministic queue pressure."""

    def __init__(self, name="gated", max_batch=2):
        self.name = name
        self.sample_shape = (2,)
        self.max_batch = max_batch
        self.plan = serving.plan_batch_buckets(max_batch)
        self.compiled = True
        self.gate = threading.Event()
        self.executed = 0
        self.fail = False

    def bucket_for(self, n):
        for b in self.plan:
            if n <= b:
                return b
        raise ValueError(n)

    def execute(self, batch):
        self.gate.wait(10.0)
        if self.fail:
            raise serving.ExecutorFailure("boom")
        self.executed += int(np.asarray(batch).shape[0])
        return np.asarray(batch).sum(axis=-1)


def _counter(name, **labels):
    return diag.metrics.counter(name, labels=labels or None).value


def _server(**kw):
    base = dict(queue_max=8, max_batch=2, batch_deadline_ms=1,
                default_deadline_ms=10_000)
    base.update(kw)
    return serving.ModelServer(**base)


# ------------------------------------------------------------------ CLI
def test_serving_self_test_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.serving", "--self-test",
         "--device", "cpu"], capture_output=True, text=True,
        env=_child_env(), cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    payload = json.loads(res.stdout.splitlines()[-1])
    assert payload["self_test_ok"], payload
    assert len(payload["checks"]) >= 50


def test_cli_without_a_card_raises_and_names_the_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default works")
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.serving", "--self-test"],
        capture_output=True, text=True, env=_child_env(), cwd=ROOT,
        timeout=120)
    assert res.returncode != 0
    assert "--device cpu" in res.stderr
    assert "self_test_ok" not in res.stdout


# ------------------------------------------------------- admission et al.
def test_queue_full_shed_is_counted():
    rt = _GatedRuntime()
    srv = _server(queue_max=2)
    srv.add_model(rt)
    before = _counter("mxnet_serve_rejected_total", reason="queue_full")
    admitted, shed = [], 0
    for _ in range(7):
        try:
            admitted.append(srv.submit("gated", X1))
        except serving.Rejected as e:
            assert e.reason == "queue_full"
            assert e.retry_after_s is not None and e.retry_after_s > 0
            shed += 1
    assert shed >= 3  # 7 offers vs <=2 riding + 2 queued
    rt.gate.set()
    for r in admitted:
        r.wait(10.0)
    assert _counter("mxnet_serve_rejected_total",
                    reason="queue_full") - before == shed


@pytest.mark.parametrize("model,data,reason", [
    ("nope", X1, "unknown_model"),
    ("shapes", np.ones((1, 5), dtype="float32"), "bad_input"),
    ("shapes", np.ones((9, 2), dtype="float32"), "too_large")])
def test_unknown_model_and_bad_input_shed(model, data, reason):
    srv = _server()
    rt = _GatedRuntime("shapes")
    rt.gate.set()
    srv.add_model(rt)
    before = _counter("mxnet_serve_rejected_total", reason=reason)
    with pytest.raises(serving.Rejected) as ei:
        srv.submit(model, data)
    assert ei.value.reason == reason
    assert _counter("mxnet_serve_rejected_total", reason=reason) == \
        before + 1
    srv.drain(timeout_s=5.0)


def test_expired_request_never_dispatched():
    rt = _GatedRuntime()
    srv = _server()
    srv.add_model(rt)
    blocker = srv.submit("gated", X1)
    time.sleep(0.05)  # the batcher takes the blocker, wedges on gate
    victim = srv.submit("gated", X1, deadline_ms=30)
    time.sleep(0.08)  # victim expires while QUEUED
    rt.gate.set()
    blocker.wait(10.0)
    with pytest.raises(serving.DeadlineExceeded):
        victim.wait(5.0)
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline and rt.executed < 1:
        time.sleep(0.01)
    assert rt.executed == 1


def test_breaker_trip_flushes_queue_and_resets():
    rt = _GatedRuntime("flaky")
    rt.gate.set()
    rt.fail = True
    srv = _server(breaker_n=2, breaker_reset_s=0.15)
    srv.add_model(rt)
    for _ in range(2):
        with pytest.raises(serving.ExecutorFailure):
            srv.submit("flaky", X1).wait(10.0)
    deadline = time.monotonic() + 5.0
    while srv._get("flaky").breaker.state() == "closed" and \
            time.monotonic() < deadline:
        time.sleep(0.005)
    assert srv._get("flaky").breaker.state() in ("open", "half_open")
    with pytest.raises(serving.Rejected) as ei:
        srv.submit("flaky", X1)
    assert ei.value.reason == "breaker_open"
    assert ei.value.retry_after_s is not None
    time.sleep(0.2)
    rt.fail = False
    srv.submit("flaky", X1).wait(10.0)
    assert srv._get("flaky").breaker.state() == "closed"
    srv.drain(timeout_s=5.0)


def test_breaker_lost_probe_does_not_wedge():
    br = serving.CircuitBreaker(1, 0.05)
    assert br.on_failure() and br.state() == "open"
    time.sleep(0.06)
    assert br.admit() is True          # the probe reservation
    assert br.admit() is False         # concurrent submits fast-fail
    br.abort_probe()                   # probe was shed at offer
    assert br.admit() is True          # next submit may probe now
    time.sleep(0.06)                   # probe expired in queue instead
    assert br.admit() is True          # reservation timed out too
    br.on_success()
    assert br.state() == "closed"


def test_probes_ready_vs_live():
    rt = _GatedRuntime("probe")
    rt.gate.set()
    srv = _server(queue_max=4)
    srv.add_model(rt)
    rep = srv.ready()
    assert rep["ready"] and srv.live()
    srv.drain(timeout_s=5.0)
    assert not srv.ready()["ready"]
    assert not srv.live()


def test_batcher_loop_touches_heartbeat(tmp_path, monkeypatch):
    hb_dir = str(tmp_path / "hb")
    monkeypatch.setenv("MXNET_ELASTIC_HEARTBEAT_DIR", hb_dir)
    monkeypatch.setattr(diag, "_hb_last", 0.0)
    monkeypatch.setattr(diag, "_hb_path", None)
    srv = _server(queue_max=4)
    try:
        srv.add_model(_demo())
        path = os.path.join(hb_dir, "hb_rank0")
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not os.path.exists(path):
            time.sleep(0.05)  # no traffic at all: idling must beacon
        assert os.path.exists(path)
    finally:
        srv.drain(timeout_s=5.0)


# ------------------------------------------------------------- metrics
def test_serving_latency_quantiles_in_prom():
    srv = _server(max_batch=4)
    srv.add_model(_demo())
    for _ in range(5):
        srv.predict("demo", np.zeros((2, 16), dtype="float32"))
    text = diag.metrics.to_prom()
    assert not diag.validate_prom_text(text)
    assert "mxnet_serve_latency_seconds_p50" in text
    assert "mxnet_serve_latency_seconds_p99" in text
    assert ('mxnet_serve_requests_total{model="demo",outcome="ok",'
            'version="v1"}') in text
    srv.drain(timeout_s=5.0)


# ---------------------------------------------------------------- HTTP
def _post(base, path, payload, timeout=30):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _http_status(fn):
    try:
        return fn().status
    except urllib.error.HTTPError as e:
        return e.code


@pytest.fixture
def http_server():
    rt = _demo()
    grt = serving.demo_generation_runtime(
        "gen_http", n_layers=1, slots=1, block_tokens=16, max_prompt=16,
        max_context=48, max_new=32, prefill_batch=1, device="cpu")
    srv = serving.ModelServer(max_batch=4, queue_max=8,
                              batch_deadline_ms=1,
                              default_deadline_ms=30_000)
    srv.add_model(rt)
    srv.add_generator(grt)
    fe = serving.HttpFrontend(srv, port=0)
    host, port = fe.start()
    yield srv, rt, grt, host, port, "http://%s:%d" % (host, port)
    srv.drain(timeout_s=10.0)
    fe.stop()


def test_http_predict_roundtrip_and_status_mapping(http_server):
    srv, rt, _, _, _, base = http_server
    assert urllib.request.urlopen(base + "/healthz").status == 200
    assert urllib.request.urlopen(base + "/readyz").status == 200
    assert not diag.validate_prom_text(
        urllib.request.urlopen(base + "/metrics").read().decode())
    x = np.random.RandomState(0).randn(3, 16).astype("float32")
    tp = "00-%s-%s-01" % ("ab" * 16, "cd" * 8)
    resp = urllib.request.urlopen(urllib.request.Request(
        base + "/v1/models/demo:predict",
        data=json.dumps({"instances": x.tolist()}).encode(),
        headers={"traceparent": tp}))
    body = json.loads(resp.read())
    assert resp.headers["traceparent"].split("-")[1] == "ab" * 16
    cls, logits = rt.execute(x)
    assert body["predictions"][0] == cls.tolist()
    np.testing.assert_allclose(body["predictions"][1], logits, rtol=0,
                               atol=0)
    assert _http_status(lambda: _post(base, "/v1/models/ghost:predict",
                                      {"instances": [[1.0]]})) == 404
    assert _http_status(lambda: urllib.request.urlopen(
        urllib.request.Request(base + "/v1/models/demo:predict",
                               data=b"[1, 2, 3]"))) == 400
    assert _http_status(lambda: _post(base, "/v1/models/demo:predict",
                                      {"instances": [[1.0] * 5]})) == 400
    assert _http_status(lambda: _post(
        base, "/v1/models/gen_http:generate",
        {"prompt": list(range(1, 40))})) == 413
    assert _http_status(lambda: urllib.request.urlopen(
        base + "/nowhere")) == 404
    stats = json.loads(urllib.request.urlopen(base + "/stats").read())
    assert stats["demo"]["device"] == "cpu" and "reqtrace" in stats
    srv.drain(timeout_s=5.0)
    assert _http_status(lambda: urllib.request.urlopen(
        base + "/healthz")) == 503
    assert _http_status(lambda: urllib.request.urlopen(
        base + "/readyz")) == 503
    assert _http_status(lambda: _post(base, "/v1/models/demo:predict",
                                      {"instances": x.tolist()})) == 503


def test_http_generate_stream_equals_blocking(http_server):
    _, _, grt, _, _, base = http_server
    blocking = json.loads(_post(base, "/v1/models/gen_http:generate",
                                {"prompt": [1, 2, 3],
                                 "max_new": 6}).read())
    assert len(blocking["tokens"]) == 6 and blocking["prompt_len"] == 3
    resp = _post(base, "/v1/models/gen_http:generate",
                 {"prompt": [1, 2, 3], "max_new": 6, "stream": True})
    assert resp.headers.get("Transfer-Encoding") == "chunked"
    lines = [json.loads(ln) for ln in resp.read().decode().splitlines()
             if ln]
    assert lines[-1] == {"done": True, "tokens": 6, "prompt_len": 3}
    assert [ln["token"] for ln in lines[:-1]] == blocking["tokens"]
    assert [ln["index"] for ln in lines[:-1]] == list(range(6))
    assert grt.kv.stats()["blocks_live"] == 0


def test_http_disconnect_cancels_the_generation(http_server,
                                                monkeypatch):
    _, _, grt, host, port, _ = http_server
    monkeypatch.setenv("MXNET_CHAOS",
                       "stall_decode_tick:model=gen_http,ms=20,count=999")
    chaos.reset()
    reqtrace.reset(capacity=32, topk=4)
    before = _counter("mxnet_serve_requests_total", model="gen_http",
                      outcome="cancelled", version="v1")
    try:
        body = json.dumps({"prompt": [1, 2, 3], "max_new": 32,
                           "stream": True})
        sk = socket.create_connection((host, port), timeout=10)
        sk.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                      struct.pack("ii", 1, 0))  # close sends RST
        sk.sendall(("POST /v1/models/gen_http:generate HTTP/1.1\r\n"
                    "Host: t\r\nContent-Type: application/json\r\n"
                    "Content-Length: %d\r\n\r\n%s"
                    % (len(body), body)).encode())
        assert sk.recv(1)  # the stream is live
        sk.close()
        rec, deadline = None, time.monotonic() + 20.0
        while time.monotonic() < deadline and rec is None:
            done = [r for r in reqtrace.snapshot()["recent"]
                    if r["model"] == "gen_http"]
            rec = done[0] if done else None
            time.sleep(0.02)
        assert rec is not None and rec["outcome"] == "cancelled"
        assert "client_disconnect" in rec["events"]
        assert rec["injected_any"]
        deadline = time.monotonic() + 5.0
        while grt.kv.stats()["blocks_live"] and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert grt.kv.stats()["blocks_live"] == 0
        assert _counter("mxnet_serve_requests_total", model="gen_http",
                        outcome="cancelled", version="v1") == before + 1
    finally:
        monkeypatch.delenv("MXNET_CHAOS")
        chaos.reset()
        reqtrace.reset()


# --------------------------------------------------------------- reload
def _drive_until_terminal(srv, model, x, timeout_s=30.0):
    n_ok = n_failed = 0
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            srv.predict(model, x)
            n_ok += 1
        except Exception:
            n_failed += 1
        st = srv.reload_status(model)
        if st["state"] in ("promoted", "rolled_back", "failed"):
            return st, n_ok, n_failed
    return srv.reload_status(model), n_ok, n_failed


@pytest.fixture
def v2_dir(tmp_path):
    d = str(tmp_path / "v2ckpt")
    ckpt.save_checkpoint(d, 3, params=serving.demo_params(seed=9))
    return d


@pytest.mark.parametrize("bad_version", [False, True])
def test_reload_canary_promotes_or_rolls_back(v2_dir, monkeypatch,
                                              bad_version):
    srv = _server(max_batch=4, queue_max=64, canary_pct=50,
                  canary_min_n=4)
    srv.add_model(_demo(seed=0))
    x = np.random.RandomState(0).randn(1, 16).astype("float32")
    v1_out = srv.predict("demo", x)[1]
    rb_before = _counter("mxnet_serve_rollbacks_total", model="demo")
    if bad_version:
        monkeypatch.setenv("MXNET_CHAOS",
                           "bad_version:model=demo,count=100000")
        chaos.reset()
    try:
        srv.reload("demo", v2_dir)
        st, n_ok, n_failed = _drive_until_terminal(srv, "demo", x)
        injected = chaos.injected_total("bad_version")
    finally:
        monkeypatch.delenv("MXNET_CHAOS", raising=False)
        chaos.reset()
    # zero admitted dropped: every request during the canary answered
    assert n_failed == 0 and n_ok > 0, (n_ok, n_failed)
    got = srv.predict("demo", x)[1]
    if bad_version:
        assert st["state"] == "rolled_back" and injected > 0, st
        assert st["canary_stats"]["errors"] >= 4
        assert _counter("mxnet_serve_rollbacks_total",
                        model="demo") == rb_before + 1
        np.testing.assert_array_equal(got, v1_out)
        assert srv.stats()["demo"]["version"] == 1
        assert srv.stats()["demo"]["canary_version"] is None
    else:
        assert st["state"] == "promoted", st
        assert st["canary_stats"]["errors"] == 0
        v2 = _demo(seed=9)
        np.testing.assert_array_equal(got, v2.execute(x)[1])
        assert srv.stats()["demo"]["version"] == 2
        assert _counter("mxnet_serve_reloads_total", model="demo",
                        outcome="promoted") >= 1
    srv.drain(timeout_s=5.0)


def test_reload_corrupt_checkpoint_fails_closed(v2_dir):
    with open(ckpt.shard_path(v2_dir, 3, 0), "r+b") as f:
        f.seek(50)
        f.write(b"\x00\x01\x02\x03")
    srv = _server(max_batch=4)
    srv.add_model(_demo(seed=0))
    st = srv.reload("demo", v2_dir, wait_s=30.0)
    assert st["state"] == "failed", st
    assert "rank0.ckpt" in str(st.get("error", "")), st
    assert srv.predict("demo", np.zeros((1, 16), "float32"))[0].shape == \
        (1,)
    assert srv.stats()["demo"]["version"] == 1
    srv.drain(timeout_s=5.0)


def test_reload_in_progress_rejected(v2_dir):
    srv = _server(max_batch=4, canary_pct=50, canary_min_n=4)
    srv.add_model(_demo(seed=0))
    srv.reload("demo", v2_dir)  # no traffic -> sits in loading/canary
    with pytest.raises(serving.Rejected) as ei:
        srv.reload("demo", v2_dir)
    assert ei.value.reason == "reload_in_progress"
    st, _, _ = _drive_until_terminal(srv, "demo",
                                     np.zeros((1, 16), "float32"))
    assert st["state"] == "promoted"
    srv.drain(timeout_s=5.0)


def test_http_reload_route(v2_dir):
    srv = _server(max_batch=4, canary_pct=0)
    srv.add_model(_demo(seed=0))
    fe = serving.HttpFrontend(srv, port=0)
    host, port = fe.start()
    base = "http://%s:%d" % (host, port)
    try:
        resp = _post(base, "/v1/models/demo:reload",
                     {"directory": v2_dir, "wait_s": 30})
        body = json.loads(resp.read())
        assert resp.status == 200 and body["reload"]["state"] == \
            "promoted", body
        stats = json.loads(urllib.request.urlopen(base + "/stats").read())
        assert stats["demo"]["version"] == 2
        assert _http_status(lambda: urllib.request.urlopen(
            urllib.request.Request(base + "/v1/models/demo:reload",
                                   data=b"{}"))) == 400
        assert _http_status(lambda: _post(
            base, "/v1/models/ghost:reload", {"directory": v2_dir})) == 404
    finally:
        srv.drain(timeout_s=5.0)
        fe.stop()


def test_generator_reload_canaries_sequences_and_promotes(tmp_path):
    """A generator's new weights from a checkpoint canary per sequence
    on the engine loop; in-flight generations never drop."""
    g1 = serving.demo_generation_runtime(
        "gen_r", n_layers=1, slots=2, max_prompt=16, max_context=32,
        max_new=4, prefill_batch=2, device="cpu", seed=0)
    g2 = serving.demo_generation_runtime(
        "gen_r", n_layers=1, slots=2, max_prompt=16, max_context=32,
        max_new=4, prefill_batch=2, device="cpu", seed=7)
    d = str(tmp_path / "g2")
    ckpt.save_checkpoint(d, 1, params=g2._params)
    srv = serving.ModelServer(queue_max=16, default_deadline_ms=30_000,
                              canary_pct=50, canary_min_n=3)
    srv.add_generator(g1)
    srv.reload("gen_r", d)
    n_ok, deadline = 0, time.monotonic() + 60.0
    while time.monotonic() < deadline:
        srv.generate("gen_r", [1, 2, 3], max_new=4, timeout_s=30.0)
        n_ok += 1
        if srv.reload_status("gen_r")["state"] not in ("loading",
                                                        "canary"):
            break
    st = srv.reload_status("gen_r")
    assert st["state"] == "promoted", st
    assert srv.stats()["gen_r"]["version"] == 2
    want = serving.GenRequest("x", [1, 2, 3], 4)
    g2.engine.enqueue(want)
    while not g2.engine.idle():
        g2.engine.step()
    got = srv.generate("gen_r", [1, 2, 3], max_new=4, timeout_s=30.0)
    assert got["tokens"] == want.tokens
    assert srv.drain(timeout_s=10.0)["left"] == 0


# ------------------------------------------------------------- SIGTERM
def test_sigterm_drain_exits_83_through_the_cli(tmp_path):
    env = _child_env({"MXNET_DUMP_DIR": str(tmp_path)})
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.serving", "--serve",
         "--port", "0", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(tmp_path))
    try:
        banner = json.loads(proc.stdout.readline())
        assert banner["device"] == "cpu" and banner["generating"] == \
            "demo_gen"
        base = "http://127.0.0.1:%d" % banner["port"]
        out = json.loads(_post(base, "/v1/models/demo_gen:generate",
                               {"prompt": [5, 9, 2], "max_new": 6}).read())
        assert len(out["tokens"]) == 6
        pred = json.loads(_post(base, "/v1/models/demo:predict",
                                {"instances": [[0.5] * 16]}).read())
        assert len(pred["predictions"][0]) == 1
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    err = proc.stderr.read()
    assert rc == diag.EXIT_PREEMPTED, (rc, err)
    assert "exiting 83" in err
