"""Thin HTTP front-end over :class:`ModelServer` — stdlib-only
(``http.server``), because the serving robustness lives in the server/
batcher layers, not the transport.

Counterpart: ``mxnet_tpu/serving/http.py`` (a copy: the same routes,
bodies, status mapping and traceparent handling).  The handler threads
only ever see host values: results arrive as numpy arrays and ints
from the model's worker thread, and streamed tokens cross over a queue.

Routes:
  * ``GET  /healthz``  — liveness (200 while the process is worth
    keeping, 503 once drained/crashed);
  * ``GET  /readyz``   — readiness (200 only when every model is
    compiled + warm and queues are below the shed watermark; body is
    the JSON condition report);
  * ``GET  /metrics``  — the diagnostics registry's Prometheus text
    exposition (p50/p99 gauges included);
  * ``POST /v1/models/<name>:predict`` — body
    ``{"instances": [[...], ...], "deadline_ms": 250}``; responds
    ``{"predictions": ...}``;
  * ``POST /v1/models/<name>:reload`` — body ``{"directory": "...",
    "step": N?, "wait_s": S?}``; kicks the zero-downtime reload
    (verify -> compile+warm -> canary -> promote/rollback) and
    responds 202 with the reload state (200 terminal when waited);
  * ``POST /v1/models/<name>:generate`` — body ``{"prompt": [ids...],
    "max_new": N?, "deadline_ms": D?, "stream": bool?}``.  Non-stream:
    one JSON reply ``{"tokens": [...], "prompt_len": P}``.  Stream:
    ``Transfer-Encoding: chunked``, one JSON line per token flushed as
    it is decoded (``{"token": id, "index": i}``, then a terminal
    ``{"done": true, ...}`` line) — a client that disconnects
    mid-stream CANCELS the generation (slot + cache blocks reclaimed
    next decode tick, co-riding sequences untouched, 499 in the
    rejection ledger).

Status mapping is the load-shedding contract made visible: 429 +
``Retry-After`` for a shed (queue_full), 503 + ``Retry-After`` for an
open breaker or draining, 504 for an expired deadline, 400/404 for
caller errors.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from . import reqtrace as _reqtrace
from .errors import (Cancelled, DeadlineExceeded, ExecutorFailure,
                     Rejected)

__all__ = ["HttpFrontend", "REASON_STATUS"]

_log = logging.getLogger(__name__)

#: Rejected.reason -> HTTP status
REASON_STATUS = {
    "queue_full": 429, "breaker_open": 503, "draining": 503,
    "too_large": 413, "unknown_model": 404, "bad_input": 400,
    "deadline": 504, "reload_in_progress": 409,
    # nginx's "client closed request" — never sent on the wire (the
    # client is gone), but it keeps the rejection ledger uniform
    "cancelled": 499,
}


def _jsonable(tree):
    """Result pytree -> JSON (bf16 arrays included)."""
    import numpy as np

    if isinstance(tree, (list, tuple)):
        return [_jsonable(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _jsonable(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind in "fc" or str(arr.dtype) == "bfloat16":
        return arr.astype("float64").tolist()
    return arr.tolist()


class _Handler(BaseHTTPRequestHandler):
    server_version = "mxnet-tpu-torch-serving/1.0"

    # the ModelServer rides on the HTTPServer instance
    @property
    def _srv(self):
        return self.server.model_server

    def log_message(self, fmt, *args):  # quiet: metrics, not stdout
        _log.debug("http: " + fmt, *args)

    def _trace_ctx(self) -> Optional[str]:
        """Accept an incoming W3C ``traceparent``: its trace-id becomes
        the request id (so the caller's trace links to the autopsy
        record), and every reply echoes a traceparent carrying the same
        trace-id.  No header -> fresh trace-id, request id generated
        server-side as usual (returns None)."""
        tid = _reqtrace.parse_traceparent(
            self.headers.get("traceparent"))
        self._tp_header, _ = _reqtrace.make_traceparent(tid)
        return tid

    def _reply(self, status: int, payload: dict,
               retry_after: Optional[float] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        tp = getattr(self, "_tp_header", None)
        if tp:
            self.send_header("traceparent", tp)
        if retry_after is not None:
            # RFC 7231: delta-seconds is an integer — round UP so a
            # conformant client never retries before capacity frees
            self.send_header("Retry-After",
                             "%d" % max(1, int(-(-retry_after // 1))))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            ok = self._srv.live()
            self._reply(200 if ok else 503, {"live": ok})
        elif self.path == "/readyz":
            rep = self._srv.ready()
            self._reply(200 if rep["ready"] else 503, rep)
        elif self.path == "/metrics":
            from .. import diagnostics as _diag

            text = _diag.metrics.to_prom()
            ex = _reqtrace.exemplar_prom_lines()
            if ex:
                # comment lines pass validate_prom_text untouched and
                # point each SLO series at a dumpable request id
                text = text.rstrip("\n") + "\n" + "\n".join(ex) + "\n"
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/stats":
            payload = dict(self._srv.stats())
            payload["reqtrace"] = _reqtrace.stats_summary()
            self._reply(200, payload)
        else:
            self._reply(404, {"error": "no route %r" % self.path})

    def do_POST(self):
        trace_id = self._trace_ctx()
        model, verb = self._route_model()
        if model is None:
            self._reply(404, {"error": "no route %r" % self.path})
            return
        if verb == "reload":
            self._do_reload(model)
            return
        if verb == "generate":
            self._do_generate(model, trace_id)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object, got %s"
                                 % type(payload).__name__)
            instances = payload["instances"]
        except (ValueError, KeyError, TypeError) as e:
            self._reply(400, {"error": "bad request body: %r" % e})
            return
        deadline_ms = payload.get("deadline_ms", "default")
        try:
            result = self._srv.predict(model, instances,
                                       deadline_ms=deadline_ms,
                                       request_id=trace_id)
            self._reply(200, {"predictions": _jsonable(result)})
        except Rejected as e:
            self._reply(REASON_STATUS.get(e.reason, 503),
                        {"error": str(e), "reason": e.reason},
                        retry_after=e.retry_after_s)
        except DeadlineExceeded as e:
            self._reply(504, {"error": str(e), "reason": "deadline"})
        except ExecutorFailure as e:
            self._reply(500, {"error": str(e), "reason": "executor"})
        except Exception as e:  # transport must outlive any request
            _log.exception("http: predict failed")
            self._reply(500, {"error": repr(e)})

    def _do_reload(self, model: str) -> None:
        """``POST /v1/models/<name>:reload`` body ``{"directory":
        "...", "step": N?, "wait_s": S?}`` — kick the background
        load+canary; 202 with the reload state (200 with the terminal
        state when ``wait_s`` is given).  A rollback is a SUCCESSFUL
        defense, not an error: it still answers 200."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object, got %s"
                                 % type(payload).__name__)
            directory = payload["directory"]
            step = payload.get("step")
            wait_s = payload.get("wait_s")
            # validate BEFORE reload(): once the background thread is
            # kicked, a late float("soon") error would 500 the caller
            # while the reload keeps running behind the failure
            if step is not None:
                step = int(step)
            if wait_s is not None:
                wait_s = float(wait_s)
        except (ValueError, KeyError, TypeError) as e:
            self._reply(400, {"error": "bad reload body: %r" % e})
            return
        try:
            state = self._srv.reload(model, directory, step=step,
                                     wait_s=wait_s)
            status = 200 if wait_s is not None else 202
            if state.get("state") == "failed":
                status = 500
            self._reply(status, {"reload": state})
        except Rejected as e:
            self._reply(REASON_STATUS.get(e.reason, 503),
                        {"error": str(e), "reason": e.reason})
        except Exception as e:
            _log.exception("http: reload failed")
            self._reply(500, {"error": repr(e)})

    def _do_generate(self, model: str,
                     trace_id: Optional[str] = None) -> None:
        """``POST /v1/models/<name>:generate``.  The streaming path is
        where continuous batching meets the transport: tokens cross
        from the engine thread over a queue and are flushed chunk by
        chunk as they decode; a write failure (client gone) cancels
        the generation at the server."""
        import queue as _q

        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object, got %s"
                                 % type(payload).__name__)
            prompt = payload["prompt"]
            max_new = payload.get("max_new")
            if max_new is not None:
                max_new = int(max_new)
            stream = bool(payload.get("stream", False))
        except (ValueError, KeyError, TypeError) as e:
            self._reply(400, {"error": "bad generate body: %r" % e})
            return
        deadline_ms = payload.get("deadline_ms", "default")
        tokens_q: "_q.Queue" = _q.Queue()
        try:
            req = self._srv.submit_generation(
                model, prompt, max_new=max_new,
                deadline_ms=deadline_ms, request_id=trace_id,
                on_token=(tokens_q.put if stream else None))
        except Rejected as e:
            self._reply(REASON_STATUS.get(e.reason, 503),
                        {"error": str(e), "reason": e.reason},
                        retry_after=e.retry_after_s)
            return
        except Exception as e:
            _log.exception("http: generate submit failed")
            self._reply(500, {"error": repr(e)})
            return
        if not stream:
            self._finish_generate_blocking(req)
            return
        # streaming: chunked transfer, one JSON line per token,
        # flushed the moment the engine decodes it
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonlines")
        self.send_header("Transfer-Encoding", "chunked")
        tp = getattr(self, "_tp_header", None)
        if tp:
            self.send_header("traceparent", tp)
        self.end_headers()
        idx = 0
        try:
            while True:
                try:
                    tok = tokens_q.get(timeout=0.25)
                except _q.Empty:
                    if req.done():  # error/cancel with no end marker
                        break
                    continue
                if tok is None:  # engine's end-of-stream marker
                    break
                self._write_chunk({"token": int(tok), "index": idx})
                _reqtrace.event(req.id, "stream_flush")
                idx += 1
            req.wait(0.0 if req.done() else 5.0)
            self._write_chunk({"done": True, "tokens": idx,
                              "prompt_len": len(req.prompt)})
        except (BrokenPipeError, ConnectionResetError, OSError):
            # client went away mid-stream: reclaim the slot + blocks
            _reqtrace.event(req.id, "client_disconnect",
                            tokens_flushed=idx)
            req.cancel()
            self._count_cancel()
            return
        except Cancelled:
            self._count_cancel()
            self._write_chunk_quiet({"done": False,
                                     "reason": "cancelled"})
        except (DeadlineExceeded, ExecutorFailure, Rejected) as e:
            self._write_chunk_quiet({"done": False, "error": str(e)})
        try:
            self.wfile.write(b"0\r\n\r\n")  # terminal chunk
            self.wfile.flush()
        except OSError:
            _reqtrace.event(req.id, "client_disconnect",
                            tokens_flushed=idx)
            req.cancel()

    def _finish_generate_blocking(self, req) -> None:
        try:
            timeout_s = 30.0 if req.deadline_ts is None else \
                max(req.deadline_ts - time.monotonic(), 0.0) + 5.0
            self._reply(200, req.wait(timeout_s))
        except Rejected as e:
            self._reply(REASON_STATUS.get(e.reason, 503),
                        {"error": str(e), "reason": e.reason},
                        retry_after=e.retry_after_s)
        except DeadlineExceeded as e:
            self._reply(504, {"error": str(e), "reason": "deadline"})
        except Cancelled as e:
            self._count_cancel()
            self._reply(REASON_STATUS["cancelled"],
                        {"error": str(e), "reason": "cancelled"})
        except ExecutorFailure as e:
            self._reply(500, {"error": str(e), "reason": "executor"})
        except Exception as e:
            _log.exception("http: generate failed")
            self._reply(500, {"error": repr(e)})

    def _write_chunk(self, obj: dict) -> None:
        data = (json.dumps(obj) + "\n").encode()
        self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
        self.wfile.flush()  # per-token flush IS the streaming contract

    def _write_chunk_quiet(self, obj: dict) -> None:
        try:
            self._write_chunk(obj)
        except OSError:
            pass

    def _count_cancel(self) -> None:
        try:
            self._srv._count_rejected("cancelled")
        except Exception:
            pass

    def _route_model(self) -> Tuple[Optional[str], Optional[str]]:
        prefix = "/v1/models/"
        for verb in ("predict", "reload", "generate"):
            suffix = ":" + verb
            if self.path.startswith(prefix) and \
                    self.path.endswith(suffix):
                return (self.path[len(prefix):-len(suffix)] or None,
                        verb)
        return None, None


class HttpFrontend:
    """Owns the ThreadingHTTPServer; ``start()`` binds (port 0 picks a
    free port — tests), ``stop()`` shuts the listener down.  Draining
    is the ModelServer's job; the listener just starts answering 503."""

    def __init__(self, model_server, host: str = "127.0.0.1",
                 port: Optional[int] = None):
        from .. import env as _env

        self.host = host
        self.port = _env.get_int("MXNET_SERVE_PORT") if port is None \
            else int(port)
        self._model_server = model_server
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> Tuple[str, int]:
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          _Handler)
        self._httpd.model_server = self._model_server
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="mx-serve-http")
        self._thread.start()
        _log.info("serving: http front-end on %s:%d", self.host,
                  self.port)
        return self.host, self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
