"""The serving tier of the port: a dynamic-batching predictor server
and a continuous-batching generation server on one robustness layer.

Counterpart: ``mxnet_tpu/serving/`` (every module, the same
``__all__``): per-model bounded queues with admission control and load
shedding, deadline propagation (expired work is never batched), warmed
executors per batch bucket (``ModelRuntime``), a per-model circuit
breaker, graceful SIGTERM drain (exit 83), distinct liveness/readiness
probes, zero-downtime reload with a canary and auto-rollback
(``ModelServer.reload``), Prometheus metrics (``mxnet_serve_*``),
per-request traces (``reqtrace``), the HTTP front end (``HttpFrontend``)
and the load generator (``loadgen``).  The generation tier runs
prefill/decode over a paged KV cache with continuous batching; its
prefill attention is the hand-written flash kernel.  Runtimes live on
``cuda`` unless built with ``device='cpu'``.  Quickstart::

    from mxnet_tpu_torch import serving

    srv = serving.ModelServer()
    srv.add_model(serving.demo_runtime("demo"))        # warms buckets
    srv.add_generator(serving.demo_generation_runtime("gen"))
    srv.install_preemption_hook()          # SIGTERM -> drain -> exit 83
    out = srv.predict("demo", batch, deadline_ms=250)
    req = srv.submit_generation("gen", prompt_ids, max_new=16,
                                on_token=print)
    tokens = req.wait(30.0)["tokens"]      # req.cancel() mid-stream ok
    host, port = serving.HttpFrontend(srv, port=0).start()

``python -m mxnet_tpu_torch.serving --self-test`` exercises the whole
layer; ``--serve`` runs the HTTP front end (``--device cpu`` off the
card).
"""
from . import reqtrace
from .batching import Request, RequestQueue
from .bucket_ladder import (bucket_for, bucket_for_2d, ladder,
                            ladder_2d)
from .errors import (REJECT_REASONS, Cancelled, DeadlineExceeded,
                     ExecutorFailure, Rejected, ServeError)
from .generate import (GenerationEngine, GenerationRuntime, GenRequest,
                       StubGenerationRuntime, demo_generation_runtime,
                       stub_greedy_reference)
from .http import HttpFrontend
from .kvcache import CacheExhausted, PagedKVCache
from .loadgen import (BackgroundLoad, gen_tokens_at_slo, qps_at_slo,
                      run_generation_load, run_load)
from .runtime import (ModelRuntime, demo_params, demo_runtime,
                      plan_batch_buckets)
from .server import CircuitBreaker, ModelServer

__all__ = [
    "Request", "RequestQueue", "ServeError", "Rejected",
    "DeadlineExceeded", "ExecutorFailure", "Cancelled",
    "REJECT_REASONS",
    "ModelRuntime", "demo_runtime", "demo_params",
    "plan_batch_buckets",
    "ladder", "ladder_2d", "bucket_for", "bucket_for_2d",
    "PagedKVCache", "CacheExhausted",
    "GenRequest", "GenerationRuntime", "GenerationEngine",
    "demo_generation_runtime", "StubGenerationRuntime",
    "stub_greedy_reference",
    "CircuitBreaker", "ModelServer", "HttpFrontend",
    "run_load", "qps_at_slo", "run_generation_load",
    "gen_tokens_at_slo", "BackgroundLoad",
    "reqtrace",
]
