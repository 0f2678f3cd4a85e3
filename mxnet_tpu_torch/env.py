"""Registry of the ``MXNET_*`` knobs the port reads.

Counterpart: ``mxnet_tpu/env.py``.  Only the knobs this package reads
are declared, with the same names, types and defaults as the JAX
package's registry, so one environment configures both.  Reads go
through the typed accessors and happen at call time, never at import.
"""
from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional

__all__ = ["EnvVar", "register", "var", "get_str", "get_int",
           "get_float", "get_bool"]

_FALSE_SPELLINGS = ("0", "false", "no", "off")


class EnvVar(NamedTuple):
    """One registered knob: declaration == documentation."""
    name: str
    kind: str          # 'int' | 'float' | 'str' | 'bool'
    default: Any
    doc: str


_REGISTRY: Dict[str, EnvVar] = {}


def register(name: str, kind: str, default: Any, doc: str) -> EnvVar:
    if kind not in ("int", "float", "str", "bool"):
        raise ValueError("unknown env kind %r for %s" % (kind, name))
    v = EnvVar(name, kind, default, doc)
    _REGISTRY[name] = v
    return v


def var(name: str) -> EnvVar:
    v = _REGISTRY.get(name)
    if v is None:
        raise KeyError("environment variable %r is not registered in "
                       "mxnet_tpu_torch.env" % name)
    return v


def get_str(name: str) -> Optional[str]:
    raw = os.environ.get(name)
    return var(name).default if raw in (None, "") else raw


def _get_num(name: str, cast):
    v = var(name)
    raw = os.environ.get(name)
    if raw in (None, ""):
        return v.default
    try:
        return cast(raw)
    except ValueError:
        return v.default


def get_int(name: str) -> Optional[int]:
    return _get_num(name, int)


def get_float(name: str) -> Optional[float]:
    return _get_num(name, float)


def get_bool(name: str) -> bool:
    """Any value but an empty one or a false spelling (0/false/no/off)
    is true; unset or empty reads the registered default."""
    raw = os.environ.get(name)
    if raw in (None, ""):
        return bool(var(name).default)
    return raw.lower() not in _FALSE_SPELLINGS


# engine.py
register("MXNET_MODULE_BULK_SIZE", "int", None,
         "Opt a fit loop into K-step bulk dispatch; presence alone opts "
         "in, the value is K (read by engine.fit_bulk_size).")

# transformer/
register("MXNET_ATTENTION_IMPL", "str", "flash",
         "Transformer attention implementation: 'flash' (the "
         "single-device kernels), 'ring' (K/V rotating over the mesh's "
         "'sp' axis, the kernels on every visible step) or 'ulysses' "
         "(an all-to-all from sequence to heads over 'sp', the kernels "
         "on the full sequence); ring and ulysses need an sp axis, "
         "flash refuses one.")

# serving/server.py
register("MXNET_SERVE_QUEUE_MAX", "int", 128,
         "Per-model admission bound (requests); a submit at a full "
         "queue is shed with reason=queue_full.")
register("MXNET_SERVE_MAX_BATCH", "int", 32,
         "Batch size the retry-after hint divides the queue depth by.")
register("MXNET_SERVE_DEADLINE_MS", "float", 1000.0,
         "Default per-request deadline; expired requests are dropped "
         "before they take a slot.")
register("MXNET_SERVE_DRAIN_S", "float", 10.0,
         "Graceful drain budget: stop admitting, finish every admitted "
         "generation, join the workers.")
register("MXNET_SERVE_BREAKER_N", "int", 5,
         "Consecutive executor failures before a model's circuit "
         "breaker opens (0 disables the breaker).")
register("MXNET_SERVE_BREAKER_RESET_S", "float", 5.0,
         "How long an open breaker waits before one half-open probe.")
register("MXNET_SERVE_BATCH_DEADLINE_MS", "float", 5.0,
         "How long the predictor's dynamic batcher holds the first "
         "queued request open for co-riders before dispatching a "
         "partial batch.")
register("MXNET_SERVE_PORT", "int", 8000,
         "HTTP front-end port of python -m mxnet_tpu_torch.serving "
         "--serve.")
register("MXNET_SERVE_CANARY_PCT", "float", 25.0,
         "During ModelServer.reload, the percentage of batches (or "
         "generation sequences) routed to the new version while it is "
         "canaried; 0 skips the canary and swaps once the new version "
         "is warm.")
register("MXNET_SERVE_CANARY_MIN_N", "int", 20,
         "Canary batches (or decode ticks) observed before the "
         "promote-vs-rollback decision.")
register("MXNET_SERVE_ROLLBACK_ERR_RATIO", "float", 2.0,
         "Roll back when the canary's error rate exceeds the stable "
         "version's over the same window times this ratio (a canary "
         "that errors while stable is clean always rolls back).")
register("MXNET_SERVE_REQTRACE_SIZE", "int", 256,
         "Request-trace ring capacity (serving/reqtrace.py); 0 "
         "disables recording.")
register("MXNET_SERVE_REQTRACE_TOPK", "int", 8,
         "Slowest completed requests kept per sliding window for the "
         "tail-latency autopsy.")
register("MXNET_SERVE_REQTRACE_WINDOW_S", "float", 60.0,
         "Sliding window (s) of the reqtrace top-K and exemplars; also "
         "rate-limits the blown-deadline auto-dump.")

# chaos.py
register("MXNET_CHAOS", "str", None,
         "Fault-injection spec: semicolon-separated rules "
         "'kind:k=v,k=v'; the port reads the serving kinds "
         "slow_request / fail_execute / bad_version / cancel_request / "
         "stall_decode_tick and the training-loop kinds kill / "
         "delay_collective.")

# diagnostics.py
register("MXNET_DUMP_DIR", "str", None,
         "Directory for relative-path artifacts (reqtrace_rank*.json, "
         "metrics expositions); unset writes to the CWD.")
register("MXNET_METRICS_FILE", "str", None,
         "Path for periodic Prometheus-text metric flushes.")
register("MXNET_METRICS_INTERVAL_S", "float", 30.0,
         "Period of the metrics file flush (s).")
register("MXNET_ELASTIC_HEARTBEAT_DIR", "str", None,
         "Directory of per-rank heartbeat files (hb_rank{K}) an "
         "elastic supervisor watches; touched by the serving workers.")
# module/module.py
register("MXNET_SKIP_NONFINITE_GRADS", "bool", False,
         "Check gradients for NaN/Inf before the kvstore push/update "
         "and skip the step (counting "
         "mxnet_training_skipped_steps_total) instead of poisoning "
         "the parameters.")

register("MXNET_DIVERGENCE_WINDOW", "int", 0,
         "Loss-spike detector window (steps) of the transformer fit "
         "loop: once the window is full, a loss above median + factor "
         "x |median| (or non-finite) trips the divergence guard; 0 "
         "disables it.")
register("MXNET_DIVERGENCE_FACTOR", "float", 3.0,
         "Divergence threshold: loss > window median + factor x "
         "|median| trips the guard (see MXNET_DIVERGENCE_WINDOW).")
register("MXNET_ELASTIC_GENERATION", "int", 0,
         "Fleet incarnation, stamped into checkpoint sidecars and "
         "manifests.")
register("MXNET_COORDINATOR_ADDRESS", "str", None,
         "host:port of rank 0's rendezvous; presence enables "
         "multi-process initialization (dist.initialize).")
register("MXNET_PROCESS_ID", "int", 0,
         "This process's rank in the pod launch contract.")
register("MXNET_NUM_PROCESSES", "int", 1,
         "Number of processes in the pod launch contract.")

# checkpoint.py
register("MXNET_CKPT_DIR", "str", None,
         "Default checkpoint directory of TransformerTrainStep.fit when "
         "checkpointing is on without an explicit dir.")
register("MXNET_CKPT_EVERY_N", "int", 0,
         "Checkpoint every N optimizer steps in TransformerTrainStep.fit; "
         "0 disables (the checkpoint_every_n argument overrides).")
register("MXNET_CKPT_KEEP", "int", 3,
         "Completed checkpoint steps retained per directory; older "
         "steps are garbage-collected after each save. 0 keeps all.")
register("MXNET_CKPT_VERIFY", "bool", True,
         "Verify shard sha256 digests against the step's MANIFEST.json "
         "on load; a corrupt newest step falls back to the newest "
         "verified one (an explicitly requested step fails fast).")

# serving/generate.py
register("MXNET_SERVE_KV_BLOCK_TOKENS", "int", 16,
         "Tokens per paged-KV-cache block; also the rounding unit of "
         "the prompt/cache bucket ladders.")
register("MXNET_SERVE_GEN_SLOTS", "int", 8,
         "Concurrent sequences per generator (continuous-batching "
         "slots); the top of the decode batch ladder.")
register("MXNET_SERVE_GEN_MAX_PROMPT", "int", 64,
         "Largest admissible prompt (tokens), rounded up to a block.")
register("MXNET_SERVE_GEN_MAX_CONTEXT", "int", 256,
         "Largest prompt+output context (tokens), rounded up to a "
         "block; the top of the decode cache-length ladder.")
register("MXNET_SERVE_GEN_MAX_NEW", "int", 32,
         "Default new tokens per generation request.")
register("MXNET_SERVE_GEN_BLOCKS", "int", 0,
         "KV-cache pool size in blocks; 0 sizes it so every slot can "
         "hold a full max-context sequence.")
register("MXNET_SERVE_GEN_PREFILL_BATCH", "int", 4,
         "Largest batched prefill (sequences admitted per tick).")

# parallel/dp.py, remat.py, transformer/train.py
register("MXNET_REMAT_POLICY", "str", "none",
         "Per-scope rematerialization policy over torch.utils.checkpoint: "
         "'none'; the transformer's 'block' (each decoder block) and "
         "'attention' (the attention sub-graph); the conv tier's 'stage' "
         "(each ResNet stage; the executor's stageN_ segments) and "
         "'conv_block' (each residual unit), in FusedTrainStep, "
         "hybridized Gluon blocks and the symbolic executor.  One scope "
         "at a time; an unknown name raises.")
register("MXNET_BACKWARD_DO_MIRROR", "bool", False,
         "The mirror: keep convolution and matrix-product outputs and "
         "recompute the rest in backward, region by region (FusedTrainStep, "
         "an outermost hybridized block's recorded call, the executor; "
         "the transformer ignores it).")
register("MXNET_ZERO_STAGE", "int", 0,
         "Optimizer-state sharding: 0 replicates momenta (default); 1 "
         "(ZeRO-1) shards them over a dp mesh of more than one rank "
         "(on one device it warns and stays replicated).")
register("MXNET_KVSTORE_BUCKET_BYTES", "int", 4 * 1024 * 1024,
         "Gradient all-reduce bucket size cap (one all-reduce per "
         "bucket, issued from backward hooks); 0 asks for the "
         "monolithic reduction (FusedTrainStep) or one bucket per dtype "
         "run (TransformerTrainStep).")
register("MXNET_KVSTORE_BUCKET_CHAIN", "bool", True,
         "The JAX package chains consecutive bucket reductions; NCCL and "
         "gloo run a process group's collectives in issue order, so the "
         "port reads it only to report it.")
register("MXNET_KVSTORE_BUCKET_IMPL", "str", "psum",
         "The JAX package's bucket reduction schedule: 'psum', 'ring' "
         "or 'hierarchical'.  The port accepts the three names and runs "
         "the backend's own all-reduce (NCCL picks its algorithm).")
register("MXNET_AUTOTUNE_PLAN", "str", None,
         "A tuned bucket plan of the JAX package's autotuner; not ported "
         "(ROADMAP A11): setting it raises at the train step's build.")
register("MXNET_AUTOTUNE_DIR", "str", None,
         "A directory of tuned bucket plans; not ported (ROADMAP A11): "
         "setting it raises at the train step's build.")
register("MXNET_SDC_CHECK_EVERY_N", "int", 0,
         "Cross-rank SDC fingerprint-vote cadence; not ported (ROADMAP "
         "A11): a nonzero value raises at the train step's build.")
register("MXNET_GRAD_ACCUM_STEPS", "int", 1,
         "Microbatch gradient accumulation inside FusedTrainStep: the "
         "per-device batch splits into this many microbatches whose "
         "gradients are summed before ONE exchange and update; it must "
         "divide the batch.")

# image/image.py
register("MXNET_CPU_WORKER_NTHREADS", "int", 1,
         "Decode worker threads for ImageIter augmentation.")

# io_pipeline.py — the sharded multi-process decode pool and the
# asynchronous device stage
register("MXNET_IO_WORKERS", "int", 0,
         "Decode-pool worker processes for io_pipeline.InputPipeline; "
         "0 means cpu_count-1 (min 1).  Each worker owns a disjoint "
         "num_parts/part_index record slice.")
register("MXNET_IO_PREFETCH_DEPTH", "int", 2,
         "Device-prefetch depth: how many batches the device stage keeps "
         "copied ahead of the consumer (2 = double buffering: batch k+1 "
         "crosses to the card while k computes).")
register("MXNET_IO_POOL_SLOTS", "int", 4,
         "Shared-memory batch slots per decode worker; bounds how far "
         "a worker can run ahead of the consumer (backpressure).")
register("MXNET_IO_START_METHOD", "str", None,
         "Decode-pool start method: 'fork' or 'spawn'.  Unset picks "
         "fork when the backing iterator has the host-only next_raw "
         "contract (workers never touch torch or CUDA, so forking a "
         "parent that holds a CUDA context is safe), spawn otherwise.")

# kvstore.py — gradient compression on the dist wire
register("MXNET_GRADIENT_COMPRESSION", "str", None,
         "Enable worker-side gradient compression on dist kvstores at "
         "create ('2bit' is the supported type): pushes travel as "
         "packed 2-bit codes with per-key error feedback, "
         "mxnet_kvstore_bytes_total{op=push} counts the compressed "
         "wire bytes.  Unset disables.")
register("MXNET_GRADIENT_COMPRESSION_THRESHOLD", "float", 0.5,
         "2-bit compression threshold: values >= t encode +t, <= -t "
         "encode -t, the rest 0 with the residual carried locally.")

# kvstore_server.py — parameter-server sync mode
register("MXNET_KVSTORE_SYNC_TIMEOUT", "float", 600.0,
         "Sync-pull progress deadline (seconds, resets on every applied "
         "round) before a stalled round aborts.")

# _ps.py — parameter-server transport
register("MXNET_PS_SECRET", "str", None,
         "Shared HMAC secret authenticating PS messages.")
register("MXNET_PS_REQUEST_TIMEOUT", "float", 900.0,
         "Client-side PS request timeout (s); exceeds the server sync "
         "window so tolerated stragglers are not aborted client-side.")
register("MXNET_PS_HEARTBEAT_INTERVAL", "float", 5.0,
         "Node -> scheduler heartbeat period (s); each beat also asks "
         "for the dead peers (diagnostics.dead_peers).")
register("MXNET_PS_RETRY_MAX", "int", 3,
         "Transport retries per PS request after a timeout/connection "
         "failure (reconnect + resend with exponential backoff); 0 "
         "fails fast.")
register("MXNET_PS_RETRY_BACKOFF_S", "float", 0.1,
         "Initial retry backoff (s); doubles per attempt with +-50% "
         "jitter.")
