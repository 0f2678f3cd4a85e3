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
           "get_float"]


class EnvVar(NamedTuple):
    """One registered knob: declaration == documentation."""
    name: str
    kind: str          # 'int' | 'float' | 'str'
    default: Any
    doc: str


_REGISTRY: Dict[str, EnvVar] = {}


def register(name: str, kind: str, default: Any, doc: str) -> EnvVar:
    if kind not in ("int", "float", "str"):
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


# engine.py
register("MXNET_MODULE_BULK_SIZE", "int", None,
         "Opt a fit loop into K-step bulk dispatch; presence alone opts "
         "in, the value is K (read by engine.fit_bulk_size).")

# transformer/
register("MXNET_ATTENTION_IMPL", "str", "flash",
         "Transformer attention implementation.  The port has 'flash' "
         "(the single-device kernel); 'ring' and 'ulysses' are not "
         "ported yet and raise.")

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

# parallel/dp.py: FusedTrainStep refuses what it does not port
register("MXNET_REMAT_POLICY", "str", "none",
         "Per-scope rematerialization policy; the port runs 'none' only "
         "(remat is queued) and refuses any other.")
register("MXNET_GRAD_ACCUM_STEPS", "int", 1,
         "Microbatch gradient accumulation inside the train step; the "
         "port runs 1 only (queued) and refuses more.")
