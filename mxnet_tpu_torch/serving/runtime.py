"""Model runtime: params -> warmed inference executors, one per
bucketed batch shape, on the runtime's device.

Counterpart: ``mxnet_tpu/serving/runtime.py``.  A server sees every
batch size between 1 and ``MXNET_SERVE_MAX_BATCH``; the runtime plans a
doubling ladder of batch buckets ahead of time, pads each dynamic batch
to the nearest bucket and slices the padding back off, and runs one
warmup batch per bucket at load so the first request pays no
first-shape cost.  PyTorch runs eagerly, so where the JAX package
AOT-compiles one executable per bucket, :meth:`ModelRuntime.compile` is
that warmup pass.  Weights are cast to the compute dtype (bf16 by
default) once at load.

``apply_fn(params, aux, x)`` takes and returns torch tensors on the
runtime's device (``cuda`` unless the caller asks for the CPU).
Results leave :meth:`ModelRuntime.execute` as numpy arrays (a bf16
output as float32, which holds it exactly: numpy has no bf16), so
server threads other than the dispatch worker only ever see host
values.

``from_checkpoint`` loads the checkpoint layout both packages write
(``mxnet_tpu_torch.checkpoint``); an incomplete step fails naming the
ranks whose shards are missing.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import bind_device, resolve_device
from .bucket_ladder import ladder as _ladder
from .errors import ExecutorFailure

__all__ = ["plan_batch_buckets", "ModelRuntime", "demo_runtime",
           "demo_params"]

_log = logging.getLogger(__name__)


def plan_batch_buckets(max_batch: int,
                       batch_sizes: Optional[Sequence[int]] = None
                       ) -> Tuple[int, ...]:
    """The batch ladder: explicit ``batch_sizes`` (sorted, deduped,
    capped) or a doubling ladder 1,2,4,...,max_batch; every request
    batch maps to exactly one bucket (the smallest holding it)."""
    return _ladder(max_batch, batch_sizes, min_size=1)


def _torch_dtype(name) -> torch.dtype:
    key = "bfloat16" if str(name) == "bfloat16" else np.dtype(name).name
    dt = getattr(torch, key, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError("unknown dtype %r" % (name,))
    return dt


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _to_host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


class ModelRuntime:
    """One served model: params + a pure ``apply_fn(params, aux, data)``
    warmed for every batch bucket on ``device``."""

    def __init__(self, name: str, apply_fn: Callable, params: Dict,
                 aux_params: Optional[Dict] = None, *,
                 sample_shape: Sequence[int],
                 input_dtype: str = "float32",
                 compute_dtype: Optional[str] = "bfloat16",
                 max_batch: Optional[int] = None,
                 batch_sizes: Optional[Sequence[int]] = None,
                 source: str = "inline",
                 device=None):
        from .. import env as _env

        self.device = resolve_device(device)
        self.name = str(name)
        self.source = source
        #: version number within a ModelServer (assigned by add_model/
        #: reload; labels serving metrics and the canary decision)
        self.version = 1
        self.sample_shape = tuple(int(d) for d in sample_shape)
        self.compute_dtype = compute_dtype
        self.max_batch = int(max_batch) if max_batch is not None \
            else _env.get_int("MXNET_SERVE_MAX_BATCH")
        self.plan = plan_batch_buckets(self.max_batch, batch_sizes)
        self._apply = apply_fn
        self._input_dtype_arg = input_dtype
        self._input_dtype = _torch_dtype(
            compute_dtype if compute_dtype and "float" in str(input_dtype)
            else input_dtype)
        self._params = self._cast_tree(params or {})
        self._aux = self._cast_tree(aux_params or {})
        self._compile_ms: Dict[int, float] = {}
        self._lock = threading.Lock()

    def _cast_tree(self, tree):
        """Host params (numpy or torch) -> tensors on the device,
        floats cast to the compute dtype ONCE at load."""
        cd = _torch_dtype(self.compute_dtype) if self.compute_dtype \
            else None

        def put(v):
            t = torch.as_tensor(v)
            if cd is not None and t.is_floating_point():
                t = t.to(cd)
            return t.to(self.device)

        return _map(tree, put)

    # -- warmup ----------------------------------------------------------
    @property
    def compiled(self) -> bool:
        return len(self._compile_ms) == len(self.plan)

    def bucket_for(self, n: int) -> int:
        """Smallest planned bucket holding ``n`` samples."""
        for b in self.plan:
            if n <= b:
                return b
        raise ValueError("%d samples > max batch %d for model %r"
                         % (n, self.plan[-1], self.name))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def compile(self, warmup: bool = True) -> Dict[int, float]:
        """Run (default) one zero batch through every bucket so the
        first real request pays no first-shape cost — the eager
        counterpart of the JAX package's AOT compile.  Idempotent;
        returns {bucket: ms}."""
        from .. import diagnostics as _diag

        bind_device(self.device)
        for b in self.plan:
            with self._lock:
                if b in self._compile_ms:
                    continue
            t0 = time.perf_counter()
            if warmup:
                zeros = np.zeros((b,) + self.sample_shape, dtype="float32")
                with torch.no_grad():
                    self._apply(self._params, self._aux,
                                self._to_device(zeros, b))
                self._sync()
            dur_ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self._compile_ms[b] = dur_ms
            try:
                _diag.metrics.counter(
                    "mxnet_serve_compiles_total",
                    help="AOT-compiled serving executors",
                    labels={"model": self.name}).inc()
                _diag.metrics.gauge(
                    "mxnet_serve_compile_ms_last",
                    labels={"model": self.name}).set(dur_ms)
            except Exception:
                pass
            _log.info("serving: warmed %s bucket=%d in %.0f ms "
                      "(warmup=%s)", self.name, b, dur_ms, warmup)
        return dict(self._compile_ms)

    def compile_stats(self) -> Dict[int, float]:
        with self._lock:
            return dict(self._compile_ms)

    # -- execution -----------------------------------------------------
    def _to_device(self, batch, bucket: int) -> torch.Tensor:
        arr = np.asarray(batch)
        n = arr.shape[0]
        if arr.shape[1:] != self.sample_shape:
            raise ValueError(
                "model %r expects sample shape %s, got %s"
                % (self.name, self.sample_shape, arr.shape[1:]))
        if n < bucket:  # pad to the planned bucket
            pad = np.zeros((bucket - n,) + self.sample_shape,
                           dtype=arr.dtype)
            arr = np.concatenate([arr, pad], axis=0)
        return torch.as_tensor(arr).to(self.device, self._input_dtype)

    def execute(self, batch):
        """Run one dynamic batch (shape ``(n, *sample_shape)``): pad to
        the nearest bucket, execute, slice the padding back off, return
        numpy.  Raises :class:`ExecutorFailure` on any executor error
        (or a chaos ``fail_execute`` injection) — the breaker's food."""
        from .. import chaos as _chaos

        n = int(np.asarray(batch).shape[0])
        bucket = self.bucket_for(n)
        if not self.compiled:
            self.compile(warmup=False)
        if _chaos.enabled() and _chaos.should_fail_execute(self.name):
            err = ExecutorFailure(
                "chaos fail_execute injected for model %r" % self.name)
            # the request recorder tags the failure span injected=true
            err.injected = True
            raise err
        x = self._to_device(batch, bucket)  # ValueError: caller's fault
        try:
            with torch.no_grad():
                out = self._apply(self._params, self._aux, x)
            return _map(out, lambda a: _to_host(a)[:n])
        except Exception as e:
            raise ExecutorFailure(
                "executor for %r (bucket %d) failed: %r"
                % (self.name, bucket, e)) from e

    # -- constructors --------------------------------------------------
    @classmethod
    def from_checkpoint(cls, name: str, directory: str,
                        apply_fn: Callable, *,
                        sample_shape: Sequence[int],
                        step: Optional[int] = None,
                        num_ranks: int = 1, rank: int = 0,
                        **kw) -> "ModelRuntime":
        """Load params/aux from a checkpoint directory (either
        package's layout).  An incomplete step surfaces the exact
        missing ranks."""
        from .. import checkpoint as _ckpt

        payload = _ckpt.load_checkpoint(directory, step=step, rank=rank,
                                        num_ranks=num_ranks)
        params = payload.get("params") or {}
        if not params:
            raise ValueError(
                "checkpoint step %s under %r holds no params — nothing "
                "to serve" % (payload.get("step"), directory))
        return cls(name, apply_fn, params,
                   aux_params=payload.get("aux_params"),
                   sample_shape=sample_shape,
                   source="checkpoint:%s@step%s"
                   % (directory, payload.get("step")), **kw)

    def successor_from_checkpoint(self, directory: str,
                                  step: Optional[int] = None
                                  ) -> "ModelRuntime":
        """A NEW version of this model from a (verified) checkpoint:
        same apply_fn, sample shape, dtypes, bucket ladder and device —
        only the weights change.  What :meth:`ModelServer.reload`
        builds and canaries."""
        return type(self).from_checkpoint(
            self.name, directory, self._apply,
            sample_shape=self.sample_shape, step=step,
            input_dtype=self._input_dtype_arg,
            compute_dtype=self.compute_dtype,
            max_batch=self.max_batch, batch_sizes=self.plan,
            device=self.device)


def demo_params(dim: int = 16, hidden: int = 32, classes: int = 4,
                seed: int = 0) -> Dict[str, Any]:
    """The demo MLP's fixed-seed host params (the JAX package's, draw
    for draw) — exposed so tests can checkpoint them and drive the
    reload-from-checkpoint path with a distinguishable version."""
    rng = np.random.RandomState(seed)
    return {
        "w1": rng.randn(dim, hidden).astype("float32") * 0.1,
        "b1": np.zeros(hidden, dtype="float32"),
        "w2": rng.randn(hidden, classes).astype("float32") * 0.1,
        "b2": np.zeros(classes, dtype="float32"),
    }


def _demo_apply(p, aux, x):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    logits = h @ p["w2"] + p["b2"]
    return torch.argmax(logits, dim=-1), logits


def demo_runtime(name: str = "demo", dim: int = 16, hidden: int = 32,
                 classes: int = 4, seed: int = 0,
                 **kw) -> ModelRuntime:
    """A small fixed-seed MLP (``tanh(x W1 + b1) W2 + b2``; returns
    ``(argmax, logits)``) on ``device`` (default ``cuda``)."""
    return ModelRuntime(name, _demo_apply,
                        demo_params(dim, hidden, classes, seed),
                        sample_shape=(dim,), **kw)
