"""Runtime health for the port's serving tier and its transformer
training loop: the metrics registry, its Prometheus text exposition,
the SIGTERM / SIGUSR1 hooks and the loss-spike divergence guard.

Counterpart: ``mxnet_tpu/diagnostics.py``, the subset serving uses —
``Gauge``/``Counter``/``Histogram``/``MetricsRegistry`` and
:data:`metrics` (same metric names, label sets and exposition, so a
dashboard reads either package), :func:`validate_prom_text`, the
preemption and dump hooks, :func:`touch_heartbeat`, ``EXIT_PREEMPTED``,
and for training :class:`DivergenceGuard`, :func:`loss_signal` and the
``mxnet_transformer_tokens_per_second`` gauge; for the input tier
the io feeds (``feed_io_bytes``, ``feed_io_queue_depth``,
``feed_io_decode_seconds``, ``feed_io_worker_death``) under the JAX
package's metric names; for the parameter server the dead peers its
heartbeat reports (:func:`set_dead_peers` / :func:`dead_peers`, the
``mxnet_ps_dead_peers`` gauge) and the kvstore byte counter
(:func:`feed_kvstore_bytes`); for the device timeline the bucket plan
a step builder stamps (:func:`set_bucket_plan` / :func:`bucket_plan`,
which traceview matches collectives against) and the
``mxnet_step_phase_seconds{phase}`` histograms its attribution feeds
(:func:`feed_phase_seconds`).  The guard always
raises: its supervised exit (84) comes with the elastic supervisor
(ROADMAP A11b).  The port's collectives (the dp buckets, sync
BatchNorm, sequence and tensor parallelism, the kvstore verbs) run
without the collective flight recorder and its watchdog, which are
queued (ROADMAP A11b), so the
signal handlers here run the hooks only: SIGUSR1 runs the dump hooks;
SIGTERM runs the dump hooks, then the preemption hooks, and exits 83
when one ran.

Recompile tracking (:func:`instrument_jit`, :func:`recompile_stats`,
:func:`recorded_steps`) keeps the JAX package's names and surface.
Eager PyTorch compiles no program, so a "recompile" here is a call of
a step under an input signature (shapes, dtypes, devices) the step has
not run before: that is where cuDNN plans its algorithms anew, the
caching allocator grows and the port's own per-shape caches (the
kernels' launch plans, the bucket flats) fill — the eager counterpart
of a retrace, and what shape churn costs.  More than
``MXNET_RECOMPILE_WARN_N`` such calls of one step name log one
RECOMPILATION STORM warning with the recent signatures.  Each wrapper
records its step ``(callable, specs, meta)`` for the static auditor
(``mxnet_tpu_torch.analysis``) the first time it sees a signature; the
port holds the step weakly (a step its caller dropped leaves the list,
where the JAX package pins it until :func:`reset_recompile_stats`).
"""
from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Gauge", "Counter", "Histogram", "MetricsRegistry", "metrics",
    "validate_prom_text", "EXIT_PREEMPTED",
    "register_preemption_hook", "unregister_preemption_hook",
    "run_preemption_hooks", "register_dump_hook",
    "run_dump_hooks", "install_signal_handlers",
    "touch_heartbeat", "DivergenceError",
    "DivergenceGuard", "tokens_per_second_gauge",
    "feed_io_bytes", "feed_io_queue_depth", "feed_io_decode_seconds",
    "feed_io_worker_death", "set_dead_peers", "dead_peers",
    "feed_kvstore_bytes", "set_bucket_plan", "bucket_plan",
    "feed_phase_seconds", "instrument_jit", "recompile_stats",
    "reset_recompile_stats", "recorded_steps", "TensorSpec",
]

_log = logging.getLogger(__name__)

#: SIGTERM landed and the preemption hooks ran (for serving: the
#: server drained, every admitted request answered)
EXIT_PREEMPTED = 83


def _dump_dir_path(path: str) -> str:
    """Relative artifact paths land under MXNET_DUMP_DIR (created on
    demand); absolute paths — and unset env — pass through."""
    if os.path.isabs(path):
        return path
    from . import env as _envmod

    base = _envmod.get_str("MXNET_DUMP_DIR")
    if not base:
        return path
    try:
        os.makedirs(base, exist_ok=True)
    except OSError:
        return path
    return os.path.join(base, path)


def _rank_info() -> Tuple[int, int]:
    """(rank, num_workers): the launcher env's DMLC_WORKER_ID /
    DMLC_NUM_WORKER (tools/launch.py), then the process group once
    ``dist.initialize()`` has run (one process per device), then
    MXNET_PROCESS_ID / MXNET_NUM_PROCESSES."""
    import torch.distributed as tdist

    if os.environ.get("DMLC_WORKER_ID") is not None:
        return (int(os.environ["DMLC_WORKER_ID"]),
                int(os.environ.get("DMLC_NUM_WORKER", "1")))
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    from . import env as _env

    if os.environ.get("MXNET_PROCESS_ID") not in (None, ""):
        return (_env.get_int("MXNET_PROCESS_ID"),
                _env.get_int("MXNET_NUM_PROCESSES"))
    return 0, 1


# ---------------------------------------------------------------------------
# preemption and dump hooks
# ---------------------------------------------------------------------------
# reentrant: SIGTERM may land on the main thread while it holds this
# lock in register/unregister
_preempt_lock = threading.RLock()
_preempt_hooks: "Dict[Any, Any]" = {}
_dump_hooks_lock = threading.RLock()
_dump_hooks: "Dict[Any, Any]" = {}
_signals_installed = False


def register_preemption_hook(fn, key: Any = None) -> Any:
    """Register ``fn()`` to run when this process is preempted
    (SIGTERM).  Returns the key for :func:`unregister_preemption_hook`.
    Arms the signal handlers (from the main thread)."""
    key = key if key is not None else id(fn)
    with _preempt_lock:
        _preempt_hooks[key] = fn
    if not _signals_installed:
        install_signal_handlers()
    return key


def unregister_preemption_hook(key: Any) -> None:
    with _preempt_lock:
        _preempt_hooks.pop(key, None)


def run_preemption_hooks(reason: str) -> int:
    """Run every registered hook (newest first); returns how many ran
    without raising.  Never raises."""
    with _preempt_lock:
        hooks = list(_preempt_hooks.items())
    ran = 0
    for key, fn in reversed(hooks):
        try:
            fn()
            ran += 1
        except Exception:
            _log.exception("preemption hook %r failed (%s)", key, reason)
    return ran


def register_dump_hook(fn, key: Any = None) -> Any:
    """Register ``fn(reason)`` to run whenever this process dumps
    evidence on a signal (SIGUSR1/SIGTERM) — the serving request
    recorder rides this.  No exit semantics.  Arms the signal
    handlers, like :func:`register_preemption_hook`."""
    key = key if key is not None else id(fn)
    with _dump_hooks_lock:
        _dump_hooks[key] = fn
    if not _signals_installed:
        install_signal_handlers()
    return key


def run_dump_hooks(reason: str) -> int:
    """Run every registered dump hook; returns how many ran without
    raising.  Never raises — this runs inside signal handlers."""
    with _dump_hooks_lock:
        hooks = list(_dump_hooks.items())
    ran = 0
    for key, fn in hooks:
        try:
            fn(reason)
            ran += 1
        except Exception:
            _log.exception("dump hook %r failed (%s)", key, reason)
    return ran


def install_signal_handlers() -> bool:
    """SIGUSR1 runs the dump hooks, then chains to any handler the app
    installed.  SIGTERM: (1) the dump hooks, (2) the preemption hooks,
    (3) ``os._exit(EXIT_PREEMPTED)`` when one ran; otherwise it chains
    to the previous handler (default: die).  ``signal.signal`` works on
    the main thread only: elsewhere this returns False and a later
    main-thread registration installs them."""
    global _signals_installed
    if threading.current_thread() is not threading.main_thread():
        return False
    _signals_installed = True
    try:
        prev_usr1 = signal.getsignal(signal.SIGUSR1)

        def _usr1(signum, frame):
            run_dump_hooks("SIGUSR1")
            if callable(prev_usr1):
                prev_usr1(signum, frame)

        prev_term = signal.getsignal(signal.SIGTERM)

        def _term(signum, frame):
            run_dump_hooks("SIGTERM")
            ran = run_preemption_hooks("SIGTERM")
            if ran:
                _log.warning(
                    "SIGTERM: %d preemption hook(s) ran — exiting %d "
                    "(resumable)", ran, EXIT_PREEMPTED)
                os._exit(EXIT_PREEMPTED)
            if prev_term is signal.SIG_IGN:
                return
            if callable(prev_term):
                prev_term(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGUSR1, _usr1)
        signal.signal(signal.SIGTERM, _term)
        return True
    except (ValueError, OSError, AttributeError):
        return False


_hb_lock = threading.Lock()
_hb_last = 0.0
_hb_path: Optional[str] = None


def touch_heartbeat(min_interval_s: float = 0.5) -> Optional[str]:
    """Liveness beacon for an elastic supervisor: utime/create
    ``$MXNET_ELASTIC_HEARTBEAT_DIR/hb_rank{K}``, rate-limited to one
    ``utime`` every ``min_interval_s``.  No-op (None) when the env is
    unset."""
    global _hb_last, _hb_path
    from . import env as _envmod

    d = _envmod.get_str("MXNET_ELASTIC_HEARTBEAT_DIR")
    if not d:
        return None
    now = time.monotonic()
    with _hb_lock:
        if now - _hb_last < min_interval_s and _hb_path:
            return _hb_path
        _hb_last = now
    path = os.path.join(d, "hb_rank%d" % _rank_info()[0])
    try:
        os.makedirs(d, exist_ok=True)
        if os.path.exists(path):
            os.utime(path)
        else:
            with open(path, "w"):
                pass
        _hb_path = path
        return path
    except OSError:
        return None


_dead_peers_lock = threading.Lock()
_dead_peers: List[str] = []


def set_dead_peers(peers) -> None:
    """Record the peers the parameter server's heartbeat declared dead
    (``_ps.Heartbeat`` feeds this from the scheduler's ``dead_nodes``)."""
    with _dead_peers_lock:
        _dead_peers[:] = [str(p) for p in (peers or [])]


def dead_peers() -> List[str]:
    with _dead_peers_lock:
        return list(_dead_peers)


# ---------------------------------------------------------------------------
# step-metrics registry (gauge / counter / histogram, prom exposition)
# ---------------------------------------------------------------------------
def _prom_name(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        ok = ch.isalnum() or ch in "_:"
        if ch.isdigit() and i == 0:
            out.append("_")
        out.append(ch if ok else "_")
    return "".join(out)


def _prom_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (_prom_name(str(k)),
                     str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(labels.items()))
    return "{%s}" % inner


def _fmt(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"  # a diverged loss must still export, not crash
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Gauge:
    """Last-write-wins scalar (step_time, loss, allocator peak)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels=None):
        self.name, self.help, self.labels = name, help, labels
        self._lock = threading.Lock()
        self.value: Optional[float] = None
        self.updated_ts: Optional[float] = None

    def set(self, value) -> None:
        with self._lock:
            self.value = float(value)
            self.updated_ts = time.time()

    def sample_lines(self) -> List[str]:
        with self._lock:
            v = self.value
        if v is None:
            return []
        return ["%s%s %s" % (_prom_name(self.name),
                             _prom_labels(self.labels), _fmt(v))]

    def to_dict(self) -> dict:
        with self._lock:
            return {"type": "gauge", "value": self.value,
                    "updated_ts": self.updated_ts,
                    "labels": self.labels or None}


class Counter:
    """Monotonic accumulator (samples seen, kvstore bytes, recompiles)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels=None):
        self.name, self.help, self.labels = name, help, labels
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, delta=1) -> None:
        if delta < 0:
            raise ValueError("counters only go up (got %r)" % (delta,))
        with self._lock:
            self.value += float(delta)

    def sample_lines(self) -> List[str]:
        with self._lock:
            v = self.value
        return ["%s%s %s" % (_prom_name(self.name),
                             _prom_labels(self.labels), _fmt(v))]

    def to_dict(self) -> dict:
        with self._lock:
            return {"type": "counter", "value": self.value,
                    "labels": self.labels or None}


# seconds-scale latencies: 1ms .. 60s
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Histogram:
    """Cumulative-bucket histogram, prom exposition semantics
    (``_bucket{le=...}`` counts are cumulative; ``+Inf`` == count)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels=None,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name, self.help, self.labels = name, help, labels
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1: +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value) -> None:
        v = float(value)
        with self._lock:
            self.sum += v
            self.count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1

    def _cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self._counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Interpolated q-quantile — prometheus' histogram_quantile
        semantics (linear within the containing bucket, the +Inf bucket
        clamps to the highest finite bound): the serving SLO gauges
        ``<name>_p50``/``<name>_p99`` of ``to_prom()``."""
        with self._lock:
            if not self.count:
                return None
            target = q * self.count
            cum = self._cumulative()
        prev_cum = 0
        for i, c in enumerate(cum):
            if c >= target:
                if i >= len(self.buckets):
                    return self.buckets[-1]  # +Inf bucket: clamp
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                in_bucket = c - prev_cum
                if in_bucket <= 0:
                    return hi
                return lo + (hi - lo) * (target - prev_cum) / in_bucket
            prev_cum = c
        return self.buckets[-1]

    def sample_lines(self) -> List[str]:
        name = _prom_name(self.name)
        base = dict(self.labels or {})
        with self._lock:
            cum = self._cumulative()
            s, n = self.sum, self.count
        lines = []
        for b, c in zip(self.buckets, cum[:-1]):
            lines.append("%s_bucket%s %d"
                         % (name, _prom_labels({**base, "le": _fmt(b)}), c))
        lines.append("%s_bucket%s %d"
                     % (name, _prom_labels({**base, "le": "+Inf"}), cum[-1]))
        lines.append("%s_sum%s %s" % (name, _prom_labels(self.labels),
                                      _fmt(s)))
        lines.append("%s_count%s %d" % (name, _prom_labels(self.labels), n))
        return lines

    def to_dict(self) -> dict:
        with self._lock:
            return {"type": "histogram", "count": self.count,
                    "sum": self.sum,
                    "buckets": {_fmt(b): c for b, c in
                                zip(self.buckets, self._cumulative()[:-1])},
                    "labels": self.labels or None}


class MetricsRegistry:
    """Named-metric registry with one instance per (name, labels) pair;
    ``to_prom()`` renders the whole registry as Prometheus text
    exposition, ``dump_json()`` as a machine-readable dict, ``flush()``
    writes the MXNET_METRICS_FILE exposition (rate-limited by
    MXNET_METRICS_INTERVAL_S, default 30s; ``force=True`` bypasses)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, frozenset], Any] = {}
        self._last_flush = 0.0

    def _get(self, cls, name: str, help: str, labels, **kw):
        key = (name, frozenset((labels or {}).items()))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help=help, labels=labels, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError("metric %r already registered as %s"
                                % (name, type(m).__name__))
            return m

    def gauge(self, name: str, help: str = "", labels=None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def counter(self, name: str, help: str = "", labels=None) -> Counter:
        return self._get(Counter, name, help, labels)

    def histogram(self, name: str, help: str = "", labels=None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def _sorted(self):
        with self._lock:
            items = list(self._metrics.values())
        return sorted(items, key=lambda m: (m.name,
                                            str(m.labels or "")))

    def to_prom(self) -> str:
        """Prometheus text exposition (one HELP/TYPE block per metric
        name, samples after) — the format node_exporter serves.

        Every histogram additionally exports interpolated ``_p50`` /
        ``_p99`` gauge families (serving SLO reporting needs quantiles
        a scraper can alert on directly, not just cumulative buckets);
        the derived families are grouped after the primary metrics so
        no family's samples interleave."""
        lines: List[str] = []
        seen_hdr = set()
        derived: List[Tuple[str, str, Any, float]] = []
        for m in self._sorted():
            pname = _prom_name(m.name)
            if pname not in seen_hdr:
                seen_hdr.add(pname)
                if m.help:
                    lines.append("# HELP %s %s"
                                 % (pname, m.help.replace("\n", " ")))
                lines.append("# TYPE %s %s" % (pname, m.kind))
            lines.extend(m.sample_lines())
            if isinstance(m, Histogram):
                for q, suffix in ((0.5, "_p50"), (0.99, "_p99")):
                    v = m.quantile(q)
                    if v is not None:
                        derived.append((pname + suffix,
                                        _prom_labels(m.labels), q, v))
        for dname, labels, q, v in sorted(derived,
                                          key=lambda t: (t[0], t[1])):
            if dname not in seen_hdr:
                seen_hdr.add(dname)
                lines.append("# HELP %s interpolated q=%s of %s"
                             % (dname, _fmt(q), dname.rsplit("_p", 1)[0]))
                lines.append("# TYPE %s gauge" % dname)
            lines.append("%s%s %s" % (dname, labels, _fmt(v)))
        return "\n".join(lines) + ("\n" if lines else "")

    def dump_json(self) -> dict:
        out: Dict[str, Any] = {}
        for m in self._sorted():
            d = m.to_dict()
            key = m.name if not m.labels else \
                m.name + _prom_labels(m.labels)
            out[key] = d
        rank, num_workers = _rank_info()
        return {"rank": rank, "num_workers": num_workers,
                "ts": time.time(), "metrics": out}

    def flush(self, path: Optional[str] = None, force: bool = True
              ) -> Optional[str]:
        from . import env as _envmod

        if path is None:
            path = _envmod.get_str("MXNET_METRICS_FILE")
        if not path:
            return None
        # no `or` fallback: MXNET_METRICS_INTERVAL_S=0 legitimately
        # means flush on every step
        interval = _envmod.get_float("MXNET_METRICS_INTERVAL_S")
        now = time.time()
        with self._lock:
            if not force and now - self._last_flush < interval:
                return None
            self._last_flush = now
        rank, num_workers = _rank_info()
        if num_workers > 1:
            root, ext = os.path.splitext(path)
            path = "%s_rank%d%s" % (root, rank, ext or ".prom")
        path = _dump_dir_path(path)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(self.to_prom())
            os.replace(tmp, path)  # scrapers never see a torn file
            return path
        except OSError:
            return None

    def maybe_flush(self) -> Optional[str]:
        """Rate-limited flush — the per-step feed calls this so a
        configured MXNET_METRICS_FILE stays fresh without a writer
        thread."""
        return self.flush(force=False)


#: process-wide registry — the serving tier feeds it
metrics = MetricsRegistry()


# ---------------------------------------------------------------------------
# prom-text validation (used by the self-test and tests)
# ---------------------------------------------------------------------------
def validate_prom_text(text: str) -> List[str]:
    """Validate Prometheus text-exposition syntax + histogram
    invariants; returns a list of problems (empty == valid)."""
    import re

    problems: List[str] = []
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
        r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""
        r"(?:,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})?"
        r" (NaN|[+-]?Inf|[+-]?[0-9.eE+-]+)$")
    label_re = re.compile(r"([a-zA-Z_][a-zA-Z0-9_]*)=\"([^\"]*)\"")

    def label_key(labels: str, drop: str = "le") -> frozenset:
        return frozenset((k, v) for k, v in label_re.findall(labels or "")
                         if k != drop)

    typed: Dict[str, str] = {}
    hist_counts: Dict[Tuple[str, frozenset], float] = {}
    hist_inf: Dict[Tuple[str, frozenset], float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line:
            problems.append("line %d: empty line" % lineno)
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "gauge", "counter", "histogram", "summary", "untyped"):
                problems.append("line %d: bad TYPE line" % lineno)
            else:
                typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = sample_re.match(line)
        if not m:
            problems.append("line %d: unparsable sample %r" % (lineno, line))
            continue
        name, labels = m.group(1), m.group(2) or ""
        value = float(m.group(3).replace("Inf", "inf"))
        if name.endswith("_count") and typed.get(name[:-6]) == "histogram":
            hist_counts[(name[:-6], label_key(labels))] = value
        if name.endswith("_bucket") and 'le="+Inf"' in labels:
            hist_inf[(name[:-7], label_key(labels))] = value
    for key, count in hist_counts.items():
        # exposition contract: the +Inf bucket equals _count
        inf = hist_inf.get(key)
        if inf is None:
            problems.append("histogram %s: no +Inf bucket" % (key,))
        elif inf != count:
            problems.append("histogram %s: +Inf bucket %s != count %s"
                            % (key, inf, count))
    return problems



# ---------------------------------------------------------------------------
# training: the divergence guard and the throughput gauge
# ---------------------------------------------------------------------------
def tokens_per_second_gauge() -> Gauge:
    """The transformer fit loop's throughput gauge (tokens/s of the
    last step, this rank), under the JAX package's name."""
    return metrics.gauge(
        "mxnet_transformer_tokens_per_second",
        "transformer fit throughput (tokens/s, this rank)")


def loss_signal(name_values) -> Optional[float]:
    """The loss-like scalar among a metric's ``(name, value)`` pairs —
    what ``Module.fit``'s divergence guard feeds on: the first metric
    whose name says loss/entropy/perplexity (spiking accuracy is not
    divergence); failing that, any non-finite metric value."""
    import math

    fallback = None
    for name, value in (name_values or ()):
        try:
            v = float(value)
        except (TypeError, ValueError):
            continue
        n = str(name).lower()
        if any(t in n for t in ("loss", "entropy", "perplex", "nll")):
            return v
        if not math.isfinite(v) and fallback is None:
            fallback = v
    return fallback


class DivergenceError(RuntimeError):
    """The loss-spike guard tripped: training was stopped rather than
    continued through garbage."""


class DivergenceGuard:
    """Loss-spike detector (``MXNET_DIVERGENCE_WINDOW`` /
    ``MXNET_DIVERGENCE_FACTOR``): once ``window`` losses are observed, a
    step whose loss exceeds ``median + factor x |median|`` of the window
    (or is non-finite) is divergence.

    :meth:`check` feeds one loss and returns True on a trip (counted in
    ``mxnet_training_divergence_trips_total``).  :meth:`trip` raises
    :class:`DivergenceError`.  The JAX package's supervised exit and its
    flight-recorder dump are not ported: the port has no elastic
    supervisor and no collective flight recorder yet (ROADMAP A11b)."""

    def __init__(self, window: Optional[int] = None,
                 factor: Optional[float] = None):
        from . import env as _envmod

        self.window = int(_envmod.get_int("MXNET_DIVERGENCE_WINDOW")
                          if window is None else window)
        self.factor = float(_envmod.get_float("MXNET_DIVERGENCE_FACTOR")
                            if factor is None else factor)
        self._history: List[float] = []

    @property
    def enabled(self) -> bool:
        return self.window > 0

    def check(self, loss: float, step: Optional[int] = None) -> bool:
        """Feed one step's loss; True when it diverged from the window.
        The spiking loss is not folded into the baseline."""
        if not self.enabled:
            return False
        import math

        loss = float(loss)
        finite = math.isfinite(loss)
        spiked = not finite
        if finite and len(self._history) >= self.window:
            med = sorted(self._history)[len(self._history) // 2]
            # scale-relative above and below zero
            spiked = loss > med + self.factor * max(abs(med), 1e-8)
        if spiked:
            metrics.counter(
                "mxnet_training_divergence_trips_total",
                help="steps the loss-spike divergence guard flagged"
            ).inc()
            _log.error(
                "DIVERGENCE: loss %r at step %s tripped the guard "
                "(window %d, factor %.2f, window median %s)",
                loss, step, self.window, self.factor,
                sorted(self._history)[len(self._history) // 2]
                if self._history else None)
            return True
        if finite:
            self._history.append(loss)
            if len(self._history) > self.window:
                del self._history[0]
        return False

    def trip(self, step: Optional[int] = None) -> None:
        """Stop training: raise :class:`DivergenceError`."""
        raise DivergenceError(
            "loss diverged at step %s (window %d, factor %.2f); restore "
            "from the last verified checkpoint" % (step, self.window,
                                                    self.factor))


# ---------------------------------------------------------------------------
# the stamped bucket plan (traceview matches collectives against it)
# ---------------------------------------------------------------------------
_plan_lock = threading.Lock()
_bucket_plan: Optional[dict] = None
_bucket_plan_owner: Optional[int] = None


def set_bucket_plan(plan_meta: Optional[dict],
                    owner: Optional[int] = None) -> None:
    """Stamp the bucket plan (``buckets.plan_meta``) of the step that
    runs; step builders pass their ``id()`` as ``owner`` so a
    monolithic rebuild only clears its own stale plan, never one a
    different live bucketed step stamped."""
    global _bucket_plan, _bucket_plan_owner
    with _plan_lock:
        if not plan_meta and _bucket_plan_owner is not None and \
                owner is not None and _bucket_plan_owner != owner:
            return
        _bucket_plan = dict(plan_meta) if plan_meta else None
        _bucket_plan_owner = owner if plan_meta else None


def bucket_plan() -> Optional[dict]:
    with _plan_lock:
        return dict(_bucket_plan) if _bucket_plan else None


def feed_phase_seconds(phase_steps) -> None:
    """``mxnet_step_phase_seconds{phase}``: traceview's attributed
    per-step phase durations, one histogram per phase.  ``phase_steps``
    maps phase name to a list of per-step seconds.  Never fails the
    capture it describes."""
    try:
        for phase, vals in (phase_steps or {}).items():
            h = metrics.histogram(
                "mxnet_step_phase_seconds",
                help="measured device seconds per step phase "
                     "(traceview attribution)",
                labels={"phase": str(phase)})
            for v in vals:
                h.observe(float(v))
        metrics.maybe_flush()
    except Exception:
        pass


# ---------------------------------------------------------------------------
# the input tier's feeds (io.py, io_pipeline.py); guarded so telemetry
# never fails the input pipeline
# ---------------------------------------------------------------------------
def feed_kvstore_bytes(op: str, nbytes: int) -> None:
    """Cumulative ``mxnet_kvstore_bytes_total{op=...}`` feed (the bytes a
    kvstore verb put on the wire); never fails the verb it measures."""
    try:
        metrics.counter("mxnet_kvstore_bytes_total",
                        help="cumulative kvstore payload bytes",
                        labels={"op": op}).inc(int(nbytes))
    except Exception:
        pass


def feed_io_bytes(nbytes: int) -> None:
    """Cumulative ``mxnet_io_bytes_total``: bytes the iterators'
    fetch path materialized."""
    try:
        metrics.counter("mxnet_io_bytes_total",
                        help="host bytes materialized by the "
                             "input pipeline").inc(int(nbytes))
    except Exception:
        pass


def feed_io_queue_depth(depth: int) -> None:
    """``mxnet_io_queue_depth``: batches on the card waiting ahead of
    the consumer (the device stage's queue).  Persistently 0 while the
    step is input-bound means the decode pool is the bottleneck;
    persistently full means the card is."""
    try:
        metrics.gauge("mxnet_io_queue_depth",
                      help="input-pipeline prefetch queue depth "
                           "(batches ready ahead of the consumer)"
                      ).set(int(depth))
    except Exception:
        pass


def feed_io_decode_seconds(seconds: float) -> None:
    """``mxnet_io_decode_seconds``: one decode-pool worker's wall time
    for one batch (shipped with the batch's slot message)."""
    try:
        metrics.histogram("mxnet_io_decode_seconds",
                          help="per-batch decode wall time in the "
                               "input-pipeline worker pool"
                          ).observe(float(seconds))
    except Exception:
        pass


def feed_io_worker_death() -> None:
    """``mxnet_io_worker_deaths_total``: decode workers that died and
    whose shard the parent adopted inline."""
    try:
        metrics.counter("mxnet_io_worker_deaths_total",
                        help="decode-pool workers that died "
                             "(shard adopted inline by the parent)"
                        ).inc()
    except Exception:
        pass


# ---------------------------------------------------------------------------
# recompile tracking
# ---------------------------------------------------------------------------
_recompile_lock = threading.RLock()
_recompile: Dict[str, dict] = {}
_recompile_warned: Dict[str, bool] = {}
# name -> (reference to the step callable, arg specs, meta): the static
# auditor's work list, captured on the calls that saw a new signature
_recorded_steps: Dict[str, Tuple[Any, tuple, dict]] = {}


class TensorSpec(tuple):
    """``(shape, dtype, device)`` of one tensor argument: what a
    recorded step is called with again (``materialize``), without
    holding the tensor."""

    __slots__ = ()

    def __new__(cls, shape, dtype, device):
        return tuple.__new__(cls, (tuple(int(d) for d in shape), dtype,
                                   str(device)))

    @property
    def shape(self):
        return self[0]

    @property
    def dtype(self):
        return self[1]

    @property
    def device(self):
        return self[2]

    def materialize(self):
        """A zero tensor of this spec (zeros are valid class ids and
        token ids, so a train step runs on them)."""
        import torch

        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)


def _tensor_of(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x
    data = getattr(x, "_data", None)      # an NDArray
    return data if isinstance(data, torch.Tensor) else None


def _arg_specs(args) -> tuple:
    """Each tensor (or NDArray) argument replaced by its
    :class:`TensorSpec`, recursively through lists, tuples and dicts."""
    def spec(x):
        t = _tensor_of(x)
        if t is not None:
            return TensorSpec(t.shape, t.dtype, t.device)
        if isinstance(x, (list, tuple)):
            return type(x)(spec(y) for y in x) if type(x) in (list, tuple) \
                else tuple(spec(y) for y in x)
        if isinstance(x, dict):
            return {k: spec(v) for k, v in x.items()}
        return x

    return tuple(spec(a) for a in args)


def _signature(args) -> tuple:
    """The hashable (shape, dtype, device) signature of a call's tensor
    arguments: the churn axis the storm warning reports."""
    sig = []

    def visit(x):
        t = _tensor_of(x)
        if t is not None:
            sig.append((tuple(t.shape), str(t.dtype).replace("torch.", ""),
                        str(t.device)))
        elif isinstance(x, (list, tuple)):
            for y in x:
                visit(y)
        elif isinstance(x, dict):
            for y in x.values():
                visit(y)

    for a in args:
        visit(a)
    return tuple(sig)


def _warn_threshold() -> int:
    from . import env as _envmod

    return _envmod.get_int("MXNET_RECOMPILE_WARN_N")


def _weak(fn):
    """A callable returning ``fn``, or None once its owner is gone (a
    bound method is held weakly; anything else strongly)."""
    import weakref

    if getattr(fn, "__self__", None) is not None and \
            hasattr(fn, "__func__"):
        try:
            return weakref.WeakMethod(fn)
        except TypeError:
            pass
    return lambda: fn


class _InstrumentedStep:
    """Transparent wrapper of one step callable: the calls under a
    signature it has not seen are its "compiles" (timed, counted in the
    registry and the metrics, stamped as ``compile`` spans while the
    profiler runs, recorded for the auditor), and past
    ``MXNET_RECOMPILE_WARN_N`` of them one warning fires a name."""

    def __init__(self, name: str, fn, meta: Optional[dict] = None):
        self._name = name
        # held as the registry holds it: a step keeping its own wrapper
        # makes no reference cycle
        self._ref = _weak(fn)
        self._meta = dict(meta) if meta else {}
        self._seen: set = set()
        with _recompile_lock:
            _recompile.setdefault(name, {
                "count": 0, "total_ms": 0.0, "max_ms": 0.0,
                "avals": [], "last_ms": 0.0})

    def __call__(self, *args, **kwargs):
        sig = _signature(args)
        fresh = sig not in self._seen
        fn = self._ref()
        if fn is None:
            raise ReferenceError("the step %r wrapped for recompile "
                                 "tracking no longer exists" % self._name)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if fresh:
            self._seen.add(sig)
            self._record_compile(sig, (time.perf_counter() - t0) * 1e3)
            try:
                with _recompile_lock:
                    _recorded_steps[self._name] = (
                        self._ref, _arg_specs(args), self._meta)
            except Exception:
                pass  # the audit hook never fails a step
        return out

    def _record_compile(self, sig, dur_ms: float) -> None:
        with _recompile_lock:
            st = _recompile.setdefault(self._name, {
                "count": 0, "total_ms": 0.0, "max_ms": 0.0,
                "avals": [], "last_ms": 0.0})
            st["count"] += 1
            st["total_ms"] += dur_ms
            st["last_ms"] = dur_ms
            st["max_ms"] = max(st["max_ms"], dur_ms)
            st["avals"].append([list(s) + [d, dev]
                                for s, d, dev in sig[:8]])
            st["avals"] = st["avals"][-8:]
            count = st["count"]
            recent = st["avals"]
            warned = _recompile_warned.get(self._name, False)
        try:
            from . import profiler as _profiler

            if _profiler.is_running():
                now = _profiler._now_us()
                _profiler.record_span("jit_compile::" + self._name,
                                      now - dur_ms * 1e3, dur_ms * 1e3,
                                      cat="compile",
                                      args={"n_compiles": count})
        except Exception:
            pass
        try:
            metrics.counter("mxnet_jit_compiles_total",
                            help="new-signature calls of instrumented step "
                                 "functions").inc()
            metrics.gauge("mxnet_jit_compile_ms_last").set(dur_ms)
        except Exception:
            pass
        if count > _warn_threshold() and not warned:
            with _recompile_lock:
                _recompile_warned[self._name] = True
            _log.warning(
                "RECOMPILATION STORM: step function %r ran cold %d times "
                "(a new input signature, or a new step built under the "
                "name) — shape/dtype churn makes every new shape pay "
                "cuDNN planning, allocator growth and cold per-shape "
                "caches. Recent signatures (shape + dtype + device per "
                "tensor arg): %s. Pad/bucketize inputs to a fixed set of "
                "shapes or pin the dtype to stop the churn.",
                self._name, count, recent)


def instrument_jit(name: str, fn, meta: Optional[dict] = None):
    """Wrap one step callable for recompile tracking (the JAX package's
    name: ``FusedTrainStep.step``, ``Module.bulk_fit``, ...).  Idempotent
    on the name: a rebuilt step keeps accumulating into the same stats
    row.  ``meta`` (``compute_dtype``, ``bucket_plan``,
    ``remat_policy``, ``state``, ...) rides into :func:`recorded_steps`
    for the auditor."""
    return _InstrumentedStep(name, fn, meta)


def recompile_stats() -> Dict[str, dict]:
    """``{name: {count, total_ms, max_ms, last_ms, avals}}`` for every
    instrumented step (``avals``: the recent signatures)."""
    with _recompile_lock:
        return {k: dict(v) for k, v in _recompile.items()}


def reset_recompile_stats() -> None:
    """Clear the stats, the warnings and the recorded steps."""
    with _recompile_lock:
        _recompile.clear()
        _recompile_warned.clear()
        _recorded_steps.clear()


def recorded_steps() -> Dict[str, Tuple[Any, tuple, dict]]:
    """``{name: (callable, specs, meta)}`` for every instrumented step
    that has run and is still alive: the auditor's work list.  ``specs``
    are the call's arguments with each tensor a :class:`TensorSpec`."""
    out = {}
    with _recompile_lock:
        items = list(_recorded_steps.items())
    for name, (ref, specs, meta) in items:
        fn = ref()
        if fn is not None:
            out[name] = (fn, specs, meta)
    return out
