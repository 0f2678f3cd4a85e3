"""The one ``torch.profiler`` capture site of the package.

Counterpart: ``mxnet_tpu/traceview/capture.py`` (there the one
``jax.profiler`` site).  Two layers:

  * thin wrappers (:func:`start_device_trace` / :func:`stop_device_trace`
    / :func:`annotation`) — profiler.py's
    ``profile_xla`` path and the step tracer below both route through
    these, so the package has exactly one module touching
    ``torch.profiler``.  The capture records host (CPU) activity and,
    for a device on the card, CUDA activity (kernels, copies, and the
    correlation of each to the host call that launched it);
  * the env-armed step tracer — ``MXNET_TRACE_DIR`` +
    ``MXNET_TRACE_STEPS`` record N steady-state dispatch windows of
    whatever workload dispatches first (FusedTrainStep /
    TransformerTrainStep / bulk fit / serving dispatch), bracket each
    with a ``mxnet:step:<i>:k=<k>`` annotation, then stop, write the
    raw trace (``trace_rank{K}.pt.trace.json``) into the trace dir, run
    the attribution (parse.py) against the stamped bucket plan, write
    ``traceview_summary_rank{K}.json`` beside it and feed
    ``mxnet_step_phase_seconds{phase}``.

The first armed dispatch is skipped (untraced warmup) so a first call's
kernel builds never pollute the steady-state measurement; the capture
starts as it ends, at least ``CAPTURE_LEAD_S`` ahead of the first
window, and a capture of the card first runs ``PRIMER_LAUNCHES`` tiny
kernels, whose records are the ones a capture's start can lose.  The
summary's ``capture.lost_launches`` counts, per window, the kernel
launches whose kernel the trace still lacks (a warning when any).
Everything is guarded: a capture that fails logs and never fails the
step it measures.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Any, Optional

_log = logging.getLogger("mxnet_tpu_torch.traceview")

__all__ = ["start_device_trace", "stop_device_trace", "annotation",
           "step_window", "enabled", "last_summary",
           "last_summary_path", "reset", "WARMUP_DISPATCHES"]

#: armed dispatches skipped before the trace starts (build absorber)
WARMUP_DISPATCHES = 1
#: the capture runs at least this long before its first window opens:
#: kineto drops device events stamped before the capture's start, and
#: the card's timestamps can read a few hundred microseconds early
CAPTURE_LEAD_S = 0.05
#: tiny kernels launched (and waited for) as a capture of the card
#: starts, under the ``mxnet:trace-primer`` annotation: a capture can
#: lose its first few dozen device records (45-53 on an H100, in a
#: process that had run other captures minutes before, whatever the
#: time between the start and the first launch), and the primer's
#: launches are what it loses then, not a window's
PRIMER_LAUNCHES = 256
PRIMER_ANNOTATION = "mxnet:trace-primer"

_prof_lock = threading.Lock()
_prof = None            # the running torch.profiler.profile, if any
_prof_path: Optional[str] = None


def _activities(device):
    """CPU, plus CUDA for a device on the card (the default); asking
    for the card without one raises."""
    import torch
    from torch.profiler import ProfilerActivity

    dev = torch.device("cuda" if device is None else device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "traceview: a device trace of %s needs a CUDA device; "
                "pass device='cpu' to trace the host only" % dev)
        acts.append(ProfilerActivity.CUDA)
    return acts


def start_device_trace(trace_dir: str, device=None,
                       record_shapes: bool = False) -> None:
    """Start the torch.profiler capture that :func:`stop_device_trace`
    exports as ``trace_dir/trace_rank{K}.pt.trace.json``.  ``device``:
    the device whose activity is recorded (default the card);
    ``record_shapes``: the host ops carry their input shapes and dtypes
    (``parallel.scaling`` sizes gloo's collectives from them)."""
    global _prof, _prof_path
    from torch.profiler import profile

    from .. import profiler as _profiler

    acts = _activities(device)
    with _prof_lock:
        if _prof is not None:
            raise RuntimeError("traceview: a device trace is already "
                               "running")
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=acts, record_shapes=record_shapes)
        prof.start()
        _prof, _prof_path = prof, os.path.join(
            trace_dir, "trace_rank%d.pt.trace.json"
            % _profiler._dist_info()[0])
        if len(acts) > 1:
            _prime(device)


def _prime(device) -> None:
    """Launch :data:`PRIMER_LAUNCHES` one-element kernels on ``device``
    under :data:`PRIMER_ANNOTATION` and wait for them."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    with annotation(PRIMER_ANNOTATION):
        x = torch.zeros(1, device=dev)
        for _ in range(PRIMER_LAUNCHES):
            x.add_(1.0)
    torch.cuda.synchronize(dev)


def stop_device_trace() -> Optional[str]:
    """Stop the running capture and export its chrome trace; returns
    the file's path (None when no capture was running)."""
    global _prof, _prof_path
    with _prof_lock:
        prof, path = _prof, _prof_path
        _prof, _prof_path = None, None
    if prof is None:
        return None
    prof.stop()
    prof.export_chrome_trace(path)
    return path


def annotation(name: str):
    """A host-side range the trace records (``record_function``): the
    step windows (``mxnet:step:<i>:k=<k>``), and the scopes a step's
    forward / backward / optimizer region (``mxnet-fwd`` / ``mxnet-bwd``
    / ``mxnet-opt``) and a bucket's pack and collective (``mxbkt%03d``)
    run under, by which parse.py attributes the device work launched
    inside them."""
    from torch.profiler import record_function

    return record_function(name)


class StepTracer:
    """Single-shot, env-armed capture of N dispatch windows."""

    def __init__(self):
        self._lock = threading.Lock()
        self._dispatches = 0      # armed dispatches seen (incl. warmup)
        self._recorded = 0        # traced windows completed
        self._tracing = False
        self._done = False
        self._t_capture0: Optional[float] = None
        self._workload: Optional[str] = None
        self._device = None
        self._summary: Optional[dict] = None
        self._summary_path: Optional[str] = None

    # -- config (lazy: tests flip env between dispatches) --------------
    def _config(self):
        from .. import env as _env

        d = _env.get_str("MXNET_TRACE_DIR")
        if not d:
            return None
        return d, max(int(_env.get_int("MXNET_TRACE_STEPS") or 1), 1)

    def enabled(self) -> bool:
        if self._done:
            return False
        return self._config() is not None

    @contextlib.contextmanager
    def step_window(self, workload: str, k: int = 1, device=None):
        """Bracket one dispatch.  Yields None when the tracer is off
        (the common path: one env lookup), else a window handle whose
        ``.block()`` the caller invokes before the window closes so the
        dispatch's device work lands inside it.  ``device``: the
        dispatch's device (default the card)."""
        cfg = None if self._done else self._config()
        if cfg is None:
            yield None
            return
        trace_dir, n_steps = cfg
        with self._lock:
            if self._done:
                cfg = None
            else:
                self._dispatches += 1
                warming = self._dispatches <= WARMUP_DISPATCHES
                if not warming and not self._tracing:
                    self._start(trace_dir, n_steps, workload, device)
        if cfg is None or not self._tracing:
            try:
                yield None
            finally:
                if cfg is not None and warming and \
                        self._dispatches == WARMUP_DISPATCHES:
                    with self._lock:
                        self._start(trace_dir, n_steps, workload, device)
            return
        if self._recorded == 0:
            lead = self._t_capture0 + CAPTURE_LEAD_S - time.monotonic()
            if lead > 0:
                time.sleep(lead)
        win = _Window(self, self._recorded, max(int(k), 1), device)
        try:
            with annotation("mxnet:step:%d:k=%d" % (win.index, win.k)):
                yield win
        finally:
            self._on_window_done(trace_dir, n_steps)

    def _start(self, trace_dir: str, n_steps: int, workload: str,
               device) -> None:
        """Start the capture (under ``self._lock``); a failure disables
        the tracer."""
        if self._done or self._tracing:
            return
        try:
            start_device_trace(trace_dir, device=device)
            self._tracing = True
            self._workload = workload
            self._device = device
            self._t_capture0 = time.monotonic()
            _log.info("traceview: recording %d %s window(s) -> %s",
                      n_steps, workload, trace_dir)
        except Exception as exc:
            _log.warning("traceview: start_trace failed (%r) — capture "
                         "disabled", exc)
            self._done = True

    def _on_window_done(self, trace_dir: str, n_steps: int) -> None:
        with self._lock:
            if self._done or not self._tracing:
                return
            self._recorded += 1
            if self._recorded < n_steps:
                return
            self._done = True
            self._tracing = False
        cost = None
        try:
            trace_path = stop_device_trace()
            if self._t_capture0 is not None:
                cost = time.monotonic() - self._t_capture0
        except Exception as exc:
            _log.warning("traceview: stop_trace failed: %r", exc)
            return
        try:
            self._ingest(trace_dir, trace_path, cost)
        except Exception as exc:
            _log.warning("traceview: trace ingest failed: %r", exc)

    def _ingest(self, trace_dir: str, trace_path: Optional[str],
                capture_cost_s) -> None:
        from .. import diagnostics as _diag
        from .. import profiler as _profiler
        from . import parse as _parse

        if trace_path is None or not os.path.exists(trace_path):
            _log.warning("traceview: no trace file under %r", trace_dir)
            return
        trace = _parse.load_trace(trace_path)
        summary = _parse.attribute(trace, plan_meta=_diag.bucket_plan(),
                                   workload=self._workload)
        rank, num_workers = _profiler._dist_info()
        summary["rank"] = rank
        summary["num_workers"] = num_workers
        lost = _parse.lost_launches(trace)
        summary["capture"] = {
            "trace_dir": trace_dir, "trace_path": trace_path,
            "steps_recorded": self._recorded,
            "warmup_skipped": WARMUP_DISPATCHES,
            "capture_cost_s": capture_cost_s,
            "captured_at": time.time(),
            "device": str(self._device or "cuda"),
            "lost_launches": lost,
        }
        if any(lost):
            _log.warning("traceview: the trace lost the kernels of %r "
                         "launches in its windows: their counts and "
                         "device time are short", lost)
        path = os.path.join(trace_dir,
                            "traceview_summary_rank%d.json" % rank)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(summary, f, indent=1)
        os.replace(tmp, path)
        self._summary = summary
        self._summary_path = path
        _diag.feed_phase_seconds(
            {p: v.get("per_step_s") or []
             for p, v in summary["phases"].items()})
        _log.info("traceview: attributed %d device event(s) over %d "
                  "step(s) -> %s", summary.get("n_device_events", 0),
                  summary["steps"]["n"], path)


class _Window:
    def __init__(self, tracer: StepTracer, index: int, k: int, device):
        self.tracer = tracer
        self.index = index
        self.k = k
        self.device = device

    def block(self, arrays: Any = None) -> None:
        """Wait for the dispatch's device work inside the annotation
        window, so it completes before the trace stops."""
        import torch

        dev = torch.device("cuda" if self.device is None else self.device)
        if dev.type == "cuda" and torch.cuda.is_available():
            torch.cuda.synchronize(dev)


_tracer = StepTracer()


def step_window(workload: str, k: int = 1, device=None):
    """Module-level dispatch hook (dp.py / transformer / bulk fit /
    serving call this): ``with step_window("FusedTrainStep", k=2,
    device=dev) as w: ... w and w.block()``."""
    return _tracer.step_window(workload, k=k, device=device)


def enabled() -> bool:
    return _tracer.enabled()


def last_summary() -> Optional[dict]:
    """The attributed summary of this process's capture (None until a
    capture completed) — profiler.summary()'s phase table reads it."""
    return _tracer._summary


def last_summary_path() -> Optional[str]:
    return _tracer._summary_path


def reset() -> None:
    """Re-arm the single-shot tracer (tests, and a second capture in one
    process)."""
    global _tracer
    _tracer = StepTracer()
