"""Request queue + dynamic batcher — the admission-controlled front
half of the serving tier.

Counterpart: ``mxnet_tpu/serving/batching.py`` (a copy; host code only).

Three robustness rules, enforced HERE rather than hoped for upstream:

  * **bounded queue**: ``offer()`` at depth ``MXNET_SERVE_QUEUE_MAX``
    sheds with ``Rejected(queue_full)`` and a retry-after hint — an
    overloaded server degrades by answering *fewer* requests within
    their deadline, never by growing an unbounded backlog whose every
    entry will miss its deadline anyway;
  * **deadlines propagate through the queue**: every request carries a
    monotonic-clock deadline; expired requests are purged (and their
    callers failed with ``DeadlineExceeded``) BEFORE dispatch — an
    expired request is never batched, because executing it wastes the
    exact capacity the still-viable requests behind it need;
  * **drain is explicit**: ``close()`` stops admission; the batcher
    keeps handing out batches until the queue is empty, then returns
    ``None`` so workers exit — the SIGTERM drain path completes every
    admitted request and loses none.

The batcher itself is deadline-driven (the TF-Serving /
dynamic-batching idiom): hold the first queued request open at most
``MXNET_SERVE_BATCH_DEADLINE_MS`` for co-riders, dispatch as soon as
the batch reaches the largest compiled bucket, and hand the batch to
the model runtime to pad to the nearest bucket.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from . import reqtrace as _reqtrace
from .errors import DeadlineExceeded, Rejected

__all__ = ["Request", "RequestQueue"]

_ids = itertools.count(1)


class Request:
    """One admitted inference request: the payload, its deadline, and a
    one-shot completion event the submitting thread waits on."""

    __slots__ = ("id", "model", "data", "n", "enqueue_ts", "deadline_ts",
                 "done_ts", "result", "error", "_event")

    def __init__(self, model: str, data, n: int,
                 deadline_s: Optional[float] = None,
                 request_id: Optional[str] = None):
        self.id = request_id or ("req-%d" % next(_ids))
        self.model = model
        self.data = data
        self.n = int(n)                       # samples in this request
        self.enqueue_ts = time.monotonic()
        self.deadline_ts = None if deadline_s is None \
            else self.enqueue_ts + float(deadline_s)
        self.done_ts: Optional[float] = None
        self.result = None
        self.error: Optional[BaseException] = None
        self._event = threading.Event()
        # every request's lifecycle opens here — construction is the
        # one point both the batch and generation tiers pass through
        _reqtrace.begin(self.id, model)

    # -- completion ----------------------------------------------------
    def set_result(self, result) -> None:
        self.result = result
        self.done_ts = time.monotonic()
        # terminal reqtrace span BEFORE the waiter wakes: by the time
        # wait() returns, the autopsy record is final
        _reqtrace.finish(self)
        self._event.set()

    def set_error(self, error: BaseException) -> None:
        self.error = error
        self.done_ts = time.monotonic()
        _reqtrace.finish(self)
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None):
        """Block for the outcome; returns the result or raises the
        recorded error (DeadlineExceeded when the wait itself times
        out)."""
        if not self._event.wait(timeout):
            raise DeadlineExceeded(
                "request %s: no result within %.3fs" % (self.id, timeout))
        if self.error is not None:
            raise self.error
        return self.result

    # -- deadline ------------------------------------------------------
    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_ts is None:
            return False
        return (time.monotonic() if now is None else now) > self.deadline_ts

    def latency_s(self) -> Optional[float]:
        if self.done_ts is None:
            return None
        return self.done_ts - self.enqueue_ts


class RequestQueue:
    """Bounded FIFO of admitted requests for ONE model, with the
    dynamic batcher (:meth:`take_batch`) on the consuming side."""

    def __init__(self, maxsize: int,
                 on_expired: Optional[Callable[[Request], None]] = None):
        self.maxsize = max(int(maxsize), 1)
        self._pending: "deque[Request]" = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._on_expired = on_expired
        # earliest queued deadline: purge_expired's O(1) fast path (the
        # batcher polls it every ~2ms; walking a deep queue each poll
        # would steal admission throughput exactly under saturation).
        # May go stale-early when the owning request is dispatched —
        # that costs one harmless rescan, never a missed expiry.
        self._next_deadline: Optional[float] = None

    # -- producer side -------------------------------------------------
    def offer(self, req: Request,
              retry_after_s: Optional[float] = None) -> None:
        """Admit or shed.  Raises :class:`Rejected` with the reason the
        metrics layer counts; on success the request is queued and a
        batcher is woken."""
        with self._cond:
            if self._closed:
                _reqtrace.reject(req.id, req.model, "draining")
                raise Rejected("draining", "server is draining; "
                               "no new work is admitted")
            if len(self._pending) >= self.maxsize:
                _reqtrace.reject(req.id, req.model, "queue_full")
                raise Rejected(
                    "queue_full",
                    "depth %d >= MXNET_SERVE_QUEUE_MAX=%d"
                    % (len(self._pending), self.maxsize),
                    retry_after_s=retry_after_s)
            if req.expired():
                # a deadline shorter than the queue's admission path —
                # reject up front, don't make a batcher discover it
                _reqtrace.reject(req.id, req.model, "deadline")
                raise Rejected("deadline",
                               "deadline expired before admission")
            self._pending.append(req)
            if req.deadline_ts is not None and \
                    (self._next_deadline is None
                     or req.deadline_ts < self._next_deadline):
                self._next_deadline = req.deadline_ts
            self._cond.notify()

    def close(self) -> None:
        """Stop admission (offers shed with reason=draining); batches
        keep flowing until the queue is empty, then take_batch returns
        None."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def depth(self) -> int:
        with self._cond:
            return len(self._pending)

    def purge_expired(self) -> List[Request]:
        """Drop (and fail) every queued request whose deadline passed —
        called by the batcher before each assembly round so an expired
        request is never batched."""
        now = time.monotonic()
        expired: List[Request] = []
        with self._cond:
            if self._next_deadline is None or now < self._next_deadline:
                return []  # nothing CAN have expired: no queue walk
            keep: "deque[Request]" = deque()
            nxt: Optional[float] = None
            for r in self._pending:
                if r.expired(now):
                    expired.append(r)
                    continue
                keep.append(r)
                if r.deadline_ts is not None and \
                        (nxt is None or r.deadline_ts < nxt):
                    nxt = r.deadline_ts
            self._pending = keep
            self._next_deadline = nxt
        for r in expired:
            # the whole life was queue residency: attribute it so the
            # autopsy says "died waiting", not just "expired"
            _reqtrace.phase(r.id, "queue", now - r.enqueue_ts)
            r.set_error(DeadlineExceeded(
                "request %s: deadline expired after %.3fs in queue "
                "(never dispatched)" % (r.id, now - r.enqueue_ts)))
            if self._on_expired is not None:
                self._on_expired(r)
        return expired

    def fail_all(self, make_error: Callable[[Request], BaseException]
                 ) -> List[Request]:
        """Fast-fail everything queued (breaker trip: the queued work is
        doomed — answering now beats timing out later)."""
        with self._cond:
            drained = list(self._pending)
            self._pending.clear()
            self._next_deadline = None
        for r in drained:
            r.set_error(make_error(r))
        return drained

    # -- consumer side: the dynamic batcher ----------------------------
    def take_batch(self, max_samples: int, wait_s: float,
                   poll_s: float = 0.002) -> Optional[List[Request]]:
        """Assemble the next batch: block for the first request, then
        admit co-riders until the batch holds ``max_samples`` or the
        batch deadline (``wait_s`` past assembly start) fires.  Returns
        ``None`` when the queue is closed AND empty (drain complete).

        Whole requests only — a request's samples are never split
        across batches (its reply is one tensor).  Expired requests are
        purged before and during assembly and never ride.
        """
        # phase 1: wait for work (or drain-complete)
        while True:
            self.purge_expired()
            with self._cond:
                if self._pending:
                    break
                if self._closed:
                    return None
                self._cond.wait(0.05)
        # phase 2: deadline-driven assembly
        batch: List[Request] = []
        total = 0
        deadline = time.monotonic() + max(wait_s, 0.0)
        while True:
            self.purge_expired()
            with self._cond:
                if not batch and self._pending and \
                        self._pending[0].n > max_samples:
                    # admission normally rejects these (too_large); a
                    # misconfigured caller must not livelock the worker
                    bad = self._pending.popleft()
                    bad.set_error(Rejected(
                        "too_large", "%d samples > max batch %d"
                        % (bad.n, max_samples)))
                    continue
                while self._pending and \
                        total + self._pending[0].n <= max_samples:
                    r = self._pending.popleft()
                    batch.append(r)
                    total += r.n
                if total >= max_samples:
                    break
                if self._closed:
                    break  # drain: flush partial batches immediately
                now = time.monotonic()
                if batch and now >= deadline:
                    break
                if not batch:
                    # everything re-expired mid-assembly: start over
                    deadline = now + max(wait_s, 0.0)
                self._cond.wait(min(max(deadline - now, 0.0), poll_s)
                                or poll_s)
        return batch

    # -- consumer side: continuous-batching admission ------------------
    def poll(self, max_requests: int) -> Optional[List[Request]]:
        """Non-blocking per-slot admission for the CONTINUOUS batcher
        (the generation tier): pop up to ``max_requests`` whole
        requests RIGHT NOW — the decode loop calls this once per tick
        with its free-slot count, so a finished sequence's slot refills
        next tick without draining co-riders.  Expired requests are
        purged first and never ride.  Returns ``None`` when the queue
        is closed AND empty (drain complete — same contract as
        :meth:`take_batch`), else a possibly-empty list."""
        self.purge_expired()
        out: List[Request] = []
        with self._cond:
            if not self._pending and self._closed:
                return None
            while self._pending and len(out) < int(max_requests):
                out.append(self._pending.popleft())
        return out
