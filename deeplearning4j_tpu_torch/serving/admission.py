"""Bounded admission — the front door that says "no" instead of falling over.

An inference server's failure mode under overload is rarely the model —
it is the unbounded queue in front of it: every request is accepted,
every request times out, memory grows, and the client sees silence.
This module is the fix, in two layers:

- **bounded queue with backpressure**: `offer()` rejects (explicitly,
  with a reason the HTTP layer maps to 429) once `max_queue` requests
  are waiting.  Nothing is ever silently dropped — a request either
  gets a result or a typed `ServingRejected`/`ServingTimeout`.
- **deadline-aware shedding at admit**: a request whose deadline cannot
  be met *given the current queue depth and the measured batch latency*
  is rejected at the door (`deadline` reason, maps to 503) instead of
  occupying a batch slot it will time out in anyway.  The estimate is
  conservative on purpose — `floor(depth / max_batch) + 1` dispatches
  (the +1 is the request's own batch) at the server's batch-latency
  EWMA, times a safety factor — admitting a doomed request costs a
  slot a live request needed; rejecting a borderline one costs a retry.

Requests are grouped by input signature (per-input shape-sans-batch +
dtype): the batcher takes the signature with the oldest waiting request
and coalesces up to `max_batch` of it, waiting at most `linger_s` for
stragglers.  One queue, many signatures — mixed traffic cannot starve a
rare shape behind a popular one forever because age, not popularity,
picks the next batch.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

#: rejection reasons -> the HTTP status the serving frontend maps them to
REJECT_STATUS = {
    "queue_full": 429,
    "deadline": 503,
    "breaker_open": 503,
    "admit_fault": 503,
    "shutdown": 503,
    # generation engine (serving.generation) rejections
    "kv_exhausted": 429,     # KV page pool has no room — retry later
    # front-door (serving.router) rejections
    "no_replicas": 503,      # every replica ejected/dead/stopped
    "route_fault": 503,      # injected serving.route failure
    "replica_dead": 503,     # routed to a replica that died mid-flight
}


class ServingRejected(RuntimeError):
    """The request was explicitly rejected (never enqueued, or shed
    before dispatch).  `reason` is one of REJECT_STATUS; `status` is the
    HTTP status code the frontend serves."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        self.status = REJECT_STATUS.get(reason, 503)
        super().__init__(
            f"request rejected ({reason})" + (f": {detail}" if detail else "")
        )


class ServingTimeout(TimeoutError):
    """The request was admitted but its deadline expired before a result
    was produced (maps to HTTP 504)."""

    status = 504


class ServingError(RuntimeError):
    """The dispatch that carried this request failed (injected fault,
    non-finite outputs, wedged device).  Maps to HTTP 500."""

    status = 500


class PendingRequest:
    """One admitted request: features (per-input tuple, NO batch dim),
    deadline, and a completion event the client thread waits on.

    Request-level observability riders (filled by the server as the
    request moves — cheap dict/float writes, no locks): ``trace_id`` /
    ``root_span`` link the request's spans into one causal chain when
    tracing is on; ``t0_pc`` / ``t_enq_pc`` are perf_counter marks the
    latency attribution derives its segments from; ``lat`` accumulates
    the per-request breakdown (queue_wait / batch_form / pad_overhead /
    dispatch seconds) that feeds the histogram families and the
    slow-request exemplars."""

    __slots__ = ("features", "fmask", "signature", "t_admit", "deadline",
                 "seq", "_event", "_result", "_error", "cancelled",
                 "orig_len", "padded_len",
                 "trace_id", "root_span", "root_parent", "t0_pc",
                 "t_enq_pc", "lat", "bucket")

    def __init__(self, features: tuple, signature: tuple,
                 deadline: float, fmask=None, seq: int = 0,
                 orig_len: Optional[int] = None,
                 padded_len: Optional[int] = None):
        self.features = features
        self.fmask = fmask
        # sequence bucketing: the request's real time length and the
        # bucket it was padded to — time-distributed outputs are sliced
        # back to orig_len before completion
        self.orig_len = orig_len
        self.padded_len = padded_len
        self.signature = signature
        self.t_admit = time.monotonic()
        self.deadline = deadline          # monotonic instant
        self.seq = seq
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self.cancelled = False            # client gave up waiting
        # request-level observability (see class docstring)
        self.trace_id: Optional[int] = None
        self.root_span: Optional[int] = None
        self.root_parent: Optional[int] = None   # a router try's span id
        self.t0_pc = self.t_enq_pc = time.perf_counter()
        self.lat: dict = {}
        # the batch bucket the request dispatched in (set before its
        # result): a canary computes its expected row at the same shape
        self.bucket: Optional[int] = None

    # -- completion (batcher side) ----------------------------------------
    def complete(self, result) -> None:
        self._result = result
        self._event.set()

    def fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    # -- waiting (client side) --------------------------------------------
    def result(self, timeout: Optional[float] = None):
        """Block until the request completes or its deadline passes.
        Raises the failure (`ServingRejected`/`ServingError`) or
        `ServingTimeout` on deadline expiry."""
        remaining = self.deadline - time.monotonic()
        if timeout is not None:
            remaining = min(remaining, timeout)
        if not self._event.wait(max(0.0, remaining)):
            self.cancelled = True
            raise ServingTimeout(
                f"request missed its deadline after "
                f"{time.monotonic() - self.t_admit:.3f}s"
            )
        if self._error is not None:
            raise self._error
        return self._result


class AdmissionQueue:
    """Bounded, signature-grouped FIFO with condition-based handoff to
    the batcher thread."""

    def __init__(self, max_queue: int):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.max_queue = int(max_queue)
        self._cond = threading.Condition()
        self._by_sig: dict[tuple, deque] = {}
        self._depth = 0
        self._seq = 0

    @property
    def depth(self) -> int:
        with self._cond:
            return self._depth

    def offer(self, req: PendingRequest) -> bool:
        """Enqueue; False when the queue is at capacity (the caller
        rejects with `queue_full` — backpressure, never a silent drop)."""
        with self._cond:
            if self._depth >= self.max_queue:
                return False
            self._seq += 1
            req.seq = self._seq
            self._by_sig.setdefault(req.signature, deque()).append(req)
            self._depth += 1
            self._cond.notify()
        return True

    def _oldest_signature(self) -> Optional[tuple]:
        """Signature whose head request has waited longest.  Caller
        holds the condition."""
        best_sig, best_seq = None, None
        for sig, dq in self._by_sig.items():
            if dq and (best_seq is None or dq[0].seq < best_seq):
                best_sig, best_seq = sig, dq[0].seq
        return best_sig

    def take_batch(self, max_batch: int, linger_s: float,
                   stop: threading.Event,
                   poll_s: float = 0.05) -> list[PendingRequest]:
        """Block until at least one request is waiting (or `stop` is
        set — then []), pick the signature with the oldest head, and
        coalesce up to `max_batch` same-signature requests, lingering
        up to `linger_s` for stragglers once the first is in hand."""
        with self._cond:
            while self._depth == 0:
                if stop.is_set():
                    return []
                self._cond.wait(poll_s)
            sig = self._oldest_signature()
            dq = self._by_sig[sig]
            batch = [dq.popleft()]
            self._depth -= 1
            t_deadline = time.monotonic() + max(0.0, linger_s)
            while len(batch) < max_batch:
                while not dq:
                    remaining = t_deadline - time.monotonic()
                    if remaining <= 0 or stop.is_set():
                        self._prune(sig, dq)
                        return batch
                    self._cond.wait(min(remaining, poll_s))
                batch.append(dq.popleft())
                self._depth -= 1
            self._prune(sig, dq)
            return batch

    def _prune(self, sig: tuple, dq: deque) -> None:
        """Drop a drained signature's deque — a long-lived replica
        seeing many distinct shapes must not accumulate empty deques
        (and an O(every-signature-ever) scan per batch take).  Caller
        holds the condition; identity-checked so a deque re-created by
        a racing offer() is never dropped."""
        if not dq and self._by_sig.get(sig) is dq:
            # both take_batch call sites hold self._cond across the call
            del self._by_sig[sig]  # tpulint: disable=LK201

    def drain(self) -> list[PendingRequest]:
        """Remove and return every waiting request (shutdown path — the
        server fails each one explicitly)."""
        with self._cond:
            out = []
            for dq in self._by_sig.values():
                out.extend(dq)
            self._by_sig.clear()
            self._depth = 0
            return out
