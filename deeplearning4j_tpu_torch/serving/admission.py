"""Bounded admission — the generation engine's front door, ported from
`deeplearning4j_tpu/serving/admission.py` (pure Python there too; the
port keeps its own copy so it never imports the JAX package).

`offer()` rejects once ``max_queue`` requests wait (the caller answers
429); nothing is silently dropped — a request gets a result or a typed
`ServingRejected` / `ServingTimeout` / `ServingError`.  Requests are
grouped by ``signature``; the taker serves the signature whose head has
waited longest.
"""

from __future__ import annotations

import threading
import time
from collections import deque

#: rejection reasons -> the HTTP status a frontend maps them to
REJECT_STATUS = {
    "queue_full": 429,
    "shutdown": 503,
    "kv_exhausted": 429,     # KV page pool has no room — retry later
}


class ServingRejected(RuntimeError):
    """Explicitly rejected (never enqueued, or shed before dispatch)."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        self.status = REJECT_STATUS.get(reason, 503)
        super().__init__(
            f"request rejected ({reason})" + (f": {detail}" if detail else ""))


class ServingTimeout(TimeoutError):
    """Admitted, but no result before the caller's deadline (504)."""

    status = 504


class ServingError(RuntimeError):
    """The dispatch that carried this request failed (500)."""

    status = 500


class AdmissionQueue:
    """Bounded, signature-grouped FIFO with condition-based handoff to
    the consuming thread.  Queued objects carry ``signature`` and ``seq``
    attributes."""

    def __init__(self, max_queue: int):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.max_queue = int(max_queue)
        self._cond = threading.Condition()
        self._by_sig: dict = {}
        self._depth = 0
        self._seq = 0

    @property
    def depth(self) -> int:
        with self._cond:
            return self._depth

    def offer(self, req) -> bool:
        """Enqueue; False when the queue is at capacity."""
        with self._cond:
            if self._depth >= self.max_queue:
                return False
            self._seq += 1
            req.seq = self._seq
            self._by_sig.setdefault(req.signature, deque()).append(req)
            self._depth += 1
            self._cond.notify()
        return True

    def _oldest_signature(self):
        best_sig, best_seq = None, None
        for sig, dq in self._by_sig.items():
            if dq and (best_seq is None or dq[0].seq < best_seq):
                best_sig, best_seq = sig, dq[0].seq
        return best_sig

    def take_batch(self, max_batch: int, linger_s: float,
                   stop: threading.Event, poll_s: float = 0.05) -> list:
        """Block until a request waits (or ``stop`` is set — then []),
        then take up to ``max_batch`` of the oldest signature, lingering
        up to ``linger_s`` for stragglers."""
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

    def _prune(self, sig, dq: deque) -> None:
        """Drop a drained signature's deque (caller holds the condition)."""
        if not dq and self._by_sig.get(sig) is dq:
            del self._by_sig[sig]

    def drain(self) -> list:
        """Remove and return every waiting request (shutdown path)."""
        with self._cond:
            out: list = []
            for dq in self._by_sig.values():
                out.extend(dq)
            self._by_sig.clear()
            self._depth = 0
            return out

