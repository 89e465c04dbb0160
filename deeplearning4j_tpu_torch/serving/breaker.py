"""Circuit breaker — the serving plane's "fail fast, recover visibly" valve.

When the device stops answering (wedged dispatch), starts answering
garbage (non-finite outputs) or every dispatch raises, continuing to
admit traffic only queues requests behind a dead program: every client
burns its full deadline learning what the first failure already proved.
The breaker converts that into an explicit, cheap 503 at ADMISSION:

  CLOSED     normal serving; consecutive dispatch failures are counted,
             any success resets the streak.
  OPEN       `threshold` consecutive failures trip the breaker: every
             admission is rejected (`breaker_open`) until
             `probe_after_s` has passed.
  HALF_OPEN  one probe batch is allowed through; success closes the
             breaker, failure re-opens it (and restarts the probe
             timer).

State changes land on the telemetry spine
(``dl4jtpu_serving_breaker_state`` gauge: 0 closed / 0.5 half-open /
1 open, and ``dl4jtpu_serving_breaker_transitions_total{to=...}``), so
a tripped replica is visible on ``/metrics`` and the fleet endpoints,
not just in its own error responses.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

log = logging.getLogger("deeplearning4j_tpu_torch")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 0.5, OPEN: 1.0}


class CircuitBreaker:
    """Consecutive-failure breaker with a timed half-open probe.

    Thread-safe: admission threads consult `admits()` while the batcher
    thread records outcomes.
    """

    def __init__(self, threshold: int = 3, probe_after_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = int(threshold)
        self.probe_after_s = float(probe_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.trips = 0                    # lifetime OPEN transitions
        self.recoveries = 0               # lifetime OPEN/HALF_OPEN -> CLOSED

    # -- state ------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str) -> None:
        """Caller holds self._lock."""
        if to == self._state:
            return
        log.warning("serving circuit breaker: %s -> %s "
                    "(%d consecutive failure(s))",
                    self._state, to, self._consecutive_failures)
        self._state = to
        if to == OPEN:
            self.trips += 1
            self._opened_at = self._clock()
            self._probe_inflight = False
        elif to == CLOSED:
            self.recoveries += 1
            self._consecutive_failures = 0
            self._probe_inflight = False
        _count_transition(to)
        _gauge_state(to)

    # -- admission-side ---------------------------------------------------
    def admits(self) -> bool:
        """May a new request enter the queue right now?  OPEN rejects
        everything until the probe window; then exactly ONE request is
        let through as the half-open probe (concurrent admitters see
        the breaker still effectively open until the probe resolves)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.probe_after_s:
                    return False
                self._transition(HALF_OPEN)
            # HALF_OPEN: admit only the single probe request
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def probe_reset(self) -> None:
        """The admitted probe request was shed before it could dispatch
        (deadline backstop, shutdown): release the probe slot so the
        breaker does not deadlock waiting on an outcome that will never
        arrive."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_inflight = False

    # -- dispatch-side ----------------------------------------------------
    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state in (HALF_OPEN, OPEN):
                # an OPEN success can happen when a batch admitted before
                # the trip completes after it — the device answered, so
                # the breaker closes either way
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                # the probe failed: back to OPEN, restart the timer
                self._transition(OPEN)
            elif (self._state == CLOSED
                  and self._consecutive_failures >= self.threshold):
                self._transition(OPEN)

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "trips": self.trips,
                "recoveries": self.recoveries,
            }


def _count_transition(to: str) -> None:
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().counter(
            "dl4jtpu_serving_breaker_transitions_total"
        ).inc(to=to)
    except Exception as e:
        # telemetry must never decide whether traffic flows
        log.debug("breaker transition metric failed: %s", e)


def _gauge_state(state: str) -> None:
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().gauge("dl4jtpu_serving_breaker_state").set(
            _STATE_GAUGE[state]
        )
    except Exception as e:
        log.debug("breaker state gauge failed: %s", e)
