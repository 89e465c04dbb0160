"""Step-deadline watchdog — the port's copy of
`deeplearning4j_tpu/runtime/watchdog.py`.

A wedged step — a device that stopped answering, a host sync that never
returns — times out nowhere until an outer deadline.  `StepWatchdog`
closes that gap: a caller arms it around every dispatched step program
and disarms on exit; the deadline is

    max(floor_s, k * EWMA(per-step latency) * n_steps)

so it tracks the real step time instead of a guessed constant
(``cold_floor_s`` substitutes while the EWMA has no sample yet, and for
a dispatch armed ``cold=True``: the port's generation engine arms its
CUDA-graph captures so, the port's counterpart of a first compile).

Escalation ladder on a blown deadline:

  1. ``warn``        — structured log line +
                       ``dl4jtpu_watchdog_stalls_total{stage="warn"}``;
  2. ``stack_dump``  — `runtime/crash.write_hang_report()`: every
                       thread's current stack, so the report shows WHERE
                       the step wedged (collective, queue, lock) —
                       deliberately free of torch.cuda calls, the
                       device runtime is exactly what may be hung;
  3. ``abort``       — the ``abort`` callable.  Elastic workers pass
                       `exit_step_wedged` (``os._exit(EXIT_STEP_WEDGED)``,
                       no atexit — a wedged collective would hang the
                       shutdown barrier too) and `ElasticSupervisor`
                       respawns the generation WITHOUT shrinking the
                       world.  ``None`` (the default for plain fits)
                       stops the ladder after the stack dump.

One shared daemon monitor thread serves every watchdog in the process
(a thread per fitted model would leak one OS thread per model across a
long test suite); per-step cost is two lock acquires and one condition
notify — noise next to a dispatch.  The port's generation engine and
server build theirs from their own configs (floor, cold floor, k); a
model's fit builds its own at entry from `runtime/flags.py`
(``DL4J_TPU_WATCHDOG``, ``DL4J_TPU_WATCHDOG_FLOOR``,
``DL4J_TPU_WATCHDOG_K``; `models/model.py` ``_ensure_watchdog``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

log = logging.getLogger("deeplearning4j_tpu_torch")

#: exit code of a worker whose watchdog hit the abort stage — distinct
#: from an eviction (EXIT_MEMBERSHIP_CHANGED) and a control-plane loss
#: (EXIT_CONTROL_PLANE_LOST): the supervisor respawns the generation
#: without shrinking the world (the hardware wedged, the worker did not
#: fail its peers)
EXIT_STEP_WEDGED = 25

STAGES = ("warn", "stack_dump", "abort")


def exit_step_wedged(event: dict) -> None:
    """The elastic-worker abort action: leave the process immediately
    with the wedged exit code.  ``os._exit`` on purpose — atexit would
    run the process group's shutdown, which is wedged on the same dead
    peer the watchdog just diagnosed."""
    log.error("watchdog abort: step wedged, exiting %d", EXIT_STEP_WEDGED)
    os._exit(EXIT_STEP_WEDGED)


class _Monitor(threading.Thread):
    """ONE daemon thread serving every armed StepWatchdog in the
    process: waits until the earliest pending escalation across the
    armed set, fires it, re-sleeps.  An empty armed set parks the
    thread indefinitely (idle processes pay nothing)."""

    def __init__(self):
        super().__init__(name="dl4jtpu-watchdog", daemon=True)
        self.cond = threading.Condition()
        self.armed: set = set()
        # monotonic instant of the next scheduled re-check; arm() only
        # notifies when its deadline lands EARLIER — a notify per step
        # would context-switch this thread awake on every dispatch
        # (measured ~40% step overhead on ~1ms CPU steps)
        self.next_wake = float("-inf")

    def run(self) -> None:
        while True:
            ready = None
            with self.cond:
                timeout = None
                for wd in list(self.armed):
                    rel = wd._seconds_until_due()
                    if rel is None:
                        continue
                    if rel <= 0:
                        ready = wd
                        break
                    timeout = rel if timeout is None else min(timeout, rel)
                if ready is None:
                    self.next_wake = (
                        float("inf") if timeout is None
                        else time.monotonic() + timeout
                    )
                    self.cond.wait(timeout)
                    self.next_wake = float("-inf")   # awake: rescanning
                    continue
            # escalation side effects (report writes, the abort action)
            # run OUTSIDE the condition — poll() re-checks the token
            try:
                ready.poll()
            except BaseException:
                # a raising escalation action (e.g. an abort that calls
                # sys.exit — SystemExit only kills THIS thread) must not
                # take the process-wide monitor down with it: every
                # watchdog constructed so far holds a reference to this
                # thread and would keep arming into a dead one
                log.exception("watchdog escalation action raised")


_MONITOR: Optional[_Monitor] = None
_MONITOR_LOCK = threading.Lock()


def _monitor() -> _Monitor:
    global _MONITOR
    with _MONITOR_LOCK:
        if _MONITOR is None or not _MONITOR.is_alive():
            _MONITOR = _Monitor()
            _MONITOR.start()
        return _MONITOR


class StepWatchdog:
    """Per-model step-deadline watchdog (see module docstring).

    floor_s / cold_floor_s: deadline floor with/without an EWMA sample
      (cold covers a first step's first-use costs).
    k: deadline multiplier over the per-step latency EWMA.
    dump_after / abort_after: stage-2/3 thresholds as multiples of the
      base deadline (warn fires at 1.0x).
    abort: callable(event_dict) for stage 3; None = stop after the dump.
    threaded: False detaches from the shared monitor — tests drive
      escalation deterministically via `poll(now=...)` with an injected
      clock.
    """

    def __init__(self, floor_s: float = 30.0, k: float = 10.0,
                 cold_floor_s: float = 600.0, ewma_alpha: float = 0.2,
                 dump_after: float = 1.5, abort_after: float = 2.0,
                 abort: Optional[Callable[[dict], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 threaded: bool = True, name: str = ""):
        self.floor_s = float(floor_s)
        self.cold_floor_s = max(float(cold_floor_s), self.floor_s)
        self.k = float(k)
        self.ewma_alpha = float(ewma_alpha)
        self.dump_after = float(dump_after)
        self.abort_after = float(abort_after)
        self.abort = abort
        self.name = name
        self.ewma: Optional[float] = None
        self.events: list[dict] = []
        self.report_paths: list[str] = []
        self._clock = clock
        self._mon = _monitor() if threaded else None
        self._cond = self._mon.cond if self._mon else threading.Condition()
        self._armed = False
        self._token = 0
        self._stage = 0
        self._t0 = 0.0
        self._base = self.cold_floor_s
        self._iteration = 0
        self._n_steps = 1
        self._stalls = None        # metrics family, resolved lazily

    # -- arm / disarm (the per-step hot path) ------------------------------
    def arm(self, iteration: int, n_steps: int = 1,
            cold: bool = False) -> None:
        """Start a step's deadline.  ``cold``: the dispatch also builds
        its program (a CUDA-graph capture), so it gets ``cold_floor_s``
        whatever the EWMA says; disarm it with ``dur=None``."""
        with self._cond:
            self._token += 1
            self._armed = True
            self._stage = 0
            self._t0 = self._clock()
            per = self.ewma
            if per is None or cold:
                self._base = self.cold_floor_s
            else:
                self._base = max(self.floor_s, self.k * per * max(1, n_steps))
            self._iteration = iteration
            self._n_steps = max(1, n_steps)
            if self._mon is not None:
                self._mon.armed.add(self)
                # wake the monitor ONLY when this deadline is earlier
                # than its next scheduled check (threaded watchdogs use
                # the monotonic clock, so the instants are comparable);
                # the common case — deadline ~30s out, monitor already
                # sleeping toward a similar instant — stays notify-free
                if self._t0 + self._base < self._mon.next_wake:
                    self._cond.notify_all()

    def disarm(self, dur: Optional[float] = None) -> None:
        """Step finished.  `dur` (seconds for the whole program) feeds
        the EWMA; pass None for failed steps — an aborted dispatch's
        wall time says nothing about healthy step latency.  A step the
        ladder escalated on is dropped for the same reason even when it
        eventually completed: folding a stall into the EWMA inflates
        every later deadline by ~k× the stall, masking the next genuine
        wedge."""
        with self._cond:
            self._armed = False
            self._token += 1
            escalated = self._stage > 0
            if self._mon is not None:
                self._mon.armed.discard(self)
            if dur is not None and dur >= 0 and not escalated:
                per = dur / self._n_steps
                a = self.ewma_alpha
                self.ewma = per if self.ewma is None else (
                    (1.0 - a) * self.ewma + a * per
                )

    def deadline_s(self) -> float:
        """The base deadline the NEXT arm() would get for n_steps=1."""
        per = self.ewma
        if per is None:
            return self.cold_floor_s
        return max(self.floor_s, self.k * per)

    # -- escalation --------------------------------------------------------
    def _seconds_until_due(self) -> Optional[float]:
        """Relative seconds until the next escalation stage, None when
        fully escalated or disarmed.  Caller holds the condition."""
        if not self._armed or self._stage >= len(STAGES):
            return None
        mult = (1.0, self.dump_after, self.abort_after)[self._stage]
        return self._t0 + self._base * mult - self._clock()

    def poll(self, now: Optional[float] = None) -> None:
        """Fire every escalation stage currently due.  The monitor
        thread calls this with the real clock; tests call it directly
        with a fake one."""
        while True:
            with self._cond:
                if not self._armed or self._stage >= len(STAGES):
                    return
                t = self._clock() if now is None else now
                mult = (1.0, self.dump_after, self.abort_after)[self._stage]
                if t < self._t0 + self._base * mult:
                    return
                stage = self._stage
                self._stage += 1
                token = self._token
                event = {
                    "stage": STAGES[stage],
                    "iteration": self._iteration,
                    "n_steps": self._n_steps,
                    "stalled_s": round(t - self._t0, 3),
                    "deadline_s": round(self._base, 3),
                    "step_ewma_s": self.ewma,
                    "time": time.time(),
                }
            self._fire(stage, event, token)

    def _fire(self, stage: int, event: dict, token: int) -> None:
        self.events.append(event)
        if len(self.events) > 64:
            del self.events[:-64]
        self._count(STAGES[stage])
        if stage == 0:
            log.warning(
                "WATCHDOG step %s stalled: %.3fs armed, deadline %.3fs "
                "(iteration %s, %d step(s) in program)",
                self.name or "program", event["stalled_s"],
                event["deadline_s"], event["iteration"], event["n_steps"],
            )
            return
        if stage == 1:
            from deeplearning4j_tpu_torch.runtime import crash

            try:
                path = crash.write_hang_report(event)
                self.report_paths.append(path)
                log.error("WATCHDOG stack dump written to %s", path)
            except Exception:
                # diagnosing the hang must not crash the monitor thread
                log.exception("watchdog hang-report write failed")
            return
        # stage 2: abort — only if still armed with the same token (the
        # step may have finished while the report above was writing)
        with self._cond:
            live = self._armed and self._token == token
        if not live:
            return
        if self.abort is not None:
            log.error("WATCHDOG aborting wedged step: %s", event)
            self.abort(event)
        else:
            log.error(
                "WATCHDOG step wedged %.3fs past deadline and no abort "
                "action is configured; the process stays up (set one, or "
                "run under ElasticWorkerLoop for EXIT_STEP_WEDGED "
                "respawn)", event["stalled_s"] - event["deadline_s"],
            )

    def _count(self, stage: str) -> None:
        try:
            if self._stalls is None:
                from deeplearning4j_tpu_torch.observe.metrics import registry

                self._stalls = registry().counter(
                    "dl4jtpu_watchdog_stalls_total"
                )
            self._stalls.inc(stage=stage)
        except Exception as e:
            # telemetry must never mask the stall handling itself
            log.debug("watchdog stall metric failed: %s", e)

    @property
    def stalled(self) -> bool:
        return bool(self.events)
