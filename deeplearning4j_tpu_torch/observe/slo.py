"""SLO objectives and multi-window burn-rate alerting over the registry —
the port's copy of `deeplearning4j_tpu/observe/slo.py`, in the
SRE-workbook shape:

- **declarative objectives** (`SLObjective`): availability ("99.9% of
  requests end ok") read off a labeled counter family, latency pX
  ("99% of requests complete under 250ms") read off a histogram
  family's cumulative buckets (`Histogram.count_le`), and throughput
  ("aggregate decode rate stays above 500 tokens/s while there is
  demand") read off a pair of counters.  All are evaluated directly
  over the process-global `MetricsRegistry` — no second bookkeeping
  path that can drift from what /metrics exports.
- **multi-window burn rates** (`SLOEngine`): each `sample()` appends a
  (t, good, bad) point per objective and derives the error-budget burn
  rate over every configured window — burn 1.0 means "spending exactly
  the budget"; 14.4 over 5 minutes is the classic page threshold.  The
  alert fires only when ALL windows exceed their thresholds (the fast
  window gives speed, the slow window immunity to blips) and clears as
  soon as the fast window drops back under — recovery is visible
  within one fast window, not one slow one.  The clock is injectable,
  so tests drive hours of burn in milliseconds.

State surfaces where an operator already looks: the engine's registry
collector refreshes ``dl4jtpu_slo_*`` gauges at scrape time, and
`ServingHTTPServer` joins the summary onto ``/healthz`` and
``/v1/status``.

    from deeplearning4j_tpu_torch.observe.slo import SLObjective, SLOEngine

    engine = SLOEngine([
        SLObjective.availability("availability", target=0.999),
        SLObjective.latency("latency_p99", target=0.99, threshold_s=0.25),
    ]).install()                       # sampled on every /metrics scrape
    engine.sample()["availability"]["alert"]
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

log = logging.getLogger("deeplearning4j_tpu_torch")


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One alerting window: burn rate over the trailing `seconds` must
    exceed `threshold` (together with every other window) to fire."""

    seconds: float
    threshold: float


#: the SRE-workbook page pair: 5m at 14.4x (2% of a 30-day budget in an
#: hour) gated by 1h at 6x
DEFAULT_WINDOWS = (BurnWindow(300.0, 14.4), BurnWindow(3600.0, 6.0))

#: retained samples per objective (see SLOEngine._min_gap)
_MAX_SAMPLES = 4096


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One declarative objective over a registry family.

    ``kind="availability"``: good/bad from a labeled COUNTER — every
    series of `family` counts toward the total, series matching any of
    the ``bad`` (label, value) pairs count as bad.
    ``kind="latency"``: good/bad from a HISTOGRAM — observations at or
    under ``threshold_s`` are good (pick thresholds on bucket bounds;
    `count_le` documents the rounding).  `target` is the good fraction
    the objective promises (0.999 = three nines).
    ``kind="throughput"``: an aggregate-RATE floor — `family` is a
    cumulative work counter (e.g. tokens generated) and
    ``demand_family`` a cumulative demand counter (e.g. streams
    admitted).  The burn rate over a window is the fractional deficit
    below ``floor_per_s`` divided by the budget, so a total stall
    burns ``1/budget`` (pages immediately on the classic thresholds)
    while meeting the floor burns zero.  A window with neither work
    nor fresh demand is idle and burns zero — a quiet replica is not
    an outage."""

    name: str
    target: float
    kind: str = "availability"
    family: str = "dl4jtpu_serving_requests_total"
    bad: tuple = (("outcome", "error"), ("outcome", "timeout"))
    threshold_s: float = 0.25
    floor_per_s: float = 0.0
    demand_family: str = ""

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: target must be in (0, 1), got "
                f"{self.target}"
            )
        if self.kind not in ("availability", "latency", "throughput"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind == "throughput" and not self.floor_per_s > 0.0:
            raise ValueError(
                f"SLO {self.name!r}: throughput objectives need "
                f"floor_per_s > 0, got {self.floor_per_s}"
            )

    @classmethod
    def availability(cls, name: str, target: float,
                     family: str = "dl4jtpu_serving_requests_total",
                     bad: Sequence = (("outcome", "error"),
                                      ("outcome", "timeout")),
                     ) -> "SLObjective":
        return cls(name=name, target=target, kind="availability",
                   family=family, bad=tuple(tuple(b) for b in bad))

    @classmethod
    def latency(cls, name: str, target: float, threshold_s: float,
                family: str = "dl4jtpu_serving_request_latency_seconds",
                ) -> "SLObjective":
        return cls(name=name, target=target, kind="latency",
                   family=family, threshold_s=threshold_s)

    @classmethod
    def throughput(cls, name: str, target: float, floor_per_s: float,
                   family: str = "dl4jtpu_decode_tokens_total",
                   demand_family: str =
                   "dl4jtpu_generation_streams_admitted_total",
                   ) -> "SLObjective":
        return cls(name=name, target=target, kind="throughput",
                   family=family, floor_per_s=floor_per_s,
                   demand_family=demand_family)

    @property
    def budget(self) -> float:
        """The error budget: the bad fraction the objective tolerates."""
        return 1.0 - self.target


class SLOEngine:
    """Burn-rate evaluator over the MetricsRegistry.  Thread-safe; one
    `sample()` per scrape is the intended cadence (the collector
    installed by `install()` does exactly that)."""

    def __init__(self, objectives: Sequence[SLObjective],
                 windows: Sequence[BurnWindow] = DEFAULT_WINDOWS,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        if not objectives:
            raise ValueError("SLOEngine needs at least one objective")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError("objective names must be unique")
        self.objectives = tuple(objectives)
        self.windows = tuple(windows)
        if not self.windows:
            raise ValueError("SLOEngine needs at least one window")
        self._clock = clock
        self._registry = registry
        self._lock = threading.Lock()
        horizon = max(w.seconds for w in self.windows)
        self._samples = {
            o.name: deque()                    # (t, good, bad), pruned
            for o in self.objectives
        }
        self._horizon = horizon
        # retention bound: samples landing closer together than this
        # COALESCE (the newest is replaced), capping the deque at
        # ~_MAX_SAMPLES per objective no matter how hard /healthz is
        # probed — each probe samples the engine, and an external LB at
        # 50/s against a 1h slow window would otherwise retain ~180k
        # tuples and linear-scan them under the lock on every probe
        self._min_gap = horizon / float(_MAX_SAMPLES)
        self._base: dict = {}                  # name -> (good, bad) at start
        self._alerting: dict = {o.name: False for o in self.objectives}
        self._alerts_total: dict = {o.name: 0 for o in self.objectives}
        self._state: dict = {}
        self._installed = False

    # -- reads -------------------------------------------------------------
    def _reg(self):
        if self._registry is not None:
            return self._registry
        from deeplearning4j_tpu_torch.observe.metrics import registry

        return registry()

    def _read(self, obj: SLObjective) -> tuple:
        """(good, bad) cumulative event counts for one objective.  The
        family is read via the bucket-agnostic `get` — the engine must
        never fight the owner over histogram bucket layouts (and a
        not-yet-registered family simply reads as zero traffic)."""
        reg = self._reg()
        fam = reg.get(obj.family)
        if obj.kind == "latency":
            if fam is None:
                return 0, 0
            total = fam.count
            good = fam.count_le(obj.threshold_s)
            return good, total - good
        if obj.kind == "throughput":
            # the "bad" slot carries cumulative DEMAND: the sample
            # tuples keep their (t, good, bad) shape and the window
            # scan in _burn_locked needs no second bookkeeping path
            work = fam.sum_series() if fam is not None else 0
            dem_fam = (reg.get(obj.demand_family)
                       if obj.demand_family else None)
            demand = dem_fam.sum_series() if dem_fam is not None else 0
            return work, demand
        if fam is None:
            return 0, 0
        total = fam.sum_series()
        bad = sum(fam.sum_series(**{k: v}) for k, v in obj.bad)
        return total - bad, bad

    # -- the evaluation tick -----------------------------------------------
    def sample(self) -> dict:
        """Read every objective, append the sample, recompute burn rates
        and alert state, refresh the gauges.  Returns the state dict
        (also available without resampling via `state()`)."""
        now = self._clock()
        out = {}
        fired = []
        with self._lock:
            for obj in self.objectives:
                good, bad = self._read(obj)
                dq = self._samples[obj.name]
                if obj.name not in self._base:
                    self._base[obj.name] = (good, bad)
                if len(dq) > 1 and now - dq[-1][0] < self._min_gap:
                    # coalesce: replace the newest retained sample —
                    # probe-rate sampling must not grow the deque (the
                    # baseline sample at dq[0] is never replaced)
                    dq[-1] = (now, good, bad)
                else:
                    dq.append((now, good, bad))
                # keep ONE sample at/just beyond the horizon so the
                # slowest window always has a full-width delta to read
                while len(dq) > 2 and dq[1][0] <= now - self._horizon:
                    dq.popleft()
                burns = {
                    w: self._burn_locked(obj, dq, now, w.seconds)
                    for w in self.windows
                }
                fast = self.windows[0]
                was = self._alerting[obj.name]
                if all(burns[w] > w.threshold for w in self.windows):
                    active = True
                elif burns[fast] <= fast.threshold:
                    # the fast window is also the CLEAR condition:
                    # recovery is visible within one fast window, not
                    # one slow one
                    active = False
                else:
                    active = was
                if active and not was:
                    self._alerts_total[obj.name] += 1
                    fired.append(obj.name)
                    log.warning(
                        "SLO %s burn alert FIRING: %s", obj.name,
                        {f"{w.seconds:g}s":
                         round(burns[w], 2) for w in self.windows},
                    )
                elif was and not active:
                    log.info("SLO %s burn alert cleared", obj.name)
                self._alerting[obj.name] = active
                if obj.kind == "throughput":
                    # no cumulative error fraction exists for a rate
                    # floor: the budget view is 1 - burn over the
                    # SLOWEST window (the long-horizon deficit)
                    slow = self.windows[-1]
                    budget_remaining = max(0.0, 1.0 - burns[slow])
                else:
                    base_good, base_bad = self._base[obj.name]
                    dgood = good - base_good
                    dbad = bad - base_bad
                    dtotal = dgood + dbad
                    budget_remaining = (
                        1.0 - (dbad / dtotal) / max(obj.budget, 1e-12)
                        if dtotal > 0 else 1.0
                    )
                out[obj.name] = {
                    "kind": obj.kind,
                    "target": obj.target,
                    "good": good,
                    "bad": bad,
                    "burn": {
                        f"{w.seconds:g}s": round(burns[w], 4)
                        for w in self.windows
                    },
                    "windows": {
                        f"{w.seconds:g}s": w.threshold
                        for w in self.windows
                    },
                    "alert": active,
                    "alerts_total": self._alerts_total[obj.name],
                    "budget_remaining": round(budget_remaining, 4),
                }
                if obj.kind == "throughput":
                    fast = self.windows[0]
                    rate = self._rate_locked(dq, now, fast.seconds)
                    out[obj.name]["floor_per_s"] = obj.floor_per_s
                    out[obj.name]["rate_per_s"] = (
                        round(rate, 4) if rate is not None else None
                    )
            self._state = out
        self._refresh_gauges(out)
        # rising edges notify OUTSIDE the engine lock: a listener (the
        # serving flight recorder) may read back engine/registry state
        for name in fired:
            _notify_alert(name, out[name])
        return out

    @staticmethod
    def _window_ref(dq, now: float, window_s: float):
        """The NEWEST sample at or before the window start (so the
        delta spans the full window, never a sliver of it)."""
        cutoff = now - window_s
        ref = dq[0]
        for s in dq:
            if s[0] <= cutoff:
                ref = s
            else:
                break
        return ref

    @classmethod
    def _burn_locked(cls, obj: SLObjective, dq, now: float,
                     window_s: float) -> float:
        """Burn rate over the trailing window.  Availability/latency:
        error rate of the events inside it over the error budget; zero
        traffic burns zero.  Throughput: fractional deficit of the
        work rate below the floor over the budget; a window with no
        work AND no fresh demand is idle and burns zero."""
        t_new, good_new, bad_new = dq[-1]
        ref = cls._window_ref(dq, now, window_s)
        dgood = good_new - ref[1]
        dbad = bad_new - ref[2]
        if obj.kind == "throughput":
            dt = t_new - ref[0]
            if dt <= 0 or (dgood <= 0 and dbad <= 0):
                return 0.0
            rate = dgood / dt
            deficit = max(0.0, 1.0 - rate / max(obj.floor_per_s, 1e-12))
            return deficit / max(obj.budget, 1e-12)
        dtotal = dgood + dbad
        if dtotal <= 0:
            return 0.0
        return (dbad / dtotal) / max(obj.budget, 1e-12)

    @classmethod
    def _rate_locked(cls, dq, now: float, window_s: float):
        """Work rate (events/s) over the trailing window, None when the
        window has no width yet."""
        t_new, good_new, _ = dq[-1]
        ref = cls._window_ref(dq, now, window_s)
        dt = t_new - ref[0]
        if dt <= 0:
            return None
        return (good_new - ref[1]) / dt

    def _refresh_gauges(self, state: dict) -> None:
        try:
            reg = self._reg()
            burn = reg.gauge("dl4jtpu_slo_burn_rate")
            budget = reg.gauge("dl4jtpu_slo_error_budget_remaining")
            alert = reg.gauge("dl4jtpu_slo_alert_active")
            fired = reg.counter("dl4jtpu_slo_alerts_total")
            for name, st in state.items():
                for window, b in st["burn"].items():
                    burn.set(b, slo=name, window=window)
                budget.set(st["budget_remaining"], slo=name)
                alert.set(1.0 if st["alert"] else 0.0, slo=name)
                fired.set_total(st["alerts_total"], slo=name)
        except Exception as e:
            # telemetry about telemetry still must not break the scrape
            log.debug("slo gauge refresh failed: %s", e)

    # -- views -------------------------------------------------------------
    def state(self) -> dict:
        """The last computed per-objective state (no resample)."""
        with self._lock:
            return dict(self._state)

    def alerting(self) -> list:
        """Names of objectives whose burn alert is currently firing."""
        with self._lock:
            return sorted(n for n, a in self._alerting.items() if a)

    def summary(self) -> dict:
        """The compact health-payload join (``/healthz``): alerting
        objective names + per-objective fast-window burn."""
        with self._lock:
            state = dict(self._state)
            alerting = sorted(
                n for n, a in self._alerting.items() if a
            )
        fast_key = f"{self.windows[0].seconds:g}s"
        return {
            "alerting": alerting,
            "objectives": {
                name: {
                    "alert": st["alert"],
                    "fast_burn": st["burn"].get(fast_key),
                    "budget_remaining": st["budget_remaining"],
                }
                for name, st in state.items()
            },
        }

    # -- lifecycle ---------------------------------------------------------
    def install(self) -> "SLOEngine":
        """Register as the process's active engine AND as a registry
        collector, so every /metrics scrape is an evaluation tick.
        Takes one baseline sample immediately: the health/status joins
        show the objectives from the moment of install, and the first
        window delta reads against install time instead of the first
        scrape."""
        if not self._installed:
            self._reg().register_collector(self._collect)
            self._installed = True
        set_active_engine(self)
        self.sample()
        return self

    def uninstall(self) -> None:
        if self._installed:
            self._reg().unregister_collector(self._collect)
            self._installed = False
        clear_active_engine(self)

    def _collect(self) -> None:
        self.sample()


# -- active-engine hook (what /healthz, /v1/status, /api/slo and the
# fleet push read) -----------------------------------------------------------

_ACTIVE: Optional[SLOEngine] = None
_ACTIVE_LOCK = threading.Lock()


def set_active_engine(engine: Optional[SLOEngine]) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = engine


def clear_active_engine(engine: SLOEngine) -> None:
    """Drop `engine` iff it is still the active one."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is engine:
            _ACTIVE = None


def active_engine() -> Optional[SLOEngine]:
    with _ACTIVE_LOCK:
        return _ACTIVE


def sample_active_state() -> Optional[dict]:
    """One fresh sample of the active engine's full state (None when no
    engine is installed, or it breaks — a broken SLO engine must never
    take down the surface reading it).  THE shared wrapper behind
    ``/v1/status``, the fleet push, and any other read path that needs
    current burn rates without waiting for a /metrics scrape."""
    try:
        eng = active_engine()
        return eng.sample() if eng is not None else None
    except Exception as e:
        log.debug("slo state sample failed: %s", e)
        return None


def sample_active_summary() -> Optional[dict]:
    """Like `sample_active_state` but the compact ``summary()`` join
    (``/healthz``: alerting names + fast-window burn)."""
    try:
        eng = active_engine()
        if eng is None:
            return None
        eng.sample()
        return eng.summary()
    except Exception as e:
        log.debug("slo summary sample failed: %s", e)
        return None


# -- alert listeners ----------------------------------------------------------
# Process-wide rising-edge hooks: `fn(objective_name, state_dict)` runs
# on every alert FIRING transition of any engine, outside the engine
# lock.  This is how the serving flight recorder dumps on an SLO page
# without observe/ ever importing serving/.

_ALERT_LISTENERS: list = []
_ALERT_LISTENERS_LOCK = threading.Lock()


def add_alert_listener(fn: Callable[[str, dict], None]) -> None:
    with _ALERT_LISTENERS_LOCK:
        if fn not in _ALERT_LISTENERS:
            _ALERT_LISTENERS.append(fn)


def remove_alert_listener(fn: Callable[[str, dict], None]) -> None:
    """Idempotent: removing a never-added listener is a no-op."""
    with _ALERT_LISTENERS_LOCK:
        if fn in _ALERT_LISTENERS:
            _ALERT_LISTENERS.remove(fn)


def _notify_alert(name: str, state: dict) -> None:
    with _ALERT_LISTENERS_LOCK:
        fns = list(_ALERT_LISTENERS)
    for fn in fns:
        try:
            fn(name, state)
        except Exception as e:
            # a broken listener must never take the evaluation tick down
            log.debug("slo alert listener failed for %s: %s", name, e)


def generation_objectives(ttft_target: float = 0.95,
                          ttft_threshold_s: float = 0.5,
                          tokens_floor_per_s: float = 50.0,
                          tokens_target: float = 0.9,
                          success_target: float = 0.99) -> list:
    """The generation-plane objective set (docs/observability.md):
    TTFT-p95 over the TTFT histogram, an aggregate tokens/s floor over
    the decode counter (demand-gated by admissions), and stream
    success over the per-outcome stream counter."""
    return [
        SLObjective.latency(
            "generation_ttft_p95", target=ttft_target,
            threshold_s=ttft_threshold_s, family="dl4jtpu_ttft_seconds",
        ),
        SLObjective.throughput(
            "generation_tokens_rate", target=tokens_target,
            floor_per_s=tokens_floor_per_s,
        ),
        SLObjective.availability(
            "generation_stream_success", target=success_target,
            family="dl4jtpu_generation_streams_total",
            bad=(("outcome", "error"), ("outcome", "wedged"),
                 ("outcome", "kv_exhausted")),
        ),
    ]
