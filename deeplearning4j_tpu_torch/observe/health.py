"""Numeric-health monitoring — `deeplearning4j_tpu/observe/health.py`:
notice divergence fast, with evidence.

`HealthListener` runs one device reduction over the parameters at a
set cadence: the parameters are gathered into one flat f32 buffer (a
copy, which is also the previous-parameters copy the next check
subtracts), and three scalars come out of it — the count of non-finite
elements, the global L2 norm, and the update norm |Δw| against the
previous check's copy.  The three scalars are the only host transfer a
check makes (one copy of a 3-vector); no leaf is read on the host.  The
copy is a new tensor, so the next step's in-place writes cannot reach
it.

Divergence events (non-finite score, non-finite parameters, a global
norm above ``norm_explosion_factor`` times the first healthy norm) are
counted (``dl4jtpu_health_divergence_total{kind=...}``), logged as one
JSON line, written through `runtime/crash.py` `write_divergence_report`
(at most ``max_reports``), and raised as `DivergenceError` when
``raise_on_divergence`` is set.
"""

from __future__ import annotations

import json
import logging
import math
import time
from typing import Optional

import torch

from deeplearning4j_tpu_torch.models.model import tree_leaves
from deeplearning4j_tpu_torch.train.listeners import TrainingListener

log = logging.getLogger("deeplearning4j_tpu_torch")


class DivergenceError(RuntimeError):
    """Raised by ``HealthListener(raise_on_divergence=True)`` on a flagged
    divergence; ``.event`` carries the structured record."""

    def __init__(self, event: dict):
        super().__init__(
            f"training diverged at iteration {event.get('iteration')}: "
            f"{event.get('kind')} (score={event.get('score')}, "
            f"global_norm={event.get('global_norm')})")
        self.event = event


@torch.no_grad()
def health_scalars(params: dict, prev: Optional[torch.Tensor]):
    """(non-finite count, global L2 norm, |Δw| or None, flat copy): one
    flat f32 copy of the parameter leaves (``jax.tree.leaves`` order)
    and three reductions over it, read back in one transfer.  ``prev``:
    the flat copy of the previous check (None: no |Δw|)."""
    leaves = tree_leaves(params)
    if not leaves:
        return 0, 0.0, None, None
    flat = torch.cat([t.detach().reshape(-1).float() for t in leaves])
    nonfinite = (~torch.isfinite(flat)).sum().float()
    gnorm = flat.square().sum().sqrt()
    if prev is not None:
        unorm = (flat - prev).square().sum().sqrt()
    else:
        unorm = gnorm.new_full((), -1.0)
    n, g, u = torch.stack([nonfinite, gnorm, unorm]).cpu().tolist()
    return int(n), g, (u if prev is not None else None), flat


class HealthListener(TrainingListener):
    """Per-step numeric-health check on the listener SPI.

    frequency: check every N iterations (the check is one flat copy and
      three reductions; cheap enough for 1 on small models).
    track_updates: keep the previous check's flat copy for |Δw| (one
      parameter-sized f32 buffer on the model's device).
    norm_explosion_factor: flag when the global norm exceeds this
      multiple of the first healthy norm.
    raise_on_divergence: raise `DivergenceError` instead of only
      recording, logging and reporting.
    write_reports: write events through `runtime/crash.py` (at most
      ``max_reports`` files a listener).
    """

    def __init__(self, frequency: int = 10, track_updates: bool = True,
                 norm_explosion_factor: float = 100.0,
                 raise_on_divergence: bool = False,
                 write_reports: bool = True, max_reports: int = 3):
        self.frequency = max(1, frequency)
        self.track_updates = track_updates
        self.norm_explosion_factor = float(norm_explosion_factor)
        self.raise_on_divergence = raise_on_divergence
        self.write_reports = write_reports
        self.max_reports = max_reports
        self.events: list[dict] = []
        self.report_paths: list[str] = []
        self.baseline_norm: Optional[float] = None
        self.last_global_norm: Optional[float] = None
        self.last_update_norm: Optional[float] = None
        self._prev_params: Optional[torch.Tensor] = None
        # the model's step program count at the last check: a grouped
        # program (steps_per_execution, or a truncated-BPTT batch's
        # windows) dispatches its k listener calls after all k updates
        self._last_seen_params = None

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency:
            return
        seen = getattr(model, "step_programs_run", None)
        if seen is not None and seen == self._last_seen_params:
            # the same parameters as the last check (a group's later
            # step): only its score is new
            score_f = float(score)
            if math.isfinite(score_f):
                return
            from deeplearning4j_tpu_torch.observe.metrics import registry as _reg

            self._flag(model, iteration, epoch, "nonfinite_score", score_f,
                       self.last_global_norm, self.last_update_norm, 0, _reg())
            return
        self._last_seen_params = seen

        from deeplearning4j_tpu_torch.observe.metrics import registry
        from deeplearning4j_tpu_torch.observe.trace import tracer

        reg = registry()
        with tracer().span("health_check", cat="health"):
            with_prev = self.track_updates and self._prev_params is not None
            nonfinite, gnorm, unorm, flat = health_scalars(
                model.params, self._prev_params if with_prev else None)
            if self.track_updates:
                self._prev_params = flat
            score_f = float(score)
        reg.counter("dl4jtpu_health_checks_total").inc()
        reg.gauge("dl4jtpu_health_param_global_norm").set(gnorm)
        if unorm is not None:
            reg.gauge("dl4jtpu_health_update_norm").set(unorm)
        self.last_global_norm = gnorm
        self.last_update_norm = unorm

        kind = None
        if not math.isfinite(score_f):
            kind = "nonfinite_score"
        elif nonfinite > 0:
            kind = "nonfinite_params"
        elif (self.baseline_norm is not None and math.isfinite(gnorm)
              and gnorm > self.norm_explosion_factor * max(self.baseline_norm, 1e-12)):
            kind = "norm_explosion"
        if kind is None:
            if self.baseline_norm is None and math.isfinite(gnorm):
                self.baseline_norm = gnorm
            return
        self._flag(model, iteration, epoch, kind, score_f, gnorm, unorm,
                   nonfinite, reg)

    @staticmethod
    def _json_safe(v):
        """Non-finite floats as strings: json.dumps would write bare NaN /
        Infinity, invalid JSON, in exactly the records that matter."""
        if v is None or (isinstance(v, float) and math.isfinite(v)):
            return v
        if isinstance(v, float):
            return repr(v)
        return v

    def _flag(self, model, iteration, epoch, kind, score, gnorm, unorm,
              nonfinite, reg) -> None:
        event = {
            "kind": kind,
            "iteration": int(iteration),
            "epoch": int(epoch),
            "score": self._json_safe(score),
            "global_norm": self._json_safe(gnorm),
            "update_norm": self._json_safe(unorm),
            "nonfinite_param_elements": nonfinite,
            "baseline_norm": self.baseline_norm,
            "norm_explosion_factor": self.norm_explosion_factor,
            "time": time.time(),
            "model": type(model).__name__,
        }
        self.events.append(event)
        reg.counter("dl4jtpu_health_divergence_total").inc(kind=kind)
        log.error("DIVERGENCE %s", json.dumps(event, sort_keys=True))
        if self.write_reports and len(self.report_paths) < self.max_reports:
            from deeplearning4j_tpu_torch.runtime import crash

            try:
                self.report_paths.append(crash.write_divergence_report(event))
            except Exception:
                # a report must never take down the training loop
                log.exception("divergence report write failed")
        if self.raise_on_divergence:
            raise DivergenceError(event)

    @property
    def diverged(self) -> bool:
        return bool(self.events)
