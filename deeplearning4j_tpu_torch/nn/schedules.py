"""Learning-rate schedules — `deeplearning4j_tpu/nn/schedules.py`.

Each schedule is a serializable dataclass whose ``to_fn(steps_per_epoch)``
returns ``step -> learning rate``.  The step is the optimizer's own
count, a host integer in the port, so a schedule costs no device work:
it is evaluated on the host in numpy f32, the dtype jax evaluates it in
(``step`` an int32, the Python constants weak-typed to f32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Union

import numpy as np

from deeplearning4j_tpu_torch.utils import serde

_F = np.float32


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Base; subclasses define ``to_fn``."""

    def to_fn(self, steps_per_epoch: int = 1):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FixedSchedule(Schedule):
    value: float = 1e-3

    def to_fn(self, steps_per_epoch: int = 1):
        return lambda step: _F(self.value)


@dataclasses.dataclass(frozen=True)
class StepSchedule(Schedule):
    """lr * decay_rate ^ floor(t / step)."""

    initial: float = 1e-3
    decay_rate: float = 0.5
    step: float = 1000.0
    per_epoch: bool = False

    def to_fn(self, steps_per_epoch: int = 1):
        unit = _F(self.step * (steps_per_epoch if self.per_epoch else 1.0))
        return lambda t: _F(self.initial) * _F(self.decay_rate) ** np.floor(_F(t) / unit)


@dataclasses.dataclass(frozen=True)
class ExponentialSchedule(Schedule):
    initial: float = 1e-3
    gamma: float = 0.999

    def to_fn(self, steps_per_epoch: int = 1):
        return lambda t: _F(self.initial) * _F(self.gamma) ** _F(t)


@dataclasses.dataclass(frozen=True)
class PolySchedule(Schedule):
    initial: float = 1e-3
    power: float = 1.0
    max_iter: int = 10000

    def to_fn(self, steps_per_epoch: int = 1):
        def fn(t):
            frac = np.clip(_F(t) / _F(self.max_iter), _F(0.0), _F(1.0))
            return _F(self.initial) * (_F(1.0) - frac) ** _F(self.power)

        return fn


@dataclasses.dataclass(frozen=True)
class SigmoidSchedule(Schedule):
    initial: float = 1e-3
    gamma: float = 0.01
    step_size: int = 1000

    def to_fn(self, steps_per_epoch: int = 1):
        return lambda t: _F(self.initial) / (
            _F(1.0) + np.exp(_F(self.gamma) * (_F(t) - _F(self.step_size))))


@dataclasses.dataclass(frozen=True)
class InverseSchedule(Schedule):
    initial: float = 1e-3
    gamma: float = 1e-3
    power: float = 1.0

    def to_fn(self, steps_per_epoch: int = 1):
        return lambda t: _F(self.initial) / (
            _F(1.0) + _F(self.gamma) * _F(t)) ** _F(self.power)


@dataclasses.dataclass(frozen=True)
class CosineSchedule(Schedule):
    """Cosine decay with optional linear warmup."""

    initial: float = 1e-3
    decay_steps: int = 10000
    warmup_steps: int = 0
    final_fraction: float = 0.0

    def to_fn(self, steps_per_epoch: int = 1):
        def fn(t):
            t = _F(t)
            if t < self.warmup_steps:
                return _F(self.initial) * t / _F(max(self.warmup_steps, 1))
            prog = np.clip((t - _F(self.warmup_steps))
                           / _F(max(self.decay_steps - self.warmup_steps, 1)),
                           _F(0.0), _F(1.0))
            # (1 - f) * 0.5 is a Python float in the JAX package, taken
            # as f32 only when it meets the array
            half = _F((1 - self.final_fraction) * 0.5)
            cos = _F(self.final_fraction) + half * (
                _F(1.0) + np.cos(_F(math.pi) * prog))
            return _F(self.initial) * cos

        return fn


for _cls in (FixedSchedule, StepSchedule, ExponentialSchedule, PolySchedule,
             SigmoidSchedule, InverseSchedule, CosineSchedule):
    serde.register(_cls)

ScheduleLike = Union[Schedule, float]


def as_schedule(s: ScheduleLike) -> Schedule:
    if isinstance(s, bool) or not isinstance(s, (int, float, Schedule)):
        raise TypeError(
            f"a learning rate is a number or a Schedule of nn/schedules.py, "
            f"got {s!r}")
    return FixedSchedule(float(s)) if isinstance(s, (int, float)) else s
