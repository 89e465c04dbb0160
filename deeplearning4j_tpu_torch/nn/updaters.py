"""Updaters (optimizers) — `Updater`, `Sgd`, `Adam` and
`with_gradient_clipping` of `deeplearning4j_tpu/nn/updaters.py`.

The JAX package lowers each updater config to an optax transformation.
The port has no optax: each config here is plain tensor code over a list
of gradients that carries optax's formula, so that the same gradients
give the same updates (the parity tests run both):

- `Sgd`: ``optax.sgd(lr)``, update = -lr * g.
- `Adam`: ``optax.adam(lr, b1, b2, eps)``:
  m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2;  count += 1;
  update = -lr * (m / (1 - b1^count)) / (sqrt(v / (1 - b2^count)) + eps).
- `with_gradient_clipping`: ``optax.clip(value)`` (elementwise), then
  ``optax.clip_by_global_norm(norm)``, then the updater.

`init(params)` makes the state for a list of parameters; `update(grads,
state)` returns the additive updates and the new state (moments are
updated in place: the port keeps one copy of them, where JAX's immutable
arrays make a new one each step).  A learning rate that is a schedule
raises until `schedules.py` is ported (ROADMAP A2).
"""

from __future__ import annotations

import dataclasses
import numbers

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Updater:
    """Base updater config."""

    learning_rate: float = 1e-3

    def __post_init__(self):
        if not isinstance(self.learning_rate, numbers.Real):
            raise NotImplementedError(
                "learning-rate schedules are not ported yet (ROADMAP A2: "
                f"nn/schedules.py); got {self.learning_rate!r}")

    def init(self, params: list) -> dict:
        return {}

    def update(self, grads: list, state: dict) -> tuple[list, dict]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Sgd(Updater):

    def update(self, grads, state):
        return [g * -self.learning_rate for g in grads], state


@dataclasses.dataclass(frozen=True)
class Adam(Updater):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"count": 0,
                "mu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
                "nu": [torch.zeros_like(p, dtype=torch.float32) for p in params]}

    @torch.no_grad()
    def update(self, grads, state):
        b1, b2 = self.beta1, self.beta2
        count = state["count"] + 1
        # optax: 1 - decay**count in f32.  Host floats holding those f32
        # values: a CPU tensor moved to the card would synchronise the
        # stream once per parameter
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        updates = []
        for g, mu, nu in zip(grads, state["mu"], state["nu"]):
            g = g.float()
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.epsilon)
            updates.append(u.mul_(-self.learning_rate))
        return updates, {**state, "count": count}


@dataclasses.dataclass(frozen=True)
class _Clipped:
    """An updater behind gradient clipping (same `init` / `update`)."""

    inner: Updater
    clip_value: float | None
    clip_norm: float | None

    def init(self, params):
        return self.inner.init(params)

    @torch.no_grad()
    def update(self, grads, state):
        if self.clip_value is not None:
            grads = [g.clamp(-self.clip_value, self.clip_value) for g in grads]
        if self.clip_norm is not None:
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            # a select, as optax does: no host sync on the norm
            grads = [torch.where(norm < self.clip_norm, g,
                                 g / norm.to(g.dtype) * self.clip_norm)
                     for g in grads]
        return self.inner.update(grads, state)


def with_gradient_clipping(tx: Updater, clip_value: float | None = None,
                           clip_norm: float | None = None):
    """Elementwise clip to [-clip_value, clip_value], then rescale to a
    global L2 norm of at most clip_norm, then ``tx`` — the optax chain
    the JAX package builds."""
    if clip_value is None and clip_norm is None:
        return tx
    return _Clipped(tx, clip_value, clip_norm)
