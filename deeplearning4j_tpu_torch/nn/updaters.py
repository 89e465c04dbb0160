"""Updaters (optimizers) — `deeplearning4j_tpu/nn/updaters.py`: the twelve
updater configs, and `with_gradient_clipping`.

The JAX package lowers each config to an optax transformation.  The port
has no optax: `to_tx` builds the same chain out of the transforms below,
each optax's arithmetic on a list of gradients in PyTorch (`_foreach`
ops, one f32 rounding an operation):

- ``sgd`` = trace (Momentum, Nesterovs) -> the learning rate;
- ``adam`` / ``nadam`` = scale_by_adam -> lr; ``adamw`` inserts
  add_decayed_weights; ``adamax``, ``amsgrad``, ``adagrad`` (scale_by_rss),
  ``adadelta`` (no learning rate), ``rmsprop`` (scale_by_rms) likewise;
- NoOp = set_to_zero;
- the learning rate, constant or a `Schedule`, is scale_by_schedule,
  which counts its own steps (the JAX package lowers a constant through
  `FixedSchedule` too).

A state is a tuple in optax's field order: Python int counts (int32 in
a checkpoint), lists of tensors (one per parameter, in the order of the
parameter list, which the model keeps in ``jax.tree.leaves`` order), and
nested tuples for a chain.  `state_leaves` flattens it in the order
``jax.tree.leaves`` flattens optax's state, `load_state_leaves` writes
such a list back: the positional ``updater.npz`` of a checkpoint.
Tensors of a state are updated in place.

Step values.  What changes from step to step besides the tensors — the
learning rate a schedule gives and Adam's bias corrections — is a
function of the counts alone: ``tx.values(state)`` gives those f32
values on the host, and ``update(..., vals=...)`` takes them as given.
With ``vals`` None the update computes them itself, as Python floats
(the CPU path, optax's arithmetic).  A captured training step on the
card passes them as 0-dim views of a device tensor it refills before
each replay, so no step's rate is baked into the graph; the counts then
advance on the host (`advance_counts`), as `update` would advance them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, NamedTuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.schedules import ScheduleLike, as_schedule
from deeplearning4j_tpu_torch.utils import serde

_INT32_MAX = 2**31 - 1


def _f32(v) -> float:
    """A Python float holding ``v`` rounded to f32: how jax takes a
    Python constant next to an f32 array."""
    return float(np.float32(v))


def _bump(count: int) -> int:
    """optax's ``safe_increment`` of an int32 count."""
    return min(count + 1, _INT32_MAX)


def _no_values(state) -> list:
    return []


class Transform(NamedTuple):
    """An optax ``GradientTransformation``: ``init(params) -> state``,
    ``update(grads, state, params, vals=None) -> (updates, state)``, and
    ``values(state)``: the step values that update reads (see the module
    docstring).  ``rate_scaled(factor)``: the same transform with its
    learning rate times ``factor`` (None: it has no rate), see
    `scale_rate`."""

    init: Callable
    update: Callable
    values: Callable = _no_values
    rate_scaled: Callable | None = None


def scale_rate(tx: Transform, factor: float) -> Transform | None:
    """``tx`` with every learning rate it applies multiplied by ``factor``
    (rounded to f32), or None when it applies none (AdaDelta, NoOp).
    The state and the step program are unchanged: only the step values
    differ, so a captured step reads the new rate from its staged
    values with no new capture.  For an f32 ``factor`` that is a power
    of two the updates equal optax's ``updates * factor`` bit for bit."""
    return tx.rate_scaled(factor) if tx.rate_scaled is not None else None


def _zeros(params):
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def _empty_init(params):
    return ()


def chain(*txs) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in txs)

    def values(state):
        return [v for t, s in zip(txs, state) for v in t.values(s)]

    def update(grads, state, params=None, vals=None):
        new = []
        at = 0
        for t, s in zip(txs, state):
            mine = None
            if vals is not None:
                n = len(t.values(s))
                mine, at = vals[at:at + n], at + n
            grads, s = t.update(grads, s, params, mine)
            new.append(s)
        return grads, tuple(new)

    def rate_scaled(factor):
        return chain(*(t.rate_scaled(factor) if t.rate_scaled is not None else t
                       for t in txs))

    rated = any(t.rate_scaled is not None for t in txs)
    return Transform(init, update, values, rate_scaled if rated else None)


def advance_counts(state):
    """``state`` with every count bumped once: the counts `update`
    returns, for a step whose tensors were updated without running it
    (a graph replay)."""
    if isinstance(state, tuple):
        return tuple(advance_counts(s) for s in state)
    if isinstance(state, int):
        return _bump(state)
    return state


def identity() -> Transform:
    return Transform(_empty_init, lambda g, s, p=None, v=None: (g, s))


def _moment(grads, moments, decay: float, order: int) -> None:
    """moments <- (1 - decay) g^order + decay moments, in place."""
    g = grads if order == 1 else torch._foreach_mul(grads, grads)
    torch._foreach_mul_(moments, _f32(decay))
    torch._foreach_add_(moments, torch._foreach_mul(g, _f32(1 - decay)))


def _bias_correction(decay: float, count: int) -> float:
    # 1 - decay^count in f32, on the host: the count is a host integer
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _sqrt(xs):
    return torch._foreach_sqrt(xs)


def scale_by_schedule(fn) -> Transform:
    """updates * fn(count), the count its own state."""
    def values(state):
        return [float(np.float32(fn(state[0])))]

    def update(grads, state, params=None, vals=None):
        (count,) = state
        (lr,) = values(state) if vals is None else vals
        return torch._foreach_mul(grads, lr), (_bump(count),)

    def rate_scaled(factor):
        f = np.float32(factor)
        return scale_by_schedule(lambda count: np.float32(fn(count)) * f)

    return Transform(lambda params: (0,), update, values, rate_scaled)


def trace(decay: float, nesterov: bool = False) -> Transform:
    def update(grads, state, params=None, vals=None):
        (tr,) = state
        torch._foreach_mul_(tr, _f32(decay))
        torch._foreach_add_(tr, grads)                  # g + decay t
        if nesterov:
            out = torch._foreach_add(grads, torch._foreach_mul(tr, _f32(decay)))
        else:
            out = list(tr)                              # the next transform copies
        return out, (tr,)

    return Transform(lambda params: (_zeros(params),), update)


def scale_by_adam(b1: float, b2: float, eps: float, nesterov: bool = False) -> Transform:
    def values(state):
        count = _bump(state[0])
        vals = [_bias_correction(b1, count), _bias_correction(b2, count)]
        if nesterov:
            vals.append(_bias_correction(b1, _bump(count)))
        return vals

    def update(grads, state, params=None, vals=None):
        count, mu, nu = state
        c1, c2, *c1_next = values(state) if vals is None else vals
        grads = [g.float() for g in grads]
        _moment(grads, mu, b1, 1)
        _moment(grads, nu, b2, 2)
        count = _bump(count)
        if nesterov:
            m = torch._foreach_mul(torch._foreach_div(mu, c1_next[0]), _f32(b1))
            torch._foreach_add_(m, torch._foreach_mul(
                torch._foreach_div(grads, c1), _f32(1 - b1)))
        else:
            m = torch._foreach_div(mu, c1)
        v = torch._foreach_div(nu, c2)
        den = _sqrt(v)
        torch._foreach_add_(den, _f32(eps))
        return torch._foreach_div(m, den), (count, mu, nu)

    return Transform(lambda params: (0, _zeros(params), _zeros(params)), update,
                     values)


def scale_by_adamax(b1: float, b2: float, eps: float) -> Transform:
    def values(state):
        return [_bias_correction(b1, _bump(state[0]))]

    def update(grads, state, params=None, vals=None):
        count, mu, nu = state
        (c1,) = values(state) if vals is None else vals
        grads = [g.float() for g in grads]
        count = _bump(count)
        _moment(grads, mu, b1, 1)
        for n, g in zip(nu, grads):                      # max(|g| + eps, b2 nu)
            torch.maximum(g.abs() + _f32(eps), n * _f32(b2), out=n)
        m = torch._foreach_div(mu, c1)
        return torch._foreach_div(m, nu), (count, mu, nu)

    return Transform(lambda params: (0, _zeros(params), _zeros(params)), update,
                     values)


def scale_by_amsgrad(b1: float, b2: float, eps: float) -> Transform:
    def values(state):
        count = _bump(state[0])
        return [_bias_correction(b1, count), _bias_correction(b2, count)]

    def update(grads, state, params=None, vals=None):
        count, mu, nu, nu_max = state
        c1, c2 = values(state) if vals is None else vals
        grads = [g.float() for g in grads]
        _moment(grads, mu, b1, 1)
        _moment(grads, nu, b2, 2)
        count = _bump(count)
        m = torch._foreach_div(mu, c1)
        v = torch._foreach_div(nu, c2)
        torch._foreach_maximum_(nu_max, v)
        den = _sqrt(nu_max)
        torch._foreach_add_(den, _f32(eps))
        return torch._foreach_div(m, den), (count, mu, nu, nu_max)

    return Transform(
        lambda params: (0, _zeros(params), _zeros(params), _zeros(params)), update,
        values)


def scale_by_rss(initial: float, eps: float) -> Transform:
    def update(grads, state, params=None, vals=None):
        (ss,) = state
        grads = [g.float() for g in grads]
        torch._foreach_add_(ss, torch._foreach_mul(grads, grads))
        out = []
        for t, g in zip(ss, grads):
            inv = torch.where(t > 0, torch.rsqrt(t + _f32(eps)), 0.0)
            out.append(inv * g)
        return out, (ss,)

    def init(params):
        return ([torch.full_like(p, _f32(initial), dtype=torch.float32)
                 for p in params],)

    return Transform(init, update)


def scale_by_adadelta(rho: float, eps: float) -> Transform:
    def update(grads, state, params=None, vals=None):
        e_g, e_x = state
        grads = [g.float() for g in grads]
        _moment(grads, e_g, rho, 2)
        num = _sqrt(torch._foreach_add(e_x, _f32(eps)))
        den = _sqrt(torch._foreach_add(e_g, _f32(eps)))
        upd = torch._foreach_mul(torch._foreach_div(num, den), grads)
        _moment(upd, e_x, rho, 2)
        return upd, (e_g, e_x)

    return Transform(lambda params: (_zeros(params), _zeros(params)), update)


def scale_by_rms(decay: float, eps: float) -> Transform:
    def update(grads, state, params=None, vals=None):
        (nu,) = state
        grads = [g.float() for g in grads]
        _moment(grads, nu, decay, 2)
        scaling = torch._foreach_rsqrt(torch._foreach_add(nu, _f32(eps)))
        return torch._foreach_mul(scaling, grads), (nu,)

    return Transform(lambda params: (_zeros(params),), update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(grads, state, params=None, vals=None):
        if not weight_decay:                  # g + 0 p is g
            return grads, state
        if params is None:
            raise ValueError("add_decayed_weights needs the parameters")
        return torch._foreach_add(
            grads, torch._foreach_mul([p.detach().float() for p in params],
                                      _f32(weight_decay))), state

    return Transform(_empty_init, update)


def set_to_zero() -> Transform:
    return Transform(_empty_init,
                     lambda g, s, p=None, v=None: ([torch.zeros_like(x) for x in g], s))


def clip(max_delta: float) -> Transform:
    return Transform(_empty_init, lambda g, s, p=None, v=None: (
        [x.clamp(-max_delta, max_delta) for x in g], s))


_norm = threading.local()


@contextlib.contextmanager
def global_norm_scope(sq_norm):
    """While active, `clip_by_global_norm` takes the squared norm from
    ``sq_norm(grads)``: the ZeRO epilogue's sum over every rank's
    slices, where a rank's gradient list holds its slices only."""
    prev = getattr(_norm, "fn", None)
    _norm.fn = sq_norm
    try:
        yield
    finally:
        _norm.fn = prev


def global_sq_norm(grads) -> torch.Tensor:
    """The squared L2 norm over every leaf of ``grads`` (over the whole
    gradient under a `global_norm_scope`)."""
    fn = getattr(_norm, "fn", None)
    if fn is not None:
        return fn(grads)
    return sum((g.float() * g.float()).sum() for g in grads)


def clip_by_global_norm(max_norm: float) -> Transform:
    def update(grads, state, params=None, vals=None):
        norm = torch.sqrt(global_sq_norm(grads))
        # a select, as optax does: no host sync on the norm
        keep = norm < max_norm
        return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm)
                for g in grads], state

    return Transform(_empty_init, update)


def state_leaves(state) -> list:
    """The state's leaves in ``jax.tree.leaves`` order of optax's state:
    counts as int32 numpy scalars, tensors as they are."""
    out = []
    for s in state:
        if isinstance(s, (tuple, list)):
            out.extend(state_leaves(s))
        elif isinstance(s, int):
            out.append(np.int32(s))
        else:
            out.append(s)
    return out


def load_state_leaves(state, leaves):
    """``state`` with its leaves replaced, in order, by ``leaves``
    (tensors or array-likes): counts become ints, tensors are copied in
    place.  Raises `ValueError` on a count or shape mismatch."""
    it = iter(leaves)

    def walk(s):
        if isinstance(s, tuple):
            return tuple(walk(x) for x in s)
        if isinstance(s, list):
            return [walk(x) for x in s]
        try:
            leaf = next(it)
        except StopIteration:
            raise ValueError("fewer saved updater leaves than the updater "
                             "state holds") from None
        if isinstance(s, int):
            return int(leaf)
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        if tuple(t.shape) != tuple(s.shape):
            raise ValueError(f"updater leaf shape {tuple(t.shape)} != "
                             f"{tuple(s.shape)}")
        s.copy_(t.to(s.dtype))
        return s

    new = walk(state)
    if next(it, None) is not None:
        raise ValueError("more saved updater leaves than the updater state holds")
    return new


@dataclasses.dataclass(frozen=True)
class Updater:
    """Base updater config.  ``learning_rate`` is a float or a `Schedule`.
    A config is itself a transform (steps counted per iteration):
    ``init`` / ``update`` of ``to_tx()``."""

    learning_rate: ScheduleLike = 1e-3

    def __post_init__(self):
        as_schedule(self.learning_rate)

    def _lr(self, steps_per_epoch: int) -> Transform:
        # the JAX package hands optax a function even for a constant
        # rate, so every updater with a rate counts its steps twice
        fn = as_schedule(self.learning_rate).to_fn(steps_per_epoch)
        return scale_by_schedule(lambda count: -np.float32(fn(count)))

    def to_tx(self, steps_per_epoch: int = 1) -> Transform:
        raise NotImplementedError

    def init(self, params):
        return self.to_tx().init(params)

    def update(self, grads, state, params=None, vals=None):
        return self.to_tx().update(grads, state, params, vals)


@dataclasses.dataclass(frozen=True)
class Sgd(Updater):
    def to_tx(self, steps_per_epoch: int = 1):
        return chain(identity(), self._lr(steps_per_epoch))


@dataclasses.dataclass(frozen=True)
class Nesterovs(Updater):
    learning_rate: ScheduleLike = 0.1
    momentum: float = 0.9

    def to_tx(self, steps_per_epoch: int = 1):
        return chain(trace(self.momentum, nesterov=True), self._lr(steps_per_epoch))


@dataclasses.dataclass(frozen=True)
class Momentum(Updater):
    learning_rate: ScheduleLike = 0.1
    momentum: float = 0.9

    def to_tx(self, steps_per_epoch: int = 1):
        return chain(trace(self.momentum), self._lr(steps_per_epoch))


@dataclasses.dataclass(frozen=True)
class Adam(Updater):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_tx(self, steps_per_epoch: int = 1):
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon),
                     self._lr(steps_per_epoch))


@dataclasses.dataclass(frozen=True)
class AdamW(Updater):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 0.01

    def to_tx(self, steps_per_epoch: int = 1):
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon),
                     add_decayed_weights(self.weight_decay),
                     self._lr(steps_per_epoch))


@dataclasses.dataclass(frozen=True)
class AdaMax(Updater):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_tx(self, steps_per_epoch: int = 1):
        return chain(scale_by_adamax(self.beta1, self.beta2, self.epsilon),
                     self._lr(steps_per_epoch))


@dataclasses.dataclass(frozen=True)
class Nadam(Updater):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_tx(self, steps_per_epoch: int = 1):
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon,
                                   nesterov=True),
                     self._lr(steps_per_epoch))


@dataclasses.dataclass(frozen=True)
class AmsGrad(Updater):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_tx(self, steps_per_epoch: int = 1):
        return chain(scale_by_amsgrad(self.beta1, self.beta2, self.epsilon),
                     self._lr(steps_per_epoch))


@dataclasses.dataclass(frozen=True)
class AdaGrad(Updater):
    epsilon: float = 1e-6

    def to_tx(self, steps_per_epoch: int = 1):
        # optax.adagrad's initial accumulator value
        return chain(scale_by_rss(0.1, self.epsilon), self._lr(steps_per_epoch))


@dataclasses.dataclass(frozen=True)
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6

    def to_tx(self, steps_per_epoch: int = 1):
        # the reference's AdaDelta ignores the learning rate; optax.adadelta
        # adds a weight decay of 0.0 first, a no-op with no state
        return chain(add_decayed_weights(0.0), scale_by_adadelta(self.rho, self.epsilon),
                     identity())


@dataclasses.dataclass(frozen=True)
class RmsProp(Updater):
    decay: float = 0.95
    epsilon: float = 1e-8

    def to_tx(self, steps_per_epoch: int = 1):
        return chain(scale_by_rms(self.decay, self.epsilon),
                     self._lr(steps_per_epoch), identity())


@dataclasses.dataclass(frozen=True)
class NoOp(Updater):
    """Frozen parameters (the reference's NoOp updater)."""

    def to_tx(self, steps_per_epoch: int = 1):
        return set_to_zero()


for _cls in (Sgd, Nesterovs, Momentum, Adam, AdamW, AdaMax, Nadam, AmsGrad,
             AdaGrad, AdaDelta, RmsProp, NoOp):
    serde.register(_cls)


def with_gradient_clipping(tx, clip_value: float | None = None,
                           clip_norm: float | None = None) -> Transform:
    """Elementwise clip to [-clip_value, clip_value], then rescale to a
    global L2 norm of at most clip_norm, then ``tx`` (a `Transform` or an
    `Updater`): the optax chain the JAX package builds, a chain even
    with no clipping."""
    if isinstance(tx, Updater):
        tx = tx.to_tx()
    txs = []
    if clip_value is not None:
        txs.append(clip(clip_value))
    if clip_norm is not None:
        txs.append(clip_by_global_norm(clip_norm))
    return chain(*txs, tx)
