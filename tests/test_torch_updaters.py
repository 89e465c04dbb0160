"""The port's updaters and schedules (`nn/updaters.py`,
`nn/schedules.py`) against the JAX package's optax chains, on the CPU.

Every updater x {a constant rate, each of the seven schedules} x {no
clip, an elementwise clip, a global-norm clip} takes 5 steps from the
same parameters and gradients (numpy seed 1).  Held after every step:
the parameters within 1e-6 (absolute; they are N(0, 1), so that is a few
f32 ulps), and the state's leaves in ``jax.tree.leaves`` order of the
optax state — the same count, shapes and int32 counts exactly, the
floats within 1e-6 (absolute and relative).  The tolerance covers f32
operations XLA orders or fuses (multiply-adds) otherwise.  Schedules
alone: ``to_fn`` at steps 0-40, per iteration and per epoch, within 1e-6
relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn import schedules as jax_schedules
from deeplearning4j_tpu.nn import updaters as jax_updaters
from deeplearning4j_tpu_torch.nn import schedules, updaters

torch.set_num_threads(1)

UPDATERS = ["Sgd", "Nesterovs", "Momentum", "Adam", "AdamW", "AdaMax", "Nadam",
            "AmsGrad", "AdaGrad", "AdaDelta", "RmsProp", "NoOp"]
SCHEDULES = {
    "constant": None,
    "FixedSchedule": dict(value=0.05),
    "StepSchedule": dict(initial=0.05, decay_rate=0.5, step=2.0),
    "ExponentialSchedule": dict(initial=0.05, gamma=0.9),
    "PolySchedule": dict(initial=0.05, power=2.0, max_iter=8),
    "SigmoidSchedule": dict(initial=0.05, gamma=0.5, step_size=3),
    "InverseSchedule": dict(initial=0.05, gamma=0.3, power=1.5),
    "CosineSchedule": dict(initial=0.05, decay_steps=6, warmup_steps=2,
                           final_fraction=0.1),
}
CLIPS = {"none": (None, None), "value": (0.5, None), "norm": (None, 2.0)}
SHAPES = [(4, 3), (5,), (2, 2, 2)]
STEPS = 5
TOL = 1e-6


def _lr(sched, module):
    if sched == "constant":
        return 0.05
    return getattr(module, sched)(**SCHEDULES[sched])


def _pair(name, sched, clip):
    value, norm = CLIPS[clip]
    port = getattr(updaters, name)(learning_rate=_lr(sched, schedules))
    ref = getattr(jax_updaters, name)(learning_rate=_lr(sched, jax_schedules))
    return (updaters.with_gradient_clipping(port, value, norm),
            jax_updaters.with_gradient_clipping(ref.to_optax(), value, norm))


def _check_state(port_state, jax_state):
    got = updaters.state_leaves(port_state)
    ref = jax.tree.leaves(jax_state)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
        if b.dtype == np.int32:
            assert int(a) == int(b)
        else:
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("name", UPDATERS)
def test_updater_matches_optax_step_for_step(name, sched, clip):
    port_tx, jax_tx = _pair(name, sched, clip)
    rng = np.random.default_rng(1)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * 2).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    jp = [jnp.asarray(p) for p in params]
    jstate = jax_tx.init(jp)
    jupdate = jax.jit(jax_tx.update)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = port_tx.init(tp)
    _check_state(tstate, jstate)
    for g in grads:
        upd, jstate = jupdate([jnp.asarray(x) for x in g], jstate, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        tupd, tstate = port_tx.update([torch.from_numpy(x) for x in g],
                                      tstate, tp)
        for p, u in zip(tp, tupd):
            p.add_(u)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
        _check_state(tstate, jstate)


@pytest.mark.parametrize("per_epoch", [False, True])
@pytest.mark.parametrize("sched", [s for s in SCHEDULES if s != "constant"])
def test_schedule_matches_jax(sched, per_epoch):
    kw = dict(SCHEDULES[sched])
    if sched == "StepSchedule":
        kw["per_epoch"] = per_epoch
    spe = 3 if per_epoch else 1
    fn = getattr(schedules, sched)(**kw).to_fn(spe)
    ref = jax.jit(getattr(jax_schedules, sched)(**kw).to_fn(spe))
    for t in range(41):
        want = np.asarray(ref(jnp.int32(t)))
        got = fn(t)
        assert np.asarray(got).dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=TOL, atol=0)


def test_as_schedule_and_learning_rate_types():
    assert schedules.as_schedule(0.1) == schedules.FixedSchedule(0.1)
    s = schedules.CosineSchedule(1e-3)
    assert schedules.as_schedule(s) is s
    with pytest.raises(TypeError, match="Schedule"):
        updaters.Adam(learning_rate="fast")
    assert updaters.Sgd(learning_rate=s).learning_rate is s


def test_updater_defaults_are_the_jax_packages():
    import dataclasses

    for name in UPDATERS:
        port = getattr(updaters, name)()
        ref = getattr(jax_updaters, name)()
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), name


def test_state_leaves_load_back_in_order():
    tx = updaters.with_gradient_clipping(updaters.AmsGrad(0.1), 1.0, None)
    params = [torch.ones(3), torch.ones(2, 2)]
    state = tx.init(params)
    _, state = tx.update([torch.full((3,), 0.5), torch.full((2, 2), -1.0)],
                         state, params)
    leaves = [np.asarray(x) for x in updaters.state_leaves(state)]
    fresh = updaters.load_state_leaves(tx.init(params), leaves)
    for a, b in zip(updaters.state_leaves(fresh), leaves):
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="fewer"):
        updaters.load_state_leaves(tx.init(params), leaves[:-1])
    with pytest.raises(ValueError, match="more"):
        updaters.load_state_leaves(tx.init(params), leaves + leaves[:1])
