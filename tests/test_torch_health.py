"""`observe/health.py` on the CPU, against the JAX package's
`HealthListener`.

- Through the same fit from the same weights, the global norm and the
  update norm |Δw| of every check agree with the JAX listener's within
  1e-6 relative; a grouped fit checks once a program (its later steps
  watch the score only), as the JAX listener does.
- The non-finite element count of a poisoned tree equals the JAX
  listener's.
- Each divergence kind (non-finite score, non-finite parameters, norm
  explosion) is recorded, counted, reported and raised as
  `DivergenceError` with ``raise_on_divergence``.
- A check makes one host transfer (three scalars), and its previous
  copy is a copy: the next step's in-place writes do not reach it.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import DataSet as JDS
from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSM
from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
    SequentialConfiguration as JSC,
)
from deeplearning4j_tpu.observe.health import HealthListener as JHealth
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.observe.health import (
    DivergenceError,
    HealthListener,
    health_scalars,
)
from deeplearning4j_tpu_torch.observe.metrics import registry

torch.set_num_threads(1)


def _conf():
    return (NeuralNetConfiguration.builder().seed(5).updater(Adam(0.05)).list()
            .layer(Dense(n_out=12, activation=Activation.TANH, name="d0"))
            .layer(OutputLayer(n_out=3, name="out"))
            .set_input_type(InputType.feed_forward(6)).build())


def _batches(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(16, 6)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]) for _ in range(n)]


def _pair():
    pm = SequentialModel(_conf(), device="cpu").init()
    jm = JaxSM(JSC.from_json(pm.conf.to_json())).init()
    return pm, jm


class _Record:
    """Reads a health listener's norms after each of its checks."""

    def __init__(self, hl):
        self.hl, self.seen = hl, []

    def iteration_done(self, model, iteration, epoch, score):
        self.seen.append((iteration, self.hl.last_global_norm, self.hl.last_update_norm))

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("spe", [1, 3])
def test_norms_follow_the_jax_listener(spe):
    pm, jm = _pair()
    ph, jh = HealthListener(frequency=1), JHealth(frequency=1)
    pr, jr = _Record(ph), _Record(jh)
    pm.set_listeners(ph, pr)
    jm.set_listeners(jh, jr)
    data = _batches()
    pm.fit([DataSet(x, y) for x, y in data], steps_per_execution=spe)
    jm.fit([JDS(x, y) for x, y in data], steps_per_execution=spe)
    assert [i for i, _, _ in pr.seen] == [i for i, _, _ in jr.seen]
    for (_, pg, pu), (_, jg, ju) in zip(pr.seen, jr.seen):
        assert _rel(pg, jg) <= 1e-6
        assert (pu is None) == (ju is None)
        if pu is not None:
            assert _rel(pu, ju) <= 1e-6, (pu, ju)
    assert ph.baseline_norm == pytest.approx(jh.baseline_norm, rel=1e-6)
    assert not ph.diverged and not jh.diverged


@pytest.mark.parametrize("n_bad", [1, 7, 40])
def test_the_nonfinite_count_matches_jax(n_bad, tmp_path, monkeypatch):
    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
    pm, jm = _pair()
    flat = np.arange(6 * 12)
    rng = np.random.default_rng(n_bad)
    idx = rng.choice(flat, n_bad, replace=False)
    w = np.array(jm.params["d0"]["W"])
    w.reshape(-1)[idx[: n_bad // 2]] = np.nan
    w.reshape(-1)[idx[n_bad // 2:]] = np.inf
    jm.params = {**jm.params, "d0": {**jm.params["d0"], "W": jnp.asarray(w)}}
    pm.load_params(jax.tree.map(np.asarray, jm.params))
    ph, jh = HealthListener(frequency=1), JHealth(frequency=1)
    ph.iteration_done(pm, 1, 0, 0.5)
    jh.iteration_done(jm, 1, 0, 0.5)
    assert ph.events[0]["kind"] == jh.events[0]["kind"] == "nonfinite_params"
    assert ph.events[0]["nonfinite_param_elements"] == \
        jh.events[0]["nonfinite_param_elements"] == n_bad


def _flag(hl, pm, kind):
    if kind == "nonfinite_score":
        hl.iteration_done(pm, 1, 0, float("nan"))
    elif kind == "nonfinite_params":
        with torch.no_grad():
            pm.params["out"]["W"][0, 0] = float("inf")
        pm.step_programs_run += 1
        hl.iteration_done(pm, 1, 0, 0.5)
    else:
        hl.iteration_done(pm, 1, 0, 0.5)         # the healthy baseline
        with torch.no_grad():
            for t in pm.params["d0"].values():
                t.mul_(1000.0)
        pm.step_programs_run += 1
        hl.iteration_done(pm, 2, 0, 0.5)


@pytest.mark.parametrize("kind", ["nonfinite_score", "nonfinite_params",
                                  "norm_explosion"])
def test_each_divergence_kind_is_recorded_and_raised(kind, tmp_path, monkeypatch):
    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
    before = registry().counter("dl4jtpu_health_divergence_total").value(kind=kind)
    pm, _ = _pair()
    hl = HealthListener(frequency=1)
    _flag(hl, pm, kind)
    assert [e["kind"] for e in hl.events] == [kind] and hl.diverged
    assert len(hl.report_paths) == 1
    with open(hl.report_paths[0]) as f:
        assert "DIVERGENCE EVENT" in f.read()
    assert registry().counter("dl4jtpu_health_divergence_total").value(
        kind=kind) == before + 1
    pm2, _ = _pair()
    raising = HealthListener(frequency=1, raise_on_divergence=True,
                             write_reports=False)
    with pytest.raises(DivergenceError) as err:
        _flag(raising, pm2, kind)
    assert err.value.event["kind"] == kind


def test_a_nan_batch_in_a_fit_raises_at_its_step(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
    pm, _ = _pair()
    pm.set_listeners(HealthListener(frequency=1, raise_on_divergence=True))
    data = [DataSet(x, y) for x, y in _batches()]
    data[3] = DataSet(np.full_like(data[3].features, np.nan), data[3].labels)
    with pytest.raises(DivergenceError) as err:
        pm.fit(data)
    assert err.value.event["iteration"] == 4 and pm.iteration == 4


def test_a_check_copies_and_reads_three_scalars(monkeypatch):
    pm, _ = _pair()
    pm.fit([DataSet(x, y) for x, y in _batches(2)])
    n, g, u, flat = health_scalars(pm.params, None)
    assert n == 0 and u is None and math.isfinite(g)
    kept = flat.clone()
    pm.fit([DataSet(x, y) for x, y in _batches(1, seed=3)])
    assert torch.equal(kept, flat)               # the copy is its own
    n, g2, u2, _ = health_scalars(pm.params, flat)
    assert u2 > 0 and g2 != g
    reads = []
    real = torch.Tensor.cpu

    def counting_cpu(t, *a, **k):
        reads.append(tuple(t.shape))
        return real(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    health_scalars(pm.params, flat)
    assert reads == [(3,)]
