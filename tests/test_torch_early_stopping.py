"""`train/early_stopping.py` on the CPU, against the JAX package.

- From the same weights and data, the port's `EarlyStoppingTrainer`
  gives the JAX trainer's termination reason and details, best epoch,
  epoch count, and scores by epoch within 1e-5, for a patience stop, a
  max-epochs stop with sparse evaluation, an iteration guard and a
  classification score; the best model it returns scores the recorded
  best score again, and is a copy (training on does not move it).
- The JAX package's early-stopping cases (`tests/test_training_tools.py`
  ``TestEarlyStopping`` and its two review regressions) on the port;
  `LocalFileModelSaver` restores on the saved model's device.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import train as jtrain
from deeplearning4j_tpu.data.iterator import NumpyDataSetIterator as JaxIt
from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSM
from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
    SequentialConfiguration as JSC,
)
from deeplearning4j_tpu_torch.data.iterator import NumpyDataSetIterator
from deeplearning4j_tpu_torch.models.model import tree_leaves
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.train import (
    ClassificationScoreCalculator,
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingTrainer,
    InMemoryModelSaver,
    LocalFileModelSaver,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
    TerminationReason,
)

torch.set_num_threads(1)


def _toy_problem(n=256, n_in=8, k=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    w = rng.normal(size=(n_in, k))
    return x, np.eye(k, dtype=np.float32)[np.argmax(x @ w, axis=1)]


def _mlp(k=3, lr=0.05):
    return (NeuralNetConfiguration.builder().seed(42).updater(Adam(lr)).list()
            .layer(Dense(n_out=16, activation=Activation.RELU, name="d0"))
            .layer(Dense(n_out=16, activation=Activation.RELU, name="d1"))
            .layer(OutputLayer(n_out=k, loss=Loss.MCXENT, activation=Activation.SOFTMAX,
                               name="out"))
            .set_input_type(InputType.feed_forward(8)).build())


def _pair(lr=0.05):
    pm = SequentialModel(_mlp(lr=lr), device="cpu").init()
    jm = JaxSM(JSC.from_json(pm.conf.to_json())).init()
    return pm, jm


def _configs(kind, pval, jval):
    """The same early-stopping configuration in both packages."""
    def build(mod, val):
        b = mod.EarlyStoppingConfiguration.builder()
        if kind == "classification":
            b.score_calculator(mod.ClassificationScoreCalculator(val, "accuracy"))
        else:
            b.score_calculator(mod.DataSetLossCalculator(val))
        if kind == "patience":
            b.epoch_termination_conditions(
                mod.ScoreImprovementEpochTerminationCondition(1, 1e-3),
                mod.MaxEpochsTerminationCondition(12))
        elif kind == "sparse":
            b.epoch_termination_conditions(mod.MaxEpochsTerminationCondition(5))
            b.evaluate_every_n_epochs(2)
        elif kind == "guard":
            b.epoch_termination_conditions(mod.MaxEpochsTerminationCondition(6))
            b.iteration_termination_conditions(
                mod.MaxScoreIterationTerminationCondition(0.5))
        else:
            b.epoch_termination_conditions(mod.MaxEpochsTerminationCondition(4))
        return b.build()

    import deeplearning4j_tpu_torch.train as ptrain

    return build(ptrain, pval), build(jtrain, jval)


@pytest.mark.parametrize("kind,lr", [("patience", 0.05), ("sparse", 0.05),
                                     ("guard", 0.05), ("classification", 0.02)])
def test_the_trainer_follows_jax(kind, lr):
    x, y = _toy_problem()
    pm, jm = _pair(lr)
    pcfg, jcfg = _configs(kind, NumpyDataSetIterator(x[:128], y[:128], 64, shuffle=False),
                          JaxIt(x[:128], y[:128], 64, shuffle=False))
    pres = EarlyStoppingTrainer(pcfg, pm, NumpyDataSetIterator(x, y, 32)).fit()
    jres = jtrain.EarlyStoppingTrainer(jcfg, jm, JaxIt(x, y, 32)).fit()
    assert pres.termination_reason.value == jres.termination_reason.value
    assert pres.termination_details == jres.termination_details
    assert (pres.best_model_epoch, pres.total_epochs) == (
        jres.best_model_epoch, jres.total_epochs)
    assert sorted(pres.score_vs_epoch) == sorted(jres.score_vs_epoch)
    for e, s in jres.score_vs_epoch.items():
        assert abs(pres.score_vs_epoch[e] - s) <= 1e-5, (e, pres.score_vs_epoch[e], s)
    assert pm.iteration == jm.iteration
    if kind == "guard":
        # the guard trips in the first epoch, before any evaluation
        assert np.isnan(pres.best_model_score) and np.isnan(jres.best_model_score)
        assert pres.best_model is pm
        return
    assert abs(pres.best_model_score - jres.best_model_score) <= 1e-5
    if kind != "classification":
        # the best model scores its recorded score again, on its own copy
        best = pres.best_model
        again = pcfg.score_calculator.calculate_score(best)
        assert again == pres.best_model_score
        before = [t.detach().clone() for t in tree_leaves(best.params)]
        pm.fit(NumpyDataSetIterator(x, y, 32))
        for a, b in zip(before, tree_leaves(best.params)):
            assert torch.equal(a, b.detach())
    assert all(type(l).__name__ != "_IterGuard" for l in pm.listeners)


# -- the JAX package's cases -------------------------------------------------------

def test_max_epochs_termination():
    x, y = _toy_problem()
    train = NumpyDataSetIterator(x, y, batch_size=64)
    val = NumpyDataSetIterator(x, y, batch_size=128, shuffle=False)
    model = SequentialModel(_mlp(), device="cpu").init()
    cfg = (EarlyStoppingConfiguration.builder()
           .score_calculator(DataSetLossCalculator(val))
           .epoch_termination_conditions(MaxEpochsTerminationCondition(3)).build())
    result = EarlyStoppingTrainer(cfg, model, train).fit()
    assert result.termination_reason == TerminationReason.EPOCH_CONDITION
    assert result.termination_details == "MaxEpochsTerminationCondition"
    assert result.total_epochs == 3
    assert result.best_model is not None
    assert len(result.score_vs_epoch) == 3
    assert result.best_model_score <= result.score_vs_epoch[0] + 1e-9


def test_score_improvement_patience():
    x, y = _toy_problem()
    train = NumpyDataSetIterator(x, y, batch_size=64)
    val = NumpyDataSetIterator(x, y, batch_size=128, shuffle=False)
    model = SequentialModel(_mlp(lr=0.0), device="cpu").init()
    cfg = (EarlyStoppingConfiguration.builder()
           .score_calculator(DataSetLossCalculator(val))
           .epoch_termination_conditions(ScoreImprovementEpochTerminationCondition(2),
                                         MaxEpochsTerminationCondition(50)).build())
    result = EarlyStoppingTrainer(cfg, model, train).fit()
    assert result.termination_details == "ScoreImprovementEpochTerminationCondition"
    assert result.total_epochs <= 5


def test_iteration_divergence_guard():
    x, y = _toy_problem()
    train = NumpyDataSetIterator(x, y, batch_size=64)
    val = NumpyDataSetIterator(x, y, batch_size=128, shuffle=False)
    model = SequentialModel(_mlp(), device="cpu").init()
    cfg = (EarlyStoppingConfiguration.builder()
           .score_calculator(DataSetLossCalculator(val))
           .epoch_termination_conditions(MaxEpochsTerminationCondition(50))
           .iteration_termination_conditions(MaxScoreIterationTerminationCondition(1e-12))
           .build())
    result = EarlyStoppingTrainer(cfg, model, train).fit()
    assert result.termination_reason == TerminationReason.ITERATION_CONDITION
    assert all(type(l).__name__ != "_IterGuard" for l in model.listeners)


def test_max_epochs_respected_with_sparse_evaluation():
    x, y = _toy_problem(n=128)
    train = NumpyDataSetIterator(x, y, batch_size=64)
    val = NumpyDataSetIterator(x, y, batch_size=128, shuffle=False)
    model = SequentialModel(_mlp(), device="cpu").init()
    cfg = (EarlyStoppingConfiguration.builder()
           .score_calculator(DataSetLossCalculator(val))
           .epoch_termination_conditions(MaxEpochsTerminationCondition(4))
           .evaluate_every_n_epochs(2).build())
    result = EarlyStoppingTrainer(cfg, model, train).fit()
    assert result.total_epochs == 4


def test_save_last_model():
    x, y = _toy_problem(n=128)
    train = NumpyDataSetIterator(x, y, batch_size=64)
    val = NumpyDataSetIterator(x, y, batch_size=128, shuffle=False)
    model = SequentialModel(_mlp(), device="cpu").init()
    saver = InMemoryModelSaver()
    cfg = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(val),
        epoch_termination_conditions=[MaxEpochsTerminationCondition(2)],
        model_saver=saver, save_last_model=True)
    EarlyStoppingTrainer(cfg, model, train).fit()
    latest = saver.get_latest_model()
    assert latest is not None
    assert torch.equal(latest.params["out"]["W"], model.params["out"]["W"])


def test_local_file_saver_restores_on_the_models_device(tmp_path):
    x, y = _toy_problem(n=128)
    val = NumpyDataSetIterator(x, y, batch_size=128, shuffle=False)
    model = SequentialModel(_mlp(), device="cpu").init()
    cfg = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(val),
        epoch_termination_conditions=[MaxEpochsTerminationCondition(2)],
        model_saver=LocalFileModelSaver(str(tmp_path)), save_last_model=True)
    res = EarlyStoppingTrainer(cfg, model, NumpyDataSetIterator(x, y, 64)).fit()
    assert res.best_model.device.type == "cpu"
    assert DataSetLossCalculator(val).calculate_score(res.best_model) == \
        res.best_model_score
    assert cfg.model_saver.get_latest_model().iteration == model.iteration
    assert ClassificationScoreCalculator(val).calculate_score(res.best_model) > 0.3
