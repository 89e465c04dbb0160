"""Early stopping — `deeplearning4j_tpu/train/early_stopping.py`, the
`org.deeplearning4j.earlystopping` role.

Reference parity (eclipse/deeplearning4j, `deeplearning4j-core`,
package `org.deeplearning4j.earlystopping`): an `EarlyStoppingConfiguration`
combining a score calculator (evaluated on held-out data each epoch),
epoch/iteration termination conditions, and a model saver retaining the best
model; `EarlyStoppingTrainer.fit()` returns an `EarlyStoppingResult` with the
best model, best epoch/score and the termination reason.

`InMemoryModelSaver` keeps the best model as a clone on its device (the
live tensors are overwritten in place by the next step, so a reference
would not do); `LocalFileModelSaver` writes zips and restores them on
the device of the model it saved.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import time
from typing import Callable, Optional

from deeplearning4j_tpu_torch.evaluation import Evaluation


# ---------------------------------------------------------------------------
# Score calculators (ScoreCalculator SPI)
# ---------------------------------------------------------------------------
class ScoreCalculator:
    """Computes the early-stopping score for a model; lower is better unless
    `minimize_score()` is False."""

    def calculate_score(self, model) -> float:
        raise NotImplementedError

    def minimize_score(self) -> bool:
        return True


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over a held-out iterator (`DataSetLossCalculator` role)."""

    def __init__(self, data, average: bool = True):
        self.data = data
        self.average = average

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        for batch in self.data:
            total += model.score(batch) * batch.num_examples
            n += batch.num_examples
        if n == 0:
            return float("nan")
        return total / n if self.average else total


class ClassificationScoreCalculator(ScoreCalculator):
    """Maximizes an Evaluation metric (accuracy/f1/...) on held-out data
    (`ClassificationScoreCalculator` role)."""

    def __init__(self, data, metric: str = "accuracy"):
        self.data = data
        self.metric = metric

    def calculate_score(self, model) -> float:
        ev: Evaluation = model.evaluate(self.data)
        return float(getattr(ev, self.metric)())

    def minimize_score(self) -> bool:
        return False


# ---------------------------------------------------------------------------
# Termination conditions
# ---------------------------------------------------------------------------
class EpochTerminationCondition:
    def terminate(self, epoch: int, score: float, minimize: bool) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score, minimize):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no (or too-small) improvement."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self._best: Optional[float] = None
        self._epochs_since = 0

    def terminate(self, epoch, score, minimize):
        if self._best is None:
            self._best = score
            return False
        improved = (
            (self._best - score) > self.min_improvement
            if minimize
            else (score - self._best) > self.min_improvement
        )
        if improved:
            self._best = score
            self._epochs_since = 0
        else:
            self._epochs_since += 1
        return self._epochs_since >= self.patience


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop as soon as the score is at least as good as a target."""

    def __init__(self, best_expected_score: float):
        self.target = best_expected_score

    def terminate(self, epoch, score, minimize):
        return score <= self.target if minimize else score >= self.target


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = time.monotonic()

    def initialize(self) -> None:
        """Reset the clock; called by the trainer when fit() starts so setup
        time (data prep, XLA warmup) doesn't count against the budget."""
        self._start = time.monotonic()

    def terminate(self, last_score):
        return (time.monotonic() - self._start) >= self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort if the training loss explodes past a bound (divergence guard)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, last_score):
        return last_score != last_score or last_score > self.max_score  # NaN or blowup


# ---------------------------------------------------------------------------
# Model savers
# ---------------------------------------------------------------------------
class InMemoryModelSaver:
    """Keeps the best (and latest) model as a clone on the model's
    device: parameters, layer state, optimizer state and counters
    copied, never referenced."""

    def __init__(self):
        self._best = None
        self._latest = None
        self._model_ref = None

    def _restore(self, snap):
        if snap is None:
            return None
        m = snap.clone()
        m.iteration = self._model_ref.iteration
        return m

    def save_best_model(self, model, score: float) -> None:
        self._best = model.clone()
        self._model_ref = model

    def save_latest_model(self, model, score: float) -> None:
        self._latest = model.clone()
        self._model_ref = model

    def get_best_model(self):
        return self._restore(self._best)

    def get_latest_model(self):
        return self._restore(self._latest)


class LocalFileModelSaver:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._path = os.path.join(directory, "bestModel.zip")
        self._saved = False
        self._device = None

    def save_best_model(self, model, score: float) -> None:
        model.save(self._path)
        self._saved = True
        self._device = model.device

    def save_latest_model(self, model, score: float) -> None:
        model.save(os.path.join(self.directory, "latestModel.zip"))
        self._device = model.device

    def get_best_model(self):
        if not self._saved:
            return None
        from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

        return ModelSerializer.restore(self._path, device=self._device)

    def get_latest_model(self):
        path = os.path.join(self.directory, "latestModel.zip")
        if not os.path.exists(path):
            return None
        from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

        return ModelSerializer.restore(path, device=self._device)


# ---------------------------------------------------------------------------
# Configuration + trainer
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EarlyStoppingConfiguration:
    score_calculator: ScoreCalculator
    epoch_termination_conditions: list = dataclasses.field(default_factory=list)
    iteration_termination_conditions: list = dataclasses.field(default_factory=list)
    model_saver: object = dataclasses.field(default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False

    class Builder:
        def __init__(self):
            self._kw = {"epoch_termination_conditions": [], "iteration_termination_conditions": []}

        def score_calculator(self, sc):
            self._kw["score_calculator"] = sc
            return self

        def epoch_termination_conditions(self, *conds):
            self._kw["epoch_termination_conditions"].extend(conds)
            return self

        def iteration_termination_conditions(self, *conds):
            self._kw["iteration_termination_conditions"].extend(conds)
            return self

        def model_saver(self, saver):
            self._kw["model_saver"] = saver
            return self

        def evaluate_every_n_epochs(self, n: int):
            self._kw["evaluate_every_n_epochs"] = n
            return self

        def save_last_model(self, save: bool = True):
            self._kw["save_last_model"] = save
            return self

        def build(self):
            return EarlyStoppingConfiguration(**self._kw)

    @staticmethod
    def builder() -> "EarlyStoppingConfiguration.Builder":
        return EarlyStoppingConfiguration.Builder()


class TerminationReason(str, enum.Enum):
    EPOCH_CONDITION = "EpochTerminationCondition"
    ITERATION_CONDITION = "IterationTerminationCondition"
    ERROR = "Error"


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: TerminationReason
    termination_details: str
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: object
    score_vs_epoch: dict[int, float] = dataclasses.field(default_factory=dict)


class EarlyStoppingTrainer:
    """Drives epoch-at-a-time fit() with score evaluation between epochs
    (`EarlyStoppingTrainer` / `EarlyStoppingGraphTrainer` role — same class
    serves both model containers since their fit() surface is shared)."""

    def __init__(self, config: EarlyStoppingConfiguration, model, train_data):
        self.config = config
        self.model = model
        self.train_data = train_data

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        minimize = cfg.score_calculator.minimize_score()
        best_score: Optional[float] = None
        best_epoch = -1
        scores: dict[int, float] = {}
        epoch = 0
        reason, details = TerminationReason.EPOCH_CONDITION, "exhausted conditions"

        class _IterGuard:
            """Listener checking iteration termination conditions mid-epoch."""

            def __init__(self, conds):
                self.conds = conds
                self.tripped: Optional[IterationTerminationCondition] = None

            def iteration_done(self, model, iteration, epoch, score):
                for c in self.conds:
                    if c.terminate(float(score)):
                        self.tripped = c
                        raise _IterationStop

            def on_epoch_start(self, model, epoch):
                pass

            def on_fit_end(self, model):
                pass

            def on_epoch_end(self, model, epoch):
                pass

        class _IterationStop(Exception):
            pass

        guard = _IterGuard(cfg.iteration_termination_conditions)
        self.model.add_listener(guard)
        for cond in list(cfg.iteration_termination_conditions) + list(
            cfg.epoch_termination_conditions
        ):
            init = getattr(cond, "initialize", None)
            if callable(init):
                init()
        last_score = float("nan")
        try:
            while True:
                try:
                    self.model.fit(self.train_data, epochs=1)
                except _IterationStop:
                    reason = TerminationReason.ITERATION_CONDITION
                    details = type(guard.tripped).__name__
                    break
                if epoch % cfg.evaluate_every_n_epochs == 0:
                    last_score = cfg.score_calculator.calculate_score(self.model)
                    scores[epoch] = last_score
                    is_best = best_score is None or (
                        last_score < best_score if minimize else last_score > best_score
                    )
                    if is_best:
                        best_score, best_epoch = last_score, epoch
                        cfg.model_saver.save_best_model(self.model, last_score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(self.model, last_score)
                # termination conditions are consulted EVERY epoch (with the
                # most recent score) so e.g. MaxEpochs can't overshoot when
                # evaluate_every_n_epochs > 1
                stop = False
                for c in cfg.epoch_termination_conditions:
                    if c.terminate(epoch, last_score, minimize):
                        reason = TerminationReason.EPOCH_CONDITION
                        details = type(c).__name__
                        stop = True
                        break
                if stop:
                    break
                epoch += 1
        finally:
            self.model.listeners.remove(guard)

        best_model = cfg.model_saver.get_best_model() or self.model
        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            best_model_epoch=best_epoch,
            best_model_score=best_score if best_score is not None else float("nan"),
            total_epochs=epoch + 1,
            best_model=best_model,
            score_vs_epoch=scores,
        )
