from deeplearning4j_tpu_torch.train.checkpoint import (
    CheckpointStore,
    CheckpointVerifyError,
    ModelSerializer,
)
from deeplearning4j_tpu_torch.train.early_stopping import (
    BestScoreEpochTerminationCondition,
    ClassificationScoreCalculator,
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
    EarlyStoppingTrainer,
    InMemoryModelSaver,
    LocalFileModelSaver,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
    TerminationReason,
)
from deeplearning4j_tpu_torch.train.listeners import (
    CheckpointListener,
    CollectScoresListener,
    EvaluativeListener,
    PerformanceListener,
    ScoreIterationListener,
    TimeIterationListener,
    TrainingListener,
)
from deeplearning4j_tpu_torch.train.preemption import (
    PreemptionError,
    PreemptionHandler,
    PreemptionListener,
)
from deeplearning4j_tpu_torch.train.recovery import RecoveryPolicy
from deeplearning4j_tpu_torch.train.transfer import (
    FineTuneConfiguration,
    TransferLearning,
    TransferLearningHelper,
)

__all__ = [
    "RecoveryPolicy",
    "CheckpointStore",
    "CheckpointVerifyError",
    "ModelSerializer",
    "PreemptionError",
    "PreemptionHandler",
    "PreemptionListener",
    "TrainingListener",
    "ScoreIterationListener",
    "PerformanceListener",
    "CollectScoresListener",
    "TimeIterationListener",
    "EvaluativeListener",
    "CheckpointListener",
    "EarlyStoppingConfiguration",
    "EarlyStoppingTrainer",
    "EarlyStoppingResult",
    "TerminationReason",
    "DataSetLossCalculator",
    "ClassificationScoreCalculator",
    "MaxEpochsTerminationCondition",
    "MaxTimeIterationTerminationCondition",
    "MaxScoreIterationTerminationCondition",
    "ScoreImprovementEpochTerminationCondition",
    "BestScoreEpochTerminationCondition",
    "InMemoryModelSaver",
    "LocalFileModelSaver",
    "FineTuneConfiguration",
    "TransferLearning",
    "TransferLearningHelper",
]
