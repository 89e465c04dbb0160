from deeplearning4j_tpu_torch.evaluation.binary import (
    EvaluationBinary,
    EvaluationCalibration,
)
from deeplearning4j_tpu_torch.evaluation.evaluation import Evaluation
from deeplearning4j_tpu_torch.evaluation.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.evaluation.roc import ROC, ROCBinary, ROCMultiClass

__all__ = [
    "Evaluation",
    "ROC",
    "ROCBinary",
    "ROCMultiClass",
    "RegressionEvaluation",
    "EvaluationBinary",
    "EvaluationCalibration",
]
