"""Autodiff graph API — the SameDiff role (`deeplearning4j_tpu/autodiff`)."""

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, SDVariable, TrainingConfig
from deeplearning4j_tpu_torch.autodiff.validation import (
    GradCheckResult,
    OpValidation,
    TestCase,
    gradient_check,
)

__all__ = [
    "SameDiff",
    "SDVariable",
    "TrainingConfig",
    "OpValidation",
    "TestCase",
    "GradCheckResult",
    "gradient_check",
]
