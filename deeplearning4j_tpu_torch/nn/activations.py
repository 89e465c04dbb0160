"""Activation functions — the part of `deeplearning4j_tpu/nn/activations.py`
the transformer slice uses.

``GELU`` is the *tanh approximation*: the JAX package maps it to
``jax.nn.gelu``, whose ``approximate`` argument defaults to True, so the
port must ask PyTorch for the same curve explicitly.
"""

from __future__ import annotations

import enum

import torch
import torch.nn.functional as F


class Activation(str, enum.Enum):
    IDENTITY = "identity"
    GELU = "gelu"
    SOFTMAX = "softmax"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _TABLE[self](x)


_TABLE = {
    Activation.IDENTITY: lambda x: x,
    Activation.GELU: lambda x: F.gelu(x, approximate="tanh"),
    Activation.SOFTMAX: lambda x: torch.softmax(x, dim=-1),
}
