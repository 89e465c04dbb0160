"""Activation functions — `deeplearning4j_tpu/nn/activations.py`: the
same enum, values and curves, in PyTorch.

``GELU`` is the *tanh approximation*: the JAX package maps it to
``jax.nn.gelu``, whose ``approximate`` argument defaults to True, so the
port asks PyTorch for the same curve explicitly.  ``SOFTPLUS`` is
``logaddexp(x, 0)`` as in jax (PyTorch's `softplus` cuts over to x above
20).
"""

from __future__ import annotations

import enum

import torch
import torch.nn.functional as F

_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


class Activation(str, enum.Enum):
    IDENTITY = "identity"
    RELU = "relu"
    RELU6 = "relu6"
    LEAKYRELU = "leakyrelu"
    ELU = "elu"
    SELU = "selu"
    GELU = "gelu"
    SILU = "silu"            # a.k.a. swish
    SIGMOID = "sigmoid"
    HARDSIGMOID = "hardsigmoid"
    TANH = "tanh"
    HARDTANH = "hardtanh"
    SOFTMAX = "softmax"
    LOGSOFTMAX = "logsoftmax"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    CUBE = "cube"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"
    THRESHOLDEDRELU = "thresholdedrelu"
    MISH = "mish"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _TABLE[self](x)


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def _elu(x):
    return torch.where(x > 0, x, torch.expm1(torch.where(x > 0, 0.0, x)))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _rational_tanh(x):
    # DL4J's rationaltanh: 1.7159 * a rational tanh approximation
    a = x.abs()
    return 1.7159 * torch.clamp(x * (1.0 + a / 2 + a * a / 16), -1.0, 1.0)


_TABLE = {
    Activation.IDENTITY: lambda x: x,
    Activation.RELU: torch.relu,
    Activation.RELU6: _relu6,
    Activation.LEAKYRELU: lambda x: torch.where(x >= 0, x, 0.01 * x),
    Activation.ELU: _elu,
    Activation.SELU: lambda x: _SELU_SCALE * torch.where(
        x > 0, x, _SELU_ALPHA * torch.expm1(torch.where(x > 0, 0.0, x))),
    Activation.GELU: lambda x: F.gelu(x, approximate="tanh"),
    Activation.SILU: lambda x: x * torch.sigmoid(x),
    Activation.SIGMOID: torch.sigmoid,
    Activation.HARDSIGMOID: lambda x: _relu6(x + 3.0) / 6.0,
    Activation.TANH: torch.tanh,
    Activation.HARDTANH: lambda x: torch.clamp(x, -1.0, 1.0),
    Activation.SOFTMAX: lambda x: torch.softmax(x, dim=-1),
    Activation.LOGSOFTMAX: lambda x: torch.log_softmax(x, dim=-1),
    Activation.SOFTPLUS: _softplus,
    Activation.SOFTSIGN: lambda x: x / (x.abs() + 1.0),
    Activation.CUBE: lambda x: x * x * x,
    Activation.RATIONALTANH: _rational_tanh,
    Activation.RECTIFIEDTANH: lambda x: torch.clamp_min(torch.tanh(x), 0.0),
    Activation.THRESHOLDEDRELU: lambda x: torch.where(x > 1.0, x, 0.0),
    Activation.MISH: lambda x: x * torch.tanh(_softplus(x)),
}
