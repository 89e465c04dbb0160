"""Layer configs — the part of `deeplearning4j_tpu/nn/conf/layers.py` the
transformer slice uses: the `LayerConfig` base, `Embedding`, `LayerNorm`
and the logits side of `ChunkedSoftmaxOutputLayer`.

A config is a frozen dataclass, as in the JAX package.  ``init`` draws
its parameters from an explicit `torch.Generator` (the JAX package draws
from threefry keys, so the two never share bits — parity tests copy
weights across with `convert.params_from_jax`).  ``apply`` is a plain
function of a parameter dict and a tensor.  Dense weights keep the JAX
layout (n_in, n_out) and are applied as ``x @ W``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import Activation

XAVIER = "xavier"
NORMAL = "normal"


def init_weight(gen: torch.Generator, shape: tuple, fan_in: int,
                fan_out: int, scheme: str, device) -> torch.Tensor:
    """``xavier``: N(0, 2 / (fan_in + fan_out)); ``normal``:
    N(0, 1) / sqrt(fan_in) — the JAX package's WeightInit formulas."""
    z = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    if scheme == XAVIER:
        return z * math.sqrt(2.0 / (fan_in + fan_out))
    if scheme == NORMAL:
        return z / math.sqrt(fan_in)
    raise ValueError(f"unsupported weight init {scheme!r}")


@dataclasses.dataclass(frozen=True)
class LayerConfig:
    """Base layer config.  ``name`` is filled as ``layer{i}`` by the
    builder; parameter trees key on it."""

    name: Optional[str] = None
    activation: Optional[Activation] = None
    weight_init: Optional[str] = None

    def __post_init__(self):
        if self.activation is not None:
            object.__setattr__(self, "activation", Activation(self.activation))

    def output_size(self, n_in: int) -> int:
        return n_in

    def init(self, gen: torch.Generator, n_in: int, device) -> dict:
        return {}

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _act(self, default=Activation.IDENTITY) -> Activation:
        return self.activation if self.activation is not None else default

    def _winit(self, default=XAVIER) -> str:
        return self.weight_init if self.weight_init is not None else default


@dataclasses.dataclass(frozen=True)
class Embedding(LayerConfig):
    """Token ids (B, T) -> vectors (B, T, n_out)."""

    n_in: int = 0
    n_out: int = 0

    def output_size(self, n_in: int) -> int:
        return self.n_out

    def init(self, gen, n_in, device):
        if self.n_in <= 0:
            raise ValueError("Embedding.n_in (vocab size) must be set explicitly")
        return {"W": init_weight(gen, (self.n_in, self.n_out), self.n_in,
                                 self.n_out, self._winit(), device)}

    def apply(self, params, x):
        return self._act()(params["W"][x.long()])


@dataclasses.dataclass(frozen=True)
class LayerNorm(LayerConfig):
    """Layer normalization over the last dim, computed in f32."""

    epsilon: float = 1e-5

    def init(self, gen, n_in, device):
        return {"gamma": torch.ones(n_in, device=device),
                "beta": torch.zeros(n_in, device=device)}

    def apply(self, params, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        y = y * params["gamma"].float() + params["beta"].float()
        return self._act()(y.to(x.dtype))


@dataclasses.dataclass(frozen=True)
class ChunkedSoftmaxOutputLayer(LayerConfig):
    """LM head whose training loss streams the vocab in chunks.  For
    inference ``apply`` passes hidden states through and ``logits``
    projects them densely; the chunked loss arrives with training."""

    n_out: int = 0
    chunk: int = 8192
    has_bias: bool = True

    def init(self, gen, n_in, device):
        p = {"W": init_weight(gen, (n_in, self.n_out), n_in, self.n_out,
                              self._winit(), device)}
        if self.has_bias:
            p["b"] = torch.zeros(self.n_out, device=device)
        return p

    def apply(self, params, x):
        return x

    def logits(self, params, h):
        y = h @ params["W"].to(h.dtype)
        if self.has_bias:
            y = y + params["b"].to(h.dtype)
        return y

    def output_activation(self) -> Activation:
        return Activation.IDENTITY
