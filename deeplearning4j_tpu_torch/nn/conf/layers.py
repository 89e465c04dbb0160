"""Layer configs — the part of `deeplearning4j_tpu/nn/conf/layers.py` the
transformer slices use: the `LayerConfig` base (with its l1 / l2
penalties), `Embedding`, `LayerNorm` and `ChunkedSoftmaxOutputLayer`
(logits for inference, the chunked loss for training).

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
from deeplearning4j_tpu_torch.quant import functional as quantf

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
    l1: Optional[float] = None
    l2: Optional[float] = None
    # probability of dropping; fit() refuses it until runtime/rng.py is ported
    dropout_rate: Optional[float] = None
    # excluded from updates; fit() refuses it until masked updates are ported
    frozen: bool = False

    # which parameters the l1 / l2 penalty applies to
    REGULARIZED = ("W",)

    def __post_init__(self):
        if self.activation is not None:
            object.__setattr__(self, "activation", Activation(self.activation))

    def output_size(self, n_in: int) -> int:
        return n_in

    def init(self, gen: torch.Generator, n_in: int, device) -> dict:
        return {}

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def regularizable_params(self, lp: dict) -> list:
        """Arrays the l1 / l2 penalty applies to."""
        return [lp[p] for p in self.REGULARIZED if p in lp]

    def regularization_terms(self, lp: dict) -> list:
        """(l1, l2, array) triples."""
        l1, l2 = self.l1 or 0.0, self.l2 or 0.0
        if not l1 and not l2:
            return []
        return [(l1, l2, w) for w in self.regularizable_params(lp)]

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
        # a quantized table gathers int8 rows and returns them in f32
        return self._act()(quantf.embedding_lookup(params["W"], x.long()))


@dataclasses.dataclass(frozen=True)
class LayerNorm(LayerConfig):
    """Layer normalization over the last dim, computed in f32."""

    epsilon: float = 1e-5
    REGULARIZED = ()

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
    """LM head whose training loss streams the vocab in chunks
    (`ops/chunked_xent.py`), so the (N, vocab) logits never exist.
    ``apply`` passes hidden states through and the loss owns the
    projection; for inference ``logits`` projects them densely."""

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
        y = quantf.matmul(h, params["W"])
        if self.has_bias:
            y = y + params["b"].to(h.dtype)
        return y

    def output_activation(self) -> Activation:
        return Activation.IDENTITY

    def compute_loss_with_params(self, lp, preds, labels, mask=None):
        """Chunked cross-entropy of (..., D) hidden states ``preds`` against
        int ids (...,) or one-hot labels (..., n_out), told apart by
        element count as in the JAX package (a sequence as long as the
        vocab would otherwise read (B, T) ids as (B, V) one-hot)."""
        from deeplearning4j_tpu_torch.ops.chunked_xent import chunked_softmax_xent

        d = preds.shape[-1]
        h = preds.reshape(-1, d)
        n = h.shape[0]
        if labels.numel() == n * self.n_out:
            labels = labels.reshape(n, self.n_out).argmax(dim=-1)   # one-hot
        elif labels.numel() != n:
            raise ValueError(
                f"labels with {labels.numel()} elements fit neither int ids "
                f"({n}) nor one-hot ({n}x{self.n_out})")
        ids = labels.reshape(-1).long()
        w = (mask.reshape(-1).float() if mask is not None
             else torch.ones((n,), dtype=torch.float32, device=h.device))
        b = lp.get("b")
        if b is None:
            b = torch.zeros((self.n_out,), dtype=torch.float32, device=h.device)
        return chunked_softmax_xent(h, lp["W"], b, ids, w, self.chunk)
