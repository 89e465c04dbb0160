"""Layer configs — the part of `deeplearning4j_tpu/nn/conf/layers.py` the
transformer slices use: the `LayerConfig` base (l1 / l2 penalties,
dropout on the layer input), `Embedding`, `LayerNorm` and
`ChunkedSoftmaxOutputLayer` (logits for inference, the chunked loss for
training).

A config is a frozen dataclass registered for serde under the JAX
package's tag, with its fields, defaults and enum values.  ``init``
draws from a threefry key (`nn/weights.py`) as the JAX layer does, so a
seed gives the JAX package's weights.  ``apply`` is a plain function of
a parameter dict and a tensor; in training it takes the layer's step key
for dropout.  Dense weights keep the JAX layout (n_in, n_out) and are
applied as ``x @ W``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.quant import functional as quantf
from deeplearning4j_tpu_torch.runtime import rng as rng_mod
from deeplearning4j_tpu_torch.utils import serde


def _coerce_enum(v, enum_cls):
    """An enum member from a member, its value ("relu"), its NAME
    ("RELU") or an alias of the enum's ``_ALIASES_`` table."""
    if isinstance(v, enum_cls):
        return v
    s = str(v).lower()
    s = getattr(enum_cls, "_ALIASES_", {}).get(s, s)
    try:
        return enum_cls(s)
    except ValueError:
        pass
    try:
        return enum_cls[str(v).upper()]
    except KeyError:
        raise ValueError(f"{v!r} is not a valid {enum_cls.__name__}; "
                         f"options: {[e.value for e in enum_cls]}") from None


def _dropout(x: torch.Tensor, rate: float, training: bool, key) -> torch.Tensor:
    """Inverted dropout on a layer's input, the JAX package's mask: kept
    where ``bernoulli(key, 1 - rate)``, scaled by a division by the keep
    probability (taken in x's dtype, as jax takes a Python scalar)."""
    if not training or rate <= 0.0 or key is None:
        return x
    keep = 1.0 - rate
    mask = rng_mod.bernoulli(key, keep, tuple(x.shape), device=x.device)
    return torch.where(mask, x / torch.tensor(keep, dtype=x.dtype, device=x.device),
                       0.0).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class LayerConfig:
    """Base layer config.  ``name`` is filled as ``layer{i}`` by the
    builder; parameter trees key on it."""

    name: Optional[str] = None
    activation: Optional[Activation] = None
    weight_init: Optional[WeightInit] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout_rate: Optional[float] = None   # probability of dropping
    # excluded from updates; fit() refuses it until masked updates are ported
    frozen: bool = False

    # which parameters the l1 / l2 penalty applies to
    REGULARIZED = ("W",)

    def __post_init__(self):
        if self.activation is not None:
            object.__setattr__(self, "activation",
                               _coerce_enum(self.activation, Activation))
        if self.weight_init is not None:
            object.__setattr__(self, "weight_init",
                               _coerce_enum(self.weight_init, WeightInit))
        loss = getattr(self, "loss", None)
        if loss is not None:
            object.__setattr__(self, "loss", _coerce_enum(loss, Loss))

    def check_supported(self) -> None:
        """Raise `NotImplementedError`, naming the ROADMAP item, for a
        field value this port cannot honour yet (called when a model is
        built, never when a configuration loads)."""

    def output_size(self, n_in: int) -> int:
        return n_in

    def init(self, key, n_in: int, device) -> dict:
        return {}

    def apply(self, params: dict, x: torch.Tensor, *, training: bool = False,
              rng=None) -> torch.Tensor:
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

    def _winit(self, default=WeightInit.XAVIER) -> WeightInit:
        return self.weight_init if self.weight_init is not None else default


@serde.register
@dataclasses.dataclass(frozen=True)
class Embedding(LayerConfig):
    """Token ids (B, T) -> vectors (B, T, n_out)."""

    n_in: int = 0
    n_out: int = 0

    def output_size(self, n_in: int) -> int:
        return self.n_out

    def init(self, key, n_in, device):
        if self.n_in <= 0:
            raise ValueError("Embedding.n_in (vocab size) must be set explicitly")
        return {"W": self._winit().init(key, (self.n_in, self.n_out),
                                        fan_in=self.n_in, fan_out=self.n_out,
                                        device=device)}

    def apply(self, params, x, *, training=False, rng=None):
        # a quantized table gathers int8 rows and returns them in f32
        return self._act()(quantf.embedding_lookup(params["W"], x.long()))


@serde.register
@dataclasses.dataclass(frozen=True)
class LayerNorm(LayerConfig):
    """Layer normalization over the last dim, computed in f32."""

    epsilon: float = 1e-5
    REGULARIZED = ()

    def init(self, key, n_in, device):
        return {"gamma": torch.ones(n_in, device=device),
                "beta": torch.zeros(n_in, device=device)}

    def apply(self, params, x, *, training=False, rng=None):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        y = y * params["gamma"].float() + params["beta"].float()
        return self._act()(y.to(x.dtype))


@serde.register
@dataclasses.dataclass(frozen=True)
class ChunkedSoftmaxOutputLayer(LayerConfig):
    """LM head whose training loss streams the vocab in chunks
    (`ops/chunked_xent.py`), so the (N, vocab) logits never exist.
    ``apply`` passes hidden states through (dropped out in training) and
    the loss owns the projection; for inference ``logits`` projects them
    densely."""

    n_out: int = 0
    chunk: int = 8192
    has_bias: bool = True

    def init(self, key, n_in, device):
        p = {"W": self._winit().init(key, (n_in, self.n_out), fan_in=n_in,
                                     fan_out=self.n_out, device=device)}
        if self.has_bias:
            p["b"] = torch.zeros(self.n_out, device=device)
        return p

    def apply(self, params, x, *, training=False, rng=None):
        return _dropout(x, self.dropout_rate or 0.0, training, rng)

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
