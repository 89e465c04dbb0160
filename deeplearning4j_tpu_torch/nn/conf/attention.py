"""Attention layer configs — `PositionalEncoding` and the pre-LN
`TransformerEncoderBlock` of `deeplearning4j_tpu/nn/conf/attention.py`.

Sequence parallelism (ring / Ulysses) is a later slice; these blocks
attend on one device through `ops.attention.mha`, which sends unmasked
calls to the flash-forward kernel on CUDA.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.layers import (
    NORMAL,
    LayerConfig,
    LayerNorm,
    init_weight,
)
from deeplearning4j_tpu_torch.ops.attention import mha
from deeplearning4j_tpu_torch.quant import functional as quantf


def sinusoid_rows(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal encoding rows for positions ``pos`` (N,) -> (N, d) f32:
    sin on even columns, cos on odd ones, the JAX package's formula with
    its f32 constants (``-log(10000) / d`` is taken in f32 there too)."""
    c = -torch.log(torch.tensor(10000.0, dtype=torch.float32)) / d
    div = torch.exp(
        torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
        * c.to(pos.device))
    ang = pos.to(torch.float32)[:, None]
    pe = torch.zeros((pos.shape[0], d), dtype=torch.float32, device=pos.device)
    pe[:, 0::2] = torch.sin(ang * div)
    pe[:, 1::2] = torch.cos(ang * div[: d // 2])
    return pe


@dataclasses.dataclass(frozen=True)
class PositionalEncoding(LayerConfig):
    """Additive positions: sinusoidal (no params) or learned
    (max_length x d table)."""

    learned: bool = False
    max_length: int = 0
    REGULARIZED = ()

    def init(self, gen, n_in, device):
        if not self.learned:
            return {}
        if self.max_length <= 0:
            raise ValueError("learned PositionalEncoding requires max_length")
        return {"P": init_weight(gen, (self.max_length, n_in), n_in, n_in,
                                 self._winit(NORMAL), device)}

    def apply(self, params, x):
        t, d = x.shape[1], x.shape[2]
        if self.learned:
            if t > self.max_length:
                raise ValueError(
                    f"sequence length {t} exceeds max_length {self.max_length}")
            return x + params["P"][:t].to(x.dtype)
        pos = torch.arange(t, device=x.device)
        return x + sinusoid_rows(pos, d).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class TransformerEncoderBlock(LayerConfig):
    """Pre-LN block: x + MHA(LN(x)), then x + FFN(LN(x))."""

    d_model: int = 0
    n_heads: int = 1
    d_ff: int = 0                        # default 4 * d_model
    causal: bool = False
    ffn_activation: Activation = Activation.GELU

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "ffn_activation",
                           Activation(self.ffn_activation))
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads {self.n_heads}")

    def _dff(self) -> int:
        return self.d_ff if self.d_ff > 0 else 4 * self.d_model

    def regularizable_params(self, lp):
        out = [lp[p] for p in ("W1", "W2") if p in lp]
        attn = lp.get("attn", {})
        out.extend(attn[p] for p in ("Wq", "Wk", "Wv", "Wo") if p in attn)
        return out

    def output_size(self, n_in: int) -> int:
        if n_in != self.d_model:
            raise ValueError(
                f"TransformerEncoderBlock d_model={self.d_model} but input "
                f"feature size is {n_in}")
        return self.d_model

    def init(self, gen, n_in, device):
        d, dff, wi = self.d_model, self._dff(), self._winit()
        attn = {nm: init_weight(gen, (d, d), d, d, wi, device)
                for nm in ("Wq", "Wk", "Wv", "Wo")}
        ln = LayerNorm()
        return {
            "attn": attn,
            "ln1": ln.init(gen, d, device),
            "ln2": ln.init(gen, d, device),
            "W1": init_weight(gen, (d, dff), d, dff, wi, device),
            "b1": torch.zeros(dff, device=device),
            "W2": init_weight(gen, (dff, d), dff, d, wi, device),
            "b2": torch.zeros(d, device=device),
        }

    def apply(self, params, x):
        ln = LayerNorm()
        ap = params["attn"]
        b, t, _ = x.shape
        h_, dh = self.n_heads, self.d_model // self.n_heads
        h = ln.apply(params["ln1"], x)
        q = quantf.matmul(h, ap["Wq"]).reshape(b, t, h_, dh)
        k = quantf.matmul(h, ap["Wk"]).reshape(b, t, h_, dh)
        v = quantf.matmul(h, ap["Wv"]).reshape(b, t, h_, dh)
        out = mha(q, k, v, causal=self.causal).reshape(b, t, h_ * dh)
        x = x + quantf.matmul(out, ap["Wo"])
        h = ln.apply(params["ln2"], x)
        h = self.ffn_activation(quantf.matmul(h, params["W1"])
                                + params["b1"].to(x.dtype))
        h = quantf.matmul(h, params["W2"]) + params["b2"].to(x.dtype)
        return x + h

