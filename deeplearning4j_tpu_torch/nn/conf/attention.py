"""Attention layer configs — `PositionalEncoding` and the pre-LN
`TransformerEncoderBlock` of `deeplearning4j_tpu/nn/conf/attention.py`.

Sequence parallelism (``seq_parallel`` "ring" / "ulysses") waits for the
parallelism slice (ROADMAP A11): a block that asks for it loads from a
configuration and raises when a model is built.  These blocks attend on
one device through `ops.attention.mha`, which sends unmasked calls to
the flash-forward kernel on CUDA.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LayerConfig,
    _coerce_enum,
    _dropout,
    layer_norm,
)
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.ops.attention import mha
from deeplearning4j_tpu_torch.quant import functional as quantf
from deeplearning4j_tpu_torch.runtime import rng as rng_mod
from deeplearning4j_tpu_torch.utils import serde


def sinusoid_rows(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal encoding rows for positions ``pos`` (N,) -> (N, d) f32:
    sin on even columns, cos on odd ones, the JAX package's formula with
    its f32 constants (``-log(10000) / d`` is taken in f32 there too)."""
    # the f32 constant as a Python float (exact): no host-to-device copy,
    # so a CUDA graph can capture the rows
    c = float(-torch.log(torch.tensor(10000.0, dtype=torch.float32)) / d)
    div = torch.exp(
        torch.arange(0, d, 2, dtype=torch.float32, device=pos.device) * c)
    ang = pos.to(torch.float32)[:, None]
    pe = torch.zeros((pos.shape[0], d), dtype=torch.float32, device=pos.device)
    pe[:, 0::2] = torch.sin(ang * div)
    pe[:, 1::2] = torch.cos(ang * div[: d // 2])
    return pe


def init_qkv_params(key, wi: WeightInit, n_in: int, hd: int, n_out: int,
                    device) -> dict:
    """Wq / Wk / Wv into n_heads * head_size (= hd) and Wo back out, from
    the four subkeys of ``key`` in that order (the JAX package's)."""
    kq, kk, kv, ko = rng_mod.split(key, 4)
    return {
        "Wq": wi.init(kq, (n_in, hd), fan_in=n_in, fan_out=hd, device=device),
        "Wk": wi.init(kk, (n_in, hd), fan_in=n_in, fan_out=hd, device=device),
        "Wv": wi.init(kv, (n_in, hd), fan_in=n_in, fan_out=hd, device=device),
        "Wo": wi.init(ko, (hd, n_out), fan_in=hd, fan_out=n_out, device=device),
    }


@serde.register
@dataclasses.dataclass(frozen=True)
class PositionalEncoding(LayerConfig):
    """Additive positions: sinusoidal (no params) or learned
    (max_length x d table)."""

    learned: bool = False
    max_length: int = 0
    REGULARIZED = ()

    @property
    def HAS_PARAMS(self):  # type: ignore[override]
        return self.learned

    def init(self, key, itype, device):
        if not self.learned:
            return {}, {}
        if self.max_length <= 0:
            raise ValueError("learned PositionalEncoding requires max_length")
        d = itype.size
        wi = self._winit(WeightInit.NORMAL)
        return {"P": wi.init(key, (self.max_length, d), fan_in=d,
                             fan_out=d, device=device)}, {}

    def apply(self, params, state, x, *, training=False, rng=None):
        t, d = x.shape[1], x.shape[2]
        if self.learned:
            if t > self.max_length:
                raise ValueError(
                    f"sequence length {t} exceeds max_length {self.max_length}")
            return x + params["P"][:t].to(x.dtype), state
        pos = torch.arange(t, device=x.device)
        return x + sinusoid_rows(pos, d).to(x.dtype), state


@serde.register
@dataclasses.dataclass(frozen=True)
class TransformerEncoderBlock(LayerConfig):
    """Pre-LN block: x + MHA(LN(x)), then x + FFN(LN(x)).  Dropout drops
    the FFN's input; the attention sub-layer takes none (the JAX block
    builds it without a rate)."""

    d_model: int = 0
    n_heads: int = 1
    d_ff: int = 0                        # default 4 * d_model
    causal: bool = False
    seq_parallel: str = "none"
    ffn_activation: Activation = Activation.GELU

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "ffn_activation",
                           _coerce_enum(self.ffn_activation, Activation))
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads {self.n_heads}")

    def check_supported(self):
        if self.seq_parallel != "none":
            raise NotImplementedError(
                f"layer {self.name!r}: seq_parallel={self.seq_parallel!r} is "
                "not ported yet (ROADMAP A11: ring and Ulysses attention)")

    def _dff(self) -> int:
        return self.d_ff if self.d_ff > 0 else 4 * self.d_model

    def regularizable_params(self, lp):
        out = [lp[p] for p in ("W1", "W2") if p in lp]
        attn = lp.get("attn", {})
        out.extend(attn[p] for p in ("Wq", "Wk", "Wv", "Wo") if p in attn)
        return out

    def output_type(self, itype):
        if itype.size != self.d_model:
            raise ValueError(
                f"TransformerEncoderBlock d_model={self.d_model} but input "
                f"feature size is {itype.size}")
        return InputType.recurrent(self.d_model, itype.shape[0])

    def init(self, key, itype, device):
        k_attn, k1, k2 = rng_mod.split(key, 3)
        d, dff, wi = self.d_model, self._dff(), self._winit()

        def ln():
            return {"gamma": torch.ones(d, device=device),
                    "beta": torch.zeros(d, device=device)}

        return {
            "attn": init_qkv_params(k_attn, wi, d, d, d, device),
            "ln1": ln(),
            "ln2": ln(),
            "W1": wi.init(k1, (d, dff), fan_in=d, fan_out=dff, device=device),
            "b1": torch.zeros(dff, device=device),
            "W2": wi.init(k2, (dff, d), fan_in=dff, fan_out=d, device=device),
            "b2": torch.zeros(d, device=device),
        }, {}

    def apply(self, params, state, x, *, training=False, rng=None):
        ap = params["attn"]
        b, t, _ = x.shape
        h_, dh = self.n_heads, self.d_model // self.n_heads
        h = layer_norm(params["ln1"], x)
        q = quantf.matmul(h, ap["Wq"]).reshape(b, t, h_, dh)
        k = quantf.matmul(h, ap["Wk"]).reshape(b, t, h_, dh)
        v = quantf.matmul(h, ap["Wv"]).reshape(b, t, h_, dh)
        out = mha(q, k, v, causal=self.causal).reshape(b, t, h_ * dh)
        x = x + quantf.matmul(out, ap["Wo"])
        h = layer_norm(params["ln2"], x)
        if training and rng is not None and self.dropout_rate:
            # the JAX block splits its key for the attention sub-layer
            # (r1, unused without a rate) and the FFN (r2)
            h = _dropout(h, self.dropout_rate, training, rng_mod.split(rng, 2)[1])
        h = self.ffn_activation(quantf.matmul(h, params["W1"])
                                + params["b1"].to(x.dtype))
        h = quantf.matmul(h, params["W2"]) + params["b2"].to(x.dtype)
        return x + h, state
