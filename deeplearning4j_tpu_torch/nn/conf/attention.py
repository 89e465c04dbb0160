"""Attention layer configs — `deeplearning4j_tpu/nn/conf/attention.py`:
`SelfAttentionLayer`, `LearnedSelfAttentionLayer`, `PositionalEncoding`
and the pre-LN `TransformerEncoderBlock`.

Every layer here attends through `_attend`: on one device (or a mesh
without a seq axis larger than 1) `ops.attention.mha`, which sends
unmasked self-attention to the flash-forward kernel on CUDA, a key mask
(the model's features mask, ``ACCEPTS_MASK``) keeping the dense route
as the JAX package's ``flash_eligible`` refuses any mask.  Under a seq
axis a layer with ``seq_parallel`` "ring" or "ulysses" runs on the
rank's time block (``SEQ_LOCAL``) and attends with
`ops.attention.ring_attention` or `ulysses_attention`; one with "none"
runs on the gathered sequence (`models/sequential.py`), densely, as the
JAX layer attends over the global arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


_SEQ_MODES = ("none", "ring", "ulysses")


def _check_seq_parallel(mode: str) -> None:
    """An unknown sequence-parallel mode is a ValueError when a model is
    built, as in the JAX package."""
    if mode not in _SEQ_MODES:
        raise ValueError(f"seq_parallel={mode!r}; options: {_SEQ_MODES}")


def _attend(q, k, v, *, causal: bool, mask, seq_parallel: str):
    """The attention core of q, k, v (B, T, H, Dh) with a (B, T) key
    mask or None: ring or Ulysses attention on the rank's time block
    when the active mesh has a seq axis larger than 1 and the layer
    asks for one (the caller then holds a block), `mha` otherwise."""
    from deeplearning4j_tpu_torch.ops.attention import ring_attention, ulysses_attention
    from deeplearning4j_tpu_torch.parallel import collectives

    _check_seq_parallel(seq_parallel)
    n = collectives.axis_size("seq")
    if seq_parallel == "none" or n == 1:
        return mha(q, k, v, causal=causal, mask=mask)
    if seq_parallel == "ulysses" and q.shape[2] % n:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by seq axis ({n})")
    core = ring_attention if seq_parallel == "ring" else ulysses_attention
    return core(q, k, v, axis="seq", causal=causal, mask=mask)


def resolve_head_size(n_out: int, n_heads: int, head_size) -> int:
    """An explicit head_size wins; otherwise n_out splits evenly over the
    heads."""
    if head_size is not None:
        return head_size
    if n_out % n_heads:
        raise ValueError(f"n_out {n_out} not divisible by n_heads {n_heads}")
    return n_out // n_heads


def init_qkv_params(key, wi: WeightInit, n_in_q: int, n_in_k: int,
                    n_in_v: int, hd: int, n_out: int, device) -> dict:
    """Wq / Wk / Wv into n_heads * head_size (= hd) and Wo back out, from
    the four subkeys of ``key`` in that order (the JAX package's)."""
    kq, kk, kv, ko = rng_mod.split(key, 4)
    return {
        "Wq": wi.init(kq, (n_in_q, hd), fan_in=n_in_q, fan_out=hd, device=device),
        "Wk": wi.init(kk, (n_in_k, hd), fan_in=n_in_k, fan_out=hd, device=device),
        "Wv": wi.init(kv, (n_in_v, hd), fan_in=n_in_v, fan_out=hd, device=device),
        "Wo": wi.init(ko, (hd, n_out), fan_in=hd, fan_out=n_out, device=device),
    }


def apply_qkv_attention(params, xq, xk, xv, *, n_heads: int, head_size: int,
                        project_input: bool, causal: bool, mask,
                        seq_parallel: str = "none"):
    """Project (when project_input), attend, merge heads, project out.
    xq / xk / xv: (B, T*, F), one tensor three times for self-attention;
    mask: a (B, Tk) keep-mask over keys or None.  The projections go
    through `quantf.matmul` (B5 for an int8 weight); the core is
    `_attend` (ring or Ulysses under a seq axis, `mha` otherwise)."""
    b, tq = xq.shape[0], xq.shape[1]
    h, dh = n_heads, head_size
    if project_input:
        q = quantf.matmul(xq, params["Wq"]).reshape(b, tq, h, dh)
        k = quantf.matmul(xk, params["Wk"]).reshape(b, xk.shape[1], h, dh)
        v = quantf.matmul(xv, params["Wv"]).reshape(b, xv.shape[1], h, dh)
    else:
        q = xq.reshape(b, tq, h, dh)
        k = xk.reshape(b, xk.shape[1], h, dh)
        v = xv.reshape(b, xv.shape[1], h, dh)
    out = _attend(q, k, v, causal=causal, mask=mask,
                  seq_parallel=seq_parallel).reshape(b, tq, h * dh)
    if project_input:
        out = quantf.matmul(out, params["Wo"])
    return out


@serde.register
@dataclasses.dataclass(frozen=True)
class SelfAttentionLayer(LayerConfig):
    """Multi-head self-attention over a sequence.  ``project_input``:
    learned Wq / Wk / Wv into n_heads * head_size, attention, Wo back out
    to n_out; without it the input is q = k = v and n_in must equal
    n_heads * head_size = n_out."""

    n_out: int = 0
    n_heads: int = 1
    head_size: Optional[int] = None       # default: n_out // n_heads
    project_input: bool = True
    causal: bool = False
    seq_parallel: str = "none"            # none | ring | ulysses

    EXPECTS = "rnn"
    ACCEPTS_MASK = True
    REGULARIZED = ("Wq", "Wk", "Wv", "Wo")

    def check_supported(self):
        _check_seq_parallel(self.seq_parallel)

    @property
    def SEQ_LOCAL(self):  # type: ignore[override]
        return self.seq_parallel != "none"

    def _head_size(self) -> int:
        return resolve_head_size(self.n_out, self.n_heads, self.head_size)

    def output_type(self, itype):
        if not self.project_input and itype.size != self.n_out:
            raise ValueError("project_input=False requires n_in == n_out "
                             f"(got {itype.size} vs {self.n_out})")
        return InputType.recurrent(self.n_out, itype.shape[0])

    def init(self, key, itype, device):
        if not self.project_input:
            if itype.size != self.n_heads * self._head_size():
                raise ValueError(
                    "project_input=False requires n_in == n_heads*head_size "
                    f"(got {itype.size} vs {self.n_heads}*{self._head_size()})")
            return {}, {}
        n_in, hd = itype.size, self.n_heads * self._head_size()
        wi = self._winit(WeightInit.XAVIER)
        return init_qkv_params(key, wi, n_in, n_in, n_in, hd, self.n_out,
                               device), {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)
        out = apply_qkv_attention(
            params, x, x, x, n_heads=self.n_heads, head_size=self._head_size(),
            project_input=self.project_input, causal=self.causal, mask=mask,
            seq_parallel=self.seq_parallel)
        return self._act()(out), state


@serde.register
@dataclasses.dataclass(frozen=True)
class LearnedSelfAttentionLayer(LayerConfig):
    """Attention with ``n_queries`` learned query vectors: (B, T, n_in)
    -> (B, n_queries, n_out) whatever T is, a trainable pooling of the
    sequence.  Keys and values attend densely (the queries are not a
    sequence to shard); Wk, Wv and Wo are plain products, never int8,
    as in the JAX layer."""

    n_out: int = 0
    n_heads: int = 1
    n_queries: int = 1
    head_size: Optional[int] = None

    EXPECTS = "rnn"
    ACCEPTS_MASK = True
    REGULARIZED = ("Wk", "Wv", "Wo", "Q")

    def _head_size(self) -> int:
        return resolve_head_size(self.n_out, self.n_heads, self.head_size)

    def output_type(self, itype):
        return InputType.recurrent(self.n_out, self.n_queries)

    def init(self, key, itype, device):
        n_in, hd = itype.size, self.n_heads * self._head_size()
        kq, kk, kv, ko = rng_mod.split(key, 4)
        wi = self._winit(WeightInit.XAVIER)
        return {
            "Q": wi.init(kq, (self.n_queries, hd), fan_in=hd, fan_out=hd,
                         device=device),
            "Wk": wi.init(kk, (n_in, hd), fan_in=n_in, fan_out=hd, device=device),
            "Wv": wi.init(kv, (n_in, hd), fan_in=n_in, fan_out=hd, device=device),
            "Wo": wi.init(ko, (hd, self.n_out), fan_in=hd, fan_out=self.n_out,
                          device=device),
        }, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)
        b, t = x.shape[0], x.shape[1]
        h, dh = self.n_heads, self._head_size()
        q = params["Q"].to(x.dtype).reshape(1, self.n_queries, h, dh).expand(
            b, self.n_queries, h, dh)
        k = (x @ params["Wk"].to(x.dtype)).reshape(b, t, h, dh)
        v = (x @ params["Wv"].to(x.dtype)).reshape(b, t, h, dh)
        out = mha(q, k, v, mask=mask)
        out = out.reshape(b, self.n_queries, h * dh) @ params["Wo"].to(x.dtype)
        return self._act()(out), state


@serde.register
@dataclasses.dataclass(frozen=True)
class PositionalEncoding(LayerConfig):
    """Additive positions: sinusoidal (no params) or learned
    (max_length x d table)."""

    learned: bool = False
    max_length: int = 0
    REGULARIZED = ()
    SEQ_LOCAL = True

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
        from deeplearning4j_tpu_torch.parallel import context

        t, d = x.shape[1], x.shape[2]
        # a time block's rows are those of its global positions
        t0, t_all = context.time_offset(t)
        if self.learned:
            if t_all > self.max_length:
                raise ValueError(
                    f"sequence length {t_all} exceeds max_length {self.max_length}")
            return x + params["P"][t0:t0 + t].to(x.dtype), state
        pos = torch.arange(t0, t0 + t, device=x.device)
        return x + sinusoid_rows(pos, d).to(x.dtype), state


@serde.register
@dataclasses.dataclass(frozen=True)
class TransformerEncoderBlock(LayerConfig):
    """Pre-LN block: x + MHA(LN(x)), then x + FFN(LN(x)).  The attention
    is a `SelfAttentionLayer` of the block's width (its tree under
    ``params["attn"]``), key-masked by the model's features mask.
    Dropout drops the FFN's input; the attention sub-layer takes none
    (the JAX block builds it without a rate)."""

    d_model: int = 0
    n_heads: int = 1
    d_ff: int = 0                        # default 4 * d_model
    causal: bool = False
    seq_parallel: str = "none"
    ffn_activation: Activation = Activation.GELU

    EXPECTS = "rnn"
    ACCEPTS_MASK = True

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "ffn_activation",
                           _coerce_enum(self.ffn_activation, Activation))
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads {self.n_heads}")

    def check_supported(self):
        _check_seq_parallel(self.seq_parallel)

    @property
    def SEQ_LOCAL(self):  # type: ignore[override]
        return self.seq_parallel != "none"

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
            "attn": init_qkv_params(k_attn, wi, d, d, d, d, d, device),
            "ln1": ln(),
            "ln2": ln(),
            "W1": wi.init(k1, (d, dff), fan_in=d, fan_out=dff, device=device),
            "b1": torch.zeros(dff, device=device),
            "W2": wi.init(k2, (dff, d), fan_in=dff, fan_out=d, device=device),
            "b2": torch.zeros(d, device=device),
        }, {}

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        h = layer_norm(params["ln1"], x)
        x = x + apply_qkv_attention(
            params["attn"], h, h, h, n_heads=self.n_heads,
            head_size=self.d_model // self.n_heads, project_input=True,
            causal=self.causal, mask=mask, seq_parallel=self.seq_parallel)
        h = layer_norm(params["ln2"], x)
        if training and rng is not None and self.dropout_rate:
            # the JAX block splits its key for the attention sub-layer
            # (r1, unused without a rate) and the FFN (r2)
            h = _dropout(h, self.dropout_rate, training, rng_mod.split(rng, 2)[1])
        h = self.ffn_activation(quantf.matmul(h, params["W1"])
                                + params["b1"].to(x.dtype))
        h = quantf.matmul(h, params["W2"]) + params["b2"].to(x.dtype)
        return x + h, state
