"""KV-cache autoregressive decoding — the dense single-request reference
of `deeplearning4j_tpu/ops/generation.py`.

`generate()` prefills per-block K/V caches from the prompt in one dense
forward, then decodes one token per tick against the caches.  Its
per-position math (`_block_step`'s f32 attention with -inf masking, the
sampling rule of `_sample`) is the contract the paged engine in
`serving/generation.py` is held to: greedy decode token for token.

Int8 weights.  Over a `quant.quantize`d model every product goes through
`quant.functional.matmul` (`ops.dequant_matmul`: kernel B5 on CUDA) and
the embedding through `quant.functional.embedding_lookup` (int8 rows
gathered, then dequantized in f32: the JAX package's
dequantize-then-gather, element for element).  A plain weight takes the
op it always took (``x @ w.to(x.dtype)``).  A quantized model computes
in f32 whatever ``bf16_compute`` says (ROADMAP C16): the JAX package
computes its quantized step in the model's compute dtype.

Sampling.  As the JAX package: greedy argmax of the unscaled logits, or
a temperature scale and a top-k threshold at the k-th largest scaled
logit, then `jax.random.categorical` — argmax of the logits plus Gumbel
noise drawn with the key ``fold_in(key(seed), g)``, g the index of the
generated token.  `runtime.rng` gives the same noise bit for bit, so a
seeded sampled stream has the JAX package's tokens, and depends on
nothing but its own seed and position, never on its slot or its
neighbours.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.models.sequential import as_tensor
from deeplearning4j_tpu_torch.nn.conf.attention import (
    PositionalEncoding,
    TransformerEncoderBlock,
    sinusoid_rows,
)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ChunkedSoftmaxOutputLayer,
    Embedding,
)
from deeplearning4j_tpu_torch.nn.conf.recurrent import RnnOutputLayer
from deeplearning4j_tpu_torch.ops.attention import mha
from deeplearning4j_tpu_torch.quant import functional as quantf
from deeplearning4j_tpu_torch.runtime import rng


def _plan(model):
    """Validate the stack shape; returns (embed, pos, blocks, head).
    Shared by `generate` and the paged engine."""
    layers = list(model.conf.layers)
    if not layers or not isinstance(layers[0], Embedding):
        raise ValueError("generate() needs an Embedding first layer")
    embed, i, pos = layers[0], 1, None
    if i < len(layers) and isinstance(layers[i], PositionalEncoding):
        pos = layers[i]
        i += 1
    blocks = []
    while i < len(layers) and isinstance(layers[i], TransformerEncoderBlock):
        blocks.append(layers[i])
        i += 1
    if i != len(layers) - 1:
        raise ValueError(
            "generate() supports [Embedding, PositionalEncoding?, "
            "TransformerEncoderBlock*, head] stacks; layer "
            f"{type(layers[i]).__name__} at position {i} is not supported")
    head = layers[-1]
    if not isinstance(head, (RnnOutputLayer, ChunkedSoftmaxOutputLayer)):
        raise ValueError(f"unsupported head {type(head).__name__}; need "
                         "RnnOutputLayer or ChunkedSoftmaxOutputLayer")
    for b in blocks:
        if not b.causal:
            raise ValueError("generate() requires causal blocks")
    return embed, pos, blocks, head


def _embed(embed, lp, ids: torch.Tensor) -> torch.Tensor:
    """The embedding layer's rows for ``ids``, its activation applied; a
    quantized table gathers int8 rows and dequantizes them in f32."""
    return embed._act()(quantf.embedding_lookup(lp["W"], ids))


def _pe_rows(pos_layer, lp, t: torch.Tensor, d: int) -> torch.Tensor:
    """Positional-encoding rows for positions ``t`` (N,) -> (N, d) f32."""
    if pos_layer is None:
        return torch.zeros((t.shape[0], d), dtype=torch.float32, device=t.device)
    if pos_layer.learned:
        return lp["P"][t.long()].float()
    return sinusoid_rows(t, d)


def _ln(lp, x):
    """LayerNorm in x's own dtype (biased variance, eps 1e-5), as the
    JAX decode path computes it."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + 1e-5)
    return y * lp["gamma"].to(x.dtype) + lp["beta"].to(x.dtype)


def _block_prefill(cfg, lp, x, mask=None):
    """Dense block forward on the prompt that also returns its K/V.
    x: (B, T, D)."""
    b, t, _ = x.shape
    h_, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    ap = lp["attn"]
    mm = quantf.matmul
    hh = _ln(lp["ln1"], x)
    q = mm(hh, ap["Wq"]).reshape(b, t, h_, dh)
    k = mm(hh, ap["Wk"]).reshape(b, t, h_, dh)
    v = mm(hh, ap["Wv"]).reshape(b, t, h_, dh)
    out = mha(q, k, v, causal=True, mask=mask)
    x = x + mm(out.reshape(b, t, h_ * dh), ap["Wo"])
    hh = _ln(lp["ln2"], x)
    hh = cfg.ffn_activation(mm(hh, lp["W1"]) + lp["b1"].to(x.dtype))
    x = x + (mm(hh, lp["W2"]) + lp["b2"].to(x.dtype))
    return x, k, v


def _block_step(cfg, lp, x_t, k_cache, v_cache, pos: int):
    """One-token block step against a dense cache, written in place.
    x_t: (B, D); caches (B, L, H, Dh)."""
    b, _ = x_t.shape
    h_, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    ell = k_cache.shape[1]
    ap = lp["attn"]
    mm = quantf.matmul
    hh = _ln(lp["ln1"], x_t)
    q = mm(hh, ap["Wq"]).reshape(b, h_, dh)
    k_cache[:, pos] = mm(hh, ap["Wk"]).reshape(b, h_, dh)
    v_cache[:, pos] = mm(hh, ap["Wv"]).reshape(b, h_, dh)
    scores = torch.einsum("bhd,blhd->bhl", q.float(),
                          k_cache.float()) / math.sqrt(dh)
    live = torch.arange(ell, device=x_t.device)[None, None, :] <= pos
    scores = scores.masked_fill(~live, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhl,blhd->bhd", p, v_cache.float())
    out = out.reshape(b, h_ * dh).to(x_t.dtype)
    x_t = x_t + mm(out, ap["Wo"])
    hh = _ln(lp["ln2"], x_t)
    hh = cfg.ffn_activation(mm(hh, lp["W1"]) + lp["b1"].to(x_t.dtype))
    return x_t + (mm(hh, lp["W2"]) + lp["b2"].to(x_t.dtype))


def _head_logits(head, lp, h):
    """h: (..., D) -> (..., vocab) logits (``h @ W + b``)."""
    return head.logits(lp, h)


def _sample(logits, *, temperature: float, top_k: int, seed: int, g: int):
    """(B, V) logits -> (B,) int64 tokens.  Greedy argmaxes the unscaled
    logits; otherwise Gumbel-argmax over the temperature-scaled logits
    with everything below the k-th largest masked out, the noise of the
    whole (B, V) batch drawn with one key (jax's categorical)."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits / temperature
    if top_k > 0:
        k = min(int(top_k), scaled.shape[-1])
        kth = torch.sort(scaled, dim=-1, descending=True).values[..., k - 1:k]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    # Only finite logits can win, and an element's noise depends on its
    # flat index alone: after one copy of the logits to the host, draw it
    # for those candidates only (some 150 small host ops at top-k 50; the
    # whole vocabulary on the card takes some 250 launches).
    host = scaled.cpu().flatten()
    cand = torch.nonzero(host > float("-inf")).flatten()
    noisy = torch.full_like(host, float("-inf"))
    noisy[cand] = host[cand] + rng.gumbel_at(rng.fold_in(rng.key(seed), g), cand)
    return torch.argmax(noisy.view(scaled.shape), dim=-1).to(scaled.device)


@torch.no_grad()
def generate(model, prompt_ids, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int = 0, seed: int = 0):
    """Decode ``max_new_tokens`` continuations of ``prompt_ids`` (B, T_p).
    Returns (B, T_p + max_new_tokens) int32 on the model's device —
    prompt followed by the generated tokens."""
    if model.params is None:
        model.init()
    embed, pos, blocks, head = _plan(model)
    dev = model.device
    prompt = as_tensor(prompt_ids, dev).to(torch.int64)
    if prompt.dim() == 1:
        prompt = prompt[None, :]
    if max_new_tokens <= 0:
        return prompt.to(torch.int32)
    b, t_p = prompt.shape
    if pos is not None and pos.learned and t_p + max_new_tokens > pos.max_length:
        raise ValueError(
            f"prompt + max_new_tokens = {t_p + max_new_tokens} exceeds the "
            f"learned PositionalEncoding max_length {pos.max_length}")
    params = model.compute_params()
    names = [l.name for l in model.conf.layers]
    embed_name, head_name = names[0], names[-1]
    pos_lp = params.get(pos.name, {}) if pos is not None else {}
    d = embed.n_out
    ell = t_p + max_new_tokens
    # quantized sites count once a call shape, as the JAX package's jitted
    # prefill and scan body are traced once
    shape = (b, t_p, max_new_tokens)
    with model.program_run("generate", *shape):
        x = _embed(embed, params[embed_name], prompt)
        if pos is not None:
            x = pos.apply(pos_lp, {}, x)[0]
        caches = []
        for cfg in blocks:
            x, k, v = _block_prefill(cfg, params[cfg.name], x, None)
            k_c = torch.zeros((b, ell) + tuple(k.shape[2:]), dtype=k.dtype,
                              device=dev)
            v_c = torch.zeros_like(k_c)
            k_c[:, :t_p] = k
            v_c[:, :t_p] = v
            caches.append((k_c, v_c))
        logits = _head_logits(head, params[head_name], x[:, -1])
    tok = _sample(logits, temperature=temperature, top_k=top_k, seed=seed, g=0)
    toks = [tok]
    for i in range(max_new_tokens - 1):
        t = t_p + i
        with model.program_run("generate_step", *shape):
            x_t = _embed(embed, params[embed_name], tok)
            x_t = x_t + _pe_rows(pos, pos_lp, torch.full((b,), t, device=dev),
                                 d).to(x_t.dtype)
            for cfg, (k_c, v_c) in zip(blocks, caches):
                x_t = _block_step(cfg, params[cfg.name], x_t, k_c, v_c, t)
            logits = _head_logits(head, params[head_name], x_t)
        tok = _sample(logits, temperature=temperature, top_k=top_k, seed=seed,
                      g=i + 1)
        toks.append(tok)
    gen = torch.stack(toks, dim=1)
    return torch.cat([prompt, gen], dim=1).to(torch.int32)
