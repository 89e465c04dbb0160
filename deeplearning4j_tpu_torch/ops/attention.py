"""Multi-head attention — `deeplearning4j_tpu/ops/attention.py`: dense
`mha`, and the sequence-parallel `ring_attention` and
`ulysses_attention` a rank runs on its time block under a seq axis.

- `ring_attention`: Q stays, the K / V blocks (and a key mask) rotate
  around the seq group (`parallel/collectives.py` `ppermute`, whose
  backward rotates back), and each held block is folded into an f32
  online softmax (running max, normaliser, weighted values) one
  ``block_size`` chunk at a time, causal masking by global positions:
  the JAX function's math.  It launches no flash kernel, as JAX's ring
  reaches no Pallas call.
- `ulysses_attention`: an all-to-all from time blocks of every head to
  the whole sequence of H / s heads, `mha` there (the flash kernels B1,
  B2 and B3 on the card when unmasked), and the all-to-all back.  A key
  mask is all-gathered and takes the dense route, as in JAX.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_eligible,
)


def mha(q, k, v, *, causal: bool = False, mask=None, q_offset: int = 0,
        kv_offset: int = 0):
    """q, k, v: (B, T, H, D) -> (B, Tq, H, D).  ``mask`` is a (B, Tk)
    keep-mask over keys.  Unmasked offset-free self-attention goes to
    `flash_attention` (the kernel on CUDA, its plain version on the
    CPU); everything else takes the dense path below."""
    if q_offset == 0 and kv_offset == 0 and flash_eligible(q, k, mask):
        return flash_attention(q, k, v, causal=causal)
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(d))
    logits = logits.float()
    if causal:
        qi = torch.arange(q.shape[1], device=q.device) + q_offset
        ki = torch.arange(k.shape[1], device=q.device) + kv_offset
        logits = logits.masked_fill(~(qi[:, None] >= ki[None, :]),
                                    float("-inf"))
    if mask is not None:
        logits = logits.masked_fill(~(mask[:, None, None, :] > 0),
                                    float("-inf"))
    w = torch.softmax(logits, dim=-1)
    w = torch.nan_to_num(w, nan=0.0)       # fully-masked rows
    return torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype), v)


def ring_attention(q, k, v, *, axis: str, causal: bool = False, mask=None,
                   block_size: int | None = 512):
    """Exact attention with K / V rotating around the ``axis`` ring.
    q, k, v: this rank's (B, T_local, H, D) time block; ``mask``: its
    (B, T_local) keep-mask over keys (rotating with them).  Returns the
    local output block."""
    from deeplearning4j_tpu_torch.parallel import collectives

    n = collectives.axis_size(axis)
    idx = collectives.axis_rank(axis)
    b, t_local, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q32 = q.float()
    qi = torch.arange(t_local, device=q.device) + idx * t_local
    if block_size is None or block_size >= t_local:
        bs = t_local
    else:
        bs = max(s for s in range(1, block_size + 1) if t_local % s == 0)
    neg = float("-inf")
    mb = (mask.float() if mask is not None
          else None)
    o = torch.zeros((b, h, t_local, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t_local), neg, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t_local), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for j in range(n):
        k_base = ((idx - j) % n) * t_local     # whose block is held now
        for c in range(0, t_local, bs):
            kc = kb[:, c:c + bs].float()
            logits = torch.einsum("bqhd,bkhd->bhqk", q32, kc) * scale
            if causal:
                ki = torch.arange(bs, device=q.device) + (k_base + c)
                logits = logits.masked_fill(~(qi[:, None] >= ki[None, :]), neg)
            if mb is not None:
                logits = logits.masked_fill(
                    ~(mb[:, None, None, c:c + bs] > 0), neg)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.exp(logits - safe_m[..., None])
            p = torch.where(torch.isneginf(logits), 0.0, p)
            corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe_m))
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vb[:, c:c + bs].float())
            m = m_new
        if j + 1 < n:
            kb = collectives.ppermute(kb, axis)
            vb = collectives.ppermute(vb, axis)
            if mb is not None:
                mb = collectives.ppermute(mb, axis)
    l = torch.clamp_min(l, 1e-20)
    out = (o / l[..., None]).to(q.dtype)
    return out.permute(0, 2, 1, 3)


def ulysses_attention(q, k, v, *, axis: str, causal: bool = False, mask=None):
    """DeepSpeed-Ulysses: heads scattered and the sequence gathered by
    an all-to-all, `mha` over the whole sequence on H / s heads, and
    the inverse all-to-all.  q, k, v: the local (B, T_local, H, D)
    block; ``mask``: the local (B, T_local) keep-mask.  H must divide
    by the axis size."""
    from deeplearning4j_tpu_torch.parallel import collectives

    n = collectives.axis_size(axis)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"ulysses needs heads ({h}) divisible by axis size ({n})")

    def scatter_heads(x):        # (B, T_local, H, D) -> (B, T, H / s, D)
        return collectives.all_to_all(x, axis, split_dim=2, concat_dim=1)

    mf = None if mask is None else collectives.gather(mask, 1, axis)
    out = mha(scatter_heads(q), scatter_heads(k), scatter_heads(v),
              causal=causal, mask=mf)
    return collectives.all_to_all(out, axis, split_dim=1, concat_dim=2)
