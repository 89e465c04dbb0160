"""Dense multi-head attention — `mha` of `deeplearning4j_tpu/ops/attention.py`.

Ring and Ulysses attention arrive with the parallelism slice.
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
