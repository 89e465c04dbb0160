"""Flash attention forward — the counterpart of
`deeplearning4j_tpu/ops/flash_attention.py`'s forward kernel.

`flash_fwd` is the kernel wrapper: (BH, T, D) q, k, v in f32 or bf16 ->
``(out, lse)`` with ``out`` in q's dtype and ``lse`` (BH, T) f32.  On a
CUDA tensor it launches ``csrc/flash_fwd.cu`` (or raises); on a CPU
tensor it runs `flash_fwd_plain`, the dense softmax of
`ops.attention.mha` that also returns the logsumexp.  The backward
kernels (dQ, dK/dV) arrive with the training slice.

`mha` sends every unmasked, offset-free call here.  The JAX package only
takes its kernel from T >= 2048, a threshold measured on a TPU v5e; the
port does not carry it over, so every prefill runs the kernel on the
card.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.runtime import kernels

#: head dims the CUDA kernel is instantiated for
FLASH_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def flash_fwd_plain(q, k, v, *, causal: bool):
    """Dense reference: softmax(q k^T / sqrt(D)) v in f32, plus the
    row logsumexp.  q, k, v: (BH, T, D)."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        above = torch.ones((t_q, t_k), dtype=torch.bool,
                           device=s.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.matmul(torch.softmax(s, dim=-1), v.float())
    return out.to(q.dtype), lse


def _check(q, k, v) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_fwd wants q, k, v of one (BH, T, D) shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_fwd wants f32 or bf16 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_fwd: q, k, v on different devices")


def flash_fwd(q, k, v, *, causal: bool):
    """(BH, T, D) -> (out, lse).  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    _check(q, k, v)
    if kernels.route(q.device) == "plain":
        return flash_fwd_plain(q, k, v, causal=causal)
    return _flash_fwd_kernel(q, k, v, causal)


def _flash_fwd_kernel(q, k, v, causal: bool):
    bh, t, d = q.shape
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_fwd: head dim {d} not in {FLASH_HEAD_DIMS}")
    if bh > 65535:
        raise ValueError(f"flash_fwd: BH {bh} exceeds the grid's 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd: q, k, v must be contiguous")
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    lib = kernels.library("flash_fwd")
    rc = lib.dl4j_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, t, d, int(bool(causal)),
        int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d),
        kernels.current_stream(q.device))
    kernels.check_launch("flash_fwd", rc)
    return out, lse


def flash_attention(q, k, v, *, causal: bool = False):
    """FlashAttention over (B, T, H, D) tensors (the `mha` layout)."""
    b, t, h, d = q.shape

    def bhtd(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()

    out, _ = flash_fwd(bhtd(q), bhtd(k), bhtd(v), causal=causal)
    return out.reshape(b, h, t, d).permute(0, 2, 1, 3)


def flash_eligible(q, k, mask) -> bool:
    """Unmasked self-attention of one length, at a head dim and dtype
    the kernel is built for."""
    return (mask is None and q.shape[1] == k.shape[1]
            and q.shape[-1] in FLASH_HEAD_DIMS and q.dtype in _DTYPES)
