"""Paged decode-step attention — the counterpart of
`deeplearning4j_tpu/ops/paged_attention.py`.

One query row per slot attends against K/V living in pages of a
preallocated pool (`serving/kv_cache.py`): ``page_tbl[s, j]`` names the
pool page holding positions ``[j*page_size, (j+1)*page_size)`` of slot
``s``, and ``seq_lens[s]`` bounds the live positions.

`paged_attention_fwd` is the kernel wrapper: on a CUDA tensor it
launches ``csrc/paged_attention.cu`` (f32 or int8 pages) or raises; on a
CPU tensor it runs `paged_attention_plain`, the JAX package's
gather-then-attend reference (`_xla_paged_attention`), whose masked
positions contribute exact zeros.  The speculative-verify chunk variant
(`paged_attention_chunk`) arrives with speculative decoding.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.runtime import kernels

#: head dims the CUDA kernel is instantiated for: every multiple of 16
#: from 16 to 256
PAGED_HEAD_DIMS = tuple(range(16, 257, 16))


def _gather_pages(pages, page_tbl):
    """(P, ps, ...) pool + (S, maxP) table -> (S, maxP*ps, ...)."""
    g = pages[page_tbl.long()]
    s, mp, ps = g.shape[0], g.shape[1], g.shape[2]
    return g.reshape((s, mp * ps) + tuple(g.shape[3:]))


def paged_attention_plain(q, k_pages, v_pages, page_tbl, seq_lens,
                          k_scale=None, v_scale=None):
    """Gather-then-attend in f32.  q: (S, H, Dh); pools (P, ps, H, Dh);
    int8 pools carry (P, ps, H) per-row scales.  Returns (S, H, Dh)."""
    dh = q.shape[-1]
    k = _gather_pages(k_pages, page_tbl).float()
    v = _gather_pages(v_pages, page_tbl).float()
    if k_scale is not None:
        k = k * _gather_pages(k_scale, page_tbl)[..., None]
    if v_scale is not None:
        v = v * _gather_pages(v_scale, page_tbl)[..., None]
    ell = k.shape[1]
    scores = torch.einsum("shd,slhd->shl", q.float(), k) / math.sqrt(dh)
    lens = seq_lens.long()
    live = torch.arange(ell, device=q.device)[None, None, :] < lens[:, None, None]
    scores = scores.masked_fill(~live, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    # an idle slot (seq_len 0) softmaxes a row of -inf into nans
    p = torch.where(lens[:, None, None] > 0, p, torch.zeros_like(p))
    return torch.einsum("shl,slhd->shd", p, v)


def _check(q, k_pages, v_pages, page_tbl, seq_lens, k_scale, v_scale):
    if q.dim() != 3 or q.dtype != torch.float32:
        raise TypeError(f"q must be (S, H, Dh) f32, got {tuple(q.shape)} {q.dtype}")
    s, h, dh = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or tuple(k_pages.shape[2:]) != (h, dh):
        raise ValueError(
            f"pools must be (P, ps, {h}, {dh}); got {tuple(k_pages.shape)}, "
            f"{tuple(v_pages.shape)}")
    quant = k_scale is not None
    want = torch.int8 if quant else torch.float32
    if k_pages.dtype != want or v_pages.dtype != want:
        raise TypeError(f"pools must be {want}; got {k_pages.dtype}, {v_pages.dtype}")
    if quant and (k_scale.shape != k_pages.shape[:3]
                  or v_scale.shape != k_pages.shape[:3]
                  or k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise ValueError("int8 pools need f32 (P, ps, H) k_scale and v_scale")
    if page_tbl.dim() != 2 or page_tbl.shape[0] != s or page_tbl.dtype != torch.int32:
        raise ValueError(f"page_tbl must be ({s}, maxP) int32")
    if seq_lens.shape != (s,) or seq_lens.dtype != torch.int32:
        raise ValueError(f"seq_lens must be ({s},) int32")
    tensors = [q, k_pages, v_pages, page_tbl, seq_lens]
    if quant:
        tensors += [k_scale, v_scale]
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: tensors on different devices")
    return tensors


def paged_attention_fwd(q, k_pages, v_pages, page_tbl, seq_lens,
                        k_scale=None, v_scale=None):
    """Kernel wrapper; see the module docstring."""
    tensors = _check(q, k_pages, v_pages, page_tbl, seq_lens, k_scale, v_scale)
    if kernels.route(q.device) == "plain":
        return paged_attention_plain(q, k_pages, v_pages, page_tbl, seq_lens,
                                     k_scale, v_scale)
    return _paged_attention_kernel(tensors, k_scale is not None)


def _paged_attention_kernel(tensors, quant: bool):
    q, k_pages, v_pages, page_tbl, seq_lens = tensors[:5]
    k_scale, v_scale = tensors[5:] if quant else (None, None)
    s, h, dh = q.shape
    if dh not in PAGED_HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {dh} is not a multiple "
                         f"of 16 from 16 to 256, the dims the kernel is "
                         f"built for")
    if h > 65535:
        raise ValueError(f"paged_attention: {h} heads exceed the grid's 65535")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    lib = kernels.library("paged_attention")
    rc = lib.dl4j_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        page_tbl.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        s, h, dh, k_pages.shape[0], k_pages.shape[1], page_tbl.shape[1],
        int(quant), 1.0 / math.sqrt(dh), kernels.current_stream(q.device))
    kernels.check_launch(
        "paged_attention_fwd_int8" if quant else "paged_attention_fwd", rc)
    return out


def paged_attention(q, k_pages, v_pages, page_tbl, seq_lens, *,
                    k_scale=None, v_scale=None):
    """One decode step of attention against paged K/V.  ``q``: (S, H, Dh)
    f32; pools (P, page_size, H, Dh) f32, or int8 with ``k_scale`` /
    ``v_scale`` (P, page_size, H); ``page_tbl``: (S, maxP) int32;
    ``seq_lens``: (S,) int32.  Returns (S, H, Dh) f32."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 pages need BOTH k_scale and v_scale")
    return paged_attention_fwd(q, k_pages, v_pages, page_tbl, seq_lens,
                               k_scale, v_scale)
