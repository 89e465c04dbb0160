"""Flash attention — the counterpart of
`deeplearning4j_tpu/ops/flash_attention.py`: forward and backward kernels
and the autograd wiring around them.

`flash_fwd` is the forward wrapper: (BH, T, D) q, k, v in f32 or bf16 ->
``(out, lse)`` with ``out`` in q's dtype and ``lse`` (BH, T) f32.
`flash_bwd` is the backward wrapper: the forward's q, k, v, out, lse and
the output cotangent g -> ``(dq, dk, dv)`` in the inputs' dtype.  On a
CUDA tensor each launches its kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``) or raises; on a CPU tensor each runs its plain
version (`flash_fwd_plain`, `flash_bwd_plain`): dense torch with f32
sums, rounding bf16 operands where the Pallas kernels round them.

`FlashAttention` is the `torch.autograd.Function` of the JAX package's
``custom_vjp`` `_flash_core`: forward through `flash_fwd`, backward
through `flash_bwd`.  `flash_attention` goes through it, so `mha` is
differentiable on both devices.

`mha` sends every unmasked, offset-free call here.  The JAX package only
takes its kernel from T >= 2048, a threshold measured on a TPU v5e; the
port does not carry it over, so every prefill and every training step
runs the kernels on the card.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.runtime import kernels

#: head dims the CUDA kernels are instantiated for
FLASH_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def _causal_mask(t_q: int, t_k: int, device) -> torch.Tensor:
    """True above the diagonal: the keys a causal query must not see."""
    return torch.ones((t_q, t_k), dtype=torch.bool, device=device).triu(1)


def _operand(dtype):
    """How an operand of a product is rounded: bf16 inputs round it to
    bf16, as the Pallas kernels do with ``mxu_f32=False`` (the JAX
    package's default); f32 inputs stay exact, as the Pallas kernels
    compute with ``mxu_f32=True``.  That f32 choice is deliberate: the
    TPU rounds f32 operands to bf16 only because bf16 is its default
    matmul precision, while the JAX package on the CPU, PyTorch's own f32
    products (TF32 off) and the quantized model's 1e-5 parity with the
    JAX package are all exact f32.  On the card the f32 forward and
    backward reach the tensor cores without changing that answer: each
    f32 operand is split into two bf16 parts and three of the four part
    products are summed in f32.  Every product sums in f32."""
    if dtype == torch.bfloat16:
        return lambda x: x.to(torch.bfloat16).float()
    return lambda x: x


def flash_fwd_plain(q, k, v, *, causal: bool):
    """Dense reference of the forward, `_fwd_kernel` of the JAX package
    without its KV blocking: softmax(Q K^T * scale) V and the row
    logsumexp, for (BH, T, D) q, k, v.  f32 inputs stay f32: the
    Pallas kernel with ``mxu_f32=True``, on purpose (`_operand`).  bf16
    inputs round where the Pallas kernel rounds: Q * scale is a bf16
    operand of S, and P a bf16 operand of P V; the max, the normaliser
    l and lse = m + log(l) come from the unrounded f32 P, so the lse
    is the one the backward's recomputed P (`flash_bwd_plain`, kernels
    B2 and B3) normalises to rows that sum to 1."""
    d = q.shape[-1]
    operand = _operand(q.dtype)
    s = torch.matmul(operand(q.float() * (1.0 / math.sqrt(d))),
                     k.float().transpose(-1, -2))
    if causal:
        s = s.masked_fill(_causal_mask(s.shape[-2], s.shape[-1], s.device),
                          float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = torch.matmul(operand(p), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_bwd_plain(q, k, v, out, lse, g, *, causal: bool):
    """Dense reference of the backward — `_flash_bwd_bhtd` of the JAX
    package without its KV blocking:
        P = exp(Q K^T * scale - lse);  dV = P^T g;  dP = g V^T
        dS = P * (dP - delta), delta = rowsum(g * out)
        dQ = dS K * scale;  dK = dS^T (Q * scale)
    delta comes from ``out`` as the forward stored it (its dtype).  f32
    inputs stay f32 throughout.  bf16 inputs round where the Pallas
    kernels round with ``mxu_f32=False``: Q * scale, P and dS are bf16
    operands of their products, which sum in f32."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    operand = _operand(q.dtype)
    qf = operand(q.float() * scale)
    kf, vf, gf = k.float(), v.float(), g.float()
    delta = (gf * out.float()).sum(-1)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) - lse[..., None])
    if causal:
        p = p.masked_fill(_causal_mask(p.shape[-2], p.shape[-1], p.device), 0.0)
    dv = torch.matmul(operand(p).transpose(-1, -2), gf)
    ds = operand(p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta[..., None]))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, name="flash_fwd") -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"{name} wants q, k, v of one (BH, T, D) shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{name} wants f32 or bf16 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on different devices")


def _check_kernel_args(name, *tensors) -> None:
    bh, _, d = tensors[0].shape
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {FLASH_HEAD_DIMS}")
    if bh > 65535:
        raise ValueError(f"{name}: BH {bh} exceeds the grid's 65535")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def _pairs(bh: int, t: int, causal: bool) -> int:
    """(query, key) pairs a (BH, T) attention scores."""
    return bh * (t * (t + 1) // 2 if causal else t * t)


def flash_fwd_work(bh: int, t: int, d: int, causal: bool, elem: int) -> list:
    """What kernel B1 computes at (BH, T, D) with ``elem``-byte inputs:
    ``[(name, flops, bytes)]``.  FLOPs: S = Q K^T and P V, 2 D each a
    scored pair; bytes: q, k, v read and out written once, and the f32
    lse."""
    return [("flash_fwd", 4 * d * _pairs(bh, t, causal),
             4 * bh * t * d * elem + bh * t * 4)]


def flash_bwd_work(bh: int, t: int, d: int, causal: bool, elem: int) -> list:
    """What kernels B2 and B3 compute at (BH, T, D): dQ recomputes S and
    dP and forms dS K (3 products a pair), dK/dV recompute S and dP and
    form P^T g and dS^T Q (4); each reads q, k, v, g, the f32 lse and
    delta once and writes its gradients once."""
    pairs = _pairs(bh, t, causal)
    read = 4 * bh * t * d * elem + 2 * bh * t * 4
    return [("flash_bwd_dq", 6 * d * pairs, read + bh * t * d * elem),
            ("flash_bwd_dkdv", 8 * d * pairs, read + 2 * bh * t * d * elem)]


def flash_fwd(q, k, v, *, causal: bool):
    """(BH, T, D) -> (out, lse).  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    _check(q, k, v)
    with kernels.kernel_call(
            lambda: flash_fwd_work(*q.shape, causal, q.element_size())):
        if kernels.route(q.device) == "plain":
            return flash_fwd_plain(q, k, v, causal=causal)
        return _flash_fwd_kernel(q, k, v, causal)


def _flash_fwd_kernel(q, k, v, causal: bool):
    """Kernel B1 on contiguous CUDA tensors: bf16 runs `flash_fwd_wgmma`,
    whose TMA loads need each of q, k, v to start on a 16-byte boundary
    (its rows, D >= 16 bf16 elements, then are too); f32 runs
    `flash_fwd_split`, whose pre-pass reads q, k, v with plain loads and
    writes their bf16 hi and lo parts into ``parts``, (3, 2, BH, T, D)
    scratch allocated here, which the kernel then reads through TMA."""
    bh, t, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    _check_kernel_args("flash_fwd", q, k, v)
    if bf16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_fwd: TMA reads bf16 q, k, v only from "
                         "16-byte aligned starts")
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    parts = None if bf16 else torch.empty((3, 2, bh, t, d), dtype=torch.bfloat16,
                                          device=q.device)
    rc = kernels.library("flash_fwd").dl4j_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), None if bf16 else parts.data_ptr(), bh, t, d,
        int(bool(causal)), int(bf16), 1.0 / math.sqrt(d),
        kernels.current_stream(q.device))
    kernels.check_launch("flash_fwd", rc)
    return out, lse


def flash_bwd(q, k, v, out, lse, g, *, causal: bool):
    """The forward's (BH, T, D) q, k, v, out, its (BH, T) f32 lse and the
    cotangent g of out -> (dq, dk, dv).  CPU tensors take the plain
    version; CUDA tensors launch the dQ and dK/dV kernels or raise."""
    _check(q, k, v, "flash_bwd")
    if out.shape != q.shape or g.shape != q.shape:
        raise ValueError(
            f"flash_bwd wants out and g of q's shape {tuple(q.shape)}; got "
            f"{tuple(out.shape)}, {tuple(g.shape)}")
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32:
        raise ValueError(f"flash_bwd wants an f32 lse of shape "
                         f"{tuple(q.shape[:2])}; got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    with kernels.kernel_call(
            lambda: flash_bwd_work(*q.shape, causal, q.element_size())):
        if kernels.route(q.device) == "plain":
            return flash_bwd_plain(q, k, v, out, lse, g, causal=causal)
        return _flash_bwd_kernel(q, k, v, out, lse, g, causal)


def _flash_bwd_kernel(q, k, v, out, lse, g, causal: bool):
    g = g.to(q.dtype)
    _check_kernel_args("flash_bwd", q, k, v, g, lse)
    if q.dtype == torch.bfloat16:
        if any(x.data_ptr() % 16 for x in (q, k, v, g)):   # 16-byte cp.async rows
            raise ValueError("flash_bwd: bf16 q, k, v, g must start on 16-byte boundaries")
        # delta outside the kernels, as the JAX package computes it outside
        # Pallas (`_flash_bwd_pallas` :253-255): from the stored out, in f32
        delta = (g.float() * out.float()).sum(-1)
        return (launch_bwd_dq(q, k, v, g, lse, delta, causal),
                *launch_bwd_dkdv(q, k, v, g, lse, delta, causal))
    out = out.float().contiguous()
    # f32: the dQ call splits q * scale, k, v and g into ``parts`` and
    # writes delta from g and out; the dK/dV call reads both
    parts = bwd_parts(q)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    dq = launch_bwd_dq(q, k, v, g, lse, delta, causal, parts, out=out)
    return (dq, *launch_bwd_dkdv(q, k, v, g, lse, delta, causal, parts))


def bwd_parts(q):
    """Scratch for the f32 backward's split inputs: (4, 2, BH, T, D) bf16,
    the hi and lo parts of q * scale, k, v and g in that order."""
    return torch.empty((4, 2, *q.shape), dtype=torch.bfloat16, device=q.device)


def _bwd_args(q, k, v, g, lse, delta, causal, parts, out):
    """The pointer and size arguments of both backward calls, and the f32
    split scratch (allocated here when a call splits into none), which the
    caller holds until the launch is enqueued."""
    bh, t, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    if not bf16 and parts is None:
        if out is None:
            raise ValueError("flash_bwd: an f32 call without out reads the split "
                             "parts and delta of an earlier call; pass them")
        parts = bwd_parts(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            None if bf16 or out is None else out.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    common = (bh, t, d, int(bool(causal)), int(bf16), 1.0 / math.sqrt(d),
              kernels.current_stream(q.device))
    return ptrs, parts, common


def launch_bwd_dq(q, k, v, g, lse, delta, causal: bool, parts=None, out=None):
    """Kernel B2 alone on checked CUDA tensors (`flash_bwd` checks them):
    dq from q, k, v, g in one dtype and the (BH, T) f32 lse and delta.
    bf16 reads delta = rowsum(g * out).  f32 reads q * scale, k, v and g
    as bf16 hi and lo parts from ``parts`` (`bwd_parts`): given the
    forward's ``out``, the call first writes them there (into new scratch
    when ``parts`` is None) and writes ``delta``, rowsum(g * out) with g
    and out split as the kernels split g and V in dP = g V^T; without
    ``out``, both hold what an earlier call wrote."""
    ptrs, parts, common = _bwd_args(q, k, v, g, lse, delta, causal, parts, out)
    dq = torch.empty_like(q)
    rc = kernels.library("flash_bwd").dl4j_flash_bwd_dq(
        *ptrs, dq.data_ptr(), None if parts is None else parts.data_ptr(), *common)
    kernels.check_launch("flash_bwd_dq", rc)
    return dq


def launch_bwd_dkdv(q, k, v, g, lse, delta, causal: bool, parts=None, out=None):
    """Kernel B3 alone, as `launch_bwd_dq`: (dk, dv)."""
    ptrs, parts, common = _bwd_args(q, k, v, g, lse, delta, causal, parts, out)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = kernels.library("flash_bwd").dl4j_flash_bwd_dkdv(
        *ptrs, dk.data_ptr(), dv.data_ptr(), None if parts is None else parts.data_ptr(),
        *common)
    kernels.check_launch("flash_bwd_dkdv", rc)
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """(BH, T, D) q, k, v -> (out, lse), differentiable in q, k, v: the
    counterpart of `_flash_core`'s ``custom_vjp``.  lse is a residual,
    not an output anyone differentiates."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g.contiguous(),
                               causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = False):
    """FlashAttention over (B, T, H, D) tensors (the `mha` layout)."""
    b, t, h, d = q.shape

    def bhtd(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()

    out, _ = FlashAttention.apply(bhtd(q), bhtd(k), bhtd(v), causal)
    return out.reshape(b, h, t, d).permute(0, 2, 1, 3)


def flash_eligible(q, k, mask) -> bool:
    """Unmasked self-attention of one length, at a head dim and dtype
    the kernel is built for."""
    return (mask is None and q.shape[1] == k.shape[1]
            and q.shape[-1] in FLASH_HEAD_DIMS and q.dtype in _DTYPES)
