"""Fused dequant-matmul — the counterpart of
`deeplearning4j_tpu/ops/dequant_matmul.py`.

``y = x @ (q * scale)`` for f32 activations ``x`` (..., K) against int8
weights ``q`` (K, N) with per-output-channel f32 scales ``scale`` (N,),
accumulated in f32 and returned as f32 (..., N).

`dequant_matmul` is the kernel wrapper: on a CUDA tensor it launches
``csrc/dequant_matmul.cu`` (the int8 weights are converted to f32 on
chip and never written back as f32) or raises; on a CPU tensor it runs
`dequant_matmul_plain`, the JAX package's dequantize-then-dot reference
(`_xla_dequant_dot`).  The kernel takes any M, K and N: it masks the
ragged edge itself, so the Pallas tiling rule (`pallas_eligible`) has no
counterpart.  The JAX package's CPU ``blocked`` implementation, its
selection rule and its selection counter are not ported (ROADMAP A7).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.runtime import kernels


def dequant_matmul_plain(x, q, scale):
    """Dequantize-then-dot in f32: ``x.float() @ (q.float() * scale)``."""
    return x.float() @ (q.float() * scale.float())


def _check(x, q, scale) -> None:
    if q.dim() != 2 or q.dtype != torch.int8:
        raise TypeError(f"q must be (K, N) int8, got {tuple(q.shape)} {q.dtype}")
    k, n = q.shape
    if scale.shape != (n,) or scale.dtype != torch.float32:
        raise TypeError(f"scale must be ({n},) f32, got {tuple(scale.shape)} "
                        f"{scale.dtype}")
    if x.dim() < 1 or x.shape[-1] != k:
        raise ValueError(f"x must be (..., {k}) to meet q {tuple(q.shape)}; got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be f32, got {x.dtype}")
    if not (x.device == q.device == scale.device):
        raise ValueError("dequant_matmul: x, q, scale on different devices")


def dequant_matmul(x, q, scale):
    """(..., K) f32 @ dequant((K, N) int8, (N,) f32) -> (..., N) f32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check(x, q, scale)
    if kernels.route(x.device) == "plain":
        return dequant_matmul_plain(x, q, scale)
    *lead, k = x.shape
    y = _dequant_matmul_kernel(x.reshape(-1, k), q, scale)
    return y.reshape(*lead, q.shape[1])


def _dequant_matmul_kernel(x2, q, scale):
    if not (x2.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("dequant_matmul: inputs must be contiguous")
    m, k = x2.shape
    n = q.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if m == 0 or n == 0:
        return y
    if -(-m // 128) > 65535:
        raise ValueError(f"dequant_matmul: {m} rows exceed the grid's 65535 tiles")
    rc = kernels.library("dequant_matmul").dl4j_dequant_matmul(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), m, n, k,
        kernels.current_stream(x2.device))
    kernels.check_launch("dequant_matmul", rc)
    return y
