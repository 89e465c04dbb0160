"""Quantization-aware ops the layer applies call — the counterpart of
`deeplearning4j_tpu/quant/functional.py`.

Each helper takes either a plain weight tensor (exactly the op the layer
ran before) or a `QuantizedTensor`, so a layer has one call site and no
branch on model state.  A quantized dense product goes to
`ops.dequant_matmul` (the B5 kernel on CUDA); a quantized embedding
gathers int8 rows and dequantizes only those, in f32.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.dequant_matmul import dequant_matmul
from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain or quantized weight; the quantized product
    accumulates in f32 and returns ``x.dtype``."""
    if isinstance(w, QuantizedTensor):
        return dequant_matmul(x.float().contiguous(), w.q, w.scale).to(x.dtype)
    return x @ w.to(x.dtype)


def conv_weight(w, dtype: torch.dtype) -> torch.Tensor:
    """Dense kernel for a conv: dequantized for a QuantizedTensor, cast
    otherwise."""
    if isinstance(w, QuantizedTensor):
        return w.dequant(dtype)
    return w.to(dtype)


def embedding_lookup(w, ids: torch.Tensor) -> torch.Tensor:
    """Row gather for a plain or quantized table; a quantized table
    gathers int8 rows and returns them dequantized in f32."""
    if isinstance(w, QuantizedTensor):
        return w.q[ids].float() * w.scale
    return w[ids]
