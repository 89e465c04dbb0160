"""QuantizedTensor — the `(int8 q, f32 scale)` weight pair of
`deeplearning4j_tpu/quant/qtensor.py`.

In the JAX package the pair is a pytree node; here it is a plain leaf
of the parameter tree.  A model holds its two tensors as buffers
(`models/sequential.py` `ParamTree`), and ``model.params`` hands the
pair back as a `QuantizedTensor`, so the tree keys match the JAX tree's.

Dequantization is ``q.to(dtype) * scale.to(dtype)`` with the scale
broadcast over the LAST axis, the output-channel axis of the (n_in,
n_out) dense and embedding layouts.  There is no ``astype`` alias: a
layer that forgets `quant.functional` fails instead of reading
unscaled integers.
"""

from __future__ import annotations

import numpy as np
import torch


class QuantizedTensor:
    """One quantized weight: ``q`` int8 of the original weight's shape and
    ``scale`` f32 of shape ``(q.shape[-1],)``; ``q * scale`` ~ the weight.
    The two may be torch tensors (a model's) or numpy arrays (a tree on
    the host, `convert.params_to_numpy`)."""

    __slots__ = ("q", "scale")

    def __init__(self, q, scale):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return len(self.q.shape)

    @property
    def dtype(self):
        """Storage dtype (int8)."""
        return self.q.dtype

    @property
    def nbytes(self) -> int:
        return int(self.q.nbytes) + int(self.scale.nbytes)

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        """The dense weight this pair stands for: cast, then scale, both
        in ``dtype``."""
        return self.q.to(dtype) * self.scale.to(dtype)

    def to(self, device) -> "QuantizedTensor":
        """The pair on ``device``.  A dtype is refused: ``dequant`` is the
        only way to a float weight."""
        if isinstance(device, torch.dtype):
            raise TypeError("QuantizedTensor.to takes a device; use "
                            "dequant(dtype) for a float weight")
        return QuantizedTensor(self.q.to(device), self.scale.to(device))

    def __repr__(self) -> str:
        return (f"QuantizedTensor(shape={self.shape}, "
                f"scale_shape={tuple(self.scale.shape)})")


def quantize_array(w, *, bits: int = 8) -> QuantizedTensor:
    """Symmetric per-output-channel int8 quantization of one weight, on
    the host in numpy, as the JAX package does it (bit for bit): the
    scale is ``max|w| / 127`` over all but the last axis, an all-zero
    channel gets scale 1.0, values round half to even (`np.round`) and
    clip to [-127, 127].  Returns CPU tensors."""
    if bits != 8:
        raise ValueError(f"only int8 supported (got bits={bits})")
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    a = np.asarray(w, dtype=np.float32)
    if a.ndim < 1:
        raise ValueError("cannot channel-quantize a scalar")
    qmax = 127.0
    amax = np.max(np.abs(a), axis=tuple(range(a.ndim - 1)))
    scale = amax / qmax
    scale = np.where(scale > 0.0, scale, 1.0).astype(np.float32)
    q = np.clip(np.round(a / scale), -qmax, qmax).astype(np.int8)
    return QuantizedTensor(torch.from_numpy(q), torch.from_numpy(scale))
