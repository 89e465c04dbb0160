"""Int8 post-training quantization for the inference path — the
counterpart of `deeplearning4j_tpu/quant/`.

`quantize(model)` rewrites a built model's matmul and embedding weights
into `(int8 q, f32 scale)` pairs (`QuantizedTensor`): symmetric
per-output-channel scales, f32 accumulation at apply time.  Every
quantized dense product goes through `ops.dequant_matmul.dequant_matmul`:
the hand-written kernel ``csrc/dequant_matmul.cu`` on a CUDA tensor, its
plain dequantize-then-dot version on a CPU tensor.

Post-training and inference-only: `quantize()` drops the optimizer
state; keep the f32 model if you intend to keep training.
"""

from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor
from deeplearning4j_tpu_torch.quant.ptq import (
    SCHEME,
    dequantize_tree,
    is_quantized,
    parity_check,
    quantize,
    quantized_bytes,
    requantize_structure,
)

__all__ = [
    "QuantizedTensor",
    "SCHEME",
    "dequantize_tree",
    "is_quantized",
    "parity_check",
    "quantize",
    "quantized_bytes",
    "requantize_structure",
]
