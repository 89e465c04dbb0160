"""The network-entry dtype rule of `deeplearning4j_tpu/models/_cast.py`.

Image batches may cross to the device as uint8 bytes (a quarter of the
f32 bytes); the cast to the compute dtype happens on the device, inside
the step.  Token ids pass through untouched.
"""

from __future__ import annotations

import torch


def entry_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A network input in the compute ``dtype``: float inputs follow it;
    uint8 inputs are image bytes, cast value for value (0..255 stays
    0..255: normalisation happened before); wider integers (int32 /
    int64 token ids) pass through."""
    if x.is_floating_point() or x.dtype == torch.uint8:
        return x.to(dtype)
    return x
