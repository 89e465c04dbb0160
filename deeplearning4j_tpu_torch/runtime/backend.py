"""Device resolution — the counterpart of `deeplearning4j_tpu/runtime/backend.py`.

The JAX package asks PJRT which platform it is on and keys its bf16
default and its kernel selection on ``backend().is_tpu``.  Here the
caller names the device.  ``"cuda"`` is the default everywhere; asking
for CUDA on a host without a CUDA device raises — a run that meant to
measure the card must never quietly measure the CPU instead.  Tests pass
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``None`` -> the default (CUDA).  Raises `RuntimeError` when CUDA
    is asked for and absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


@dataclasses.dataclass(frozen=True)
class Backend:
    """Identity and capabilities of one device."""

    platform: str                 # "gpu" | "cpu"
    device_kind: str              # e.g. "NVIDIA H100 80GB HBM3"
    num_devices: int
    capability: tuple             # (major, minor); (0, 0) on the CPU

    @property
    def is_cuda(self) -> bool:
        return self.platform == "gpu"

    @property
    def is_hopper(self) -> bool:
        return self.capability == (9, 0)

    @property
    def compute_dtype(self) -> torch.dtype:
        """bf16 on CUDA (tensor-core native), f32 on the CPU — where the
        JAX package picks bf16 on a TPU."""
        return torch.bfloat16 if self.is_cuda else torch.float32


def backend(device=None) -> Backend:
    dev = resolve_device(device)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        return Backend(
            platform="gpu",
            device_kind=torch.cuda.get_device_name(idx),
            num_devices=torch.cuda.device_count(),
            capability=tuple(torch.cuda.get_device_capability(idx)),
        )
    return Backend(platform="cpu", device_kind="cpu", num_devices=1,
                   capability=(0, 0))
