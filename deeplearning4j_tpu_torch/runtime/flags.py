"""Sequence bucketing — the part of `deeplearning4j_tpu/runtime/flags.py`
the serving slice needs.

The JAX package buckets time axes so that a compiled program is reused
across lengths.  PyTorch runs eagerly, but the bucket still decides the
prefill length and therefore how prompt K/V lands in pages, so the port
keeps the same rule.
"""

from __future__ import annotations

import os


def sequence_bucket_size() -> int:
    """Default bucketing quantum (``DL4J_TPU_SEQUENCE_BUCKET``, else 64)."""
    return int(os.environ.get("DL4J_TPU_SEQUENCE_BUCKET", "64"))


def bucket_length(length: int, quantum: int | None = None) -> int:
    """Round a sequence length UP to a multiple of the quantum
    (``None`` reads `sequence_bucket_size`)."""
    q = quantum if quantum is not None else sequence_bucket_size()
    if q <= 0:
        raise ValueError(f"bucket quantum must be positive, got {q}")
    n = max(1, int(length))
    return ((n + q - 1) // q) * q
