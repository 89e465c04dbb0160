"""The parts of `deeplearning4j_tpu/runtime/flags.py` the port honours:
sequence bucketing and the fit loops' prefetch depth.

The JAX package buckets time axes so that a compiled program is reused
across lengths.  PyTorch runs eagerly, but the bucket still decides the
prefill length and therefore how prompt K/V lands in pages, so the port
keeps the same rule.

`Environment.prefetch_depth` (``DL4J_TPU_PREFETCH_DEPTH``, default 2) is
how many batches the fit loops' `data.prefetch.PrefetchIterator` stages
ahead of the running step; 0 disables the wrap.  `environment()` is the
process's one `Environment`, read from the environment variables on
first use; tests set its fields directly.
"""

from __future__ import annotations

import dataclasses
import os
import threading


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


@dataclasses.dataclass
class Environment:
    """Run-wide settings (the JAX package's `Environment`, the fields the
    port reads)."""

    # batches the fit loops stage ahead of the running step; 0: none
    prefetch_depth: int = 2

    @staticmethod
    def from_env() -> "Environment":
        return Environment(
            prefetch_depth=int(os.environ.get("DL4J_TPU_PREFETCH_DEPTH", "2")))


_ENV: Environment | None = None
_ENV_LOCK = threading.Lock()


def environment() -> Environment:
    """The process's `Environment` (made from the environment variables
    on first use)."""
    global _ENV
    with _ENV_LOCK:
        if _ENV is None:
            _ENV = Environment.from_env()
        return _ENV
