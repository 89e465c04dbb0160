"""The parts of `deeplearning4j_tpu/runtime/flags.py` the port honours:
sequence bucketing, the fit loops' prefetch depth and their step
watchdog.

The JAX package buckets time axes so that a compiled program is reused
across lengths.  PyTorch runs eagerly, but the bucket still decides the
prefill length and therefore how prompt K/V lands in pages, so the port
keeps the same rule.

`Environment.prefetch_depth` (``DL4J_TPU_PREFETCH_DEPTH``, default 2) is
how many batches the fit loops' `data.prefetch.PrefetchIterator` stages
ahead of the running step; 0 disables the wrap.

The fit's step watchdog (`runtime/watchdog.py`, made at fit entry):
``watchdog_enabled`` (``DL4J_TPU_WATCHDOG``, default on; off: no
watchdog is made), ``watchdog_floor_s`` (``DL4J_TPU_WATCHDOG_FLOOR``,
30) and ``watchdog_k`` (``DL4J_TPU_WATCHDOG_K``, 10): a step's deadline
is ``max(floor, k * the EWMA of recent step latency)``.

Data parallelism (`parallel/data_parallel.py`): ``zero``
(``DL4J_TPU_ZERO``, default 0) is the ZeRO stage `distribute` uses when
its `ParallelConfig` names none; ``auto_plan`` (``DL4J_TPU_AUTO_PLAN``)
makes a `distribute` without a config ask the planner
(`parallel/planner.py`) for one.

`environment()` is the
process's one `Environment`, read from the environment variables on
first use; tests set its fields directly.
"""

from __future__ import annotations

import dataclasses
import os
import threading


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


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
    # the fit's step watchdog: made at fit entry when enabled
    watchdog_enabled: bool = True
    watchdog_floor_s: float = 30.0
    watchdog_k: float = 10.0
    # distribute()'s ZeRO stage when its config names none (0, 1, 2)
    zero: int = 0
    # distribute() with no config asks the planner for one
    auto_plan: bool = False

    @staticmethod
    def from_env() -> "Environment":
        return Environment(
            prefetch_depth=int(os.environ.get("DL4J_TPU_PREFETCH_DEPTH", "2")),
            watchdog_enabled=_env_bool("DL4J_TPU_WATCHDOG", True),
            watchdog_floor_s=float(os.environ.get("DL4J_TPU_WATCHDOG_FLOOR", "30")),
            watchdog_k=float(os.environ.get("DL4J_TPU_WATCHDOG_K", "10")),
            zero=int(os.environ.get("DL4J_TPU_ZERO", "0")),
            auto_plan=_env_bool("DL4J_TPU_AUTO_PLAN"))


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
