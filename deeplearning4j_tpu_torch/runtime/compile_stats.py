"""Compile-tax instrumentation — the port's copy of
`deeplearning4j_tpu/runtime/compile_stats.py`, counting what the port
really compiles.

The JAX package counts XLA's traces, compiles and persistent-cache
traffic from ``jax.monitoring`` events.  The port compiles two things,
and the same fields count them, so the ``dl4jtpu_compile_*`` families
read the same:

- ``jit_cache_misses``: CUDA-graph captures (`runtime/graphs.py`
  `CapturedProgram`), the port's one-per-shape program build — the
  generation engine's decode and verify steps, again after a hot-swap or
  a training step changed the weights they read;
- ``backend_compiles``: kernel-library requests of `runtime/kernels.py`
  `build_all`, one per ``csrc/*.cu`` source: an ``nvcc`` run, or a
  library found up to date on disk (as an XLA compile request counts
  cache retrievals);
- ``compile_secs``: the seconds of those ``nvcc`` runs, each process's
  own wall (they run together, so the sum exceeds the build's wall);
- ``persistent_cache_hits``: a library found up to date in
  ``build/torch_kernels/``;
- ``persistent_cache_puts``: a library written there;
- ``compile_secs_saved``: the ``nvcc`` seconds recorded beside a
  library when it was built, summed over the libraries found up to date.

So ``fresh_backend_compiles`` (requests less hits) is the number of
``nvcc`` runs, and a second process in a warm checkout shows 0 there.
The port does not use ``torch.compile``, so there is nothing of it to
count.

    before = compile_stats.snapshot()
    engine.generate(prompt, 16)
    spent = compile_stats.snapshot() - before
    print(spent.jit_cache_misses, spent.fresh_backend_compiles)

`observe.metrics` bridges every field into the ``dl4jtpu_compile_*``
families at scrape time (`_compile_stats_collector`).
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass(frozen=True)
class CompileStats:
    """Immutable counter snapshot; subtract two for a window's delta."""

    jit_cache_misses: int = 0      # CUDA-graph captures
    backend_compiles: int = 0      # kernel-library requests (incl. hits)
    compile_secs: float = 0.0      # seconds of nvcc runs
    persistent_cache_hits: int = 0  # libraries found up to date
    persistent_cache_puts: int = 0  # libraries written
    compile_secs_saved: float = 0.0  # recorded nvcc seconds of the hits

    @property
    def fresh_backend_compiles(self) -> int:
        """Requests NOT served by an up-to-date library: the ``nvcc``
        runs.  A second process in a warm checkout shows 0 here."""
        return self.backend_compiles - self.persistent_cache_hits

    def __sub__(self, other: "CompileStats") -> "CompileStats":
        return CompileStats(
            jit_cache_misses=self.jit_cache_misses - other.jit_cache_misses,
            backend_compiles=self.backend_compiles - other.backend_compiles,
            compile_secs=self.compile_secs - other.compile_secs,
            persistent_cache_hits=(
                self.persistent_cache_hits - other.persistent_cache_hits
            ),
            persistent_cache_puts=(
                self.persistent_cache_puts - other.persistent_cache_puts
            ),
            compile_secs_saved=(
                self.compile_secs_saved - other.compile_secs_saved
            ),
        )

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fresh_backend_compiles"] = self.fresh_backend_compiles
        d["compile_secs"] = round(d["compile_secs"], 4)
        d["compile_secs_saved"] = round(d["compile_secs_saved"], 4)
        return d


_lock = threading.Lock()
_counts = {
    "captures": 0,
    "requests": 0,
    "compile_secs": 0.0,
    "hits": 0,
    "puts": 0,
    "saved_secs": 0.0,
}


def note_capture() -> None:
    """One CUDA graph captured (`CapturedProgram`)."""
    with _lock:
        _counts["captures"] += 1


def note_build(secs: float) -> None:
    """One ``nvcc`` run that wrote its library after ``secs`` seconds."""
    with _lock:
        _counts["requests"] += 1
        _counts["compile_secs"] += max(0.0, float(secs))
        _counts["puts"] += 1


def note_hit(saved_secs: float) -> None:
    """One library found up to date; ``saved_secs`` is the ``nvcc`` time
    recorded when it was built (0 when none was recorded)."""
    with _lock:
        _counts["requests"] += 1
        _counts["hits"] += 1
        _counts["saved_secs"] += max(0.0, float(saved_secs))


def snapshot() -> CompileStats:
    """Current process-global counters."""
    with _lock:
        return CompileStats(
            jit_cache_misses=_counts["captures"],
            backend_compiles=_counts["requests"],
            compile_secs=_counts["compile_secs"],
            persistent_cache_hits=_counts["hits"],
            persistent_cache_puts=_counts["puts"],
            compile_secs_saved=_counts["saved_secs"],
        )
