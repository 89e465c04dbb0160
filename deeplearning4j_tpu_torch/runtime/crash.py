"""Device OOM crash reporting — the port's copy of
`deeplearning4j_tpu/runtime/crash.py` (the `CrashReportingUtil` role).

On a CUDA out-of-memory error a model writes a report: the caching
allocator's ``torch.cuda.memory_stats()`` for each card and every live
CUDA tensor, largest first (shape, dtype, bytes; one row a storage) —
the counterpart of the JAX package's ``jax.live_arrays()`` table.  The
hang report a watchdog writes (`write_hang_report`) stays free of the
device runtime: the runtime is exactly what may be hung.

Report location: ``DL4JTPU_CRASH_DIR`` (default: cwd).
"""

from __future__ import annotations

import gc
import os
import time
from typing import Optional

ENV_CRASH_DIR = "DL4JTPU_CRASH_DIR"


def _live_buffer_table(limit: int = 60) -> tuple[list[str], int]:
    """Rows for the live CUDA tensors, largest storage first (a storage
    shared by several views counts once)."""
    import torch

    by_storage: dict = {}
    try:
        objs = gc.get_objects()
    except Exception:
        return ["  <live-tensor introspection unavailable>"], 0
    for o in objs:
        try:
            if not (isinstance(o, torch.Tensor) and o.is_cuda):
                continue
            st = o.untyped_storage()
            key = (st.device.index, st.data_ptr())
            if key not in by_storage:
                by_storage[key] = (st.nbytes(), o)
        except Exception:
            continue
    sized = sorted(by_storage.values(), key=lambda t: -t[0])
    total = sum(n for n, _ in sized)
    rows = []
    for nbytes, t in sized[:limit]:
        rows.append(f"  {nbytes/1e6:12.2f} MB  {str(t.dtype):>14}  "
                    f"{str(tuple(t.shape)):<24} {t.device}")
    if len(sized) > limit:
        rows.append(f"  ... and {len(sized) - limit} more storages")
    return rows, total


def write_memory_report(path: Optional[str] = None,
                        header: str = "") -> str:
    """Write the device-memory report; returns the file path."""
    import torch

    if path is None:
        d = os.environ.get(ENV_CRASH_DIR, ".")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"dl4jtpu-memory-report-{int(time.time())}.txt")

    lines = ["deeplearning4j_tpu_torch device memory report",
             f"time: {time.strftime('%Y-%m-%d %H:%M:%S')}", ""]
    if header:
        lines += [header, ""]
    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for i in range(n_dev):
        lines.append(f"device: cuda:{i} ({torch.cuda.get_device_name(i)})")
        try:
            stats = torch.cuda.memory_stats(i)
        except Exception:
            stats = {}
        for k in ("allocated_bytes.all.current", "allocated_bytes.all.peak",
                  "reserved_bytes.all.current", "num_alloc_retries",
                  "num_ooms"):
            if k in stats:
                lines.append(f"  {k}: {stats[k]:,}")
        lines.append("")
    rows, total = _live_buffer_table()
    lines.append(f"live CUDA tensors (largest first; {total/1e6:.1f} MB "
                 "total attributed):")
    lines.extend(rows)
    lines.append("")
    lines.append("hints: lower the batch size; fewer KV pages "
                 "(GenerationConfig.num_pages); use bf16_compute.")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def is_oom_error(exc: BaseException) -> bool:
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = str(exc)
    return "CUDA out of memory" in msg or "Out of memory" in msg


def maybe_write_oom_report(exc: BaseException) -> Optional[str]:
    """If exc looks like a device OOM, write the crash report and return its
    path (models re-raise the original error either way)."""
    if not is_oom_error(exc):
        return None
    try:
        return write_memory_report(
            header=f"TRIGGER: {type(exc).__name__}: {str(exc)[:2000]}"
        )
    except Exception:
        return None


import itertools as _itertools

_divergence_seq = _itertools.count()


def write_divergence_report(event: dict, path: Optional[str] = None) -> str:
    """Divergence report — the numeric-health analog of the OOM report.

    `observe.health.HealthListener` routes flagged events (NaN/Inf score,
    non-finite params, norm explosion) here: the structured event heads
    the same device-memory + live-buffer report an OOM produces, so the
    post-mortem has the params' residence and sizes next to the numbers
    that went bad.  Returns the report path.
    """
    import json

    if path is None:
        d = os.environ.get(ENV_CRASH_DIR, ".")
        os.makedirs(d, exist_ok=True)
        # timestamp + process-wide sequence: back-to-back events (the k
        # listener dispatches of a grouped program land in the same ms)
        # must not overwrite each other's reports
        path = os.path.join(
            d,
            f"dl4jtpu-divergence-report-{int(time.time() * 1000)}"
            f"-{next(_divergence_seq)}.txt",
        )
    header = "\n".join(
        ["DIVERGENCE EVENT (observe.health numeric monitor):"]
        + [f"  {k}: {v}" for k, v in sorted(event.items())]
        + ["", "event json: " + json.dumps(event, sort_keys=True)]
    )
    return write_memory_report(path, header=header)


_hang_seq = _itertools.count()


def write_hang_report(context: dict, path: Optional[str] = None) -> str:
    """Thread-stack dump for a wedged step (watchdog stage 2).

    Deliberately does NOT touch torch.cuda: the device runtime is
    exactly what may be hung, and a `memory_stats()` call could block
    the watchdog thread too.  Pure host introspection: every
    thread's current stack via `sys._current_frames`, names/daemon
    flags, plus the watchdog's context (iteration, armed seconds,
    deadline).  Returns the report path.
    """
    import json
    import sys
    import threading
    import traceback

    if path is None:
        d = os.environ.get(ENV_CRASH_DIR, ".")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d,
            f"dl4jtpu-hang-report-{int(time.time() * 1000)}"
            f"-{next(_hang_seq)}.txt",
        )
    by_ident = {t.ident: t for t in threading.enumerate()}
    lines = [
        "deeplearning4j_tpu_torch step-watchdog hang report",
        f"time: {time.strftime('%Y-%m-%d %H:%M:%S')}",
        "",
        "WATCHDOG EVENT:",
    ]
    lines += [f"  {k}: {v}" for k, v in sorted(context.items())]
    lines += ["", "event json: " + json.dumps(context, sort_keys=True,
                                              default=str), ""]
    frames = sys._current_frames()
    lines.append(f"threads ({len(frames)}):")
    for tid, frame in sorted(frames.items()):
        t = by_ident.get(tid)
        label = t.name if t is not None else "?"
        flags = " daemon" if (t is not None and t.daemon) else ""
        lines.append(f"-- thread {tid} ({label}{flags}):")
        for entry in traceback.format_stack(frame):
            lines.extend("  " + ln for ln in entry.rstrip().splitlines())
    lines.append("")
    lines.append(
        "hints: a stack inside a collective means a peer died mid-step "
        "(elastic respawn recovers); inside a synchronize or .cpu() "
        "means the device runtime stopped answering; inside queue.get "
        "means the input pipeline stalled."
    )
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


class oom_report_scope:
    """Context manager the models wrap their compiled-step invocation in: a
    device OOM escaping the scope gets the memory report written and a
    pointer to it chained onto the error."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is None:
            return False
        report = maybe_write_oom_report(exc)
        if report:
            raise RuntimeError(
                f"device OOM during fit step; memory report written to "
                f"{report}"
            ) from exc
        return False
