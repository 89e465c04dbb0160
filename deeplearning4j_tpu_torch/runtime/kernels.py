"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
its own ``nvcc`` process into a shared library that `ctypes` loads —
no PyTorch headers, so a build takes seconds, not the minutes a
``torch/extension.h`` translation unit costs.  All sources are built
together, in parallel, the first time any kernel is asked for; the
libraries land in ``build/torch_kernels/`` of the checkout (listed in
``.gitignore``) under a name that hashes the source, the headers it
includes (``csrc/*.cuh``) and the flags, so a later process in the same
checkout reuses them and an edited header rebuilds every library that
includes it.

Nothing here runs at import: a CPU-only host has no ``nvcc``, and its
tests import every module.

Launch counters: every kernel wrapper calls `check_launch` right after
its kernel launched, and nowhere else, so a run can prove that its main
path went through the kernels (`reset_launches` before, `launches`
after).  A CUDA graph capture enqueues kernels without running them:
inside `holding_launches` this thread's launches are held, not counted,
and every replay of the graph counts them (`count_replay`), so the
counters still say how many times each kernel ran.

Work counters: a ctypes launch is no torch op, so no torch operation
counter sees it.  Each wrapper runs inside `kernel_call`, with a
function of its shapes that says what its kernels compute (FLOPs, and
bytes: each input read once, each output written once; the wrappers'
``*_work`` functions, which `chip_smoke.py`'s bound column calls too).
Inside a counting scope (`observe/cost.py`) those are summed per
kernel, and `in_kernel_call` tells the scope's op counter to leave out
the torch ops a wrapper runs (its plain version on the CPU), so a
program counts the same on both devices.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from deeplearning4j_tpu_torch.runtime import compile_stats

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]

NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v", "-lineinfo",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: source stem -> {exported C function: argtypes}; every function
#: returns the cudaError_t of its launch as an int (0 = success)
SIGNATURES = {
    "flash_fwd": {
        # q, k, v, out, lse, parts, bh, t, d, causal, bf16, sm_scale, stream
        "dl4j_flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    },
    "flash_bwd": {
        # q, k, v, g, out, lse, delta, dq, parts, bh, t, d, causal, bf16,
        # sm_scale, stream
        "dl4j_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _F, _P],
        # q, k, v, g, out, lse, delta, dk, dv, parts, bh, t, d, causal, bf16,
        # sm_scale, stream
        "dl4j_flash_bwd_dkdv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _F, _P],
    },
    "paged_attention": {
        # q, k_pages, v_pages, k_scale, v_scale, page_tbl, seq_lens, out,
        # ws, tickets, slots, heads, head_dim, num_pages, page_size,
        # max_pages, head_group, pages_per_chunk, int8, sm_scale, stream
        "dl4j_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    },
    "dequant_matmul": {
        # x, q, scale, y, x_parts, partial, m, n, k, route, splits, stream
        "dl4j_dequant_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
}

_BUILD_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()
_LAUNCHES: dict[str, int] = {}


def build_dir() -> Path:
    return REPO_ROOT / "build" / "torch_kernels"


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built where the CUDA toolkit is installed")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def sources(stem: str) -> list[Path]:
    """``csrc/<stem>.cu`` and every header it includes with quotes,
    recursively, each once."""
    found: list[Path] = []

    def visit(path: Path) -> None:
        if path in found:
            return
        found.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            visit(path.parent / name.decode())

    visit(CSRC / f"{stem}.cu")
    return found


def _lib_path(stem: str) -> Path:
    """The library's name hashes its source, every header the source
    includes, and the flags: an edited header rebuilds its users."""
    h = hashlib.sha256()
    for path in sources(stem):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all started together.  Raises with the compiler's output
    on failure; writes each compiler log (ptxas register / spill report)
    and the run's seconds beside its library.  Every source counts in
    `compile_stats`: an ``nvcc`` run with its seconds, or an up-to-date
    library with the seconds recorded when it was built."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {stem: _lib_path(stem) for stem in SIGNATURES}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    for stem, path in paths.items():
        if stem not in todo:
            compile_stats.note_hit(_recorded_secs(path))
    if not todo:
        return paths
    nvcc = nvcc_path()

    def run(stem: str, path: Path):
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        return proc, tmp, time.perf_counter() - t0

    with ThreadPoolExecutor(len(todo)) as pool:
        runs = {s: pool.submit(run, s, p) for s, p in todo.items()}
        results = {s: f.result() for s, f in runs.items()}
    errors = []
    for stem, (proc, tmp, secs) in results.items():
        paths[stem].with_suffix(".log").write_bytes(proc.stdout)
        if proc.returncode != 0:
            errors.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n"
                          + proc.stdout.decode(errors="replace"))
            continue
        paths[stem].with_suffix(".secs").write_text(f"{secs:.6f}\n")
        os.replace(tmp, paths[stem])
        compile_stats.note_build(secs)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def _recorded_secs(path: Path) -> float:
    """The ``nvcc`` seconds written beside a library when it was built
    (0.0 for a library built without the record)."""
    try:
        return float(path.with_suffix(".secs").read_text())
    except (OSError, ValueError):
        return 0.0


def library(stem: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<stem>.cu`` (builds all on first use)."""
    lib = _LIBS.get(stem)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        if stem not in _LIBS:
            paths = build_all()
            for s, p in paths.items():
                cdll = ctypes.CDLL(str(p))
                for fn, argtypes in SIGNATURES[s].items():
                    f = getattr(cdll, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                _LIBS[s] = cdll
        return _LIBS[stem]


def route(device: torch.device) -> str:
    """``"plain"`` for a CPU tensor, ``"kernel"`` for a CUDA one; any
    other device is an error.  The wrappers' only choice between a
    kernel and its plain version.  Under a `FakeTensorMode` (an abstract
    run: `observe/cost.py` `analyze_signature`, the pipeline planner's
    probe) the tensors hold no data and nothing launches: the plain
    version computes their shapes."""
    if device.type == "cpu" or _abstract():
        return "plain"
    if device.type == "cuda":
        return "kernel"
    raise ValueError(f"no kernel or plain version for device {device}")


def _abstract() -> bool:
    """A `FakeTensorMode` is on this thread's dispatch mode stack."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    return any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack())


def current_stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on
    ``device`` — kernels launch there and never synchronise."""
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, rc: int) -> None:
    """Raise on a non-zero ``cudaGetLastError`` from a launch, else count
    the launch (or hold it, inside `holding_launches`)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    held = getattr(_HOLD, "launches", None)
    if held is None and _HOLD_BY_STREAM:
        # a backward runs in autograd's device thread, on the stream of
        # its forward: a launch there during a capture is held too
        held = _HOLD_BY_STREAM.get(torch.cuda.current_stream().cuda_stream)
    if held is not None:
        with _COUNT_LOCK:
            held[name] = held.get(name, 0) + 1
        return
    with _COUNT_LOCK:
        _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


_HOLD = threading.local()
#: capture stream -> the held dict of the capture running on it
_HOLD_BY_STREAM: dict = {}


@contextlib.contextmanager
def holding_launches(stream: int | None = None):
    """Launches this thread makes inside the block go into the yielded
    dict instead of the counters: a graph capture enqueues kernels that
    do not run until the graph replays.  With ``stream`` (the capture
    stream's raw handle), launches any other thread makes on that
    stream meanwhile are held as well: autograd runs a captured step's
    backward in its own thread."""
    if getattr(_HOLD, "launches", None) is not None:
        raise RuntimeError("holding_launches does not nest")
    _HOLD.launches = held = {}
    if stream is not None:
        _HOLD_BY_STREAM[stream] = held
    try:
        yield held
    finally:
        _HOLD.launches = None
        if stream is not None:
            _HOLD_BY_STREAM.pop(stream, None)


def count_replay(held: dict) -> None:
    """Count the launches a captured graph holds: it ran them once."""
    with _COUNT_LOCK:
        for name, n in held.items():
            _LAUNCHES[name] = _LAUNCHES.get(name, 0) + n


_WORK = threading.local()


def _work_sums():
    """The ``kernel_work`` dict of the innermost active torch dispatch
    mode that keeps one (the counting scope of `observe/cost.py`), or
    None.  The mode stack, unlike a Python thread-local, follows a
    backward into autograd's device threads."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        work = getattr(mode, "kernel_work", None)
        if work is not None:
            return work
    return None


@contextlib.contextmanager
def kernel_call(work):
    """One wrapper call.  Inside a counting scope, ``work()`` — a list of
    ``(kernel name, flops, bytes)`` from the call's shapes — is added to
    the scope's ``name -> [calls, flops, bytes]`` sums, and
    `in_kernel_call` is true for the block.  Outside one, nothing runs
    but the stack lookup."""
    if getattr(_WORK, "inside", False):
        yield
        return
    acc = _work_sums()
    if acc is None:
        yield
        return
    for name, flops, nbytes in work():
        rec = acc.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += float(flops)
        rec[2] += float(nbytes)
    _WORK.inside = True
    try:
        yield
    finally:
        _WORK.inside = False


def in_kernel_call() -> bool:
    """True inside a counted wrapper call (see `kernel_call`)."""
    return getattr(_WORK, "inside", False)


def launches() -> dict[str, int]:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launches() -> None:
    with _COUNT_LOCK:
        _LAUNCHES.clear()
