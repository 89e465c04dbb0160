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
after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

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
        # q, k, v, g, lse, delta, dq, bh, t, d, causal, bf16, sm_scale, stream
        "dl4j_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _F, _P],
        # q, k, v, g, lse, delta, dk, dv, bh, t, d, causal, bf16, sm_scale,
        # stream
        "dl4j_flash_bwd_dkdv": [_P, _P, _P, _P, _P, _P, _P, _P,
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
    beside its library."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {stem: _lib_path(stem) for stem in SIGNATURES}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for stem, path in todo.items():
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp)
    errors = []
    for stem, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        paths[stem].with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            errors.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n"
                          + log.decode(errors="replace"))
            continue
        os.replace(tmp, paths[stem])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


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
    other device is an error.  The wrappers' only dispatch decision."""
    if device.type == "cpu":
        return "plain"
    if device.type == "cuda":
        return "kernel"
    raise ValueError(f"no kernel or plain version for device {device}")


def current_stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on
    ``device`` — kernels launch there and never synchronise."""
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, rc: int) -> None:
    """Raise on a non-zero ``cudaGetLastError`` from a launch, else count
    the launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    with _COUNT_LOCK:
        _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launches() -> dict[str, int]:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launches() -> None:
    with _COUNT_LOCK:
        _LAUNCHES.clear()
