"""ctypes binding for the native IO runtime — the counterpart of
`deeplearning4j_tpu/runtime/native.py`, over the same C++ source
(``native/dl4jtpu_io.cpp``): CSV -> float32 matrices parsed by threads,
IDX (MNIST-family) decoding, uint8 -> float32 scaling, and JPEG batch
decode and resize through libjpeg.

The port builds its own library from that source with ``g++`` into
``build/native/`` of the checkout (listed in ``.gitignore``), under a
name that hashes the source and the flags, as `runtime/kernels.py` names
its kernel libraries: a later process in the same checkout reuses it,
an edited source rebuilds it.  Nothing is written under ``native/``
(the JAX package's ``make -C native`` writes its library there).  JPEG
decode compiles in, with ``-DDL4JTPU_WITH_JPEG -ljpeg``, exactly when
``jpeglib.h`` preprocesses, as ``native/Makefile`` decides.

A build that fails raises with the compiler's output.  Where there is
no compiler (or ``DL4JTPU_NO_NATIVE`` is set) the library is missing,
`available` is False and the callers take their numpy paths, as the JAX
package's do.  Nothing builds at import.

    from deeplearning4j_tpu_torch.runtime import native
    if native.available():
        arr = native.csv_read_f32("data.csv", skip_rows=1)
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = REPO_ROOT / "native" / "dl4jtpu_io.cpp"
ENV_DISABLE = "DL4JTPU_NO_NATIVE"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared"]
JPEG_FLAGS = ["-DDL4JTPU_WITH_JPEG"]
JPEG_LIBS = ["-ljpeg"]

log = logging.getLogger("deeplearning4j_tpu_torch")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def build_dir() -> Path:
    return REPO_ROOT / "build" / "native"


def compiler() -> Optional[str]:
    """The C++ compiler (``$CXX``, else ``g++``), or None when absent."""
    return shutil.which(os.environ.get("CXX", "g++"))


def jpeg_headers(cxx: str) -> bool:
    """Whether ``#include <jpeglib.h>`` preprocesses: ``native/Makefile``'s
    HAS_JPEG test."""
    proc = subprocess.run([cxx, "-E", "-x", "c++", "-"],
                          input=b"#include <jpeglib.h>\n",
                          stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return proc.returncode == 0


def build_command(cxx: str, out: Path, jpeg: bool) -> list[str]:
    return ([cxx, *CXX_FLAGS, *(JPEG_FLAGS if jpeg else []), "-o", str(out),
             str(SOURCE)] + (JPEG_LIBS if jpeg else []))


def library_path(cxx: str, jpeg: bool) -> Path:
    """``build/native/libdl4jtpu_io-<hash>.so``: the hash covers the
    source, the compiler and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(build_command(cxx, Path("out"), jpeg)).encode())
    return build_dir() / f"libdl4jtpu_io-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless an up-to-date one is there; its path.
    Raises with the compiler's output when the build fails, and when
    there is no compiler."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError(f"no C++ compiler ({os.environ.get('CXX', 'g++')}) "
                           "to build the native IO library")
    jpeg = jpeg_headers(cxx)
    path = library_path(cxx, jpeg)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    log.info("building the native IO library into %s (jpeg: %s)", path, jpeg)
    proc = subprocess.run(build_command(cxx, tmp, jpeg), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    path.with_suffix(".log").write_bytes(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed ({proc.returncode}):\n"
                           + proc.stdout.decode(errors="replace"))
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dl4jtpu_csv_read_f32.restype = ctypes.c_int
    lib.dl4jtpu_csv_read_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_long,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.c_int,
    ]
    lib.dl4jtpu_idx_read_u8.restype = ctypes.c_int
    lib.dl4jtpu_idx_read_u8.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int), ctypes.c_long * 4,
    ]
    lib.dl4jtpu_u8_to_f32_scaled.restype = None
    lib.dl4jtpu_u8_to_f32_scaled.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ]
    lib.dl4jtpu_free.restype = None
    lib.dl4jtpu_free.argtypes = [ctypes.c_void_p]
    lib.dl4jtpu_io_version.restype = ctypes.c_char_p
    lib.dl4jtpu_has_jpeg.restype = ctypes.c_int
    for name, elem in (("dl4jtpu_jpeg_batch", ctypes.c_float),
                       ("dl4jtpu_jpeg_batch_u8", ctypes.c_uint8)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(elem), ctypes.c_int]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None when disabled or
    when there is no compiler.  A failed build raises."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        if os.environ.get(ENV_DISABLE, "") not in ("", "0") or compiler() is None:
            _tried = True
            return None
        path = build()
        _tried = True
        _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    return lib


def available() -> bool:
    return _load() is not None


def version() -> Optional[str]:
    lib = _load()
    return lib.dl4jtpu_io_version().decode() if lib else None


def _n_threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def csv_read_f32(path: str, delimiter: str = ",", skip_rows: int = 0) -> np.ndarray:
    """Parse a numeric CSV into a float32 (rows, cols) array natively."""
    lib = _require()
    data = ctypes.POINTER(ctypes.c_float)()
    rows, cols = ctypes.c_long(), ctypes.c_long()
    rc = lib.dl4jtpu_csv_read_f32(
        str(path).encode(), delimiter.encode()[:1], skip_rows,
        ctypes.byref(data), ctypes.byref(rows), ctypes.byref(cols), _n_threads())
    if rc != 0:
        raise IOError(f"dl4jtpu_csv_read_f32({path}) failed rc={rc}")
    try:
        return np.ctypeslib.as_array(data, shape=(rows.value, cols.value)).copy()
    finally:
        lib.dl4jtpu_free(data)


def idx_read_u8(path: str) -> np.ndarray:
    """Decode an IDX file of unsigned bytes (MNIST images or labels)."""
    lib = _require()
    data = ctypes.POINTER(ctypes.c_uint8)()
    ndim = ctypes.c_int()
    dims = (ctypes.c_long * 4)()
    rc = lib.dl4jtpu_idx_read_u8(str(path).encode(), ctypes.byref(data),
                                 ctypes.byref(ndim), dims)
    if rc != 0:
        raise IOError(f"dl4jtpu_idx_read_u8({path}) failed rc={rc}")
    shape = tuple(dims[i] for i in range(ndim.value))
    try:
        return np.ctypeslib.as_array(data, shape=shape).copy()
    finally:
        lib.dl4jtpu_free(data)


def u8_to_f32_scaled(src: np.ndarray, scale: float = 1.0 / 255.0,
                     shift: float = 0.0) -> np.ndarray:
    """uint8 -> float32 * scale + shift (the image scaler's hot path)."""
    lib = _require()
    src = np.ascontiguousarray(src, dtype=np.uint8)
    dst = np.empty(src.shape, np.float32)
    lib.dl4jtpu_u8_to_f32_scaled(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.size, scale, shift, _n_threads())
    return dst


def has_jpeg() -> bool:
    """True when the library was compiled against libjpeg."""
    lib = _load()
    return bool(lib is not None and lib.dl4jtpu_has_jpeg())


def jpeg_batch_decode(paths, height: int, width: int, channels: int = 3,
                      n_threads: int = 0, dtype=np.float32) -> np.ndarray:
    """Decode and resize a batch of JPEG files natively to
    (n, height, width, channels) in 0..255: libjpeg's DCT-domain
    prescale, then a bilinear pass to the exact size.  Files that fail
    to decode come back zero-filled (a warning is logged).  ``dtype``
    float32 or uint8 (the wire format of the device decode: a quarter
    of the f32 bytes cross to the card)."""
    lib = _load()
    if lib is None or not has_jpeg():
        raise RuntimeError("native JPEG decode unavailable")
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.float32), np.dtype(np.uint8)):
        raise ValueError(f"jpeg_batch_decode dtype must be float32 or uint8, got {dtype}")
    paths = [str(p) for p in paths]
    n = len(paths)
    out = np.empty((n, height, width, channels), dtype)
    arr = (ctypes.c_char_p * n)(*(p.encode() for p in paths))
    if dtype == np.uint8:
        fn, elem = lib.dl4jtpu_jpeg_batch_u8, ctypes.c_uint8
    else:
        fn, elem = lib.dl4jtpu_jpeg_batch, ctypes.c_float
    fails = fn(arr, n, height, width, channels,
               out.ctypes.data_as(ctypes.POINTER(elem)), n_threads or _n_threads())
    if fails:
        log.warning("jpeg_batch_decode: %d/%d files failed (zero-filled)", fails, n)
    return out
