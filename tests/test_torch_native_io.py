"""The port's native IO runtime (`deeplearning4j_tpu_torch/runtime/native.py`)
against the JAX package's (`deeplearning4j_tpu/runtime/native.py`), both
over ``native/dl4jtpu_io.cpp``, on the same files.

- The port builds its own library with ``g++`` into ``build/native/``
  (a name that hashes the source and the flags; ``-DDL4JTPU_WITH_JPEG
  -ljpeg`` exactly when ``jpeglib.h`` preprocesses) and writes nothing
  under ``native/``; a failed build raises with the compiler's output;
  without a compiler the library is missing and the callers take their
  numpy paths, with the same values.
- CSV, IDX, the uint8 scaler and the JPEG batch decode (float32 and
  uint8) give the JAX package's arrays bit for bit, and their errors
  where it raises; the JPEG cases skip where ``jpeglib.h`` is absent.
- The callers: `data.builtin`'s IDX reader and uint8 scaler,
  `ImagePreProcessingScaler` and `datavec.load_numeric_csv`.
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from deeplearning4j_tpu.data import builtin as jax_builtin
from deeplearning4j_tpu.data import normalizers as jax_norm
from deeplearning4j_tpu.data.dataset import DataSet as JDS
from deeplearning4j_tpu.datavec import load_numeric_csv as jax_load_csv
from deeplearning4j_tpu.runtime import native as jax_native
from deeplearning4j_tpu_torch.data import builtin, normalizers
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.datavec import load_numeric_csv
from deeplearning4j_tpu_torch.runtime import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "native")
HAS_CXX = native.compiler() is not None
JPEG = HAS_CXX and native.jpeg_headers(native.compiler())

needs_cxx = pytest.mark.skipif(not HAS_CXX, reason="no C++ compiler on this host")
needs_jpeg = pytest.mark.skipif(not JPEG, reason="no jpeglib.h on this host")


def _native_listing():
    """native/'s files with their sizes and modification times."""
    out = {}
    for name in sorted(os.listdir(NATIVE_DIR)):
        st = os.stat(os.path.join(NATIVE_DIR, name))
        out[name] = (st.st_size, st.st_mtime_ns)
    return out


def _write_idx(path, arr):
    with open(path, "wb") as f:
        f.write(struct.pack(">BBBB", 0, 0, 8, arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.fixture
def jpeg_dir(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for cls in ("cat", "dog"):
        d = tmp_path / cls
        d.mkdir()
        for i in range(5):
            img = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
            img[:30] = (30 + 40 * i, 80, 160)
            Image.fromarray(img).save(d / f"{i}.jpg", quality=90)
    return tmp_path


@needs_cxx
def test_build_lands_in_build_native_and_writes_nothing_under_native(tmp_path, monkeypatch):
    before = _native_listing()
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "native_build")
    path = native.build()
    assert path.parent == tmp_path / "native_build" and path.exists()
    assert path.name.startswith("libdl4jtpu_io-") and path.suffix == ".so"
    assert len(path.stem.split("-")[1]) == 16
    assert native.build() == path                    # up to date: reused
    cmd = native.build_command(native.compiler(), path, JPEG)
    assert ("-DDL4JTPU_WITH_JPEG" in cmd) == JPEG and ("-ljpeg" in cmd) == JPEG
    assert (native.library_path(native.compiler(), True)
            != native.library_path(native.compiler(), False))
    # the library the package loads lives under build/native of the checkout
    assert native.available()
    assert _native_listing() == before


@needs_cxx
def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "dl4jtpu_io.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "out")
    with pytest.raises(RuntimeError, match="failed") as e:
        native.build()
    assert "error" in str(e.value)
    assert not list((tmp_path / "out").glob("*.so"))


def test_without_a_compiler_the_callers_take_numpy(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", "no-such-compiler-dl4j")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.compiler() is None and not native.available()
    assert not native.has_jpeg()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.u8_to_f32_scaled(np.zeros(3, np.uint8))
    x = np.random.default_rng(1).integers(0, 256, (4, 7, 7, 1)).astype(np.uint8)
    got = builtin._u8_scale(x, 1 / 255.0, -0.5)
    want = jax_native.u8_to_f32_scaled(x, 1 / 255.0, -0.5)
    assert np.array_equal(got, want)
    arr = np.random.default_rng(2).integers(0, 256, (5, 6, 7)).astype(np.uint8)
    _write_idx(tmp_path / "x.idx", arr)
    assert np.array_equal(builtin._read_idx(tmp_path / "x.idx"), arr)
    monkeypatch.setenv("DL4JTPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("CXX")
    assert not native.available()


@needs_cxx
@pytest.mark.parametrize("case", ["plain", "header", "semicolon", "naninf"])
def test_csv_matches_jax(case, tmp_path):
    p = tmp_path / "m.csv"
    rng = np.random.default_rng(9)
    kw = {}
    if case in ("plain", "header"):
        m = rng.normal(0, 100, (300, 5)).astype(np.float32)
        np.savetxt(p, m, delimiter=",", fmt="%.6f",
                   header="a,b,c,d,e" if case == "header" else "", comments="")
        if case == "header":
            kw = {"skip_rows": 1}
        elif p.read_text().startswith("\n"):
            p.write_text(p.read_text()[1:])
    elif case == "semicolon":
        p.write_text("1;2;3\n4;5;6\n-7.25;8e3;9\n")
        kw = {"delimiter": ";"}
    else:
        p.write_text("1,nan,inf\n2,-inf,3\n")
    got = native.csv_read_f32(str(p), **kw)
    want = jax_native.csv_read_f32(str(p), **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


@needs_cxx
@pytest.mark.parametrize("text", ["1,2,3\n4,5\n", "1,2\n3,4,5\n", "1,NA,3\n", "1,,3\n"])
def test_bad_csv_raises_as_jax(text, tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text(text)
    with pytest.raises(IOError, match="rc="):
        jax_native.csv_read_f32(str(p))
    with pytest.raises(IOError, match="rc="):
        native.csv_read_f32(str(p))
    with pytest.raises(IOError):
        native.csv_read_f32(str(tmp_path / "missing.csv"))


@needs_cxx
def test_load_numeric_csv_matches_jax(tmp_path):
    m = np.random.default_rng(3).normal(0, 1, (50, 3)).astype(np.float32)
    p = tmp_path / "m.csv"
    np.savetxt(p, m, delimiter=",", fmt="%.6f")
    assert np.array_equal(load_numeric_csv(p), jax_load_csv(p))


@needs_cxx
@pytest.mark.parametrize("shape", [(7,), (6, 28, 28), (3, 4, 5, 2)])
def test_idx_matches_jax_and_the_builtin_reader(shape, tmp_path):
    arr = np.random.default_rng(4).integers(0, 256, shape).astype(np.uint8)
    p = tmp_path / "a.idx"
    _write_idx(p, arr)
    got = native.idx_read_u8(str(p))
    assert got.dtype == np.uint8 and np.array_equal(got, arr)
    assert np.array_equal(got, jax_native.idx_read_u8(str(p)))
    assert np.array_equal(builtin._read_idx(p), jax_builtin._read_idx(p))


@needs_cxx
def test_corrupt_idx_raises(tmp_path):
    p = tmp_path / "huge.idx"
    with open(p, "wb") as f:
        f.write(struct.pack(">BBBB", 0, 0, 8, 4))
        for _ in range(4):
            f.write(struct.pack(">i", 65536))
    with pytest.raises(IOError):
        native.idx_read_u8(str(p))
    q = tmp_path / "magic.idx"
    q.write_bytes(b"\x01\x02\x03\x04" + b"\x00" * 8)
    with pytest.raises(IOError):
        native.idx_read_u8(str(q))


@needs_cxx
@pytest.mark.parametrize("scale,shift", [(1 / 255.0, 0.0), (1 / 255.0, -0.5),
                                         (2 / 255.0, -1.0), (1 / 127.5, -1.0)])
def test_u8_scale_matches_jax_and_numpy(scale, shift):
    x = np.random.default_rng(5).integers(0, 256, (4, 28, 28, 1)).astype(np.uint8)
    got = native.u8_to_f32_scaled(x, scale, shift)
    assert np.array_equal(got, jax_native.u8_to_f32_scaled(x, scale, shift))
    assert np.array_equal(got, x.astype(np.float32) * np.float32(scale) + np.float32(shift))
    assert np.array_equal(builtin._u8_scale(x, scale, shift), got)


@needs_cxx
def test_image_scaler_native_path_matches_jax():
    x = np.random.default_rng(6).integers(0, 256, (4, 8, 8, 1)).astype(np.uint8)
    y = np.zeros((4, 2), np.float32)
    got = normalizers.ImagePreProcessingScaler(-1.0, 1.0).transform(DataSet(x, y))
    want = jax_norm.ImagePreProcessingScaler(-1.0, 1.0).transform(JDS(x, y))
    assert np.array_equal(got.features, want.features)


@needs_jpeg
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_jpeg_batch_decode_matches_jax(jpeg_dir, dtype):
    assert native.has_jpeg() and jax_native.has_jpeg()
    paths = sorted(jpeg_dir.rglob("*.jpg"))
    got = native.jpeg_batch_decode(paths, 24, 32, 3, dtype=dtype)
    want = jax_native.jpeg_batch_decode(paths, 24, 32, 3, dtype=dtype)
    assert got.dtype == np.dtype(dtype) and got.shape == (10, 24, 32, 3)
    assert np.array_equal(got, want)
    gray = native.jpeg_batch_decode(paths[:2], 16, 16, 1, n_threads=1, dtype=dtype)
    assert np.array_equal(gray, jax_native.jpeg_batch_decode(paths[:2], 16, 16, 1,
                                                             n_threads=1, dtype=dtype))


@needs_jpeg
def test_jpeg_failures_zero_fill_and_bad_dtype_raises(tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg at all")
    out = native.jpeg_batch_decode([bad], 16, 16, 3)
    assert out.shape == (1, 16, 16, 3) and (out == 0).all()
    with pytest.raises(ValueError, match="float32 or uint8"):
        native.jpeg_batch_decode([bad], 16, 16, 3, dtype=np.int16)


def test_importing_the_binding_builds_nothing(tmp_path):
    """A fresh interpreter that imports the binding (as the tests import
    every module) runs no compiler and writes no library."""
    script = ("import deeplearning4j_tpu_torch.runtime.native as n, sys;"
              "print(n._lib is None and not n._tried)")
    env = dict(os.environ, CXX=str(tmp_path / "compiler-that-logs"))
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"
