"""Built-in dataset iterators — `deeplearning4j_tpu/data/builtin.py`
(the MnistDataSetIterator / CifarDataSetIterator role), in numpy.

The reference downloads MNIST / CIFAR on first use.  Nothing here
downloads: each built-in first looks for local copies (IDX or npz files
under ``$DL4J_TPU_DATA_DIR`` or ``./data``) and otherwise renders a
deterministic procedural dataset of the same shape from its seed, byte
for byte the JAX package's: digit glyphs from a 5x7 font with random
scale, erosion, shift, intensity and noise; CIFAR-shaped class-
conditional gradients and patches.  The JAX package also searches
``~/.dl4j_tpu``; the port reads nothing outside the paths it is given.
IDX files decode, and uint8 images scale, through the native IO runtime
(`runtime/native.py`) where it is built, else in numpy: the same
values either way.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import DataSetIterator

# 5x7 digit glyphs (classic font), 1 bit per pixel, row-major top-down.
_DIGIT_GLYPHS = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _data_dirs() -> list[Path]:
    dirs = []
    if os.environ.get("DL4J_TPU_DATA_DIR"):
        dirs.append(Path(os.environ["DL4J_TPU_DATA_DIR"]))
    dirs.append(Path("./data"))
    return dirs


def _read_idx(path: Path) -> np.ndarray:
    if path.suffix != ".gz":
        # the native decoder when built; ungzipped files only
        from deeplearning4j_tpu_torch.runtime import native

        if native.available():
            try:
                return native.idx_read_u8(str(path))
            except (IOError, RuntimeError):
                pass                      # the numpy path below
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _u8_scale(x: np.ndarray, scale: float = 1.0 / 255.0,
              shift: float = 0.0) -> np.ndarray:
    """uint8 -> float32 * scale + shift, natively when built."""
    from deeplearning4j_tpu_torch.runtime import native

    if x.dtype == np.uint8 and native.available():
        try:
            return native.u8_to_f32_scaled(x, scale, shift)
        except (IOError, RuntimeError):
            pass
    return x.astype(np.float32) * scale + shift


def _find_mnist() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None:
    names = [
        ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
         "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    ]
    for d in _data_dirs():
        for base in (d, d / "mnist", d / "MNIST"):
            for quad in names:
                paths = []
                ok = True
                for n in quad:
                    found = None
                    for cand in (base / n, base / (n + ".gz")):
                        if cand.exists():
                            found = cand
                            break
                    if found is None:
                        ok = False
                        break
                    paths.append(found)
                if ok:
                    xi, yi, xt, yt = (_read_idx(p) for p in paths)
                    return xi, yi, xt, yt
    return None


def synthetic_mnist(
    n: int, seed: int = 0, image_size: int = 28
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-like digits: glyph + shift + scale + noise.

    Returns (images [n, s, s, 1] float32 in [0,1], labels int [n]).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    glyphs = np.zeros((10, 7, 5), np.float32)
    for d, rows in _DIGIT_GLYPHS.items():
        glyphs[d] = np.array([[int(c) for c in r] for r in rows], np.float32)
    images = np.zeros((n, image_size, image_size, 1), np.float32)
    for i, lab in enumerate(labels):
        g = glyphs[lab]
        # upscale by a per-example factor (2..3) with nearest neighbor
        scale = rng.integers(2, 4)
        up = np.repeat(np.repeat(g, scale * 2, axis=0), scale * 2, axis=1)
        # thin random erosion: drop some "on" pixels to mimic stroke noise
        keep = rng.random(up.shape) > 0.08
        up = up * keep
        h, w = up.shape
        h, w = min(h, image_size), min(w, image_size)
        up = up[:h, :w]
        max_r, max_c = image_size - h, image_size - w
        r0 = rng.integers(0, max_r + 1)
        c0 = rng.integers(0, max_c + 1)
        images[i, r0 : r0 + h, c0 : c0 + w, 0] = up
    # intensity jitter + background noise
    images *= rng.uniform(0.7, 1.0, (n, 1, 1, 1)).astype(np.float32)
    images += rng.normal(0, 0.08, images.shape).astype(np.float32)
    return np.clip(images, 0.0, 1.0), labels.astype(np.int64)


class MnistDataSetIterator(DataSetIterator):
    """MNIST minibatches, NHWC [B,28,28,1] in [0,1], one-hot labels.

    Real data when found locally (IDX files); deterministic synthetic
    otherwise (`is_synthetic` says which).
    """

    NUM_CLASSES = 10

    def __init__(
        self,
        batch_size: int,
        train: bool = True,
        seed: int = 123,
        num_examples: int | None = None,
        flatten: bool = False,
    ):
        self._batch = batch_size
        self._flatten = flatten
        found = _find_mnist()
        if found is not None:
            xi, yi, xt, yt = found
            x, y = (xi, yi) if train else (xt, yt)
            self.is_synthetic = False
            x = _u8_scale(x)[..., None]
            y = y.astype(np.int64)
        else:
            default_n = 60000 if train else 10000
            n = num_examples or default_n
            x, y = synthetic_mnist(n, seed=seed if train else seed + 777)
            self.is_synthetic = True
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        if flatten:
            x = x.reshape(x.shape[0], -1)
        self._x = x
        self._y = np.eye(self.NUM_CLASSES, dtype=np.float32)[y]
        self._rng = np.random.default_rng(seed)
        self._shuffle = train

    @property
    def batch_size(self) -> int:
        return self._batch

    @property
    def num_examples(self) -> int:
        return len(self._x)

    def reset(self) -> None:
        pass

    def __iter__(self):
        yield from _iterate_batches(self._x, self._y, self._batch, self._shuffle, self._rng)


def _iterate_batches(x, y, batch, shuffle, rng):
    """Training (shuffle=True) drops the final short batch to keep step
    shapes static; evaluation (shuffle=False) yields it so no example is
    silently excluded from metrics."""
    idx = np.arange(len(x))
    if shuffle:
        rng.shuffle(idx)
    n_full = len(idx) // batch
    for i in range(n_full):
        sl = idx[i * batch : (i + 1) * batch]
        yield DataSet(x[sl], y[sl])
    tail = idx[n_full * batch :]
    if len(tail) and (not shuffle or n_full == 0):
        yield DataSet(x[tail], y[tail])


def synthetic_cifar(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """CIFAR-shaped procedural 10-class dataset [n,32,32,3]."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    images = rng.normal(0.45, 0.15, (n, 32, 32, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 31.0
    for i, lab in enumerate(labels):
        # class-conditional chromatic gradient + textured patch
        a, b = (lab % 5) / 4.0, (lab // 5) / 1.0
        images[i, :, :, 0] += 0.3 * (a * xx + (1 - a) * yy)
        images[i, :, :, 1] += 0.3 * (b * (1 - xx))
        r0, c0 = (lab * 3) % 24, (lab * 7) % 24
        images[i, r0 : r0 + 8, c0 : c0 + 8, 2] += 0.4
    return np.clip(images, 0, 1), labels.astype(np.int64)


class CifarDataSetIterator(DataSetIterator):
    """CIFAR-10-shaped minibatches (synthetic fallback, local npz when found)."""

    NUM_CLASSES = 10

    def __init__(self, batch_size: int, train: bool = True, seed: int = 321,
                 num_examples: int | None = None):
        self._batch = batch_size
        x = y = None
        self.is_synthetic = False
        for d in _data_dirs():
            f = d / ("cifar10_train.npz" if train else "cifar10_test.npz")
            if f.exists():
                data = np.load(f)
                x, y = data["x"].astype(np.float32), data["y"].astype(np.int64)
                if x.max() > 1.5:
                    x = x / 255.0
                if x.shape[1] == 3:  # NCHW on disk -> NHWC
                    x = x.transpose(0, 2, 3, 1)
                break
        if x is None:
            n = num_examples or (50000 if train else 10000)
            x, y = synthetic_cifar(n, seed=seed if train else seed + 999)
            self.is_synthetic = True
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        self._x = x
        self._y = np.eye(self.NUM_CLASSES, dtype=np.float32)[y]
        self._rng = np.random.default_rng(seed)
        self._shuffle = train

    @property
    def batch_size(self) -> int:
        return self._batch

    @property
    def num_examples(self) -> int:
        return len(self._x)

    def reset(self) -> None:
        pass

    def __iter__(self):
        yield from _iterate_batches(self._x, self._y, self._batch, self._shuffle, self._rng)
