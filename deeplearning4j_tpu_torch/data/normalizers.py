"""Data normalizers — `deeplearning4j_tpu/data/normalizers.py` (the
`org.nd4j.linalg.dataset.api.preprocessor` role), in numpy.

fit(iterator) accumulates statistics; transform applies them;
save/restore persists them as the JAX package's JSON, so a file written
by either package restores in the other.  The device lowering of a
normalizer (``device_spec``, ``NormalizingIterator.device_chain``: the
transform fused into the step program) is ROADMAP A12's.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import DataSetIterator


class Normalizer:
    def fit(self, iterator) -> "Normalizer":
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def revert_features(self, features: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- persistence -------------------------------------------------------
    def state_dict(self) -> dict:
        raise NotImplementedError

    def load_state_dict(self, d: dict) -> None:
        raise NotImplementedError

    def save(self, path: str) -> None:
        Path(path).write_text(
            json.dumps({"type": type(self).__name__, **self.state_dict()})
        )

    @staticmethod
    def restore(path: str) -> "Normalizer":
        d = json.loads(Path(path).read_text())
        cls = {c.__name__: c for c in (NormalizerStandardize, NormalizerMinMaxScaler,
                                       ImagePreProcessingScaler)}[d.pop("type")]
        n = cls()
        n.load_state_dict(d)
        return n


class NormalizerStandardize(Normalizer):
    """Per-feature zero-mean unit-variance (fit via streaming moments)."""

    def __init__(self):
        self.mean: np.ndarray | None = None
        self.std: np.ndarray | None = None

    def fit(self, iterator):
        count = 0
        s1 = s2 = None
        for batch in iterator:
            f = batch.features.astype(np.float64)
            axes = tuple(range(f.ndim - 1))
            b1 = f.sum(axis=axes)
            b2 = (f**2).sum(axis=axes)
            n = int(np.prod([f.shape[a] for a in axes]))
            s1 = b1 if s1 is None else s1 + b1
            s2 = b2 if s2 is None else s2 + b2
            count += n
        iterator.reset()
        self.mean = (s1 / count).astype(np.float32)
        var = s2 / count - (s1 / count) ** 2
        self.std = np.sqrt(np.maximum(var, 1e-12)).astype(np.float32)
        return self

    def transform(self, ds: DataSet) -> DataSet:
        f = (ds.features - self.mean) / self.std
        return DataSet(f.astype(np.float32), ds.labels, ds.features_mask, ds.labels_mask)

    def revert_features(self, features):
        return features * self.std + self.mean


    def state_dict(self):
        return {"mean": self.mean.tolist(), "std": self.std.tolist()}

    def load_state_dict(self, d):
        self.mean = np.asarray(d["mean"], np.float32)
        self.std = np.asarray(d["std"], np.float32)


class NormalizerMinMaxScaler(Normalizer):
    """Scale features into [lo, hi] using per-feature min/max."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo, self.hi = lo, hi
        self.min: np.ndarray | None = None
        self.max: np.ndarray | None = None

    def fit(self, iterator):
        mn = mx = None
        for batch in iterator:
            f = batch.features
            axes = tuple(range(f.ndim - 1))
            bmn, bmx = f.min(axis=axes), f.max(axis=axes)
            mn = bmn if mn is None else np.minimum(mn, bmn)
            mx = bmx if mx is None else np.maximum(mx, bmx)
        iterator.reset()
        self.min, self.max = mn.astype(np.float32), mx.astype(np.float32)
        return self

    def transform(self, ds: DataSet) -> DataSet:
        rng = np.maximum(self.max - self.min, 1e-12)
        f = (ds.features - self.min) / rng * (self.hi - self.lo) + self.lo
        return DataSet(f.astype(np.float32), ds.labels, ds.features_mask, ds.labels_mask)

    def revert_features(self, features):
        rng = np.maximum(self.max - self.min, 1e-12)
        return (features - self.lo) / (self.hi - self.lo) * rng + self.min


    def state_dict(self):
        return {"lo": self.lo, "hi": self.hi,
                "min": self.min.tolist(), "max": self.max.tolist()}

    def load_state_dict(self, d):
        self.lo, self.hi = d["lo"], d["hi"]
        self.min = np.asarray(d["min"], np.float32)
        self.max = np.asarray(d["max"], np.float32)


class ImagePreProcessingScaler(Normalizer):
    """uint8 [0,255] images -> [lo,hi] floats (stateless; fit is a no-op)."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo, self.hi = lo, hi

    def fit(self, iterator):
        return self

    def transform(self, ds: DataSet) -> DataSet:
        scale = (self.hi - self.lo) / 255.0
        x = np.asarray(ds.features)
        # the JAX package's native uint8 scaler waits for ROADMAP A12;
        # this is its numpy path
        f = x.astype(np.float32) * scale + self.lo
        return DataSet(f, ds.labels, ds.features_mask, ds.labels_mask)


    def revert_features(self, features):
        return (features - self.lo) / (self.hi - self.lo) * 255.0

    def state_dict(self):
        return {"lo": self.lo, "hi": self.hi}

    def load_state_dict(self, d):
        self.lo, self.hi = d["lo"], d["hi"]


class NormalizingIterator(DataSetIterator):
    """Wrap an iterator so every batch passes through a fitted normalizer
    (the reference's ``iterator.setPreProcessor(normalizer)``)."""

    def __init__(self, base, normalizer: Normalizer):
        self._base = base
        self._norm = normalizer

    @property
    def batch_size(self):
        return self._base.batch_size

    def reset(self):
        self._base.reset()

    def __iter__(self):
        for batch in self._base:
            yield self._norm.transform(batch)
