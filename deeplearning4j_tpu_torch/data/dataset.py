"""`DataSet` and `MultiDataSet` — the minibatches of
`deeplearning4j_tpu/data/dataset.py`: features and labels (plus optional
sequence masks) kept as numpy on the host, moved to the model's device
inside the training step (or staged there ahead of it by
`data/prefetch.py`).  A `MultiDataSet` holds one array per network input
and one per network output of a computation graph.

The port keeps its own copy although the JAX module imports only numpy:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Routing and attribution tags a batch object carries beside its arrays
# (the JAX package's): the cache tier's ``_etl_source``, the device
# decode's raw-feed tag and its augmentation index.  Structural copies
# (split, map, prefetch staging) carry them forward, so a raw batch
# split by recovery's OOM microbatching keeps its decode keys.
BATCH_TAGS = ("_etl_source", "_raw_for_device_decode", "_decode_step")


def copy_tags(src, dst):
    """The known batch tags of ``src`` set on ``dst`` (returned)."""
    for tag in BATCH_TAGS:
        v = getattr(src, tag, None)
        if v is not None:
            try:
                setattr(dst, tag, v)
            except AttributeError:
                pass              # slotted or foreign batch types
    return dst


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: np.ndarray | None = None
    labels_mask: np.ndarray | None = None

    @property
    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_batches(self, batch_size: int) -> list["DataSet"]:
        out = []
        n = self.num_examples
        for i in range(0, n, batch_size):
            sl = slice(i, min(i + batch_size, n))
            out.append(copy_tags(self, DataSet(
                self.features[sl],
                self.labels[sl],
                None if self.features_mask is None else self.features_mask[sl],
                None if self.labels_mask is None else self.labels_mask[sl],
            )))
        return out

    def shuffle(self, rng: np.random.Generator) -> "DataSet":
        perm = rng.permutation(self.num_examples)
        return DataSet(
            self.features[perm],
            self.labels[perm],
            None if self.features_mask is None else self.features_mask[perm],
            None if self.labels_mask is None else self.labels_mask[perm],
        )


@dataclasses.dataclass
class MultiDataSet:
    features: tuple
    labels: tuple
    features_masks: tuple | None = None
    labels_masks: tuple | None = None

    @property
    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    @staticmethod
    def from_dataset(ds: DataSet) -> "MultiDataSet":
        return MultiDataSet(
            (ds.features,),
            (ds.labels,),
            None if ds.features_mask is None else (ds.features_mask,),
            None if ds.labels_mask is None else (ds.labels_mask,),
        )

    def split_batches(self, batch_size: int) -> list["MultiDataSet"]:
        out = []
        n = self.num_examples
        for i in range(0, n, batch_size):
            sl = slice(i, min(i + batch_size, n))

            def cut(arrays):
                if arrays is None:
                    return None
                return tuple(None if a is None else a[sl] for a in arrays)

            out.append(copy_tags(self, MultiDataSet(
                cut(self.features), cut(self.labels), cut(self.features_masks),
                cut(self.labels_masks))))
        return out


def as_numpy(x, dtype=None) -> np.ndarray:
    """An array of ``x``: numpy and array-likes as they are, a tensor (on
    any device) copied to the host."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def map_batch(batch, fn, *, masks: bool = True):
    """A structural copy of a `DataSet` / `MultiDataSet` with ``fn``
    applied to every feature and label array, masks too unless
    ``masks=False`` (then they carry over).  None entries and other
    objects pass through."""
    def ap(a):
        return None if a is None else fn(a)

    if isinstance(batch, DataSet):
        return copy_tags(batch, DataSet(
            ap(batch.features), ap(batch.labels),
            ap(batch.features_mask) if masks else batch.features_mask,
            ap(batch.labels_mask) if masks else batch.labels_mask))
    if isinstance(batch, MultiDataSet):
        def apt(arrays, mask_group=False):
            if arrays is None or (mask_group and not masks):
                return arrays
            return tuple(ap(a) for a in arrays)

        return copy_tags(batch, MultiDataSet(
            apt(batch.features), apt(batch.labels),
            apt(batch.features_masks, mask_group=True),
            apt(batch.labels_masks, mask_group=True)))
    return batch


def named_arrays(batch, *, masks: bool = True) -> dict:
    """A batch as name -> numpy array (``features``, ``labels``,
    ``*_mask``; a `MultiDataSet`'s entries suffixed ``_<i>``; None
    entries dropped; other objects give {}): the quarantine record's and
    the non-finite input scan's view of a batch.  Tensors are copied to
    the host."""
    out: dict = {}
    if isinstance(batch, DataSet):
        pairs = [("features", batch.features), ("labels", batch.labels)]
        if masks:
            pairs += [("features_mask", batch.features_mask),
                      ("labels_mask", batch.labels_mask)]
        for name, a in pairs:
            if a is not None:
                out[name] = as_numpy(a)
    elif isinstance(batch, MultiDataSet):
        groups = [("features", batch.features), ("labels", batch.labels)]
        if masks:
            groups += [("features_mask", batch.features_masks or ()),
                       ("labels_mask", batch.labels_masks or ())]
        for group, arrays in groups:
            for i, a in enumerate(arrays):
                if a is not None:
                    out[f"{group}_{i}"] = as_numpy(a)
    return out
