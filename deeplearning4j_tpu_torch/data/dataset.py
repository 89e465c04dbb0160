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
            out.append(DataSet(
                self.features[sl],
                self.labels[sl],
                None if self.features_mask is None else self.features_mask[sl],
                None if self.labels_mask is None else self.labels_mask[sl],
            ))
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

            out.append(MultiDataSet(cut(self.features), cut(self.labels),
                                    cut(self.features_masks),
                                    cut(self.labels_masks)))
        return out
