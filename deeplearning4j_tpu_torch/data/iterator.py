"""The `DataSetIterator` contract, the two in-memory iterators of
`deeplearning4j_tpu/data/iterator.py` that ``fit`` builds from its
arguments, and `AsyncDataSetIterator`, the prefetching wrapper (a facade
over `data/prefetch.py`)."""

from __future__ import annotations

from collections.abc import Iterable, Iterator

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataSetIterator:
    """Iterable over DataSet minibatches; resettable."""

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    @property
    def batch_size(self) -> int:
        raise NotImplementedError


class NumpyDataSetIterator(DataSetIterator):
    """In-memory (features, labels) arrays -> shuffled minibatches."""

    def __init__(self, features: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        if len(features) == 0:
            raise ValueError("empty dataset")
        if len(features) != len(labels):
            raise ValueError(
                f"features ({len(features)}) and labels ({len(labels)}) "
                "have different numbers of examples")
        self._data = DataSet(np.asarray(features), np.asarray(labels))
        self._batch = int(batch_size)
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._drop_last = drop_last

    @property
    def batch_size(self) -> int:
        return self._batch

    def reset(self) -> None:
        pass  # stateless between epochs; the shuffle is drawn per __iter__

    def __iter__(self) -> Iterator[DataSet]:
        ds = self._data.shuffle(self._rng) if self._shuffle else self._data
        batches = ds.split_batches(self._batch)
        if self._drop_last:
            kept = [b for b in batches if b.num_examples == self._batch]
            # never drop everything: a dataset smaller than batch_size
            # still trains on its single short batch
            batches = kept if kept else batches
        yield from batches


class ExistingDataSetIterator(DataSetIterator):
    """Wraps any iterable of DataSet."""

    def __init__(self, batches: Iterable[DataSet]):
        self._batches = list(batches)

    @property
    def batch_size(self) -> int:
        return self._batches[0].num_examples if self._batches else 0

    def reset(self) -> None:
        pass

    def __iter__(self) -> Iterator[DataSet]:
        return iter(self._batches)


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch of ``base`` (the reference's
    AsyncDataSetIterator): `data.prefetch.PrefetchIterator` with
    ``queue_size`` as its depth, staging onto ``device`` (CUDA by
    default) when ``device_put``, else pulling ahead only."""

    def __init__(self, base: DataSetIterator, queue_size: int = 2,
                 device_put: bool = True, device=None):
        from deeplearning4j_tpu_torch.data.prefetch import (
            PrefetchIterator,
            stage_to_device,
        )

        self._base = base
        self._prefetch = PrefetchIterator(
            base, depth=queue_size,
            stage=stage_to_device if device_put else None, device=device)

    @property
    def batch_size(self) -> int:
        return self._base.batch_size

    def reset(self) -> None:
        self._prefetch.reset()

    def close(self) -> None:
        self._prefetch.close()

    def __iter__(self) -> Iterator[DataSet]:
        return iter(self._prefetch)
