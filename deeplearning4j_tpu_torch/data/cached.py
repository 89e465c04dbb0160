"""Disk-backed batch cache — the `ExistingMiniBatchDataSetIterator` role.

ETL-fed training re-decodes every JPEG each epoch even though the decoded
batches never change (the ETL-fed flagship runs at a fraction of the
synthetic headline for exactly this reason).  `CachedDataSetIterator`
eliminates the re-decode tax: epoch 1 pulls from the base iterator and
writes each batch to disk in its device WIRE format (uint8 stays uint8 —
byte-identical round trip, 1/4 the f32 size); epoch 2+ memory-maps the
saved arrays and never touches the base pipeline again.

Layout under ``cache_dir``::

    b00000.features.npy          one .npy per array — np.load(mmap_mode="r")
    b00000.labels.npy            hands the training loop zero-copy views
    b00000.features_mask.npy     (optional)
    b00000.labels_mask.npy       (optional)
    manifest.json                written ATOMICALLY after a complete epoch

The manifest is the commit point: a process killed mid-population leaves
no manifest, so the next run re-decodes from scratch instead of training
on a silently truncated epoch.  A pre-existing complete cache is used
as-is — the base iterator is never consumed (it may even be None).

The port keeps its own copy of `deeplearning4j_tpu/data/cached.py`, which
imports no JAX: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
from collections.abc import Iterator
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import DataSetIterator

_ARRAYS = ("features", "labels", "features_mask", "labels_mask")


def _cache_counter():
    """The spine's cache family (lazy: data/ stays importable without
    observe in odd partial checkouts)."""
    from deeplearning4j_tpu_torch.observe.metrics import registry

    return registry().counter("dl4jtpu_data_cache_batches_total")


class CachedDataSetIterator(DataSetIterator):
    """Cache a base iterator's batches to disk on the first pass, replay
    them via mmap afterwards.

    ``cache_hits`` counts batches served from disk, ``decode_epochs``
    counts full passes that consumed the base iterator — the bench and
    tests assert the decode path is actually skipped, not assumed."""

    def __init__(self, base: Optional[DataSetIterator], cache_dir: str):
        self._base = base
        self.cache_dir = cache_dir
        self.cache_hits = 0
        self.decode_epochs = 0
        os.makedirs(cache_dir, exist_ok=True)
        self._manifest = self._load_manifest()
        if self._manifest is None and base is None:
            raise ValueError(
                f"no complete cache at {cache_dir} and no base iterator "
                "to populate it from"
            )

    # -- manifest ----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.cache_dir, "manifest.json")

    def _load_manifest(self) -> Optional[dict]:
        try:
            with open(self._manifest_path()) as f:
                m = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        return m if m.get("complete") else None

    @property
    def is_cached(self) -> bool:
        """True once a complete epoch is on disk (replay mode)."""
        return self._manifest is not None

    # -- iteration ---------------------------------------------------------
    @property
    def batch_size(self) -> int:
        if self._manifest is not None:
            return int(self._manifest.get("batch_size", 0))
        return self._base.batch_size

    def reset(self) -> None:
        # replay mode never touches the base pipeline; an incomplete
        # cache restarts population from a clean slate
        if self._manifest is None and self._base is not None:
            self._base.reset()

    def _batch_path(self, i: int, name: str) -> str:
        return os.path.join(self.cache_dir, f"b{i:05d}.{name}.npy")

    def _replay(self) -> Iterator[DataSet]:
        n = int(self._manifest["n_batches"])
        present = self._manifest["arrays"]
        counter = _cache_counter()
        for i in range(n):
            arrs = {}
            for name in _ARRAYS:
                if name in present:
                    # mmap: the training loop reads straight from page
                    # cache; no decode, no copy until device transfer
                    arrs[name] = np.load(
                        self._batch_path(i, name), mmap_mode="r"
                    )
                else:
                    arrs[name] = None
            self.cache_hits += 1
            counter.inc(source="cache")
            ds = DataSet(arrs["features"], arrs["labels"],
                         arrs["features_mask"], arrs["labels_mask"])
            # the fit loops' timed feed reads this tag: hit-path pull
            # time is mmap/page-cache replay, not input-pipeline
            # starvation — it lands on the source="cache" series of
            # dl4jtpu_etl_wait_seconds_total instead of inflating the
            # ETL-wait total PerformanceListener reports
            ds._etl_source = "cache"
            yield ds

    def _populate(self) -> Iterator[DataSet]:
        count = 0
        present: Optional[list] = None
        counter = _cache_counter()
        for batch in self._base:
            arrs = {
                "features": batch.features,
                "labels": batch.labels,
                "features_mask": batch.features_mask,
                "labels_mask": batch.labels_mask,
            }
            here = [n for n in _ARRAYS if arrs[n] is not None]
            if present is None:
                present = here
            elif here != present:
                raise ValueError(
                    "base iterator changed its mask layout mid-epoch "
                    f"(batch {count}: {here} vs {present}); the cache "
                    "needs a uniform batch structure"
                )
            for name in here:
                np.save(self._batch_path(count, name),
                        np.asarray(arrs[name]))
            count += 1
            counter.inc(source="decode")
            yield batch
        if count == 0:
            raise ValueError("base iterator yielded no batches to cache")
        self.decode_epochs += 1
        manifest = {
            "complete": True,
            "n_batches": count,
            "arrays": present,
            "batch_size": int(self._base.batch_size),
        }
        # tmp + rename: the manifest only ever names a fully-written epoch
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, self._manifest_path())
        self._manifest = manifest

    def __iter__(self) -> Iterator[DataSet]:
        if self._manifest is not None:
            return self._replay()
        return self._populate()
