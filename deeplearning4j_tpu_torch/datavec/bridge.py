"""RecordReader → DataSetIterator bridge.

Role parity: `org.deeplearning4j.datasets.datavec.RecordReaderDataSetIterator`
(SURVEY.md §2.2 "Dataset iterators") — consumes a RecordReader, splits each
record into features / label, one-hots classification labels, and emits
`DataSet` minibatches.  Fixed batch shapes (final short batch padded-or-
dropped by choice) keep the captured step from capturing again.

The port keeps its own copy of `deeplearning4j_tpu/datavec/bridge.py`, which
imports no JAX: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import DataSetIterator
from deeplearning4j_tpu_torch.datavec.records import RecordReader


class RecordReaderDataSetIterator(DataSetIterator):
    """Batches records from a RecordReader.

    Classification: `label_index` selects the label column, one-hotted to
    `num_classes` (reference constructor `(reader, batch, labelIdx, numClasses)`).
    Regression: `regression=True` keeps the label columns raw; `label_index`
    .. `label_index_to` select a contiguous label span (inclusive), matching
    the reference's regression constructor.
    Image records (`[ndarray, label]`): the feature cell is used as-is.
    """

    def __init__(
        self,
        reader: RecordReader,
        batch_size: int,
        label_index: Optional[int] = None,
        num_classes: Optional[int] = None,
        *,
        regression: bool = False,
        label_index_to: Optional[int] = None,
        drop_last: bool = False,
    ):
        if not regression and label_index is not None and num_classes is None:
            raise ValueError("classification mode requires num_classes")
        self._reader = reader
        self._batch = int(batch_size)
        self._label_index = label_index
        self._label_index_to = label_index_to if label_index_to is not None else label_index
        self._num_classes = num_classes
        self._regression = regression
        self._drop_last = drop_last

    @property
    def batch_size(self) -> int:
        return self._batch

    def reset(self) -> None:
        self._reader.reset()

    def _split(self, record: list):
        if self._label_index is None:
            return record, None
        if (
            len(record) == 2
            and isinstance(record[0], np.ndarray)
            and self._label_index == 1
        ):
            # image record: [tensor, label]
            return record[0], record[1]
        lo, hi = self._label_index, self._label_index_to
        label = record[lo : hi + 1]
        feats = record[:lo] + record[hi + 1 :]
        return feats, label[0] if len(label) == 1 else label

    def _emit(self, feats: list, labels: list) -> DataSet:
        f = np.asarray(feats)
        if f.dtype != np.uint8:
            # uint8 passes through untouched: it is the WIRE format for
            # the device-cast image path (4x fewer host->device bytes;
            # models cast to the compute dtype inside the jitted step)
            f = f.astype(np.float32, copy=False)
        if not labels or labels[0] is None:
            return DataSet(f, np.zeros((len(feats), 0), np.float32))
        if self._regression:
            y = np.asarray(labels, dtype=np.float32)
            if y.ndim == 1:
                y = y[:, None]
        else:
            idx = np.asarray(labels, dtype=np.int64).reshape(-1)
            if (idx < 0).any() or (idx >= self._num_classes).any():
                raise ValueError(
                    f"label out of range [0, {self._num_classes}): {idx.min()}..{idx.max()}"
                )
            y = np.eye(self._num_classes, dtype=np.float32)[idx]
        return DataSet(f, y)

    def __iter__(self) -> Iterator[DataSet]:
        feats, labels = [], []
        for record in self._reader:
            x, y = self._split(list(record))
            feats.append(x)
            labels.append(y)
            if len(feats) == self._batch:
                yield self._emit(feats, labels)
                feats, labels = [], []
        if feats and not self._drop_last:
            yield self._emit(feats, labels)


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequence records -> bucketed (B, T, F) batches — the reference's
    `SequenceRecordReaderDataSetIterator` with recompile hygiene.

    Consumes a sequence reader (e.g. `CSVSequenceRecordReader`: one
    sequence = a list of timestep records).  Each batch's time axis is
    padded to the longest member rounded UP to the bucket quantum
    (`flags.sequence_bucket_size` unless `bucket_size` overrides), and
    sequences are grouped into same-bucket batches, so a ragged corpus
    compiles at most ceil(max_len/quantum) step programs instead of one
    per distinct length.  `features_mask` (B, T) marks real timesteps.

    Classification (`label_index` + `num_classes`): per-timestep labels
    one-hot to (B, T, C) with `labels_mask` = features_mask.
    Regression keeps label columns raw as (B, T, L).
    `label_index=None` emits label-free batches (sequence pretraining).
    Tail batches of a bucket keep the full batch-size shape with padded
    examples masked out (mask rows all-zero) — batch shape stays static.
    """

    def __init__(
        self,
        reader,
        batch_size: int,
        label_index: Optional[int] = None,
        num_classes: Optional[int] = None,
        *,
        regression: bool = False,
        bucket_size: Optional[int] = None,
    ):
        if not regression and label_index is not None and num_classes is None:
            raise ValueError("classification mode requires num_classes")
        self._reader = reader
        self._batch = int(batch_size)
        self._label_index = label_index
        self._num_classes = num_classes
        self._regression = regression
        self._bucket = bucket_size

    @property
    def batch_size(self) -> int:
        return self._batch

    def reset(self) -> None:
        if hasattr(self._reader, "reset"):
            self._reader.reset()

    def _split_seq(self, seq: list):
        """One ragged sequence -> ((T, F) features, (T, L) labels-or-None)."""
        feats, labels = [], []
        for record in seq:
            record = list(record)
            if self._label_index is None:
                feats.append(record)
                continue
            lo = self._label_index
            labels.append(record[lo])
            feats.append(record[:lo] + record[lo + 1:])
        f = np.asarray(feats, np.float32)
        if self._label_index is None:
            return f, None
        if self._regression:
            y = np.asarray(labels, np.float32)
            if y.ndim == 1:
                y = y[:, None]
            return f, y
        idx = np.asarray(labels, np.int64)
        if (idx < 0).any() or (idx >= self._num_classes).any():
            raise ValueError(
                f"label out of range [0, {self._num_classes}): "
                f"{idx.min()}..{idx.max()}"
            )
        return f, np.eye(self._num_classes, dtype=np.float32)[idx]

    def _emit(self, seqs: list, bucket_len: int) -> DataSet:
        bs = self._batch
        n_feat = seqs[0][0].shape[1]
        f = np.zeros((bs, bucket_len, n_feat), np.float32)
        fmask = np.zeros((bs, bucket_len), np.float32)
        has_labels = seqs[0][1] is not None
        y = lmask = None
        if has_labels:
            n_lab = seqs[0][1].shape[1]
            y = np.zeros((bs, bucket_len, n_lab), np.float32)
            lmask = np.zeros((bs, bucket_len), np.float32)
        for j, (sf, sy) in enumerate(seqs):
            t = sf.shape[0]
            f[j, :t] = sf
            fmask[j, :t] = 1.0
            if has_labels:
                y[j, :t] = sy
                lmask[j, :t] = 1.0
        if not has_labels:
            y = np.zeros((bs, 0), np.float32)
        return DataSet(f, y, features_mask=fmask, labels_mask=lmask)

    def __iter__(self) -> Iterator[DataSet]:
        from deeplearning4j_tpu_torch.runtime.flags import bucket_length

        pending: dict[int, list] = {}
        for seq_i, seq in enumerate(self._reader):
            seq = list(seq)
            if not seq:
                # an empty sequence file is an upstream ETL artifact;
                # name it here rather than dying in batch assembly with
                # a shape error that points nowhere
                raise ValueError(
                    f"sequence {seq_i} has zero timesteps; drop empty "
                    "sequences before the iterator"
                )
            sf, sy = self._split_seq(seq)
            L = bucket_length(sf.shape[0], self._bucket)
            bucket = pending.setdefault(L, [])
            bucket.append((sf, sy))
            if len(bucket) == self._batch:
                yield self._emit(bucket, L)
                pending[L] = []
        for L in sorted(pending):
            if pending[L]:
                yield self._emit(pending[L], L)
