"""Record readers — the `org.datavec.api.records.reader.RecordReader` role.

A record is a plain Python list of values (the reference's `List<Writable>`;
Writable boxing is a JVM artifact, not a capability).  Readers are iterables
with `reset()`, matching the reference SPI's `hasNext/next/reset` loop
(SURVEY.md §2.2 "DataVec (ETL)").

`ImageRecordReader` mirrors `org.datavec.image.recordreader.ImageRecordReader`:
walks a directory tree, labels from the parent directory name
(ParentPathLabelGenerator behavior), decodes via PIL instead of JavaCV,
emits HWC float arrays — channels-last, the JAX package's conv layout,
which the port keeps.

The port keeps its own copy of `deeplearning4j_tpu/datavec/records.py`, which
imports no JAX: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import csv
import io
import os
import random
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np


class RecordReader:
    """Iterable-with-reset SPI.

    The stepwise `has_next()`/`next_record()` pair shares one lazily-created
    iterator plus a one-record peek buffer; `reset()` discards both so the
    next step starts a fresh pass.
    """

    _iter: Optional[Iterator[list]] = None
    _peek: Optional[list] = None

    def __iter__(self) -> Iterator[list]:
        raise NotImplementedError

    def reset(self) -> None:
        self._iter = None
        self._peek = None

    def next_record(self):
        """Convenience single-step API (reference `next()`)."""
        if self._peek is not None:
            rec, self._peek = self._peek, None
            return rec
        if self._iter is None:
            self._iter = iter(self)
        return next(self._iter)

    def has_next(self) -> bool:
        if self._peek is not None:
            return True
        if self._iter is None:
            self._iter = iter(self)
        try:
            self._peek = next(self._iter)
        except StopIteration:
            return False
        return True


class CollectionRecordReader(RecordReader):
    """In-memory records (reference `CollectionRecordReader`)."""

    def __init__(self, records: Sequence[Sequence]):
        self._records = [list(r) for r in records]

    def __iter__(self):
        return iter([list(r) for r in self._records])


class LineRecordReader(RecordReader):
    """One record per line: `[line]` (reference `LineRecordReader`)."""

    def __init__(self, path: str | os.PathLike):
        self._path = Path(path)

    def __iter__(self):
        with open(self._path, "r") as f:
            for line in f:
                yield [line.rstrip("\n")]


class CSVRecordReader(RecordReader):
    """CSV parsing with skip-lines and delimiter (reference `CSVRecordReader`).

    Values are type-sniffed per cell: int → float → string, matching how the
    reference's Writables come out of CSVRecordReader + downstream conversion.
    """

    def __init__(
        self,
        path: str | os.PathLike | None = None,
        skip_lines: int = 0,
        delimiter: str = ",",
        *,
        text: str | None = None,
    ):
        if (path is None) == (text is None):
            raise ValueError("exactly one of path/text required")
        self._path = Path(path) if path is not None else None
        self._text = text
        self._skip = skip_lines
        self._delim = delimiter

    @staticmethod
    def _convert(cell: str):
        cell = cell.strip()
        try:
            return int(cell)
        except ValueError:
            pass
        try:
            return float(cell)
        except ValueError:
            pass
        return cell

    def __iter__(self):
        if self._path is not None:
            f = open(self._path, "r", newline="")
        else:
            f = io.StringIO(self._text)
        try:
            reader = csv.reader(f, delimiter=self._delim)
            for i, row in enumerate(reader):
                if i < self._skip or not row:
                    continue
                yield [self._convert(c) for c in row]
        finally:
            f.close()


_IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".npy"}


class ImageRecordReader(RecordReader):
    """Directory-tree image reader with parent-dir labels.

    Record layout: `[image(H,W,C) float32 ndarray, label_index int]` —
    channels-last (NHWC batches downstream, the layout the port's convolutions take),
    where the reference emits NCHW for cuDNN.  `.npy` files are read directly
    (golden-fixture path); everything else decodes through PIL.
    """

    def __init__(
        self,
        height: int,
        width: int,
        channels: int = 3,
        *,
        shuffle_seed: Optional[int] = None,
        label_generator=None,
        path_filter=None,
        dtype="float32",
    ):
        """label_generator: Path -> label string (default: parent dir —
        the ParentPathLabelGenerator behavior; see
        pattern_label_generator for the filename-pattern variant).
        path_filter: list[Path] -> list[Path] applied before shuffling
        (random_path_filter / balanced_path_filter roles).
        dtype: 'float32' (default) or 'uint8' — uint8 keeps decoded
        pixels as bytes end-to-end so batches cross the host->device
        link at 1/4 the size; models cast to the compute dtype on
        device (see models/_cast.entry_cast)."""
        self.height, self.width, self.channels = height, width, channels
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.dtype(np.float32), np.dtype(np.uint8)):
            raise ValueError(
                f"ImageRecordReader dtype must be float32 or uint8, "
                f"got {dtype}")
        self._shuffle_seed = shuffle_seed
        self._label_of = label_generator or (lambda p: p.parent.name)
        self._path_filter = path_filter
        self._files: List[Path] = []
        self.labels: List[str] = []

    def initialize(self, root: str | os.PathLike) -> "ImageRecordReader":
        root = Path(root)
        self._files = sorted(
            p for p in root.rglob("*") if p.suffix.lower() in _IMAGE_EXTS and p.is_file()
        )
        if not self._files:
            raise FileNotFoundError(f"no images under {root}")
        if self._path_filter is not None:
            self._files = list(self._path_filter(self._files))
            if not self._files:
                raise FileNotFoundError("path_filter removed every image")
        self.labels = sorted({self._label_of(p) for p in self._files})
        if self._shuffle_seed is not None:
            random.Random(self._shuffle_seed).shuffle(self._files)
        return self

    def num_labels(self) -> int:
        return len(self.labels)

    def _decode(self, path: Path) -> np.ndarray:
        if path.suffix.lower() == ".npy":
            img = np.load(path)
            if self.dtype == np.uint8 and img.dtype != np.uint8:
                # clamp-round like the native path — a bare astype would
                # truncate 254.9 -> 254 and WRAP negatives to 255
                img = np.clip(np.rint(img), 0, 255)
            img = img.astype(self.dtype)
            if img.ndim == 2:
                img = img[:, :, None]
        else:
            from PIL import Image

            with Image.open(path) as im:
                im = im.convert("L" if self.channels == 1 else "RGB")
                im = im.resize((self.width, self.height))
                img = np.asarray(im, dtype=self.dtype)
                if img.ndim == 2:
                    img = img[:, :, None]
        if img.shape != (self.height, self.width, self.channels):
            # pad/crop npy fixtures that bypass PIL resizing
            out = np.zeros((self.height, self.width, self.channels),
                           self.dtype)
            h = min(self.height, img.shape[0])
            w = min(self.width, img.shape[1])
            c = min(self.channels, img.shape[2])
            out[:h, :w, :c] = img[:h, :w, :c]
            img = out
        return img

    _NATIVE_CHUNK = 64

    def __iter__(self):
        label_idx = {name: i for i, name in enumerate(self.labels)}
        native_jpeg = False
        try:
            from deeplearning4j_tpu_torch.runtime import native

            native_jpeg = native.has_jpeg()
        except Exception:
            pass
        if not native_jpeg:
            for p in self._files:
                yield [self._decode(p), label_idx[self._label_of(p)]]
            return
        # native fast path: decode JPEG runs in threaded C batches (the
        # reference's JavaCV-native decode tier); other formats per-file
        for i in range(0, len(self._files), self._NATIVE_CHUNK):
            chunk = self._files[i:i + self._NATIVE_CHUNK]
            jpegs = [p for p in chunk if p.suffix.lower() in (".jpg", ".jpeg")]
            decoded = {}
            if jpegs:
                from deeplearning4j_tpu_torch.runtime import native

                batch = native.jpeg_batch_decode(
                    jpegs, self.height, self.width, self.channels,
                    dtype=self.dtype,
                )
                decoded = {p: batch[j] for j, p in enumerate(jpegs)}
            for p in chunk:
                img = decoded.get(p)
                if img is None or not img.any():
                    # native decode zero-fills failures; re-decode through
                    # PIL so corrupt files RAISE like the fallback path
                    # does (an all-black legit image just takes the slow
                    # path and comes back black again)
                    img = self._decode(p)
                yield [img, label_idx[self._label_of(p)]]


def pattern_label_generator(delimiter: str = "_", position: int = 0):
    """Label from a filename segment (PatternPathLabelGenerator role):
    'cat_001.png' with delimiter '_' position 0 -> 'cat'."""

    def gen(p: Path) -> str:
        parts = p.stem.split(delimiter)
        if position >= len(parts):
            raise ValueError(
                f"{p.name!r} has no segment {position} splitting on "
                f"{delimiter!r}"
            )
        return parts[position]

    return gen


def random_path_filter(seed: int, max_paths: int):
    """Random subsample of at most max_paths files (RandomPathFilter)."""

    def filt(paths: List[Path]) -> List[Path]:
        paths = list(paths)
        if len(paths) <= max_paths:
            return paths
        return random.Random(seed).sample(paths, max_paths)

    return filt


def balanced_path_filter(seed: int, max_per_class: int, label_generator=None):
    """At most max_per_class files per label, randomly chosen
    (BalancedPathFilter): guards against class imbalance from lopsided
    directory trees."""
    label_of = label_generator or (lambda p: p.parent.name)

    def filt(paths: List[Path]) -> List[Path]:
        by_label: dict = {}
        for p in paths:
            by_label.setdefault(label_of(p), []).append(p)
        rng = random.Random(seed)
        out: List[Path] = []
        for label in sorted(by_label):
            group = by_label[label]
            if len(group) > max_per_class:
                group = rng.sample(group, max_per_class)
            out.extend(group)
        return out

    return filt


def load_numeric_csv(path, delimiter: str = ",", skip_lines: int = 0) -> "np.ndarray":
    """Bulk-load an all-numeric CSV as a float32 matrix.

    The DataVec-role native fast path: parses in C++
    (native/dl4jtpu_io.cpp, multithreaded) when the library is built,
    otherwise numpy.  Use this instead of iterating CSVRecordReader when
    the file is purely numeric and large.
    """
    import numpy as np

    from deeplearning4j_tpu_torch.runtime import native

    if native.available():
        try:
            return native.csv_read_f32(str(path), delimiter, skip_lines)
        except (IOError, RuntimeError):
            pass
    return np.loadtxt(path, delimiter=delimiter, skiprows=skip_lines,
                      dtype=np.float32, ndmin=2)


class JDBCRecordReader(RecordReader):
    """SQL-backed records — the `org.datavec.jdbc.records.reader.impl.
    JDBCRecordReader` role.  Python's DB-API replaces JDBC: pass any
    DB-API connection (sqlite3 ships in the stdlib) or a sqlite path, plus
    the query.  Each row becomes one record; parameters are bound
    server-side (no string splicing).

        rr = JDBCRecordReader("data.db", "SELECT f1, f2, label FROM train")
    """

    def __init__(self, conn_or_path, query: str, parameters: tuple = ()):
        if isinstance(conn_or_path, (str, os.PathLike)):
            import sqlite3

            # check_same_thread=False: AsyncDataSetIterator consumes readers
            # from a producer thread; access is serialized per pass anyway
            self._conn = sqlite3.connect(
                str(conn_or_path), check_same_thread=False
            )
            self._owns = True
        else:
            self._conn = conn_or_path
            self._owns = False
        self.query = query
        self.parameters = tuple(parameters)

    def __iter__(self):
        cur = self._conn.cursor()
        try:
            cur.execute(self.query, self.parameters)
            for row in cur:
                yield list(row)
        finally:
            # a partially-consumed generator may be finalized AFTER the
            # connection was closed (GeneratorExit at GC time); closing a
            # cursor on a closed connection raises in sqlite3
            try:
                cur.close()
            except Exception:
                pass

    def column_names(self) -> list[str]:
        if getattr(self, "_columns", None) is None:
            cur = self._conn.cursor()
            try:
                # LIMIT 0 wrapper: cursor.description is populated without
                # the server executing the full (possibly expensive) query.
                # Subquery alias is mandatory on PostgreSQL.
                try:
                    cur.execute(
                        f"SELECT * FROM ({self.query}) AS _cols LIMIT 0",
                        self.parameters,
                    )
                except Exception:
                    # a failed statement can abort an open transaction
                    # (PostgreSQL): roll back before the plain fallback
                    try:
                        self._conn.rollback()
                    except Exception:
                        pass
                    cur.close()
                    cur = self._conn.cursor()
                    cur.execute(self.query, self.parameters)
                self._columns = [d[0] for d in cur.description]
            finally:
                cur.close()
        return self._columns

    def close(self) -> None:
        if self._owns:
            self._conn.close()


class CSVSequenceRecordReader(RecordReader):
    """Per-file sequences — the `CSVSequenceRecordReader` role: each CSV
    file under `directory` (sorted by name) is ONE sequence; every line is
    a timestep record.  Iterating yields sequences (list of records);
    `sequence_lengths()` exposes the ragged lengths for masking.
    """

    def __init__(self, directory: str | os.PathLike, skip_lines: int = 0,
                 delimiter: str = ",", glob: str = "*.csv"):
        self.directory = Path(directory)
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self.glob = glob
        self._paths = sorted(self.directory.glob(glob))
        if not self._paths:
            raise FileNotFoundError(
                f"no files matching {glob!r} under {self.directory}"
            )
        self._lengths: list[int] | None = None

    def __iter__(self):
        lengths = []
        for p in self._paths:
            reader = CSVRecordReader(p, skip_lines=self.skip_lines,
                                     delimiter=self.delimiter)
            seq = list(reader)
            lengths.append(len(seq))
            yield seq
        self._lengths = lengths

    def num_sequences(self) -> int:
        return len(self._paths)

    def sequence_lengths(self) -> list[int]:
        """Ragged per-sequence lengths (cached — computing them must not
        cost a second full parse of every file).  Counts exactly what
        iteration yields: blank rows are skipped, skip_lines only eats
        real leading rows."""
        if self._lengths is None:
            lengths = []
            for p in self._paths:
                with open(p, newline="") as f:
                    n = sum(
                        1
                        for i, row in enumerate(csv.reader(f, delimiter=self.delimiter))
                        if i >= self.skip_lines and row
                    )
                lengths.append(n)
            self._lengths = lengths
        return self._lengths
