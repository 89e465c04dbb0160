"""DataVec-role ETL — `deeplearning4j_tpu/datavec/`, the port's own copy:
a record abstraction over CSV, lines, collections, images, audio and
video, a typed `Schema`, a declarative `TransformProcess` of column
operations with its executors, joins and reductions, and the
`RecordReaderDataSetIterator` bridge into training.

The readers and transforms run on the host in numpy, with the JAX
package's NHWC record layout.  The common decode chain can leave the
host: `datavec/device.py` runs a `TransformChain` inside the captured
training step, so ``fit`` stages raw uint8 bytes and the card decodes
(its module docstring has the contract).
"""

from deeplearning4j_tpu_torch.datavec.records import (
    CSVSequenceRecordReader,
    JDBCRecordReader,
    balanced_path_filter,
    load_numeric_csv,
    pattern_label_generator,
    random_path_filter,
    RecordReader,
    CollectionRecordReader,
    CSVRecordReader,
    LineRecordReader,
    ImageRecordReader,
)
from deeplearning4j_tpu_torch.datavec.audio import (
    SpectrogramRecordReader,
    VideoRecordReader,
    WavFileRecordReader,
    read_wav,
    spectrogram,
    write_wav,
)
from deeplearning4j_tpu_torch.datavec.schema import Schema, ColumnType
from deeplearning4j_tpu_torch.datavec.transform import TransformProcess
from deeplearning4j_tpu_torch.datavec.executor import LocalTransformExecutor
from deeplearning4j_tpu_torch.datavec.bridge import (
    RecordReaderDataSetIterator,
    SequenceRecordReaderDataSetIterator,
)
from deeplearning4j_tpu_torch.datavec.join_reduce import (
    Join,
    JoinType,
    Reducer,
    ReduceOp,
)
from deeplearning4j_tpu_torch.datavec.device import (
    DeviceTransformIterator,
    TransformChain,
    device_transform,
)

__all__ = [
    "DeviceTransformIterator",
    "TransformChain",
    "device_transform",
    "load_numeric_csv",
    "JDBCRecordReader",
    "CSVSequenceRecordReader",
    "Join",
    "JoinType",
    "Reducer",
    "ReduceOp",
    "RecordReader",
    "CollectionRecordReader",
    "CSVRecordReader",
    "LineRecordReader",
    "ImageRecordReader",
    "Schema",
    "ColumnType",
    "TransformProcess",
    "LocalTransformExecutor",
    "RecordReaderDataSetIterator",
    "SequenceRecordReaderDataSetIterator",
    "WavFileRecordReader",
    "SpectrogramRecordReader",
    "VideoRecordReader",
    "read_wav",
    "write_wav",
    "spectrogram",
    "pattern_label_generator",
    "random_path_filter",
    "balanced_path_filter",
]
