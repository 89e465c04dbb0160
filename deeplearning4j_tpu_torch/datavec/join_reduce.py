"""Joins and group-by reductions over record streams.

Reference roles: `org.datavec.api.transform.join.Join` (Inner/LeftOuter/
RightOuter/FullOuter on key columns) and `org.datavec.api.transform.reduce.
Reducer` (group-by keys + per-column aggregation ops), executed by the
local/Spark executors (SURVEY.md §2.2 "DataVec" — previously a parity
gap).  The executor here is local and hash-based; the cluster tier's role
is played by the data-parallel input pipeline.

The port keeps its own copy of `deeplearning4j_tpu/datavec/join_reduce.py`, which
imports no JAX: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import enum
import math
from typing import Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.datavec.schema import ColumnMeta, ColumnType, Schema

Records = List[list]


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT_OUTER = "left_outer"
    RIGHT_OUTER = "right_outer"
    FULL_OUTER = "full_outer"


class Join:
    """Hash join on key columns.

    Output schema: key columns (typed from the left), then the left
    non-key columns, then the right non-key columns.  Missing sides in
    outer joins fill with None.
    """

    def __init__(self, join_type: JoinType | str, left_schema: Schema,
                 right_schema: Schema, *key_columns: str):
        self.join_type = JoinType(join_type)
        if not key_columns:
            raise ValueError("at least one key column required")
        for k in key_columns:
            if k not in left_schema.column_names():
                raise ValueError(f"key {k!r} not in left schema")
            if k not in right_schema.column_names():
                raise ValueError(f"key {k!r} not in right schema")
        self.keys = list(key_columns)
        self.left_schema = left_schema
        self.right_schema = right_schema
        self._l_key_idx = [left_schema.column_names().index(k) for k in self.keys]
        self._r_key_idx = [right_schema.column_names().index(k) for k in self.keys]
        self._l_rest = [
            i for i, c in enumerate(left_schema.columns)
            if c.name not in self.keys
        ]
        self._r_rest = [
            i for i, c in enumerate(right_schema.columns)
            if c.name not in self.keys
        ]

    def output_schema(self) -> Schema:
        cols = [self.left_schema.columns[i] for i in self._l_key_idx]
        cols += [self.left_schema.columns[i] for i in self._l_rest]
        cols += [self.right_schema.columns[i] for i in self._r_rest]
        return Schema(cols)

    def execute(self, left: Records, right: Records) -> Records:
        by_key: Dict[tuple, list] = {}
        for r in right:
            by_key.setdefault(
                tuple(r[i] for i in self._r_key_idx), []
            ).append(r)
        out: Records = []
        matched_right: set = set()
        for l in left:
            key = tuple(l[i] for i in self._l_key_idx)
            matches = by_key.get(key)
            if matches:
                matched_right.add(key)
                for r in matches:
                    out.append(
                        list(key)
                        + [l[i] for i in self._l_rest]
                        + [r[i] for i in self._r_rest]
                    )
            elif self.join_type in (JoinType.LEFT_OUTER, JoinType.FULL_OUTER):
                out.append(
                    list(key)
                    + [l[i] for i in self._l_rest]
                    + [None] * len(self._r_rest)
                )
        if self.join_type in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
            for key, matches in by_key.items():
                if key in matched_right:
                    continue
                for r in matches:
                    out.append(
                        list(key)
                        + [None] * len(self._l_rest)
                        + [r[i] for i in self._r_rest]
                    )
        return out


class ReduceOp(enum.Enum):
    SUM = "sum"
    MEAN = "mean"
    MIN = "min"
    MAX = "max"
    COUNT = "count"
    STDEV = "stdev"
    FIRST = "first"
    LAST = "last"
    RANGE = "range"          # max - min


_NUMERIC_OUT = {
    ReduceOp.SUM: ColumnType.DOUBLE,
    ReduceOp.MEAN: ColumnType.DOUBLE,
    ReduceOp.MIN: ColumnType.DOUBLE,
    ReduceOp.MAX: ColumnType.DOUBLE,
    ReduceOp.COUNT: ColumnType.LONG,
    ReduceOp.STDEV: ColumnType.DOUBLE,
    ReduceOp.RANGE: ColumnType.DOUBLE,
}


def _reduce_values(op: ReduceOp, values: list):
    if op is ReduceOp.COUNT:
        return len(values)
    if op is ReduceOp.FIRST:
        return values[0] if values else None
    if op is ReduceOp.LAST:
        return values[-1] if values else None
    nums = [float(v) for v in values if v is not None]
    if not nums:
        return None
    if op is ReduceOp.SUM:
        return sum(nums)
    if op is ReduceOp.MEAN:
        return sum(nums) / len(nums)
    if op is ReduceOp.MIN:
        return min(nums)
    if op is ReduceOp.MAX:
        return max(nums)
    if op is ReduceOp.RANGE:
        return max(nums) - min(nums)
    if op is ReduceOp.STDEV:
        m = sum(nums) / len(nums)
        if len(nums) < 2:
            return 0.0
        return math.sqrt(sum((v - m) ** 2 for v in nums) / (len(nums) - 1))
    raise ValueError(f"unhandled op {op}")


class Reducer:
    """Group-by-keys aggregation with a per-column op map.

        reducer = (Reducer.builder(schema, "city")
                   .sum("sales").mean("price").count("id").build())
        out = reducer.execute(records)   # one record per key group

    Output schema: keys, then aggregated columns named "<op>(<col>)".
    """

    def __init__(self, schema: Schema, keys: Sequence[str],
                 ops: Sequence[tuple]):
        self.schema = schema
        self.keys = list(keys)
        for k in self.keys:
            if k not in schema.column_names():
                raise ValueError(f"key {k!r} not in schema")
        self.ops = [(ReduceOp(op), col) for op, col in ops]
        names = schema.column_names()
        for op, col in self.ops:
            if col not in names:
                raise ValueError(f"column {col!r} not in schema")
            meta = schema.columns[names.index(col)]
            if op in (ReduceOp.SUM, ReduceOp.MEAN, ReduceOp.MIN, ReduceOp.MAX,
                      ReduceOp.STDEV, ReduceOp.RANGE) and not meta.is_numeric():
                raise ValueError(
                    f"{op.value}({col}) needs a numeric column, got "
                    f"{meta.type.value}"
                )
        self._key_idx = [names.index(k) for k in self.keys]
        self._op_idx = [(op, names.index(col)) for op, col in self.ops]

    @staticmethod
    def builder(schema: Schema, *keys: str) -> "Reducer.Builder":
        return Reducer.Builder(schema, keys)

    class Builder:
        def __init__(self, schema: Schema, keys: Sequence[str]):
            self._schema = schema
            self._keys = list(keys)
            self._ops: List[tuple] = []

        def _op(self, op: ReduceOp, *cols: str) -> "Reducer.Builder":
            for c in cols:
                self._ops.append((op, c))
            return self

        def sum(self, *cols):
            return self._op(ReduceOp.SUM, *cols)

        def mean(self, *cols):
            return self._op(ReduceOp.MEAN, *cols)

        def min(self, *cols):
            return self._op(ReduceOp.MIN, *cols)

        def max(self, *cols):
            return self._op(ReduceOp.MAX, *cols)

        def count(self, *cols):
            return self._op(ReduceOp.COUNT, *cols)

        def stdev(self, *cols):
            return self._op(ReduceOp.STDEV, *cols)

        def first(self, *cols):
            return self._op(ReduceOp.FIRST, *cols)

        def last(self, *cols):
            return self._op(ReduceOp.LAST, *cols)

        def range(self, *cols):
            return self._op(ReduceOp.RANGE, *cols)

        def build(self) -> "Reducer":
            return Reducer(self._schema, self._keys, self._ops)

    def output_schema(self) -> Schema:
        names = self.schema.column_names()
        cols = [self.schema.columns[i] for i in self._key_idx]
        for op, idx in self._op_idx:
            src = self.schema.columns[idx]
            if op in (ReduceOp.FIRST, ReduceOp.LAST):
                out_type = src.type
            else:
                out_type = _NUMERIC_OUT[op]
            cols.append(
                ColumnMeta(f"{op.value}({src.name})", out_type,
                           src.categories if op in (ReduceOp.FIRST,
                                                    ReduceOp.LAST) else None)
            )
        return Schema(cols)

    def execute(self, records: Records) -> Records:
        groups: Dict[tuple, list] = {}
        order: List[tuple] = []
        for r in records:
            key = tuple(r[i] for i in self._key_idx)
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(r)
        out: Records = []
        for key in order:
            rows = groups[key]
            rec = list(key)
            for op, idx in self._op_idx:
                rec.append(_reduce_values(op, [r[idx] for r in rows]))
            out.append(rec)
        return out
