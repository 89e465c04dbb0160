"""Typed column schema — the `org.datavec.api.transform.schema.Schema` role.

A schema names and types the columns of a record stream; TransformProcess
steps consume and produce schemas so the output layout of a declarative
pipeline is known statically (reference behavior: each transform maps an
input Schema to an output Schema).

The port keeps its own copy of `deeplearning4j_tpu/datavec/schema.py`, which
imports no JAX: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import List, Optional, Sequence


class ColumnType(enum.Enum):
    DOUBLE = "double"
    INTEGER = "integer"
    LONG = "long"
    CATEGORICAL = "categorical"
    STRING = "string"
    TIME = "time"
    BOOLEAN = "boolean"


@dataclasses.dataclass(frozen=True)
class ColumnMeta:
    name: str
    type: ColumnType
    # categorical state space, when type == CATEGORICAL
    categories: Optional[tuple] = None

    def is_numeric(self) -> bool:
        return self.type in (ColumnType.DOUBLE, ColumnType.INTEGER, ColumnType.LONG, ColumnType.BOOLEAN)


class Schema:
    """Ordered, named, typed columns with a builder matching the reference DSL.

    >>> s = (Schema.builder()
    ...      .add_double("sepal_len")
    ...      .add_categorical("species", ["a", "b"])
    ...      .build())
    """

    def __init__(self, columns: Sequence[ColumnMeta]):
        self.columns: List[ColumnMeta] = list(columns)
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")
        self._index = {c.name: i for i, c in enumerate(self.columns)}

    # --- queries ---------------------------------------------------------
    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    def num_columns(self) -> int:
        return len(self.columns)

    def index_of(self, name: str) -> int:
        if name not in self._index:
            raise KeyError(f"no column {name!r}; have {self.column_names()}")
        return self._index[name]

    def meta(self, name: str) -> ColumnMeta:
        return self.columns[self.index_of(name)]

    def has_column(self, name: str) -> bool:
        return name in self._index

    # --- serde -----------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            [
                {
                    "name": c.name,
                    "type": c.type.value,
                    "categories": list(c.categories) if c.categories else None,
                }
                for c in self.columns
            ]
        )

    @staticmethod
    def from_json(s: str) -> "Schema":
        cols = [
            ColumnMeta(
                d["name"],
                ColumnType(d["type"]),
                tuple(d["categories"]) if d.get("categories") else None,
            )
            for d in json.loads(s)
        ]
        return Schema(cols)

    def __eq__(self, other) -> bool:
        return isinstance(other, Schema) and self.columns == other.columns

    def __repr__(self) -> str:
        return "Schema(" + ", ".join(f"{c.name}:{c.type.value}" for c in self.columns) + ")"

    # --- builder ---------------------------------------------------------
    class Builder:
        def __init__(self):
            self._cols: List[ColumnMeta] = []

        def add_double(self, *names: str) -> "Schema.Builder":
            for n in names:
                self._cols.append(ColumnMeta(n, ColumnType.DOUBLE))
            return self

        def add_integer(self, *names: str) -> "Schema.Builder":
            for n in names:
                self._cols.append(ColumnMeta(n, ColumnType.INTEGER))
            return self

        def add_long(self, *names: str) -> "Schema.Builder":
            for n in names:
                self._cols.append(ColumnMeta(n, ColumnType.LONG))
            return self

        def add_string(self, *names: str) -> "Schema.Builder":
            for n in names:
                self._cols.append(ColumnMeta(n, ColumnType.STRING))
            return self

        def add_boolean(self, *names: str) -> "Schema.Builder":
            for n in names:
                self._cols.append(ColumnMeta(n, ColumnType.BOOLEAN))
            return self

        def add_categorical(self, name: str, categories: Sequence[str]) -> "Schema.Builder":
            self._cols.append(ColumnMeta(name, ColumnType.CATEGORICAL, tuple(categories)))
            return self

        def build(self) -> "Schema":
            return Schema(self._cols)

    @staticmethod
    def builder() -> "Schema.Builder":
        return Schema.Builder()
