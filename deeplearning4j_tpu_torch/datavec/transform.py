"""Declarative column transforms — the `TransformProcess` role.

Reference: `org.datavec.api.transform.TransformProcess` — a builder of
column operations, each mapping (Schema, records) → (Schema, records),
executed by a local or Spark executor (SURVEY.md §2.2).  Here the executor
is local and vectorized where possible; the Spark tier's role (cluster ETL)
belongs to the data-parallel input pipeline, not a JVM cluster.

Each step is (schema_fn, records_fn); the process composes them and exposes
`final_schema` statically — same contract as the reference, so a pipeline's
output layout is known before any data flows.

The port keeps its own copy of `deeplearning4j_tpu/datavec/transform.py`, which
imports no JAX: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from typing import Callable, List, Optional, Sequence

from deeplearning4j_tpu_torch.datavec.schema import ColumnMeta, ColumnType, Schema

Records = List[list]


class _Step:
    def __init__(self, name: str, schema_fn, records_fn, spec: dict):
        self.name = name
        self.schema_fn = schema_fn
        self.records_fn = records_fn
        self.spec = spec  # JSON-serializable description


class TransformProcess:
    """Composed, schema-checked column pipeline with a builder DSL."""

    def __init__(self, initial_schema: Schema, steps: Sequence[_Step]):
        self.initial_schema = initial_schema
        self.steps = list(steps)
        # propagate schemas eagerly: config errors surface at build time,
        # matching the reference's behavior.
        s = initial_schema
        self._schemas = [s]
        for st in self.steps:
            s = st.schema_fn(s)
            self._schemas.append(s)

    @property
    def final_schema(self) -> Schema:
        return self._schemas[-1]

    #: builder step kinds that operate on WHOLE sequences (after
    #: convert_to_sequence the record stream is List[sequence] =
    #: List[List[row]]; plain column steps map over each sequence)
    _SEQ_KINDS = frozenset({
        "convert_to_sequence", "offset_sequence", "trim_sequence",
        "sequence_moving_window_reduce",
    })

    def execute(self, records: Records) -> Records:
        out = [list(r) for r in records]
        seq_mode = False
        for st, schema in zip(self.steps, self._schemas[:-1]):
            kind = st.spec.get("kind")
            if kind == "convert_to_sequence":
                out = st.records_fn(schema, out)
                seq_mode = True
            elif kind in self._SEQ_KINDS:
                out = st.records_fn(schema, out)
            elif seq_mode:
                out = [st.records_fn(schema, seq) for seq in out]
                # row filters may empty a sequence entirely
                out = [seq for seq in out if seq]
            else:
                out = st.records_fn(schema, out)
        return out

    @property
    def emits_sequences(self) -> bool:
        """True when execute() returns List[sequence] (the reference's
        convertToSequence switches the pipeline to sequence records)."""
        return any(
            st.spec.get("kind") == "convert_to_sequence" for st in self.steps
        )

    def to_json(self) -> str:
        return json.dumps(
            {
                "initial_schema": json.loads(self.initial_schema.to_json()),
                "steps": [s.spec for s in self.steps],
            }
        )

    @staticmethod
    def from_json(text: str) -> "TransformProcess":
        d = json.loads(text)
        schema = Schema.from_json(json.dumps(d["initial_schema"]))
        b = TransformProcess.builder(schema)
        for spec in d["steps"]:
            kind = spec["kind"]
            if kind == "derive_column":
                # the custom fn is not serializable (reference parity: custom
                # transforms round-trip by class name only) — fail loudly
                # instead of rebuilding a pipeline that crashes at execute.
                raise ValueError(
                    "cannot deserialize a derive_column step: its fn is not "
                    "JSON-serializable; rebuild the pipeline in code"
                )
            args = {k: v for k, v in spec.items() if k != "kind"}
            if not hasattr(b, kind):
                raise ValueError(f"unknown transform step {kind!r}")
            if kind in ("remove_columns", "keep_columns", "reorder_columns"):
                # these builders are declared (*names); their spec
                # serializes {"names": [...]} — unpack positionally
                getattr(b, kind)(*args["names"])
            else:
                getattr(b, kind)(**args)
        return b.build()

    @staticmethod
    def builder(schema: Schema) -> "TransformProcess.Builder":
        return TransformProcess.Builder(schema)

    # ------------------------------------------------------------------
    class Builder:
        def __init__(self, schema: Schema):
            self._schema = schema
            self._steps: List[_Step] = []

        def build(self) -> "TransformProcess":
            return TransformProcess(self._schema, self._steps)

        def _add(self, name, schema_fn, records_fn, spec):
            self._steps.append(_Step(name, schema_fn, records_fn, spec))
            self._running_schema = schema_fn(self._current_schema())
            return self

        def _require_sequence_mode(self, kind: str):
            if not any(
                st.spec.get("kind") == "convert_to_sequence"
                for st in self._steps
            ):
                raise ValueError(
                    f"{kind} operates on sequences; add "
                    "convert_to_sequence(key, sort) earlier in the pipeline"
                )

        # --- column selection ---------------------------------------
        def remove_columns(self, *names: str):
            names_l = list(names) if not (len(names) == 1 and isinstance(names[0], list)) else list(names[0])

            def schema_fn(s: Schema) -> Schema:
                for n in names_l:
                    s.index_of(n)
                return Schema([c for c in s.columns if c.name not in names_l])

            def records_fn(s: Schema, recs: Records) -> Records:
                keep = [i for i, c in enumerate(s.columns) if c.name not in names_l]
                return [[r[i] for i in keep] for r in recs]

            return self._add("remove_columns", schema_fn, records_fn, {"kind": "remove_columns", "names": names_l})

        def keep_columns(self, *names: str):
            names_l = list(names) if not (len(names) == 1 and isinstance(names[0], list)) else list(names[0])

            def schema_fn(s: Schema) -> Schema:
                return Schema([s.meta(n) for n in names_l])

            def records_fn(s: Schema, recs: Records) -> Records:
                idx = [s.index_of(n) for n in names_l]
                return [[r[i] for i in idx] for r in recs]

            return self._add("keep_columns", schema_fn, records_fn, {"kind": "keep_columns", "names": names_l})

        def rename_column(self, old: str, new: str):
            def schema_fn(s: Schema) -> Schema:
                i = s.index_of(old)
                cols = list(s.columns)
                cols[i] = ColumnMeta(new, cols[i].type, cols[i].categories)
                return Schema(cols)

            return self._add(
                "rename_column", schema_fn, lambda s, recs: recs,
                {"kind": "rename_column", "old": old, "new": new},
            )

        def reorder_columns(self, *names: str):
            names_l = list(names) if not (len(names) == 1 and isinstance(names[0], list)) else list(names[0])

            def schema_fn(s: Schema) -> Schema:
                rest = [c.name for c in s.columns if c.name not in names_l]
                return Schema([s.meta(n) for n in names_l + rest])

            def records_fn(s: Schema, recs: Records) -> Records:
                rest = [c.name for c in s.columns if c.name not in names_l]
                idx = [s.index_of(n) for n in names_l + rest]
                return [[r[i] for i in idx] for r in recs]

            return self._add("reorder_columns", schema_fn, records_fn, {"kind": "reorder_columns", "names": names_l})

        # --- categorical --------------------------------------------
        def string_to_categorical(self, name: str, categories: Sequence[str]):
            cats = tuple(categories)

            def schema_fn(s: Schema) -> Schema:
                i = s.index_of(name)
                cols = list(s.columns)
                cols[i] = ColumnMeta(name, ColumnType.CATEGORICAL, cats)
                return Schema(cols)

            def records_fn(s: Schema, recs: Records) -> Records:
                i = s.index_of(name)
                for r in recs:
                    if r[i] not in cats:
                        raise ValueError(f"value {r[i]!r} not in categories {cats} for column {name!r}")
                return recs

            return self._add(
                "string_to_categorical", schema_fn, records_fn,
                {"kind": "string_to_categorical", "name": name, "categories": list(cats)},
            )

        def categorical_to_integer(self, name: str):
            def schema_fn(s: Schema) -> Schema:
                i = s.index_of(name)
                if s.columns[i].type != ColumnType.CATEGORICAL:
                    raise ValueError(f"{name!r} is not categorical")
                cols = list(s.columns)
                cols[i] = ColumnMeta(name, ColumnType.INTEGER)
                return Schema(cols)

            def records_fn(s: Schema, recs: Records) -> Records:
                i = s.index_of(name)
                lookup = {c: j for j, c in enumerate(s.columns[i].categories)}
                for r in recs:
                    r[i] = lookup[r[i]]
                return recs

            return self._add(
                "categorical_to_integer", schema_fn, records_fn,
                {"kind": "categorical_to_integer", "name": name},
            )

        def categorical_to_one_hot(self, name: str):
            def schema_fn(s: Schema) -> Schema:
                i = s.index_of(name)
                if s.columns[i].type != ColumnType.CATEGORICAL:
                    raise ValueError(f"{name!r} is not categorical")
                cols = list(s.columns)
                onehot = [ColumnMeta(f"{name}[{c}]", ColumnType.INTEGER) for c in s.columns[i].categories]
                return Schema(cols[:i] + onehot + cols[i + 1:])

            def records_fn(s: Schema, recs: Records) -> Records:
                i = s.index_of(name)
                cats = s.columns[i].categories
                lookup = {c: j for j, c in enumerate(cats)}
                out = []
                for r in recs:
                    vec = [0] * len(cats)
                    vec[lookup[r[i]]] = 1
                    out.append(r[:i] + vec + r[i + 1:])
                return out

            return self._add(
                "categorical_to_one_hot", schema_fn, records_fn,
                {"kind": "categorical_to_one_hot", "name": name},
            )

        # --- math ----------------------------------------------------
        def double_math_op(self, name: str, op: str, scalar: float):
            ops = {
                "add": lambda v: v + scalar,
                "subtract": lambda v: v - scalar,
                "multiply": lambda v: v * scalar,
                "divide": lambda v: v / scalar,
                "power": lambda v: v ** scalar,
            }
            if op not in ops:
                raise ValueError(f"unknown op {op!r}; have {sorted(ops)}")

            def schema_fn(s: Schema) -> Schema:
                i = s.index_of(name)
                cols = list(s.columns)
                cols[i] = ColumnMeta(name, ColumnType.DOUBLE)
                return Schema(cols)

            def records_fn(s: Schema, recs: Records) -> Records:
                i = s.index_of(name)
                f = ops[op]
                for r in recs:
                    r[i] = f(float(r[i]))
                return recs

            return self._add(
                "double_math_op", schema_fn, records_fn,
                {"kind": "double_math_op", "name": name, "op": op, "scalar": scalar},
            )

        def normalize_min_max(self, name: str, min_val: float, max_val: float):
            """Scale [min_val, max_val] → [0, 1] (reference Normalize.MinMax)."""
            span = max_val - min_val

            def schema_fn(s: Schema) -> Schema:
                i = s.index_of(name)
                cols = list(s.columns)
                cols[i] = ColumnMeta(name, ColumnType.DOUBLE)
                return Schema(cols)

            def records_fn(s: Schema, recs: Records) -> Records:
                i = s.index_of(name)
                for r in recs:
                    r[i] = (float(r[i]) - min_val) / span
                return recs

            return self._add(
                "normalize_min_max", schema_fn, records_fn,
                {"kind": "normalize_min_max", "name": name, "min_val": min_val, "max_val": max_val},
            )

        def normalize_standardize(self, name: str, mean: float, std: float):
            def schema_fn(s: Schema) -> Schema:
                i = s.index_of(name)
                cols = list(s.columns)
                cols[i] = ColumnMeta(name, ColumnType.DOUBLE)
                return Schema(cols)

            def records_fn(s: Schema, recs: Records) -> Records:
                i = s.index_of(name)
                for r in recs:
                    r[i] = (float(r[i]) - mean) / std
                return recs

            return self._add(
                "normalize_standardize", schema_fn, records_fn,
                {"kind": "normalize_standardize", "name": name, "mean": mean, "std": std},
            )

        # --- filter / replace ---------------------------------------
        def filter_rows(self, name: str, condition: str, value):
            """Drop rows where the condition HOLDS (reference FilterInvalidValues/
            ConditionFilter semantics: filter = remove matching)."""
            conds = {
                "lt": lambda v: v < value,
                "lte": lambda v: v <= value,
                "gt": lambda v: v > value,
                "gte": lambda v: v >= value,
                "eq": lambda v: v == value,
                "neq": lambda v: v != value,
            }
            if condition not in conds:
                raise ValueError(f"unknown condition {condition!r}")

            def records_fn(s: Schema, recs: Records) -> Records:
                i = s.index_of(name)
                f = conds[condition]
                return [r for r in recs if not f(r[i])]

            return self._add(
                "filter_rows", lambda s: s, records_fn,
                {"kind": "filter_rows", "name": name, "condition": condition, "value": value},
            )

        def replace_where(self, name: str, condition: str, value, replacement):
            conds = {
                "lt": lambda v: v < value,
                "lte": lambda v: v <= value,
                "gt": lambda v: v > value,
                "gte": lambda v: v >= value,
                "eq": lambda v: v == value,
                "neq": lambda v: v != value,
            }
            if condition not in conds:
                raise ValueError(f"unknown condition {condition!r}; have {sorted(conds)}")

            def records_fn(s: Schema, recs: Records) -> Records:
                i = s.index_of(name)
                f = conds[condition]
                for r in recs:
                    if f(r[i]):
                        r[i] = replacement
                return recs

            return self._add(
                "replace_where", lambda s: s, records_fn,
                {"kind": "replace_where", "name": name, "condition": condition,
                 "value": value, "replacement": replacement},
            )

        # --- derived columns ----------------------------------------
        def add_constant_column(self, name: str, col_type: str, value):
            def schema_fn(s: Schema) -> Schema:
                return Schema(list(s.columns) + [ColumnMeta(name, ColumnType(col_type))])

            def records_fn(s: Schema, recs: Records) -> Records:
                for r in recs:
                    r.append(value)
                return recs

            return self._add(
                "add_constant_column", schema_fn, records_fn,
                {"kind": "add_constant_column", "name": name, "col_type": col_type, "value": value},
            )

        # --- string transforms (the reference's StringMap / ReplaceString
        # / ChangeCase / Append / ReplaceEmpty / Concatenate family) ------
        def _require_string(self, name: str):
            m = self._current_schema().meta(name)
            if m.type != ColumnType.STRING:
                raise ValueError(
                    f"column {name!r} is {m.type}, expected STRING"
                )

        def _current_schema(self) -> Schema:
            # running schema, updated incrementally per _add — replaying
            # every prior schema_fn here would make builds O(steps^2)
            if not hasattr(self, "_running_schema"):
                self._running_schema = self._schema
            return self._running_schema

        def _string_op(self, kind: str, name: str, fn, spec_extra: dict):
            self._require_string(name)

            def records_fn(s: Schema, recs: Records) -> Records:
                i = s.index_of(name)
                for r in recs:
                    r[i] = fn(str(r[i]))
                return recs

            return self._add(kind, lambda s: s, records_fn,
                             {"kind": kind, "name": name, **spec_extra})

        def string_map(self, name: str, mapping: dict):
            """Exact-match value replacement (StringMapTransform role)."""
            m = dict(mapping)
            return self._string_op(
                "string_map", name, lambda v: m.get(v, v),
                {"mapping": m},
            )

        def replace_string(self, name: str, regex: str, replacement: str):
            """Regex substitution (ReplaceStringTransform role)."""
            import re as _re

            pat = _re.compile(regex)
            return self._string_op(
                "replace_string", name,
                lambda v: pat.sub(replacement, v),
                {"regex": regex, "replacement": replacement},
            )

        def change_case(self, name: str, mode: str = "lower"):
            if mode not in ("lower", "upper"):
                raise ValueError(f"change_case mode must be lower/upper, got {mode!r}")
            return self._string_op(
                "change_case", name,
                (str.lower if mode == "lower" else str.upper),
                {"mode": mode},
            )

        def append_string(self, name: str, suffix: str):
            return self._string_op(
                "append_string", name, lambda v: v + suffix,
                {"suffix": suffix},
            )

        def prepend_string(self, name: str, prefix: str):
            return self._string_op(
                "prepend_string", name, lambda v: prefix + v,
                {"prefix": prefix},
            )

        def trim_string(self, name: str):
            return self._string_op("trim_string", name, str.strip, {})

        def replace_empty(self, name: str, value: str):
            return self._string_op(
                "replace_empty", name,
                lambda v: value if v == "" else v,
                {"value": value},
            )

        def concat_strings(self, new_name: str, sources: Sequence[str],
                           delimiter: str = ""):
            """New STRING column joining existing string columns
            (ConcatenateStringColumns role)."""
            srcs = list(sources)
            cur = self._current_schema()
            for n in srcs:
                m = cur.meta(n)
                if m.type != ColumnType.STRING:
                    raise ValueError(
                        f"concat_strings source {n!r} is {m.type}, "
                        "expected STRING"
                    )

            def schema_fn(s: Schema) -> Schema:
                return Schema(
                    list(s.columns) + [ColumnMeta(new_name, ColumnType.STRING)]
                )

            def records_fn(s: Schema, recs: Records) -> Records:
                idx = [s.index_of(n) for n in srcs]
                for r in recs:
                    r.append(delimiter.join(str(r[i]) for i in idx))
                return recs

            return self._add(
                "concat_strings", schema_fn, records_fn,
                {"kind": "concat_strings", "new_name": new_name,
                 "sources": srcs, "delimiter": delimiter},
            )

        # --- time transforms (StringToTime / DeriveColumnsFromTime) -----
        def string_to_time(self, name: str, fmt: str):
            """Parse a STRING column into a TIME column of epoch MILLIS
            (StringToTimeTransform role).  fmt is strptime syntax; naive
            timestamps are taken as UTC, an offset in the format (%z) is
            honored."""
            import datetime as _dt

            self._require_string(name)

            def schema_fn(s: Schema) -> Schema:
                i = s.index_of(name)
                cols = list(s.columns)
                cols[i] = ColumnMeta(name, ColumnType.TIME)
                return Schema(cols)

            def records_fn(s: Schema, recs: Records) -> Records:
                i = s.index_of(name)
                for r in recs:
                    t = _dt.datetime.strptime(str(r[i]), fmt)
                    if t.tzinfo is None:
                        t = t.replace(tzinfo=_dt.timezone.utc)
                    r[i] = int(t.timestamp() * 1000)
                return recs

            return self._add(
                "string_to_time", schema_fn, records_fn,
                {"kind": "string_to_time", "name": name, "fmt": fmt},
            )

        _TIME_FIELDS = ("year", "month", "day", "hour", "minute", "second",
                        "day_of_week")

        def derive_time_fields(self, name: str, fields: Sequence[str]):
            """From an epoch-millis LONG column, append INTEGER columns for
            the requested UTC fields (DeriveColumnsFromTimeTransform role)."""
            import datetime as _dt

            fields = list(fields)
            bad = [f for f in fields if f not in self._TIME_FIELDS]
            if bad:
                raise ValueError(
                    f"unknown time fields {bad}; options: {self._TIME_FIELDS}"
                )
            m = self._current_schema().meta(name)
            if m.type not in (ColumnType.TIME, ColumnType.LONG,
                              ColumnType.INTEGER):
                raise ValueError(
                    f"column {name!r} is {m.type}, expected TIME/LONG "
                    "epoch millis"
                )

            def schema_fn(s: Schema) -> Schema:
                return Schema(
                    list(s.columns)
                    + [ColumnMeta(f"{name}_{f}", ColumnType.INTEGER)
                       for f in fields]
                )

            def records_fn(s: Schema, recs: Records) -> Records:
                i = s.index_of(name)
                for r in recs:
                    t = _dt.datetime.fromtimestamp(
                        int(r[i]) / 1000.0, tz=_dt.timezone.utc
                    )
                    for f in fields:
                        if f == "day_of_week":
                            r.append(t.weekday())
                        else:
                            r.append(getattr(t, f))
                return recs

            return self._add(
                "derive_time_fields", schema_fn, records_fn,
                {"kind": "derive_time_fields", "name": name,
                 "fields": fields},
            )

        def derive_column(self, name: str, col_type: str, sources: Sequence[str],
                          fn: Optional[Callable] = None):
            """Custom derived column.  `fn(*source_values)`; not JSON round-trippable
            (reference parity: custom transforms serialize by class name only)."""
            srcs = list(sources)

            def schema_fn(s: Schema) -> Schema:
                for n in srcs:
                    s.index_of(n)
                return Schema(list(s.columns) + [ColumnMeta(name, ColumnType(col_type))])

            def records_fn(s: Schema, recs: Records) -> Records:
                idx = [s.index_of(n) for n in srcs]
                for r in recs:
                    r.append(fn(*[r[i] for i in idx]))
                return recs

            return self._add(
                "derive_column", schema_fn, records_fn,
                {"kind": "derive_column", "name": name, "col_type": col_type, "sources": srcs},
            )

        # --- sequence operations (the reference's convertToSequence /
        # offset / trim / moving-window sequence transforms) -----------
        def convert_to_sequence(self, key_column: str, sort_column: str):
            """Group rows by key, sort each group by sort_column: the
            record stream becomes List[sequence].  Subsequent column
            steps apply per step-row within each sequence; sequence
            steps below operate on whole sequences."""

            def schema_fn(s: Schema) -> Schema:
                s.index_of(key_column)
                s.index_of(sort_column)
                return s

            def records_fn(s: Schema, recs: Records) -> Records:
                ki, si = s.index_of(key_column), s.index_of(sort_column)
                groups: dict = {}
                order = []
                for r in recs:
                    k = r[ki]
                    if k not in groups:
                        groups[k] = []
                        order.append(k)
                    groups[k].append(r)
                return [
                    sorted(groups[k], key=lambda r: r[si]) for k in order
                ]

            return self._add(
                "convert_to_sequence", schema_fn, records_fn,
                {"kind": "convert_to_sequence", "key_column": key_column,
                 "sort_column": sort_column},
            )

        def offset_sequence(self, columns, offset: int):
            self._require_sequence_mode("offset_sequence")
            """Shift the named columns by `offset` steps WITHIN each
            sequence (positive = values move toward later steps — lag
            features; negative = lead).  Steps that lose a value are
            trimmed, so every emitted row is fully populated."""
            cols = list(columns) if not isinstance(columns, str) else [columns]

            def schema_fn(s: Schema) -> Schema:
                for c in cols:
                    s.index_of(c)
                return s

            def records_fn(s: Schema, seqs: Records) -> Records:
                idx = [s.index_of(c) for c in cols]
                out = []
                for seq in seqs:
                    n = len(seq)
                    k = abs(offset)
                    if n <= k:
                        continue
                    rows = []
                    if offset > 0:
                        # row t carries column value from t-offset
                        for t in range(k, n):
                            r = list(seq[t])
                            for i in idx:
                                r[i] = seq[t - k][i]
                            rows.append(r)
                    else:
                        for t in range(0, n - k):
                            r = list(seq[t])
                            for i in idx:
                                r[i] = seq[t + k][i]
                            rows.append(r)
                    out.append(rows)
                return out

            return self._add(
                "offset_sequence", schema_fn, records_fn,
                {"kind": "offset_sequence", "columns": cols,
                 "offset": offset},
            )

        def trim_sequence(self, num_steps: int, from_start: bool = True):
            self._require_sequence_mode("trim_sequence")
            """Drop num_steps rows from the start (or end) of every
            sequence; sequences that would empty are removed."""

            def records_fn(s: Schema, seqs: Records) -> Records:
                out = []
                for seq in seqs:
                    t = seq[num_steps:] if from_start else (
                        seq[:-num_steps] if num_steps else seq
                    )
                    if t:
                        out.append(t)
                return out

            return self._add(
                "trim_sequence", lambda s: s, records_fn,
                {"kind": "trim_sequence", "num_steps": num_steps,
                 "from_start": from_start},
            )

        def sequence_moving_window_reduce(self, column: str, window: int,
                                          op: str = "mean"):
            self._require_sequence_mode("sequence_moving_window_reduce")
            if int(window) < 1:
                raise ValueError(f"window must be >= 1, got {window}")
            """New column <column>_<op>_<window>: the op over the
            TRAILING window ending at each step (fewer at the head —
            the reference's SequenceMovingWindowReduce edge behavior)."""
            ops = {
                "mean": lambda v: sum(v) / len(v),
                "sum": sum,
                "min": min,
                "max": max,
            }
            if op not in ops:
                raise ValueError(
                    f"unknown moving-window op {op!r}; have {sorted(ops)}"
                )
            new_name = f"{column}_{op}_{window}"

            def schema_fn(s: Schema) -> Schema:
                s.index_of(column)
                return Schema(
                    list(s.columns)
                    + [ColumnMeta(new_name, ColumnType.DOUBLE)]
                )

            def records_fn(s: Schema, seqs: Records) -> Records:
                ci = s.index_of(column)
                out = []
                for seq in seqs:
                    rows = []
                    for t, r in enumerate(seq):
                        lo = max(0, t - window + 1)
                        vals = [float(seq[u][ci]) for u in range(lo, t + 1)]
                        rows.append(list(r) + [ops[op](vals)])
                    out.append(rows)
                return out

            return self._add(
                "sequence_moving_window_reduce", schema_fn, records_fn,
                {"kind": "sequence_moving_window_reduce", "column": column,
                 "window": window, "op": op},
            )
