"""The port's DataVec (`deeplearning4j_tpu_torch/datavec/`: readers, path
filters and label generators, schema, transforms, the executor, joins and
reductions, and the iterator bridge) against the JAX package's on the
same records, on the CPU.

Each scenario is one function of the package's ``datavec`` module (and
its ``data`` batches) that returns plain values; it runs once with the
JAX package and once with the port, and the two results must be equal
exactly: the same records, schemas, JSON and batch arrays, bit for bit.
The ImageRecordReader cases cover ``.npy``, PNG and JPEG trees in
float32 and uint8 (JPEG through the native batch decode where the host
has ``jpeglib.h``, else through PIL), with a shuffle seed.
"""

import dataclasses
import sqlite3
import warnings

import numpy as np
import pytest

import deeplearning4j_tpu.datavec as jdv
import deeplearning4j_tpu_torch.datavec as pdv
from deeplearning4j_tpu.datavec import bridge as jbridge
from deeplearning4j_tpu.datavec import executor as jexec
from deeplearning4j_tpu_torch.datavec import bridge as pbridge
from deeplearning4j_tpu_torch.datavec import executor as pexec

IRIS_CSV = """5.1,3.5,1.4,0.2,setosa
4.9,3.0,1.4,0.2,setosa
6.4,3.2,4.5,1.5,versicolor
6.9,3.1,4.9,1.5,versicolor
5.8,2.7,5.1,1.9,virginica
6.3,3.3,6.0,2.5,virginica
"""

PACKAGES = {"jax": (jdv, jbridge, jexec), "port": (pdv, pbridge, pexec)}


def _plain(x):
    """A comparable form of a scenario's result: arrays as (dtype,
    shape, bytes), batches as their arrays, containers recursively."""
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, np.ascontiguousarray(x).tobytes())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


def _iris_schema(dv):
    return (dv.Schema.builder().add_double("sl", "sw", "pl", "pw")
            .add_categorical("species", ["setosa", "versicolor", "virginica"]).build())


def _iris(dv):
    return [list(r) for r in dv.CSVRecordReader(text=IRIS_CSV)]


# -- scenarios: (package modules, tmp_path) -> plain values ------------------------


def s_csv_reader(m, tmp):
    dv = m[0]
    p = tmp / "d.csv"
    p.write_text("1,2.5,hello\n3,4.5,world\n-7,1e-3,x y\n")
    return [list(dv.CSVRecordReader(p)),
            list(dv.CSVRecordReader(text="header,x\n1,2\n", skip_lines=1))]


def s_line_and_collection_readers(m, tmp):
    dv = m[0]
    p = tmp / "t.txt"
    p.write_text("alpha\nbeta\n\ngamma\n")
    rr = dv.CollectionRecordReader([[1], [2], [3]])
    seen = []
    while rr.has_next():
        seen.append(rr.next_record())
    rr.reset()
    return [list(dv.LineRecordReader(p)), seen, rr.next_record(), list(rr)]


def s_csv_sequence_reader(m, tmp):
    dv = m[0]
    (tmp / "a.csv").write_text("1,2\n3,4\n5,6\n")
    (tmp / "b.csv").write_text("7,8\n")
    rr = dv.CSVSequenceRecordReader(tmp)
    return [list(rr), rr.num_sequences(), rr.sequence_lengths()]


def s_jdbc_reader(m, tmp):
    dv = m[0]
    db = str(tmp / "d.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (f1 REAL, f2 REAL, label INTEGER)")
    conn.executemany("INSERT INTO t VALUES (?,?,?)",
                     [(0.1, 1.0, 0), (0.2, 2.0, 1), (0.3, 3.0, 0)])
    conn.commit()
    conn.close()
    rr = dv.JDBCRecordReader(db, "SELECT f1, f2, label FROM t WHERE f2 >= ?", (2.0,))
    out = [rr.column_names(), list(rr)]
    rr.reset()
    out.append(rr.next_record())
    rr.close()
    return out


def _npy_tree(tmp, shape=(6, 6, 3), classes=("cat", "dog", "eel"), n=4):
    rng = np.random.default_rng(1)
    for c in classes:
        (tmp / c).mkdir()
        for i in range(n):
            np.save(tmp / c / f"{c}_{i}.npy",
                    (rng.random(shape) * 300 - 20).astype(np.float32))
    return tmp


def s_image_reader_npy(m, tmp):
    dv = m[0]
    _npy_tree(tmp)
    out = []
    for dtype in ("float32", "uint8"):
        rr = dv.ImageRecordReader(6, 6, 3, shuffle_seed=3, dtype=dtype).initialize(tmp)
        out.append([rr.labels, rr.num_labels(), list(rr)])
    # fixtures of another size are padded / cropped
    rr = dv.ImageRecordReader(4, 8, 2).initialize(tmp)
    out.append(list(rr))
    return out


def _png_tree(tmp):
    from PIL import Image

    rng = np.random.default_rng(2)
    for c in ("a", "b"):
        (tmp / c).mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (12, 20, 3)).astype(np.uint8)).save(
                tmp / c / f"{i}.png")
    return tmp


def s_image_reader_png(m, tmp):
    dv = m[0]
    _png_tree(tmp)
    return [list(dv.ImageRecordReader(8, 10, 3, dtype=d).initialize(tmp))
            for d in ("float32", "uint8")] + [
        list(dv.ImageRecordReader(8, 8, 1).initialize(tmp))]


def _jpeg_tree(tmp, n=5):
    from PIL import Image

    rng = np.random.default_rng(3)
    for c in ("c0", "c1"):
        (tmp / c).mkdir()
        for i in range(n):
            img = np.stack([np.linspace(0, 255, 40)[None, :] * np.ones((30, 1)),
                            rng.integers(0, 255, (30, 40)),
                            np.full((30, 40), 40.0 * i)], -1).astype(np.uint8)
            Image.fromarray(img).save(tmp / c / f"img_{i}.jpg", quality=85)
    return tmp


def s_image_reader_jpeg(m, tmp):
    dv = m[0]
    _jpeg_tree(tmp)
    return [list(dv.ImageRecordReader(16, 16, 3, shuffle_seed=0, dtype=d).initialize(tmp))
            for d in ("float32", "uint8")]


def s_label_generators_and_path_filters(m, tmp):
    dv = m[0]
    d = tmp / "all"
    d.mkdir()
    for cls, n in (("cat", 5), ("dog", 2)):
        for i in range(n):
            np.save(d / f"{cls}_{i}.npy", np.full((4, 4), float(i), np.float32))
    gen = dv.pattern_label_generator("_", 0)
    out = []
    for filt in (None, dv.balanced_path_filter(0, 2, label_generator=gen),
                 dv.random_path_filter(1, 3)):
        rr = dv.ImageRecordReader(4, 4, 1, label_generator=gen, path_filter=filt,
                                  shuffle_seed=5).initialize(tmp)
        out.append([rr.labels, list(rr)])
    with pytest.raises(ValueError, match="segment"):
        dv.ImageRecordReader(4, 4, 1, label_generator=dv.pattern_label_generator(
            "_", 5)).initialize(tmp)
    return out


def s_schema(m, tmp):
    dv = m[0]
    s = _iris_schema(dv)
    with pytest.raises(ValueError):
        dv.Schema.builder().add_double("x", "x").build()
    return [s.to_json(), s.num_columns(), s.index_of("pl"),
            s.meta("species").type.name, s.meta("species").categories,
            dv.Schema.from_json(s.to_json()) == s]


def s_transform_pipeline(m, tmp):
    dv = m[0]
    tp = (dv.TransformProcess.builder(_iris_schema(dv))
          .categorical_to_integer("species")
          .normalize_min_max("sl", 4.0, 8.0)
          .filter_rows("pw", "gt", 2.0)
          .double_math_op("sw", "multiply", 10.0)
          .replace_where("pl", "lt", 2.0, 0.0)
          .rename_column("pw", "petal_width")
          .add_constant_column("one", "double", 1.0)
          .reorder_columns("species", "sl")
          .build())
    oh = dv.TransformProcess.builder(_iris_schema(dv)).categorical_to_one_hot(
        "species").remove_columns("sw").build()
    return [tp.to_json(), tp.final_schema.column_names(), tp.execute(_iris(dv)),
            oh.execute(_iris(dv)), oh.final_schema.to_json(),
            dv.TransformProcess.from_json(tp.to_json()).execute(_iris(dv))]


def s_transform_derive(m, tmp):
    dv = m[0]
    s = dv.Schema.builder().add_double("a", "b").build()
    tp = (dv.TransformProcess.builder(s)
          .derive_column("sum", "double", ["a", "b"], fn=lambda x, y: x + y).build())
    with pytest.raises(ValueError, match="derive_column"):
        dv.TransformProcess.from_json(tp.to_json())
    return tp.execute([[2.0, 3.0], [-1.5, 0.25]])


def s_string_and_time_transforms(m, tmp):
    dv = m[0]
    schema = dv.Schema.builder().add_string("a").add_string("b").add_string("ts").build()
    tp = (dv.TransformProcess.builder(schema)
          .trim_string("a").change_case("a", "upper").string_map("a", {"CAT": "FELINE"})
          .replace_string("b", r"\d+", "#").replace_empty("b", "missing")
          .append_string("b", "!").prepend_string("b", ">")
          .concat_strings("ab", ["a", "b"], delimiter="|")
          .string_to_time("ts", "%Y-%m-%d %H:%M:%S %z")
          .derive_time_fields("ts", ["year", "hour", "day_of_week"])
          .build())
    rows = [[" cat ", "x42y", "2026-07-30 21:15:00 +0000"],
            ["dog", "", "2026-01-01 00:00:00 +0500"]]
    return [tp.execute(rows), tp.to_json(),
            dv.TransformProcess.from_json(tp.to_json()).execute(rows)]


def _seq_tp(dv, *extra):
    schema = dv.Schema.builder().add_string("device").add_integer("t").add_double("v").build()
    b = dv.TransformProcess.builder(schema).convert_to_sequence("device", "t")
    for f in extra:
        f(b)
    return b.build()


SEQ_ROWS = [["a", 2, 10.0], ["b", 1, 100.0], ["a", 1, 5.0],
            ["b", 3, 300.0], ["a", 3, 20.0], ["b", 2, 200.0]]


def s_sequence_transforms(m, tmp):
    dv = m[0]
    tps = [_seq_tp(dv),
           _seq_tp(dv, lambda b: b.offset_sequence(["v"], 1)),
           _seq_tp(dv, lambda b: b.sequence_moving_window_reduce("v", 2, "mean"),
                   lambda b: b.trim_sequence(1, from_start=True)),
           _seq_tp(dv, lambda b: b.double_math_op("v", "multiply", 2.0),
                   lambda b: b.filter_rows("v", "gte", 100.0))]
    return [[tp.execute([list(r) for r in SEQ_ROWS]), tp.to_json()] for tp in tps]


def _executor_tp(dv):
    schema = (dv.Schema.builder().add_double("x").add_double("y")
              .add_categorical("c", ["a", "b"]).build())
    return (dv.TransformProcess.builder(schema).double_math_op("x", "multiply", 2.0)
            .categorical_to_integer("c").filter_rows("y", "lt", 0.5).build())


def s_executor_parallel(m, tmp):
    dv = m[0]
    rng = np.random.default_rng(0)
    recs = [[float(i), float(rng.random()), "a" if i % 2 else "b"] for i in range(600)]
    tp = _executor_tp(dv)
    out = [dv.LocalTransformExecutor.execute(tp, recs, num_workers=2,
                                             min_records_per_worker=100),
           dv.LocalTransformExecutor.execute(tp, recs[:16], num_workers=2)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        seq = dv.LocalTransformExecutor.execute(
            _seq_tp(dv), SEQ_ROWS * 10, num_workers=2, min_records_per_worker=1)
    out += [seq, any("sequence" in str(w.message) for w in caught)]
    return out


def s_executor_worker_imports_no_torch(m, tmp):
    """The executor's worker loads the transform module by path: a
    fresh interpreter running it imports neither package's heavy
    dependencies."""
    import json
    import subprocess
    import sys

    ex = m[2]
    tp = _executor_tp(m[0])
    probe = ("import runpy, sys; sys.argv = [sys.argv[0]];"
             f"runpy.run_path({ex.__file__!r}, run_name='__main__');"
             "print('\\n' + repr(sorted(k for k in sys.modules if k in "
             "('torch', 'jax'))), file=sys.stderr)")
    proc = subprocess.run([sys.executable, "-S", "-c", probe], text=True,
                          input=json.dumps({"process": tp.to_json(),
                                            "records": [[1.0, 0.9, "a"], [2.0, 0.1, "b"]]}),
                          capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return [json.loads(proc.stdout), proc.stderr.strip().splitlines()[-1]]


def s_join_and_reduce(m, tmp):
    dv = m[0]
    left_s = dv.Schema.builder().add_integer("id").add_string("name").build()
    right_s = dv.Schema.builder().add_integer("id").add_double("score").build()
    left, right = [[1, "a"], [2, "b"], [3, "c"]], [[1, 0.5], [1, 0.7], [3, 0.9], [4, 0.1]]
    joins = [(kind, dv.Join(kind, left_s, right_s, "id").execute(left, right),
              dv.Join(kind, left_s, right_s, "id").output_schema().to_json())
             for kind in ("inner", "left_outer", "right_outer", "full_outer")]
    schema = (dv.Schema.builder().add_string("city").add_double("sales")
              .add_integer("n").build())
    records = [["ab", 10.0, 1], ["ab", 20.0, 2], ["cd", 5.0, 3], ["ab", 1.5, 7]]
    r = (dv.Reducer.builder(schema, "city").sum("sales").mean("sales").count("n")
         .max("n").min("sales").stdev("sales").first("n").last("n").build())
    with pytest.raises(ValueError, match="numeric"):
        dv.Reducer.builder(dv.Schema.builder().add_string("k").add_string("v").build(),
                           "k").sum("v").build()
    return [joins, r.output_schema().column_names(), r.execute(records)]


def s_bridge_classification_and_regression(m, tmp):
    dv = m[0]
    tp = dv.TransformProcess.builder(_iris_schema(dv)).categorical_to_integer(
        "species").build()
    rows = tp.execute(_iris(dv))
    out = [list(dv.RecordReaderDataSetIterator(dv.CollectionRecordReader(rows), 4,
                                               label_index=4, num_classes=3)),
           list(dv.RecordReaderDataSetIterator(dv.CollectionRecordReader(rows), 4,
                                               label_index=4, num_classes=3,
                                               drop_last=True)),
           list(dv.RecordReaderDataSetIterator(
               dv.CollectionRecordReader([[1.0, 2.0, 10.0, 20.0], [3.0, 4.0, 30.0, 40.0]]),
               2, label_index=2, label_index_to=3, regression=True)),
           list(dv.RecordReaderDataSetIterator(dv.CollectionRecordReader(rows), 5))]
    with pytest.raises(ValueError, match="out of range"):
        list(dv.RecordReaderDataSetIterator(dv.CollectionRecordReader([[1.0, 5]]), 1,
                                            label_index=1, num_classes=3))
    return out


def s_bridge_images_uint8(m, tmp):
    dv = m[0]
    _npy_tree(tmp)
    rr = dv.ImageRecordReader(6, 6, 3, shuffle_seed=0, dtype="uint8").initialize(tmp)
    it = dv.RecordReaderDataSetIterator(rr, 5, label_index=1, num_classes=3)
    first = list(it)
    it.reset()
    return [first, list(it)]


def s_sequence_bridge_buckets(m, tmp):
    dv = m[0]
    rng = np.random.default_rng(4)
    for i, t in enumerate((3, 9, 5, 1, 12, 7, 4)):
        rows = [f"{rng.random():.4f},{rng.random():.4f},{int(rng.integers(0, 3))}"
                for _ in range(t)]
        (tmp / f"s{i}.csv").write_text("\n".join(rows) + "\n")
    out = []
    for kw in (dict(label_index=2, num_classes=3, bucket_size=4),
               dict(label_index=2, regression=True, bucket_size=8),
               dict(bucket_size=5)):
        it = dv.SequenceRecordReaderDataSetIterator(dv.CSVSequenceRecordReader(tmp),
                                                    3, **kw)
        out.append(list(it))
    return out


SCENARIOS = [s_csv_reader, s_line_and_collection_readers, s_csv_sequence_reader,
             s_jdbc_reader, s_image_reader_npy, s_image_reader_png, s_image_reader_jpeg,
             s_label_generators_and_path_filters, s_schema, s_transform_pipeline,
             s_transform_derive, s_string_and_time_transforms, s_sequence_transforms,
             s_executor_parallel, s_executor_worker_imports_no_torch, s_join_and_reduce,
             s_bridge_classification_and_regression, s_bridge_images_uint8,
             s_sequence_bridge_buckets]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[2:])
def test_port_matches_jax(scenario, tmp_path):
    results = {}
    for name, mods in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        results[name] = _plain(scenario(mods, d))
    assert results["port"] == results["jax"]


def test_all_matches_the_jax_package():
    assert sorted(pdv.__all__) == sorted(jdv.__all__)
    for name in pdv.__all__:
        assert getattr(pdv, name).__module__.startswith("deeplearning4j_tpu_torch.")


def test_a_transform_process_json_crosses_packages():
    """A process written by either package's ``to_json`` rebuilds in the
    other and executes to the same records."""
    jtp = (jdv.TransformProcess.builder(_iris_schema(jdv)).categorical_to_integer("species")
           .normalize_min_max("sl", 4.0, 8.0).filter_rows("pw", "gt", 2.0).build())
    ptp = pdv.TransformProcess.from_json(jtp.to_json())
    assert ptp.execute(_iris(pdv)) == jtp.execute(_iris(jdv))
    back = jdv.TransformProcess.from_json(ptp.to_json())
    assert back.execute(_iris(jdv)) == ptp.execute(_iris(pdv))
    assert ptp.to_json() == jtp.to_json()
