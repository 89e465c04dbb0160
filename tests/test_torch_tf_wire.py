"""The port's protobuf wire codec (`deeplearning4j_tpu_torch/modelimport/
_tf/wire.py`) and graph writer against the JAX package's
``google.protobuf`` messages (`tf_graph_subset_pb2`) and writer: bytes
either side writes parse on the other into equal messages."""

import struct

import numpy as np
import pytest

from deeplearning4j_tpu.modelimport._tf import tf_graph_subset_pb2 as pb
from deeplearning4j_tpu.modelimport._tf.synthetic import (
    build_bert_classifier_graphdef as jax_bert,
)
from deeplearning4j_tpu.modelimport.tensorflow import _tensor_to_np as jax_tensor_to_np
from deeplearning4j_tpu_torch.modelimport._tf import wire
from deeplearning4j_tpu_torch.modelimport._tf.synthetic import (
    FrozenGraphWriter,
    build_bert_classifier_graphdef,
)
from deeplearning4j_tpu_torch.modelimport.tensorflow import _Importer, _tensor_to_np

SMALL = dict(vocab=128, d_model=32, n_layers=2, n_heads=2, seq_len=16, batch=4,
             n_classes=2, seed=4)


def _port(raw, cls=wire.GraphDef):
    m = cls()
    m.ParseFromString(raw)
    return m


def _jax(raw, cls=pb.GraphDef):
    m = cls()
    m.ParseFromString(raw)
    return m


def _attr_value(a):
    """An AttrValue as plain Python, through the importer's own reader."""
    kind = a.WhichOneof("value")
    if kind == "tensor":
        return ("tensor", a.tensor.dtype, [d.size for d in a.tensor.tensor_shape.dim],
                bytes(a.tensor.tensor_content))
    node = type("N", (), {"attr": {"k": a}})()
    return kind, _Importer.attr(node, "k")


def test_jax_writers_bert_decodes_to_the_same_nodes_attributes_and_tensors():
    raw = jax_bert(**SMALL)
    j, p = _jax(raw), _port(raw)
    assert len(p.node) == len(j.node) and p.versions.producer == j.versions.producer
    for pn, jn in zip(p.node, j.node):
        assert (pn.name, pn.op, list(pn.input)) == (jn.name, jn.op, list(jn.input))
        assert sorted(pn.attr) == sorted(jn.attr)
        for k in jn.attr:
            assert _attr_value(pn.attr[k]) == _attr_value(jn.attr[k]), (pn.name, k)
        if pn.op == "Const":
            want = jax_tensor_to_np(jn.attr["value"].tensor)
            got = _tensor_to_np(pn.attr["value"].tensor)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    SMALL,
    dict(SMALL, n_layers=1, n_heads=4, batch=2, seed=9),
    dict(vocab=30, d_model=8, n_layers=3, n_heads=2, seq_len=6, batch=3, n_classes=5, seed=0),
])
def test_port_writer_parses_with_pb2_equal_to_the_jax_writer(kw):
    raw = build_bert_classifier_graphdef(**kw)
    assert _jax(raw) == _jax(jax_bert(**kw))


def test_tensor_content_is_a_zero_copy_view_of_the_input():
    raw = build_bert_classifier_graphdef(**SMALL)
    g = _port(raw)
    t = next(n for n in g.node if n.name == "embeddings/word").attr["value"].tensor
    view = t.tensor_content
    assert isinstance(view, memoryview) and view.obj is raw
    assert len(view) == SMALL["vocab"] * SMALL["d_model"] * 4
    arr = _tensor_to_np(t)
    assert not arr.flags.writeable and arr.shape == (SMALL["vocab"], SMALL["d_model"])


def test_a_parsed_graph_reserializes_to_an_equal_message():
    # maps carry no order, so bytes may differ where attr entries do
    raw = jax_bert(**SMALL)
    again = _port(raw).SerializeToString()
    assert _jax(again) == _jax(raw) and len(again) == len(raw)


def test_negative_int64_and_int32_take_ten_bytes_both_ways():
    j = pb.AttrValue()
    j.list.i.extend([-1, 2**40, -(2**63), 2**63 - 1, 0])
    p = wire.AttrValue()
    p.list.i.extend([-1, 2**40, -(2**63), 2**63 - 1, 0])
    assert p.SerializeToString() == j.SerializeToString()
    assert list(_port(j.SerializeToString(), wire.AttrValue).list.i) == list(j.list.i)
    jt = pb.TensorProto(dtype=pb.DT_INT32, version_number=-7)
    jt.int_val.extend([-5, 3])
    jt.tensor_shape.dim.add().size = -1
    pt = _port(jt.SerializeToString(), wire.TensorProto)
    assert pt.version_number == -7 and list(pt.int_val) == [-5, 3]
    assert pt.tensor_shape.dim[0].size == -1
    assert pt.SerializeToString() == jt.SerializeToString()
    single = wire.AttrValue(i=-3).SerializeToString()
    assert len(single) == 1 + 10 and _jax(single, pb.AttrValue).i == -3


def test_packed_and_unpacked_repeated_fields_read_alike():
    vals = [3, -1, 70000, 0]
    packed = pb.TensorProto()
    packed.int_val.extend(vals)
    packed.float_val.extend([1.5, -2.25])
    packed.bool_val.extend([True, False, True])
    # the same fields written unpacked: one tag per element
    unpacked = b"".join(wire._varint((7 << 3) | 0) + wire._varint(v) for v in vals)
    unpacked += b"".join(wire._varint((5 << 3) | 5) + struct.pack("<f", v)
                         for v in (1.5, -2.25))
    unpacked += b"".join(wire._varint((11 << 3) | 0) + wire._varint(int(v))
                         for v in (True, False, True))
    for raw in (packed.SerializeToString(), unpacked):
        t = _port(raw, wire.TensorProto)
        assert list(t.int_val) == vals and list(t.float_val) == [1.5, -2.25]
        assert list(t.bool_val) == [True, False, True]
        assert _jax(t.SerializeToString(), pb.TensorProto) == packed
    assert _jax(unpacked, pb.TensorProto) == packed


def test_unknown_fields_are_skipped():
    node = pb.NodeDef(name="n", op="Add", device="/cpu:0")
    node.input.extend(["a", "b:1", "^c"])
    node.attr["T"].type = pb.DT_FLOAT
    extra = (wire._varint((99 << 3) | 0) + wire._varint(2**50)            # varint
             + wire._varint((100 << 3) | 2) + wire._varint(3) + b"xyz"   # bytes
             + wire._varint((101 << 3) | 5) + b"\0\0\0\0"                # fixed32
             + wire._varint((102 << 3) | 1) + b"\0" * 8                  # fixed64
             + wire._varint((103 << 3) | 3) + wire._varint((1 << 3) | 0) + b"\x05"
             + wire._varint((103 << 3) | 4))                             # a group
    raw = extra + node.SerializeToString() + extra
    p = _port(raw, wire.NodeDef)
    assert (p.name, p.op, list(p.input), p.device) == ("n", "Add", ["a", "b:1", "^c"], "/cpu:0")
    assert p.attr["T"].type == pb.DT_FLOAT
    assert _jax(p.SerializeToString(), pb.NodeDef) == node


def test_truncated_bytes_raise():
    raw = build_bert_classifier_graphdef(**SMALL)
    with pytest.raises(wire.DecodeError):
        _port(raw[:1000])


def _function_library(mod, msg):
    """A GraphDef with a FunctionDef library written through ``mod``'s
    API (the generated pb2 or the port's codec)."""
    g = msg()
    g.versions.producer = 1087
    g.versions.min_consumer = 12
    fd = g.library.function.add()
    fd.signature.name = "body_fn"
    for nm, t in (("i", 3), ("a", 1)):
        arg = fd.signature.input_arg.add()
        arg.name, arg.type = nm, t
    out = fd.signature.output_arg.add()
    out.name, out.type_attr = "out", "T"
    n = fd.node_def.add()
    n.name, n.op = "mul", "Mul"
    n.input.extend(["a", "two:output:0"])
    n.attr["T"].type = 1
    n.attr["shape"].shape.dim.add().size = -1
    n.attr["f"].func.name = "inner"
    n.attr["f"].func.attr["N"].i = 2
    n.attr["l"].list.s.extend([b"x", b"yz"])
    n.attr["l2"].list.f.extend([0.5, -1.0])
    n.attr["l3"].list.type.extend([1, 3])
    n.attr["b"].b = False
    n.attr["p"].placeholder = "T"
    fd.ret["out"] = "mul:z:0"
    fd.control_ret["side"] = "mul"
    fd.attr["_noinline"].b = True
    node = g.node.add()
    node.name, node.op = "call", "PartitionedCall"
    node.attr["f"].func.name = "body_fn"
    return g


def test_function_def_libraries_both_ways():
    j = _function_library(pb, pb.GraphDef)
    p = _function_library(wire, wire.GraphDef)
    assert _jax(p.SerializeToString()) == j
    back = _port(j.SerializeToString())
    assert back == p and _jax(back.SerializeToString()) == j
    fd = back.library.function[0]
    assert [a.name for a in fd.signature.input_arg] == ["i", "a"]
    assert fd.ret["out"] == "mul:z:0" and fd.control_ret["side"] == "mul"
    n = fd.node_def[0]
    assert n.attr["b"].WhichOneof("value") == "b" and n.attr["b"].b is False
    assert n.attr["f"].func.attr["N"].i == 2 and list(n.attr["l"].list.s) == [b"x", b"yz"]
    assert n.attr["p"].WhichOneof("value") == "placeholder"
    copy = wire.NodeDef()
    copy.CopyFrom(n)
    del copy.input[:]
    copy.input.extend(["q"])
    assert list(n.input) == ["a", "two:output:0"] and list(copy.input) == ["q"]
    assert copy.attr["f"].func.name == "inner"


def test_writer_helpers_match_the_jax_writer():
    from deeplearning4j_tpu.modelimport._tf.synthetic import FrozenGraphWriter as JaxWriter

    def write(cls):
        w = cls()
        x = w.placeholder("x", np.float32, [None, 3])
        k = w.const("k", np.arange(6, dtype=np.float32).reshape(3, 2))
        i = w.const("i", np.asarray([1, -2], np.int64))
        w.reshape(w.matmul(x, k, transpose_b=False), (-1,))
        w.node("Cast", "c", [i], types={"SrcT": 9, "DstT": 1}, Truncate=False)
        w.node("Identity", "s", [x], types={"T": 1}, label="hello", rate=0.5, n=-3)
        return w.serialize()

    assert _jax(write(FrozenGraphWriter)) == _jax(write(JaxWriter))
