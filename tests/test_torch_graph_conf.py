"""The graph configuration (`nn/conf/graph_conf.py`) against the JAX
package's, on the CPU.

- The topological order, the cycle and unknown-input errors, and every
  node's output type and flatten flag equal the JAX configuration's.
- Every vertex's output against the JAX vertex's on the same numpy
  inputs, in f32: every `ElementWiseOp`, the merges, subsets, scales,
  normalisation, stacking and reshapes exactly or within 1e-6 of the
  largest element (the same f32 operations), `AttentionVertex` with 1, 2
  and 3 inputs and without ``project_input`` within 1e-5 (the same f32
  products summed in another order), its initial projections bit for
  bit.
- JSON both ways: the port's ``to_json`` of every vertex, and of a whole
  graph, is the JAX package's, and each package reads the other's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.conf import graph_conf as jg
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.input_type import InputType as JaxInputType
from deeplearning4j_tpu.utils import serde as jax_serde
from deeplearning4j_tpu_torch.nn.conf import graph_conf as pg
from deeplearning4j_tpu_torch.nn.conf import layers
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.runtime import rng
from deeplearning4j_tpu_torch.utils import serde

torch.set_num_threads(1)


def _graph(pkg_g, pkg_layers, itype):
    """A DAG with a fork, a merge, a skip and two outputs."""
    return (pkg_g.GraphBuilder()
            .add_inputs("a", "b")
            .set_input_types(itype.convolutional(6, 6, 2), itype.feed_forward(5))
            .add_layer("c1", pkg_layers.Conv2D(n_out=3, kernel=(3, 3), padding="same"), "a")
            .add_layer("c2", pkg_layers.Conv2D(n_out=3, kernel=(3, 3), padding="same"), "c1")
            .add_vertex("skip", pkg_g.ElementWiseVertex(pkg_g.ElementWiseOp.ADD), "c1", "c2")
            .add_layer("d1", pkg_layers.Dense(n_out=4), "skip")
            .add_layer("d2", pkg_layers.Dense(n_out=4), "b")
            .add_vertex("m", pkg_g.MergeVertex(), "d1", "d2")
            .add_layer("out1", pkg_layers.OutputLayer(n_out=3), "m")
            .add_layer("out2", pkg_layers.OutputLayer(n_out=2, loss="mse",
                                                      activation="identity"), "d2")
            .set_outputs("out1", "out2")
            .build())


def test_order_types_and_flatten_flags_are_the_jax_configurations():
    jconf = _graph(jg, jax_layers, JaxInputType)
    pconf = _graph(pg, layers, InputType)
    assert [n.name for n in pconf.topological_order()] == \
        [n.name for n in jconf.topological_order()]
    (jt, jf), (pt, pf) = jconf.infer_types(), pconf.infer_types()
    assert pf == jf and pf["d1"] and not pf["d2"]
    assert {k: (t.kind, tuple(t.shape)) for k, t in pt.items()} == \
        {k: (t.kind, tuple(t.shape)) for k, t in jt.items()}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_cycles_and_unknown_inputs_raise(pkg):
    g, lay, it = (jg, jax_layers, JaxInputType) if pkg == "jax" else (pg, layers, InputType)

    def base():
        return g.GraphBuilder().add_inputs("in").set_input_types(it.feed_forward(3))

    with pytest.raises(ValueError, match="cycle"):
        (base().add_layer("x", lay.Dense(n_out=3), "y")
         .add_layer("y", lay.Dense(n_out=3), "x")
         .add_layer("out", lay.OutputLayer(n_out=2), "y").set_outputs("out").build())
    with pytest.raises(ValueError, match="unknown input 'nope'"):
        (base().add_layer("x", lay.Dense(n_out=3), "nope")
         .add_layer("out", lay.OutputLayer(n_out=2), "x").set_outputs("out").build())
    with pytest.raises(ValueError, match="is not a node"):
        (base().add_layer("x", lay.Dense(n_out=3), "in").set_outputs("gone").build())
    with pytest.raises(ValueError, match="duplicate node names"):
        (base().add_layer("x", lay.Dense(n_out=3), "in")
         .add_layer("x", lay.OutputLayer(n_out=2), "x").set_outputs("x").build())


def test_a_deep_chain_orders_without_recursion():
    g = pg.GraphBuilder().add_inputs("in").set_input_types(InputType.feed_forward(2))
    prev = "in"
    for i in range(3000):
        g.add_vertex(f"v{i}", pg.ScaleVertex(scale=1.0), prev)
        prev = f"v{i}"
    conf = g.add_layer("out", layers.OutputLayer(n_out=2), prev).set_outputs("out").build()
    assert [n.name for n in conf.topological_order()][-1] == "out"


# name -> (vertex kwargs, input shapes (batch first), kind of the inputs)
VERTICES = {
    **{f"elementwise_{op.value}": ("ElementWiseVertex", dict(op=op.value),
                                   [(3, 4)] * 3, "ff") for op in jg.ElementWiseOp},
    "elementwise_add_maps": ("ElementWiseVertex", dict(), [(2, 3, 3, 2)] * 2, "cnn"),
    "merge_ff": ("MergeVertex", dict(), [(3, 4), (3, 2)], "ff"),
    "merge_rnn": ("MergeVertex", dict(), [(2, 5, 3), (2, 5, 4)], "rnn"),
    "merge_maps": ("MergeVertex", dict(), [(2, 3, 3, 2), (2, 3, 3, 1)], "cnn"),
    "merge_declared_axis": ("MergeVertex", dict(declared_axis=1), [(3, 4), (3, 2)], "ff"),
    "subset_ff": ("SubsetVertex", dict(frm=1, to=3), [(3, 6)], "ff"),
    "subset_maps": ("SubsetVertex", dict(frm=0, to=1), [(2, 3, 3, 4)], "cnn"),
    "scale": ("ScaleVertex", dict(scale=0.37), [(3, 4)], "ff"),
    "l2_normalize": ("L2NormalizeVertex", dict(), [(3, 5)], "ff"),
    "l2_normalize_zero": ("L2NormalizeVertex", dict(epsilon=1e-3), [(3, 5)], "zero"),
    "stack": ("StackVertex", dict(), [(2, 4), (2, 4), (2, 4)], "ff"),
    "unstack": ("UnstackVertex", dict(index=1, stack_size=3), [(6, 4)], "ff"),
    "reshape_rnn": ("ReshapeVertex", dict(shape=(3, -1)), [(2, 12)], "ff"),
    "reshape_maps": ("ReshapeVertex", dict(shape=(2, 2, 3)), [(2, 12)], "ff"),
}
ATTENTION = {
    "attention_self": (dict(n_out=8, n_heads=2), [(2, 6, 5)]),
    "attention_q_kv": (dict(n_out=6, n_heads=3), [(2, 4, 5), (2, 7, 3)]),
    "attention_q_k_v": (dict(n_out=4, n_heads=2, head_size=3), [(2, 5, 4), (2, 6, 3),
                                                                (2, 6, 2)]),
    "attention_causal": (dict(n_out=8, n_heads=2, causal=True), [(2, 6, 5)]),
    "attention_no_projection": (dict(n_out=8, n_heads=2, project_input=False),
                                [(2, 6, 8)]),
}


def _itypes(shapes, kind):
    out = []
    for s in shapes:
        if kind in ("ff", "zero"):
            out.append((JaxInputType.feed_forward(s[1]), InputType.feed_forward(s[1])))
        elif kind == "rnn":
            out.append((JaxInputType.recurrent(s[2], s[1]), InputType.recurrent(s[2], s[1])))
        else:
            out.append((JaxInputType.convolutional(*s[1:]),
                        InputType.convolutional(*s[1:])))
    return [a for a, _ in out], [b for _, b in out]


def _pair(cls, kw):
    """The JAX and port vertices; an ``op`` value as each package's enum."""
    jkw, pkw = dict(kw), dict(kw)
    if "op" in kw:
        jkw["op"], pkw["op"] = jg.ElementWiseOp(kw["op"]), pg.ElementWiseOp(kw["op"])
    return getattr(jg, cls)(**jkw), getattr(pg, cls)(**pkw)


@pytest.mark.parametrize("case", sorted(VERTICES))
def test_vertex_matches_the_jax_vertex(case):
    cls, kw, shapes, kind = VERTICES[case]
    jv, pv = _pair(cls, kw)
    jts, pts = _itypes(shapes, kind)
    jt, pt = jv.output_type(jts), pv.output_type(pts)
    assert (pt.kind, tuple(pt.shape)) == (jt.kind, tuple(jt.shape))
    r = np.random.default_rng(sorted(VERTICES).index(case))
    xs = [r.normal(size=s).astype(np.float32) for s in shapes]
    if kind == "zero":
        xs[0][1] = 0.0                     # a row below epsilon
    want = np.asarray(jv.apply([jnp.asarray(x) for x in xs]))
    got = pv.apply([torch.from_numpy(x) for x in xs]).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(ATTENTION))
def test_attention_vertex_matches_the_jax_vertex(case):
    kw, shapes = ATTENTION[case]
    jv, pv = jg.AttentionVertex(**kw), pg.AttentionVertex(**kw)
    jts, pts = _itypes(shapes, "rnn")
    assert tuple(pv.output_type(pts).shape) == tuple(jv.output_type(jts).shape)
    seed = sorted(ATTENTION).index(case)
    jp = jv.init(jax.random.key(seed), jts)
    pp = pv.init(rng.key(seed), pts, "cpu")
    assert sorted(jp) == sorted(pp)
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jp[k]), pp[k].numpy())
    r = np.random.default_rng(50 + seed)
    xs = [r.normal(size=s).astype(np.float32) for s in shapes]
    want = np.asarray(jv.apply([jnp.asarray(x) for x in xs], params=jp))
    got = pv.apply([torch.from_numpy(x) for x in xs], params=pp).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_attention_vertex_sequence_parallel_raises_naming_a11():
    """An AttentionVertex with ``seq_parallel=\"ring\"`` builds (ROADMAP A11's
    ring attention is ported) and runs the dense core on one device: the
    \"none\" vertex's output; distributing a graph over a seq axis still
    names A11, refused before any world forms."""
    from deeplearning4j_tpu_torch.models.computation_graph import GraphModel

    conf = (pg.GraphBuilder().add_inputs("in")
            .set_input_types(InputType.recurrent(8, 4))
            .add_vertex("att", pg.AttentionVertex(n_out=8, n_heads=2,
                                                  seq_parallel="ring"), "in")
            .add_layer("pool", layers.GlobalPooling(), "att")
            .add_layer("out", layers.OutputLayer(n_out=2), "pool")
            .set_outputs("out").build())
    ring = GraphModel(conf, device="cpu").init()
    none = GraphModel(dataclasses.replace(conf, nodes=tuple(
        dataclasses.replace(n, vertex=dataclasses.replace(n.vertex, seq_parallel="none"))
        if n.vertex is not None else n for n in conf.nodes)), device="cpu").init()
    x = np.random.default_rng(0).normal(size=(2, 4, 8)).astype(np.float32)
    torch.testing.assert_close(ring.output(x), none.output(x), rtol=0, atol=0)
    from deeplearning4j_tpu_torch.parallel.data_parallel import _check_model_parallel
    from deeplearning4j_tpu_torch.runtime import distributed

    with pytest.raises(NotImplementedError, match="A11"):
        _check_model_parallel(ring, {}, True)
    assert not distributed.is_initialized()


@pytest.mark.parametrize("case", sorted(VERTICES) + sorted(ATTENTION))
def test_vertex_json_both_ways(case):
    if case in ATTENTION:
        cls, kw = "AttentionVertex", dict(ATTENTION[case][0], weight_init="xavier", l2=1e-4)
    else:
        cls, kw = VERTICES[case][:2]
    jv, pv = _pair(cls, kw)
    pj, jj = serde.dumps(pv), jax_serde.dumps(jv)
    assert json.loads(pj) == json.loads(jj)
    assert serde.loads(jj) == pv
    assert jax_serde.loads(pj) == jv


def test_graph_json_both_ways():
    jconf = _graph(jg, jax_layers, JaxInputType)
    pconf = _graph(pg, layers, InputType)
    assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())
    back = pg.GraphConfiguration.from_json(jconf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    theirs = jg.GraphConfiguration.from_json(pconf.to_json())
    assert json.loads(theirs.to_json()) == json.loads(pconf.to_json())
    with pytest.raises(TypeError, match="GraphConfiguration"):
        pg.GraphConfiguration.from_json(serde.dumps(layers.Dense(n_out=2)))


def test_builder_defaults_reach_layers_and_attention_vertices():
    """The net-wide activation, weight init, l1 / l2 and dropout fill the
    layers that left them unset (an output layer keeps its own
    activation); l1 / l2 reach a vertex with parameters."""
    kw = dict(activation="tanh", weight_init="relu", l1=1e-3, l2=2e-3, dropout=0.25)

    def build(g, lay, it):
        b = g.GraphBuilder()
        for k, v in kw.items():
            getattr(b, k)(v)
        return (b.add_inputs("in").set_input_types(it.recurrent(8, 5))
                .add_vertex("att", g.AttentionVertex(n_out=8, n_heads=2), "in")
                .add_layer("pool", lay.GlobalPooling(), "att")
                .add_layer("d", lay.Dense(n_out=4), "pool")
                .add_layer("out", lay.OutputLayer(n_out=2), "d")
                .set_outputs("out").build())

    pconf, jconf = build(pg, layers, InputType), build(jg, jax_layers, JaxInputType)
    assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())
    nodes = {n.name: n for n in pconf.nodes}
    assert nodes["d"].layer.l2 == 2e-3 and nodes["d"].layer.dropout_rate == 0.25
    assert nodes["att"].vertex.l1 == 1e-3 and nodes["out"].layer.activation is None
