"""`GraphModel` (`models/computation_graph.py`) and the ResNet-50 zoo
entry against the JAX package's, on the CPU, in f32.

- A narrow ResNet-50 (each package's `ResNet50` with one block a stage
  and narrow filters, at 32 x 32 x 3, 10 classes) starts from the JAX
  package's weights and BatchNorm state bit for bit, and its 5 Adam
  `fit_batch` losses on one batch are within 1e-5 of the JAX model's (the
  same f32 steps, convolutions and BatchNorm sums in another order).
  The comparison is continuous only away from a ReLU's kink: at this
  size the last stage's maps are 1 x 1, so a BatchNorm there normalises
  over the batch's 8 values alone, and on other data one pre-activation
  within the packages' ~1e-6 forward difference of zero (3.6e-7 in JAX,
  -7.7e-7 here, seen on numpy seed 3) flips its ReLU; the BatchNorm then
  couples the flip into the whole channel's gradient, 10-20% of every
  upstream gradient, and Adam carries it into the next losses.
- A graph with two inputs and two outputs on `MultiDataSet` batches,
  with a `param_key` shared by two nodes (one copy, trained by both):
  losses within 1e-5, parameters within 1e-5 after 3 steps.  A graph
  with `Dropout` and builder-wide dropout: the same masks, so the same
  losses within 1e-5.
- ``fit(..., steps_per_execution=K)`` trains as K `fit_batch` calls, bit
  for bit.
- ``output`` / ``predict`` / ``evaluate`` / ``score`` against the JAX
  model's from the same trees (within 1e-5; predictions and accuracy
  equal); ``clone`` is an independent copy.
- Graph checkpoint zips both ways: parameters, optimizer and BatchNorm
  state bit for bit, the next step's loss within 1e-5.
- A quantized graph: int8 trees bit for bit, ``output()`` within 1e-5 of
  max p of the JAX package's quantized model.
- The full `ResNet50()` configuration writes the JAX package's JSON, and
  has its parameter count (shapes only: nothing of full size is drawn).
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.data.dataset import DataSet as JDS
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.models.computation_graph import GraphModel as JaxGM
from deeplearning4j_tpu.nn.conf import graph_conf as jg
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.quant import quantize as jax_quantize
from deeplearning4j_tpu.train.checkpoint import ModelSerializer as JaxMS
from deeplearning4j_tpu.zoo.resnet import ResNet50 as JaxResNet50
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
from deeplearning4j_tpu_torch.models.model import tree_leaves
from deeplearning4j_tpu_torch.nn.conf import graph_conf as pg
from deeplearning4j_tpu_torch.nn.conf import layers as pl
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType as PIT
from deeplearning4j_tpu_torch.nn.updaters import Adam, state_leaves
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.quant import is_quantized, parity_check, quantize
from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer
from deeplearning4j_tpu_torch.zoo.resnet import ResNet50

torch.set_num_threads(2)

LOSS_TOL = 1e-5


class JaxNarrow(JaxResNet50):
    STAGES = (1, 1, 1, 1)
    FILTERS = (8, 8, 16, 16)


class Narrow(ResNet50):
    STAGES = (1, 1, 1, 1)
    FILTERS = (8, 8, 16, 16)


def _narrow_batches(n, batch=8):
    r = np.random.default_rng(0)
    return [(r.normal(size=(batch, 32, 32, 3)).astype(np.float32),
             np.eye(10, dtype=np.float32)[r.integers(0, 10, batch)]) for _ in range(n)]


def _jleaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _pleaves(tree):
    return [t.detach().numpy() for t in tree_leaves(tree)]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _close(a, b, tol=1e-5):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        assert np.abs(x - y).max() <= tol * max(np.abs(y).max(), 1.0)


def test_narrow_resnet_starts_from_the_jax_weights_and_follows_its_losses():
    jm = JaxNarrow(num_classes=10, height=32, width=32).init_model()
    pm = Narrow(num_classes=10, height=32, width=32).init_model(device="cpu")
    _same(_pleaves(pm.params), _jleaves(jm.params))
    _same(_pleaves(pm.net_state), _jleaves(jm.net_state))
    assert sorted(pm.params) == sorted(jm.params)
    x, y = _narrow_batches(1)[0]
    for _ in range(5):
        jm.fit_batch(JDS(x, y))
        pm.fit_batch(DataSet(x, y))
        assert abs(pm.score_value - jm.score_value) <= LOSS_TOL, \
            (pm.score_value, jm.score_value)
    assert pm.iteration == 5


def _two_io(g, lay, it, upd, dropout=None):
    """Two inputs, two outputs; ``enc_a`` and ``enc_b`` share the
    ``enc`` parameters."""
    b = g.GraphBuilder().seed(11).updater(upd(1e-2))
    if dropout is not None:
        b.dropout(dropout)
    b = (b.add_inputs("a", "b")
         .set_input_types(it.feed_forward(6), it.feed_forward(6))
         .add_layer("enc_a", lay.Dense(n_out=5, activation="tanh"), "a", param_key="enc")
         .add_layer("enc_b", lay.Dense(n_out=5, activation="tanh"), "b", param_key="enc")
         .add_vertex("m", g.MergeVertex(), "enc_a", "enc_b"))
    if dropout is not None:
        b.add_layer("drop", lay.Dropout(rate=0.4), "m")
        b.add_layer("h", lay.Dense(n_out=7, activation="relu"), "drop")
    else:
        b.add_layer("h", lay.Dense(n_out=7, activation="relu", l2=1e-3), "m")
    return (b.add_layer("out1", lay.OutputLayer(n_out=3, activation="softmax"), "h")
            .add_layer("out2", lay.OutputLayer(n_out=2, loss="mse",
                                               activation="identity"), "enc_b")
            .set_outputs("out1", "out2").build())


def _mds_batches(n, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a, b = (r.normal(size=(8, 6)).astype(np.float32) for _ in range(2))
        y1 = np.eye(3, dtype=np.float32)[r.integers(0, 3, 8)]
        y2 = r.normal(size=(8, 2)).astype(np.float32)
        out.append(((a, b), (y1, y2)))
    return out


def _pair(dropout=None):
    jm = JaxGM(_two_io(jg, jl, JIT, JAdam, dropout)).init()
    pm = GraphModel(_two_io(pg, pl, PIT, Adam, dropout), device="cpu").init()
    return jm, pm


@pytest.mark.parametrize("dropout", [None, 0.3])
def test_two_inputs_two_outputs_and_a_shared_key_train_as_jax(dropout):
    jm, pm = _pair(dropout)
    assert sorted(pm.params) == sorted(jm.params) and "enc" in pm.params
    assert "enc_a" not in pm.params
    _same(_pleaves(pm.params), _jleaves(jm.params))
    for feats, labels in _mds_batches(3):
        jm.fit_batch(JMDS(feats, labels))
        pm.fit_batch(MultiDataSet(feats, labels))
        assert abs(pm.score_value - jm.score_value) <= LOSS_TOL
    _close(_pleaves(pm.params), _jleaves(jm.params))


def test_a_dataset_feeds_a_one_input_graph_and_a_wrong_batch_raises():
    pm = GraphModel(_two_io(pg, pl, PIT, Adam), device="cpu").init()
    with pytest.raises(ValueError, match="2 inputs, batch has 1"):
        pm.fit_batch(DataSet(np.zeros((2, 6), np.float32), np.zeros((2, 3), np.float32)))
    with pytest.raises(ValueError, match="2 inputs"):
        pm.output(np.zeros((2, 6), np.float32))
    jm, nm = JaxNarrow(num_classes=10, height=32, width=32), Narrow(
        num_classes=10, height=32, width=32).init_model(device="cpu")
    x, y = _narrow_batches(1)[0]
    nm.fit_batch(DataSet(x, y))
    assert np.isfinite(nm.score_value) and jm.NAME == "resnet50"


def test_steps_per_execution_trains_as_batch_by_batch():
    batches = [MultiDataSet(f, l) for f, l in _mds_batches(5, seed=4)]
    a = GraphModel(_two_io(pg, pl, PIT, Adam), device="cpu").init()
    b = GraphModel(_two_io(pg, pl, PIT, Adam), device="cpu").init()
    a.fit(batches, steps_per_execution=2)        # 2 groups and a tail
    losses = []
    for m in batches:
        b.fit_batch(m)
        losses.append(float(b._last_score))
    _same(_pleaves(a.params), _pleaves(b.params))
    _same(_opt_leaves(a), _opt_leaves(b))
    assert a.iteration == b.iteration == 5 and float(a._last_score) == losses[-1]


def test_inference_surface_matches_jax():
    jm, pm = _pair()
    for feats, labels in _mds_batches(2, seed=6):
        jm.fit_batch(JMDS(feats, labels))
    pm.load_params(jax.tree.map(np.asarray, jm.params))
    (fa, fb), (y1, y2) = _mds_batches(1, seed=9)[0]
    jo, po = jm.output(fa, fb), pm.output(fa, fb)
    assert isinstance(po, tuple) and len(po) == 2
    _close([p.numpy() for p in po], [np.asarray(j) for j in jo])
    np.testing.assert_array_equal(pm.predict(fa, fb), jm.predict(fa, fb))
    batch, jbatch = MultiDataSet((fa, fb), (y1, y2)), JMDS((fa, fb), (y1, y2))
    assert pm.evaluate(batch).accuracy() == jm.evaluate(jbatch).accuracy()
    assert abs(pm.score(batch) - jm.score(jbatch)) <= LOSS_TOL
    c = pm.clone()
    _same(_pleaves(c.params), _pleaves(pm.params))
    c.fit_batch(batch)
    assert not np.array_equal(_pleaves(c.params)[0], _pleaves(pm.params)[0])
    assert c.iteration == pm.iteration + 1


def _bn_graph(g, lay, it, upd):
    return (g.GraphBuilder().seed(5).updater(upd(1e-2))
            .add_inputs("in").set_input_types(it.convolutional(8, 8, 2))
            .add_layer("c", lay.Conv2D(n_out=4, kernel=(3, 3), padding="same"), "in")
            .add_layer("bn", lay.BatchNorm(activation="relu"), "c")
            .add_layer("p", lay.Subsampling(kernel=(2, 2), stride=(2, 2)), "bn")
            .add_layer("d", lay.Dense(n_out=6, activation="relu"), "p")
            .add_layer("out", lay.OutputLayer(n_out=3, activation="softmax"), "d")
            .set_outputs("out").build())


def _bn_batch(seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(6, 8, 8, 2)).astype(np.float32),
            np.eye(3, dtype=np.float32)[r.integers(0, 3, 6)])


def _opt_leaves(m):
    return [np.asarray(x.detach() if torch.is_tensor(x) else x)
            for x in state_leaves(m.opt_state)]


def _port_all(m):
    return _pleaves(m.params), _opt_leaves(m), _pleaves(m.net_state)


def _jax_all(m):
    return _jleaves(m.params), _jleaves(m.opt_state), _jleaves(m.net_state)


def test_graph_zips_both_ways(tmp_path):
    jm = JaxGM(_bn_graph(jg, jl, JIT, JAdam)).init()
    for s in range(2):
        jm.fit_batch(JDS(*_bn_batch(s)))
    path = str(tmp_path / "jax.zip")
    JaxMS.write_model(jm, path)
    pm = ModelSerializer.restore(path, device="cpu")
    assert isinstance(pm, GraphModel) and pm.iteration == 2
    for a, b in zip(_port_all(pm), _jax_all(jm)):
        _same(a, b)
    jm.fit_batch(JDS(*_bn_batch(7)))
    pm.fit_batch(DataSet(*_bn_batch(7)))
    assert abs(pm.score_value - jm.score_value) <= LOSS_TOL

    out = str(tmp_path / "port.zip")
    ModelSerializer.write_model(pm, out)
    assert JaxMS.verify(out)["iteration"] == 3
    back = JaxMS.restore(out)
    assert type(back).__name__ == "GraphModel"
    for a, b in zip(_jax_all(back), _port_all(pm)):
        _same(a, b)


def test_a_quantized_graph_matches_jax_quantize(tmp_path):
    jm = JaxGM(_bn_graph(jg, jl, JIT, JAdam)).init()
    jm.fit_batch(JDS(*_bn_batch(0)))
    pm = GraphModel(_bn_graph(pg, pl, PIT, Adam), device="cpu")
    pm.load_params(jax.tree.map(np.asarray, jm.params))
    pm.load_net_state(jax.tree.map(np.asarray, jm.net_state))
    jq, pq = jax_quantize(jm), quantize(pm)
    assert is_quantized(pq) and not is_quantized(pm)
    jq_leaves = [np.asarray(a) for a in jax.tree.leaves(jax.tree.map(np.asarray, jq.params))]
    _same(_pleaves(pq.params), jq_leaves)
    x, y = _bn_batch(3)
    want = np.asarray(jq.output(x))
    got = pq.output(x).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert parity_check(pm, pq, x)["pass"]
    with pytest.raises(RuntimeError, match="int8-quantized"):
        pq.fit_batch(DataSet(x, y))
    path = str(tmp_path / "q.zip")
    ModelSerializer.write_model(pq, path)
    back = ModelSerializer.restore(path, device="cpu")
    _same(_pleaves(back.params), _pleaves(pq.params))
    np.testing.assert_array_equal(back.output(x).numpy(), got)


def test_full_resnet50_configuration_and_parameter_count_are_jaxs():
    jconf, pconf = JaxResNet50().conf(), ResNet50().conf()
    assert pconf.to_json() == jconf.to_json()
    assert pg.GraphConfiguration.from_json(jconf.to_json()) == pconf
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jax.eval_shape(lambda: JaxGM(jconf).init().params)))

    def shaped(self, key, shape, **kw):
        return torch.empty(tuple(shape), device="meta")

    model = GraphModel(pconf, device="cpu")
    model.device = torch.device("meta")        # shapes only
    with mock.patch.object(WeightInit, "init", shaped):
        model.init()
    assert model.num_params() == want == 25_583_592
    assert dataclasses.replace(pconf, seed=1).seed == 1
