"""Frozen layers and `train/transfer.py` on the CPU, against the JAX
package (f32).

- A narrow transformer (2 blocks, d 64) and a narrow ResNet (each
  package's `ResNet50` with one block a stage) rebuilt by
  ``TransferLearning.Builder`` / ``GraphBuilder`` with
  ``set_feature_extractor`` and ``n_out_replace``: the new heads' weights
  are the JAX package's bit for bit, 5 Adam steps give losses within
  1e-5 of the JAX model's, and the frozen leaves keep their bits in both
  packages.  A frozen BatchNorm's running statistics move in both, as
  the JAX package updates them (ROADMAP C, found in the reference).
- A frozen prefix records no backward: its leaves get no gradient and
  the updater holds no state for them (optax ``masked``'s layout).
- ``TransferLearningHelper.featurize`` / ``fit_featurized`` against the
  JAX helper: features within 1e-6, losses within 1e-5.
- A frozen model's zip restores both ways: parameters and optimizer
  leaves bit for bit, the next loss within 1e-5.
- The JAX package's transfer cases (`tests/test_training_tools.py`
  ``TestTransferLearning`` and the helper across a CNN flatten) on the
  port.
"""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.data.dataset import DataSet as JDS
from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSM
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.train import FineTuneConfiguration as JFTC
from deeplearning4j_tpu.train import TransferLearning as JTL
from deeplearning4j_tpu.train import TransferLearningHelper as JTLH
from deeplearning4j_tpu.train.checkpoint import ModelSerializer as JaxMS
from deeplearning4j_tpu.zoo.resnet import ResNet50 as JaxResNet50
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import NumpyDataSetIterator
from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
from deeplearning4j_tpu_torch.models.model import _tree_map, tree_leaves
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    Conv2D,
    Dense,
    OutputLayer,
    Subsampling,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
    SequentialConfiguration,
)
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.updaters import Adam, Sgd, state_leaves
from deeplearning4j_tpu_torch.train import (
    FineTuneConfiguration,
    TransferLearning,
    TransferLearningHelper,
)
from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer
from deeplearning4j_tpu_torch.zoo.resnet import ResNet50
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

torch.set_num_threads(1)

LOSS_TOL = 1e-5


class JaxNarrow(JaxResNet50):
    STAGES = (1, 1, 1, 1)
    FILTERS = (8, 8, 16, 16)


class Narrow(ResNet50):
    STAGES = (1, 1, 1, 1)
    FILTERS = (8, 8, 16, 16)


def _jl(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _pl(tree):
    """Copies of the leaves (a view would follow the in-place steps)."""
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _port_twin(jm, cls):
    """The port model of the JAX model's configuration and weights."""
    conf_cls = GraphConfiguration if cls is GraphModel else SequentialConfiguration
    pm = cls(conf_cls.from_json(jm.conf.to_json()), device="cpu")
    pm.load_params(jax.tree.map(np.asarray, jm.params))
    pm.load_net_state(jax.tree.map(np.asarray, jm.net_state))
    return pm


def _frozen_names(model):
    return sorted(model._frozen)


# -- the narrow transformer ----------------------------------------------------

def _transformer_pair():
    kw = dict(vocab_size=64, d_model=64, n_heads=2, n_layers=2, causal=True, seed=7,
              chunked_vocab_loss=True, vocab_chunk=16, learning_rate=1e-3)
    jm = JaxTE(**kw).init_model()
    pm = TransformerEncoder(**kw).init_model(device="cpu")
    _same(_pl(pm.params), _jl(jm.params))
    rng = np.random.default_rng(0)
    for _ in range(2):                        # some pretraining in both
        ids = rng.integers(0, 64, (2, 16)).astype(np.int32)
        jm.fit_batch(JDS(ids, np.roll(ids, -1, axis=1)))
        pm.fit_batch(DataSet(ids, np.roll(ids, -1, axis=1)))
    return jm, _port_twin(jm, SequentialModel)


def _repair_nested(jt, jm, reinit):
    """The JAX package's `_copy_retained_params` copies a retained layer
    key by key with ``np.array``, which turns a nested parameter dict (a
    transformer block's ``attn`` / ``ln1`` subtrees) into a 0-d object
    array, and the JAX model then fails its first step (ROADMAP C, found
    in the reference).  Install what it means to copy: the old layer's
    tree."""
    import jax.numpy as jnp

    jt.params = {name: (jax.tree.map(jnp.array, jm.params[name])
                        if name not in reinit and name in jm.params else table)
                 for name, table in jt.params.items()}


def test_transformer_feature_extractor_follows_jax():
    jm, pm = _transformer_pair()
    jt = (JTL.Builder(jm).fine_tune_configuration(JFTC(updater=JAdam(1e-3)))
          .set_feature_extractor(2).n_out_replace(4, 32).build())
    assert isinstance(jt.params["layer2"]["attn"], np.ndarray)   # the fault
    _repair_nested(jt, jm, reinit={"layer4"})
    pt = (TransferLearning.Builder(pm)
          .fine_tune_configuration(FineTuneConfiguration(updater=Adam(1e-3)))
          .set_feature_extractor(2).n_out_replace(4, 32).build())
    assert _frozen_names(pt) == ["layer0", "layer1", "layer2"]
    assert [l.frozen for l in pt.conf.layers] == [l.frozen for l in jt.conf.layers]
    _same(_pl(pt.params), _jl(jt.params))     # kept weights and the new head
    held = [k for k in pt._frozen if k in pt.params]
    frozen_before = _pl({k: pt.params[k] for k in held})
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 32, (2, 16)).astype(np.int32)
    y = np.roll(ids, -1, axis=1)
    for _ in range(5):
        jt.fit_batch(JDS(ids, y))
        pt.fit_batch(DataSet(ids, y))
        assert abs(pt.score_value - jt.score_value) <= LOSS_TOL, \
            (pt.score_value, jt.score_value)
    _same(_pl({k: pt.params[k] for k in held}), frozen_before)
    _same(_jl({k: jt.params[k] for k in held}), frozen_before)
    moved = _pl(pt.params["layer3"])
    assert any(not np.array_equal(a, b) for a, b in zip(moved, _jl(jm.params["layer3"])))
    # the updater holds state for the trainable leaves only, as optax's
    # masked does: the same leaves as the JAX model's state
    _close_state(pt, jt)


def _close_state(pm, jm):
    p, j = state_leaves(pm.opt_state), jax.tree.leaves(jm.opt_state)
    assert len(p) == len(j)
    n_train = len(pm._trainable_leaves(pm.params))
    assert n_train < len(tree_leaves(pm.params))
    for a, b in zip(p, j):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1.0)


def test_a_frozen_prefix_records_no_backward():
    _, pm = _transformer_pair()
    pt = TransferLearning.Builder(pm).set_feature_extractor(2).build()
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 64, (2, 16)).astype(np.int32)
    b = DataSet(ids, np.roll(ids, -1, axis=1))
    pt._prepare([b])
    loss, grads, _ = pt._grad_step(pt.params, pt.net_state,
                                   *pt._batch_arrays(b), pt._layer_keys(0))
    assert len(grads) == len(pt._trainable_leaves(pt.params))
    assert all(t.grad is None for k in pt._frozen if k in pt.params
               for t in tree_leaves(pt.params[k]))
    # nothing before the first trainable block records a graph: the
    # frozen block's output has no grad_fn, the next block's has
    params = {k: _tree_map(torch.Tensor.detach, v) if k in pt._frozen else v
              for k, v in pt.params.items()}
    outs = [x for _, x, _, _ in pt._layer_outputs(
        pt.cast_tree(params, detach=False), pt.net_state, ids, training=True,
        keys=pt._layer_keys(0))]
    assert outs[2].grad_fn is None and outs[3].grad_fn is not None
    assert np.isfinite(float(loss.detach()))


# -- the narrow ResNet -------------------------------------------------------------

def _narrow_batches(n, classes, batch=8, seed=0):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(batch, 32, 32, 3)).astype(np.float32),
             np.eye(classes, dtype=np.float32)[r.integers(0, classes, batch)])
            for _ in range(n)]


def test_resnet_feature_extractor_follows_jax():
    jm = JaxNarrow(num_classes=10, height=32, width=32).init_model()
    pm = _port_twin(jm, GraphModel)
    jt = (JTL.GraphBuilder(jm).fine_tune_configuration(JFTC(updater=JAdam(1e-3)))
          .set_feature_extractor("s2b0_out").n_out_replace("output", 5).build())
    pt = (TransferLearning.GraphBuilder(pm)
          .fine_tune_configuration(FineTuneConfiguration(updater=Adam(1e-3)))
          .set_feature_extractor("s2b0_out").n_out_replace("output", 5).build())
    assert "stem_conv" in pt._frozen and "s2b0_c3" in pt._frozen
    assert "s3b0_c1" not in pt._frozen and "output" not in pt._frozen
    _same(_pl(pt.params), _jl(jt.params))
    _same(_pl(pt.net_state), _jl(jt.net_state))
    frozen = sorted(k for k in pt._frozen if k in pt.params)
    before = _pl({k: pt.params[k] for k in frozen})
    stats_before = _pl({k: pt.net_state[k] for k in frozen if k in pt.net_state})
    x, y = _narrow_batches(1, 5)[0]
    for _ in range(5):
        jt.fit_batch(JDS(x, y))
        pt.fit_batch(DataSet(x, y))
        assert abs(pt.score_value - jt.score_value) <= LOSS_TOL, \
            (pt.score_value, jt.score_value)
    _same(_pl({k: pt.params[k] for k in frozen}), before)
    _same(_jl({k: jt.params[k] for k in frozen}), before)
    # a frozen BatchNorm's running statistics still move (JAX semantics)
    stats_after = _pl({k: pt.net_state[k] for k in frozen if k in pt.net_state})
    assert all(not np.array_equal(a, b) for a, b in zip(stats_before, stats_after))
    jstats = _jl({k: jt.net_state[k] for k in frozen if k in jt.net_state})
    for a, b in zip(stats_after, jstats):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# -- the helper ------------------------------------------------------------------

def _toy_problem(n=256, n_in=8, k=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    w = rng.normal(size=(n_in, k))
    return x, np.eye(k, dtype=np.float32)[np.argmax(x @ w, axis=1)]


def _mlp(lr=0.05):
    return (NeuralNetConfiguration.builder().seed(42).updater(Adam(lr)).list()
            .layer(Dense(n_out=16, activation=Activation.RELU, name="d0"))
            .layer(Dense(n_out=16, activation=Activation.RELU, name="d1"))
            .layer(OutputLayer(n_out=3, loss=Loss.MCXENT, activation=Activation.SOFTMAX,
                               name="out"))
            .set_input_type(InputType.feed_forward(8)).build())


def _jax_of(conf):
    from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
        SequentialConfiguration as JSC,
    )

    return JaxSM(JSC.from_json(conf.to_json())).init()


def test_helper_featurize_and_fit_featurized_follow_jax():
    x, y = _toy_problem()
    pm = SequentialModel(_mlp(), device="cpu").init()
    jm = _jax_of(pm.conf)
    _same(_pl(pm.params), _jl(jm.params))
    pt = TransferLearning.Builder(pm).set_feature_extractor("d1").build()
    jt = JTL.Builder(jm).set_feature_extractor("d1").build()
    ph, jh = TransferLearningHelper(pt), JTLH(jt)
    pf, jf = ph.featurize(DataSet(x[:64], y[:64])), jh.featurize(JDS(x[:64], y[:64]))
    np.testing.assert_allclose(pf.features, np.asarray(jf.features), rtol=1e-6,
                               atol=1e-6)
    for i in range(0, 64, 16):
        ph.unfrozen_model.fit_batch(DataSet(pf.features[i:i + 16], y[i:i + 16]))
        jh.unfrozen_model.fit_batch(JDS(np.asarray(jf.features)[i:i + 16],
                                        y[i:i + 16]))
        assert abs(ph.unfrozen_model.score_value
                   - jh.unfrozen_model.score_value) <= LOSS_TOL
    full_p, full_j = ph.to_full_model(), jh.to_full_model()
    np.testing.assert_allclose(full_p.output(x[:8]).numpy(),
                               np.asarray(full_j.output(x[:8])), rtol=1e-5, atol=1e-6)


# -- a frozen model's zip ------------------------------------------------------------

def test_a_frozen_models_zip_restores_both_ways(tmp_path):
    x, y = _toy_problem(n=64)
    pm = SequentialModel(_mlp(), device="cpu").init()
    pt = TransferLearning.Builder(pm).set_feature_extractor("d0").build()
    jt = _jax_of(pt.conf)
    assert [l.frozen for l in jt.conf.layers] == [True, False, False]
    for i in range(0, 32, 16):
        pt.fit_batch(DataSet(x[i:i + 16], y[i:i + 16]))
    p = str(tmp_path / "port.zip")
    pt.save(p)
    jr = JaxMS.restore(p)
    _same(_jl(jr.params), _pl(pt.params))
    _same(_jl(jr.opt_state), [np.asarray(a) for a in state_leaves(pt.opt_state)])
    jr.fit_batch(JDS(x[32:48], y[32:48]))
    pt.fit_batch(DataSet(x[32:48], y[32:48]))
    assert abs(jr.score_value - pt.score_value) <= LOSS_TOL
    q = str(tmp_path / "jax.zip")
    JaxMS.write_model(jr, q)
    pr = ModelSerializer.restore(q, device="cpu")
    assert pr._frozen == {"d0"}
    _same(_pl(pr.params), _jl(jr.params))
    _same([np.asarray(a) for a in state_leaves(pr.opt_state)], _jl(jr.opt_state))
    jr.fit_batch(JDS(x[48:], y[48:]))
    pr.fit_batch(DataSet(x[48:], y[48:]))
    assert abs(jr.score_value - pr.score_value) <= LOSS_TOL


# -- the JAX package's transfer cases ------------------------------------------------

def _trained():
    x, y = _toy_problem()
    model = SequentialModel(_mlp(), device="cpu").init()
    model.fit(NumpyDataSetIterator(x, y, batch_size=64), epochs=2)
    return model, x, y


def test_feature_extractor_freezes_params():
    model, x, y = _trained()
    tl = (TransferLearning.Builder(model)
          .fine_tune_configuration(FineTuneConfiguration(updater=Sgd(0.1)))
          .set_feature_extractor("d1").build())
    assert tl.conf.layers[0].frozen and tl.conf.layers[1].frozen
    assert not tl.conf.layers[2].frozen
    np.testing.assert_array_equal(tl.params["d0"]["W"].detach().numpy(),
                                  model.params["d0"]["W"].detach().numpy())
    frozen_before = {k: v.detach().clone() for k, v in tl.params["d0"].items()}
    tl.fit(NumpyDataSetIterator(x, y, batch_size=64), epochs=1)
    for k, before in frozen_before.items():
        assert torch.equal(before, tl.params["d0"][k].detach())
    assert not np.allclose(tl.params["out"]["W"].detach().numpy(),
                           model.params["out"]["W"].detach().numpy())


def test_n_out_replace_reinits_downstream():
    model, x, y = _trained()
    tl = (TransferLearning.Builder(model).set_feature_extractor("d0")
          .n_out_replace("d1", 32).build())
    assert tl.conf.layers[1].n_out == 32
    assert tl.params["d1"]["W"].shape[-1] == 32
    assert tl.params["out"]["W"].shape[0] == 32
    np.testing.assert_array_equal(tl.params["d0"]["W"].detach().numpy(),
                                  model.params["d0"]["W"].detach().numpy())
    tl.fit(NumpyDataSetIterator(x, y, batch_size=64), epochs=1)


def test_replace_head():
    model, x, y = _trained()
    tl = (TransferLearning.Builder(model).set_feature_extractor("d1")
          .remove_output_layer()
          .add_layer(OutputLayer(n_out=5, loss=Loss.MCXENT,
                                 activation=Activation.SOFTMAX, name="newout"))
          .build())
    assert tl.conf.layers[-1].name == "newout"
    assert tuple(tl.output(x[:4]).shape) == (4, 5)


def test_helper_featurize_matches_full_forward():
    model, x, y = _trained()
    tl = TransferLearning.Builder(model).set_feature_extractor("d1").build()
    helper = TransferLearningHelper(tl)
    feat = helper.featurize(DataSet(x[:32], y[:32]))
    assert feat.features.shape == (32, 16)
    out_via_helper = helper.output_from_featurized(feat.features).numpy()
    np.testing.assert_allclose(out_via_helper, tl.output(x[:32]).numpy(),
                               rtol=1e-4, atol=1e-5)
    helper.fit_featurized(feat, epochs=1)
    full = helper.to_full_model()
    np.testing.assert_allclose(full.output(x[:32]).numpy(),
                               helper.output_from_featurized(feat.features).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_helper_featurize_across_cnn_flatten_boundary():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8, 8, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 32)]
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-3)).list()
            .layer(Conv2D(n_out=4, kernel=(3, 3), activation=Activation.RELU, name="c0"))
            .layer(Subsampling(kernel=(2, 2), stride=(2, 2), name="p0"))
            .layer(Dense(n_out=8, activation=Activation.RELU, name="d0"))
            .layer(OutputLayer(n_out=2, loss=Loss.MCXENT, activation=Activation.SOFTMAX,
                               name="out"))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())
    model = SequentialModel(conf, device="cpu").init()
    tl = TransferLearning.Builder(model).set_feature_extractor("p0").build()
    helper = TransferLearningHelper(tl)
    feat = helper.featurize(DataSet(x, y))
    assert feat.features.ndim == 2
    np.testing.assert_allclose(helper.output_from_featurized(feat.features).numpy(),
                               tl.output(x).numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_sgd_and_adam_fine_tunes_follow_jax(updater):
    """The fine-tune configuration's updater replaces the model's, in
    both packages alike."""
    x, y = _toy_problem(n=64)
    pm = SequentialModel(_mlp(), device="cpu").init()
    jm = _jax_of(pm.conf)
    pu, ju = (Sgd(0.1), JSgd(0.1)) if updater == "sgd" else (Adam(1e-2), JAdam(1e-2))
    pt = (TransferLearning.Builder(pm)
          .fine_tune_configuration(FineTuneConfiguration(updater=pu, seed=5))
          .set_feature_extractor("d0").build())
    jt = (JTL.Builder(jm).fine_tune_configuration(JFTC(updater=ju, seed=5))
          .set_feature_extractor("d0").build())
    assert pt.conf.seed == 5 and type(pt.conf.updater).__name__ == type(pu).__name__
    for i in range(0, 64, 16):
        pt.fit_batch(DataSet(x[i:i + 16], y[i:i + 16]))
        jt.fit_batch(JDS(x[i:i + 16], y[i:i + 16]))
        assert abs(pt.score_value - jt.score_value) <= LOSS_TOL
