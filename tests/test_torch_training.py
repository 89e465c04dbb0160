"""The port's training slice against the JAX package, on the CPU.

Inputs are made from numpy seeds and handed to both packages; weights
go JAX -> port through `convert.params_from_jax` and come back through
`convert.params_to_numpy`.  Both sides compute in f32 (the JAX package
runs its dense `mha` here; the port runs the plain versions of its flash
kernels, forward and backward).  Tolerances, with their reasons:

- chunked loss and its gradients: atol 1e-5 / rtol 1e-5 — the same f32
  products, summed in another order; the bf16-h gradient within one bf16
  rounding (rtol 2^-7);
- updaters: rtol 1e-5, atol 1e-7 — optax's elementwise formulas, f32;
- the whole slice, 5 `fit_batch` steps: `score_value` within 1e-5 at
  every step (f32 forward in another summation order).  Final parameters
  within atol 5e-4, a tenth of the learning rate, with 99.9 % of all
  elements within 1e-5: Adam divides each gradient element by its own
  running magnitude, so an element whose gradient sits near Adam's eps
  (1e-8) turns f32 summation noise into a visible part of one step.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models._common import pop_aux_losses as jax_pop_aux
from deeplearning4j_tpu.models._common import (
    regularization_loss as jax_regularization_loss,
)
from deeplearning4j_tpu.nn import updaters as jax_updaters
from deeplearning4j_tpu.ops.chunked_xent import (
    chunked_softmax_xent as jax_chunked_xent,
)
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.convert import params_from_jax, params_to_numpy
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import NumpyDataSetIterator
from deeplearning4j_tpu_torch.models._common import (
    pop_aux_losses,
    regularization_loss,
)
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.ops.chunked_xent import chunked_softmax_xent
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

# small shapes: one intra-op thread keeps these files from competing with
# the multi-process tests that share the host under pytest-xdist
torch.set_num_threads(1)

VOCAB, D, HEADS, LAYERS, LR = 50, 32, 2, 2, 5e-3
BATCH, SEQ, STEPS = 2, 12, 5


def _zoo(cls, chunked=True, **kw):
    return cls(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS,
               causal=True, seed=7, chunked_vocab_loss=chunked, vocab_chunk=16,
               learning_rate=LR, **kw)


def _carry(jmodel, conf):
    return params_from_jax(jax.tree.map(np.asarray, jmodel.params),
                           SequentialModel(conf, device="cpu"))


def _batches(one_hot, seed=0, n=STEPS):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
        y = np.roll(ids, -1, axis=1)
        if one_hot:
            y = np.eye(VOCAB, dtype=np.float32)[y]
        out.append((ids, y))
    return out


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# -- chunked loss ---------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 25])          # 50 % 16 != 0, 50 % 25 == 0
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_xent_value_and_grads_match_jax(chunk, masked):
    rng = np.random.default_rng(chunk + int(masked))
    n, d = 24, 16
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, VOCAB)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(VOCAB) * 0.1).astype(np.float32)
    labels = rng.integers(0, VOCAB, n).astype(np.int32)
    weights = np.ones(n, np.float32)
    if masked:
        weights[::3] = 0.0
    ref, ref_g = jax.value_and_grad(jax_chunked_xent, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), jnp.asarray(labels),
        jnp.asarray(weights), chunk)
    th, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (h, w, b))
    loss = chunked_softmax_xent(th, tw, tb, torch.from_numpy(labels).long(),
                                torch.from_numpy(weights), chunk)
    got_g = torch.autograd.grad(loss, (th, tw, tb))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5, atol=1e-5)
    for name, a, r in zip(("dh", "dW", "db"), got_g, ref_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_chunked_xent_bf16_hidden_states_match_jax():
    rng = np.random.default_rng(11)
    n, d = 16, 16
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, VOCAB)) * 0.3).astype(np.float32)
    b = np.zeros(VOCAB, np.float32)
    labels = rng.integers(0, VOCAB, n).astype(np.int32)
    weights = np.ones(n, np.float32)
    jh = jnp.asarray(h).astype(jnp.bfloat16)
    ref, ref_g = jax.value_and_grad(jax_chunked_xent, argnums=(0, 1, 2))(
        jh, jnp.asarray(w), jnp.asarray(b), jnp.asarray(labels),
        jnp.asarray(weights), 16)
    th = torch.from_numpy(h).to(torch.bfloat16).requires_grad_(True)
    tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (w, b))
    loss = chunked_softmax_xent(th, tw, tb, torch.from_numpy(labels),
                                torch.from_numpy(weights), 16)
    dh, dw, db = torch.autograd.grad(loss, (th, tw, tb))
    assert dh.dtype == torch.bfloat16
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(dh.float().numpy(),
                               np.asarray(ref_g[0].astype(jnp.float32)),
                               rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(ref_g[1]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(ref_g[2]), rtol=1e-5,
                               atol=1e-5)


# -- updaters -------------------------------------------------------------------

def _updater_run(port_tx, jax_tx, steps=6):
    rng = np.random.default_rng(1)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 3).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    jp = [jnp.asarray(p) for p in params]
    jstate = jax_tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = port_tx.init(tp)
    for g in grads:
        upd, jstate = jax_tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        tupd, tstate = port_tx.update([torch.from_numpy(x) for x in g], tstate)
        for p, u in zip(tp, tupd):
            p.add_(u)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("clip", [(None, None), (1.0, None), (None, 2.0),
                                  (2.5, 4.0)])
@pytest.mark.parametrize("name", ["Adam", "Sgd"])
def test_updaters_with_clipping_match_optax(name, clip):
    value, norm = clip
    port = getattr(updaters, name)(0.05)
    ref = getattr(jax_updaters, name)(0.05).to_optax()
    _updater_run(updaters.with_gradient_clipping(port, value, norm),
                 jax_updaters.with_gradient_clipping(ref, value, norm))


def test_adam_defaults_are_optax_defaults():
    a = updaters.Adam(1e-3)
    ref = jax_updaters.Adam(1e-3)
    assert (a.beta1, a.beta2, a.epsilon) == (ref.beta1, ref.beta2, ref.epsilon)
    _updater_run(a, optax.adam(1e-3))


def test_schedule_learning_rate_is_not_ported():
    """Schedules are ported now (`nn/schedules.py`): a `Schedule` is a
    learning rate, a bare function still is not (it does not serialize)."""
    from deeplearning4j_tpu_torch.nn.schedules import StepSchedule

    with pytest.raises(TypeError, match="Schedule"):
        updaters.Adam(learning_rate=lambda step: 1e-3)
    sched = StepSchedule(initial=0.05, decay_rate=0.5, step=2.0)
    assert updaters.Adam(learning_rate=sched).learning_rate is sched


# -- training-step pieces ---------------------------------------------------------

def test_regularization_and_aux_losses_match_jax():
    jmodel = _zoo(JaxTE).init_model()

    def penalised(layers):
        return [(l.name, dataclasses.replace(l, l1=1e-3, l2=2e-2))
                for l in layers]

    ref = jax_regularization_loss(jmodel.params,
                                  penalised(jmodel.conf.layers))
    tm = _carry(jmodel, _zoo(TransformerEncoder).conf())
    got = regularization_loss(tm.params, penalised(tm.conf.layers))
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    assert regularization_loss(tm.params, [(l.name, l) for l in tm.conf.layers]) == 0.0

    state = {"a": {"__aux_loss__": np.float32(0.25), "s": 1},
             "b": {"__aux_loss__": np.float32(0.5)}, "c": {"t": 2}}
    ref_total, ref_clean = jax_pop_aux(state)
    total, clean = pop_aux_losses(state)
    assert float(total) == float(ref_total) and clean == ref_clean


@pytest.mark.parametrize("chunked", [True, False])
def test_fit_batch_matches_jax_step_for_step(chunked):
    """5 Adam steps of the small transformer on the same batches: the
    chunked head with int ids, and the dense `RnnOutputLayer` mcxent head
    with one-hot labels."""
    jmodel = _zoo(JaxTE, chunked).init_model()
    model = _carry(jmodel, _zoo(TransformerEncoder, chunked).conf())
    for ids, y in _batches(one_hot=not chunked):
        jmodel.fit_batch(JaxDataSet(ids, y))
        model.fit_batch(DataSet(ids, y))
        assert abs(model.score_value - jmodel.score_value) <= 1e-5
    assert model.iteration == STEPS
    got = _leaves(params_to_numpy(model))
    ref = _leaves(jax.tree.map(np.asarray, jmodel.params))
    err = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, ref)])
    assert err.max() <= 5e-4, err.max()
    assert np.mean(err <= 1e-5) >= 0.999, np.mean(err <= 1e-5)


def test_l1_l2_training_matches_jax():
    """The penalty enters score_value and the gradients on both sides."""
    jmodel = _zoo(JaxTE).init_model()
    jconf = jmodel.conf
    jconf = dataclasses.replace(jconf, layers=tuple(
        dataclasses.replace(l, l1=1e-4, l2=1e-2) for l in jconf.layers))
    from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSM

    jpen = JaxSM(jconf)
    jpen.init()
    jpen.params = jmodel.params
    jpen.opt_state = jpen._tx.init(jpen.params)
    conf = _zoo(TransformerEncoder).conf()
    conf = dataclasses.replace(conf, layers=tuple(
        dataclasses.replace(l, l1=1e-4, l2=1e-2) for l in conf.layers))
    model = _carry(jmodel, conf)
    for ids, y in _batches(one_hot=False, seed=4, n=3):
        jpen.fit_batch(JaxDataSet(ids, y))
        model.fit_batch(DataSet(ids, y))
        assert abs(model.score_value - jpen.score_value) <= 1e-5


def test_output_after_fit_batch_serves_the_new_weights():
    model = _zoo(TransformerEncoder).init_model(device="cpu")
    ids, y = _batches(one_hot=False, n=1)[0]
    before = model.output(ids)
    model.fit_batch(DataSet(ids, y))
    after = model.output(ids)
    assert not torch.allclose(before, after)
    fresh = SequentialModel(model.conf, device="cpu").load_params(
        params_to_numpy(model))
    torch.testing.assert_close(after, fresh.output(ids), rtol=0, atol=0)


def test_fit_runs_epochs_of_batches_and_the_loss_falls():
    model = _zoo(TransformerEncoder).init_model(device="cpu")
    rng = np.random.default_rng(2)
    ids = rng.integers(0, VOCAB, (8, SEQ))
    it = NumpyDataSetIterator(ids, np.roll(ids, -1, axis=1), batch_size=4)
    model.fit(it, epochs=3)
    first = model.score_value
    assert (model.iteration, model.epoch) == (6, 3)
    model.fit(DataSet(ids, np.roll(ids, -1, axis=1)), epochs=4, batch_size=8)
    assert model.iteration == 10 and model.score_value < first


def test_builder_sets_the_training_settings():
    conf = (NeuralNetConfiguration.builder().updater(updaters.Adam(0.1))
            .gradient_clip(value=1.0, norm=2.0).steps_per_epoch(7)
            .list().layer(_zoo(TransformerEncoder).conf().layers[0])
            .build())
    assert conf.updater == updaters.Adam(0.1)
    assert (conf.gradient_clip_value, conf.gradient_clip_norm) == (1.0, 2.0)
    assert conf.steps_per_epoch == 7
    assert isinstance(NeuralNetConfiguration.builder().list().layer(
        conf.layers[0]).build().updater, updaters.Sgd)
    assert isinstance(_zoo(TransformerEncoder).conf().updater, updaters.Adam)


def test_what_the_slice_does_not_train_raises():
    """Dropout trains now (the JAX package's masks,
    `tests/test_torch_init_rng.py`), and grouped steps since the LeNet
    slice (`tests/test_torch_lenet.py` holds their losses; a group of
    none is refused), and features masks since the attention slice (an
    all-ones mask gives the unmasked step's loss, through the dense
    attention instead of flash), and frozen layers since the training
    tooling slice (the frozen embedding keeps its bits; its parity with
    the JAX package is `tests/test_torch_transfer.py`'s), and data
    parallelism since the data-parallel slice (`tests/test_torch_parallel.py`
    holds it against the JAX mesh), and tensor parallelism since the
    model-parallel slice (the flagship's embedding split by columns and
    its head by vocabulary, the blocks whole), and pipeline parallelism
    since the pipeline slice (`tests/test_torch_pipeline_fit.py`);
    `ParallelInference` still raises, naming its ROADMAP item.  TBPTT
    loads as configuration data and builds since the recurrent slice."""
    ids, y = _batches(one_hot=False, n=1)[0]
    batch = DataSet(ids, y)
    model = _zoo(TransformerEncoder).init_model(device="cpu")
    with pytest.raises(ValueError, match="steps_per_execution"):
        model.fit(batch, steps_per_execution=0)
    # a features mask trains (key masks through the attention, the JAX step)
    masked, plain = model.clone(), model.clone()
    masked.fit_batch(DataSet(ids, y, features_mask=np.ones_like(ids)))
    plain.fit_batch(batch)
    assert masked.score_value == pytest.approx(plain.score_value, rel=1e-5)
    conf = _zoo(TransformerEncoder).conf()
    conf = dataclasses.replace(conf, layers=(
        dataclasses.replace(conf.layers[0], frozen=True),) + conf.layers[1:])
    frozen = SequentialModel(conf, device="cpu").init()
    name = conf.layers[0].name
    before = {k: v.detach().clone() for k, v in frozen.params[name].items()}
    frozen.fit_batch(batch)
    assert frozen.iteration == 1 and np.isfinite(frozen.score_value)
    for k, v in before.items():
        assert torch.equal(v, frozen.params[name][k])
    tbptt = (NeuralNetConfiguration.builder().tbptt(16).list()
             .layer(_zoo(TransformerEncoder).conf().layers[0]).build())
    assert (tbptt.backprop_type, tbptt.tbptt_length) == ("tbptt", 16)
    # it builds since the recurrent slice (ROADMAP A8)
    assert SequentialModel(tbptt, device="cpu")._tbptt
    from deeplearning4j_tpu_torch.parallel.strategy import param_specs

    specs = param_specs(model.params, model.conf)
    assert specs["layer0"] == {"W": (None, "model")}
    assert all(s == () for blk in ("layer2", "layer3")
               for s in jax.tree.leaves(specs[blk], is_leaf=lambda x: isinstance(x, tuple)))
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    with pytest.raises(NotImplementedError, match="A11"):
        ParallelInference(model)
    assert model.iteration == 0
