"""The port's losses (`nn/losses.py`) and activations against the JAX
package's, on the CPU.

Every member of `Loss`, without a mask and with a (B, T) mask, on the
same f32 inputs (numpy seed per case): categorical losses on logits
(the fused path) and on probabilities, with int and one-hot labels;
elementwise losses on activated predictions.  Held within 1e-6 relative
(1e-6 absolute near 0): the same f32 formulas, reduced in another order.
Every activation within 1e-6 on the same inputs.  Three `fit_batch`
steps of heads whose loss takes the non-fused path (MSE on identity,
mcxent after a declared ReLU) and the fused sigmoid one (XENT) match
the JAX package's losses within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSM
from deeplearning4j_tpu.nn import activations as jax_activations
from deeplearning4j_tpu.nn import losses as jax_losses
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn import activations, losses
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    SequentialConfiguration,
)

torch.set_num_threads(1)

B, T, C = 3, 5, 7
CATEGORICAL = ("mcxent", "nll", "sparse_mcxent", "xent")
TOL = 1e-6


def _inputs(loss, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, T, C)) * 2).astype(np.float32)
    if loss == "xent":
        labels = (rng.random((B, T, C)) < 0.4).astype(np.float32)
    elif loss in CATEGORICAL:
        labels = rng.integers(0, C, (B, T)).astype(np.int32)
    elif loss in ("hinge", "squared_hinge", "wasserstein"):
        labels = np.where(rng.random((B, T, C)) < 0.5, -1.0, 1.0).astype(np.float32)
    elif loss in ("kld", "reconstruction_xent"):
        labels = rng.random((B, T, C)).astype(np.float32)
        labels /= labels.sum(-1, keepdims=True)
    else:
        labels = (rng.standard_normal((B, T, C)) + 1).astype(np.float32)
    if loss in ("poisson", "kld", "reconstruction_xent", "msle"):
        preds = 1.0 / (1.0 + np.exp(-logits))            # in (0, 1)
    else:
        preds = logits
    mask = (rng.random((B, T)) < 0.7).astype(np.float32)
    return preds.astype(np.float32), labels, mask


def _both(loss, preds, labels, mask, from_logits=True):
    ref = jax_losses.compute(jax_losses.Loss(loss), jnp.asarray(preds),
                             jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask),
                             from_logits=from_logits)
    got = losses.compute(losses.Loss(loss), torch.from_numpy(preds),
                         torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask),
                         from_logits=from_logits)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("loss", [m.value for m in jax_losses.Loss])
def test_every_loss_matches_jax(loss, masked):
    preds, labels, mask = _inputs(loss, seed=len(loss) * 7 + masked)
    _both(loss, preds, labels, mask if masked else None)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("loss", ["mcxent", "nll", "sparse_mcxent", "xent"])
def test_categorical_losses_on_probabilities_and_one_hot_labels(loss, masked):
    preds, labels, mask = _inputs(loss, seed=3 + masked)
    mask = mask if masked else None
    if loss == "xent":
        probs = 1.0 / (1.0 + np.exp(-preds))
    else:
        e = np.exp(preds - preds.max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)
    _both(loss, probs.astype(np.float32), labels, mask, from_logits=False)
    if loss != "xent":
        one_hot = np.eye(C, dtype=np.float32)[labels]
        _both(loss, preds, one_hot, mask)


@pytest.mark.parametrize("act", [m.value for m in jax_activations.Activation])
def test_every_activation_matches_jax(act):
    x = (np.random.default_rng(4).standard_normal((4, 33)) * 3).astype(np.float32)
    x[0, :5] = [0.0, 1.0, -1.0, 6.0, -3.0]                # kinks and clips
    ref = np.asarray(jax_activations.Activation(act)(jnp.asarray(x)))
    got = activations.Activation(act)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def _head_conf(pkg_conf, loss, act):
    head = dataclasses.replace(pkg_conf.layers[-1], loss=loss, activation=act)
    return dataclasses.replace(pkg_conf, layers=pkg_conf.layers[:-1] + (head,))


@pytest.mark.parametrize("loss,act", [("mse", "identity"), ("mcxent", "relu"),
                                      ("xent", "sigmoid")])
def test_fit_batch_with_other_losses_matches_jax(loss, act):
    kw = dict(vocab_size=16, d_model=32, n_heads=2, n_layers=1, seed=3,
              learning_rate=5e-3)
    jconf = _head_conf(JaxTE(**kw).conf(), loss, act)
    jmodel = JaxSM(jconf).init()
    model = SequentialModel(SequentialConfiguration.from_json(jconf.to_json()),
                            device="cpu").init()
    rng = np.random.default_rng(9)
    for _ in range(3):
        ids = rng.integers(0, 16, (2, 8)).astype(np.int32)
        y = np.eye(16, dtype=np.float32)[np.roll(ids, -1, axis=1)]
        jmodel.fit_batch(JaxDataSet(ids, y))
        model.fit_batch(DataSet(ids, y))
        assert abs(model.score_value - float(jmodel.score_value)) <= 1e-5
