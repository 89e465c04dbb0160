"""The port's random bits for initialisation and dropout against
`jax.random` and the JAX package, on the CPU.

- `SeedStream` (named keys, sequential keys, its state dict, the step
  fold) and `split` give jax's key words exactly.
- `normal` equals ``jax.random.normal`` bit for bit at odd and even
  sizes; its erfinv equals XLA's on every one of the 2^23 uniform values
  a normal draw can start from.  `bernoulli`, and `uniform` between
  bounds (one rounding for the scale-and-shift, as XLA's fused
  multiply-add), equal jax's bit for bit.
- Every `WeightInit` scheme equals the JAX package's at the same key bit
  for bit, except ORTHOGONAL (QR is not reproducible across libraries):
  within 1e-6 absolute, its product Q^T Q the identity within 1e-5.
- `SequentialModel.init` at a seed gives the JAX package's whole tree
  bit for bit (both heads, a learned positional encoding, several
  builder-level schemes).
- Dropout: the layer-input mask equals the JAX package's `_dropout`
  exactly; 3 `fit_batch` steps with dropout 0.1 on every layer match the
  JAX package's losses within 1e-5, and its final parameters as the plain
  training test holds them (`_close_after_adam`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSM
from deeplearning4j_tpu.nn import weights as jax_weights
from deeplearning4j_tpu.nn.conf.layers import _dropout as jax_dropout
from deeplearning4j_tpu.runtime.rng import SeedStream as JaxSeedStream
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.convert import params_to_numpy
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn import weights
from deeplearning4j_tpu_torch.nn.conf.layers import _dropout
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    SequentialConfiguration,
)
from deeplearning4j_tpu_torch.runtime import rng

torch.set_num_threads(1)

SEEDS = (0, 7, 123, -1, 2**31 - 1)
SHAPES = [(7,), (64,), (3, 1001), (16, 32)]


def _words(k):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)).view(np.uint32))


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_stream_matches_jax(seed):
    ours, ref = rng.SeedStream(seed), JaxSeedStream(seed)
    assert ours.root == _words(ref.root)
    for name in ("init/layer0", "init/layer10", "dropout", ""):
        assert ours.key(name) == _words(ref.key(name))
    for _ in range(3):
        assert ours.next() == _words(ref.next())
    state = ref.state_dict()
    assert ours.state_dict() == state
    again = rng.SeedStream(0)
    again.load_state_dict(state)
    assert again.next() == _words(ref.next())
    assert rng.SeedStream(ours.root).root == ours.root
    for step in (0, 1, 2**32 - 1):
        assert rng.SeedStream.fold(ours.root, step) == _words(
            JaxSeedStream.fold(ref.root, step))


@pytest.mark.parametrize("n", [2, 3, 4, 7])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed, n):
    ref = jax.random.split(jax.random.key(seed), n)
    assert rng.split(rng.key(seed), n) == [_words(k) for k in ref]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_bernoulli_uniform_match_jax_bit_for_bit(seed, shape):
    key, jkey = rng.fold_in(rng.key(seed), 3), jax.random.fold_in(
        jax.random.key(seed), 3)
    np.testing.assert_array_equal(_bits(rng.normal(key, shape)),
                                  _bits(jax.random.normal(jkey, shape)))
    for p in (0.9, 0.5, 0.1):
        np.testing.assert_array_equal(rng.bernoulli(key, p, shape).numpy(),
                                      np.asarray(jax.random.bernoulli(jkey, p, shape)))
    for a in (0.37, 0.0541, 1.7320508):
        np.testing.assert_array_equal(
            _bits(rng.uniform(key, shape, -a, a)),
            _bits(jax.random.uniform(jkey, shape, jnp.float32, -a, a)))


def test_erfinv_matches_xla_on_every_uniform_value():
    """All 2^23 inputs a normal draw can reach: the uniform values
    (1 + m 2^-23 - 1) * 2 + nextafter(-1, 0) of every mantissa m."""
    m = torch.arange(2**23, dtype=torch.int64)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = rng._uniform(m << 9, lo, 1.0)
    ref = jax.jit(lambda x: jnp.float32(np.sqrt(2)) * jax.lax.erf_inv(x))(u.numpy())
    got = rng._SQRT2 * rng._erfinv(u)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("shape,fans", [((8, 12), (None, None)), ((7, 5), (3, 9)),
                                        ((3, 3, 4, 6), (None, None)), ((5,), (None, None))])
@pytest.mark.parametrize("scheme", [w.value for w in jax_weights.WeightInit])
def test_every_weight_init_matches_jax(scheme, shape, fans):
    if scheme == "identity" and (len(shape) != 2 or shape[0] != shape[1]):
        shape = (6, 6)
    if scheme == "orthogonal" and len(shape) < 2:
        shape = (5, 3)
    key = rng.fold_in(rng.key(11), len(shape))
    jkey = jax.random.fold_in(jax.random.key(11), len(shape))
    got = weights.WeightInit(scheme).init(key, shape, *fans)
    ref = np.asarray(jax_weights.WeightInit(scheme).init(jkey, shape, *fans))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    if scheme != "orthogonal":
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        return
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    q = got.reshape(-1, shape[-1]).double()
    gram = q.T @ q if q.shape[0] >= q.shape[1] else q @ q.T
    np.testing.assert_allclose(gram.numpy(), np.eye(gram.shape[0]), atol=1e-5)


def test_fans_match_jax():
    for shape in ((), (5,), (4, 7), (3, 3, 4, 6), (2, 3, 3, 4, 6)):
        assert weights._fans(shape) == jax_weights._fans(shape)


def _with(conf, **fields):
    return dataclasses.replace(conf, layers=tuple(
        dataclasses.replace(l, **fields) for l in conf.layers))


def _port_of(jconf):
    return SequentialConfiguration.from_json(jconf.to_json())


def _tree_bits(tree):
    return [_bits(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("variant", ["chunked", "dense", "learned_positions",
                                     "uniform_schemes", "lecun"])
def test_init_matches_jax_bit_for_bit(variant):
    jconf = JaxTE(vocab_size=64, d_model=32, n_heads=2, n_layers=2, seed=29,
                  chunked_vocab_loss=variant == "chunked", vocab_chunk=16).conf()
    if variant == "learned_positions":
        from deeplearning4j_tpu.nn.conf.attention import PositionalEncoding

        jconf = dataclasses.replace(jconf, layers=(
            jconf.layers[0], dataclasses.replace(
                PositionalEncoding(learned=True, max_length=24), name="layer1"),
        ) + jconf.layers[2:])
    elif variant == "uniform_schemes":
        jconf = _with(jconf, weight_init="xavier_uniform")
    elif variant == "lecun":
        jconf = _with(jconf, weight_init="lecun_normal")
    ref = JaxSM(jconf).init()
    got = SequentialModel(_port_of(jconf), device="cpu").init()
    want = _tree_bits(jax.tree.map(np.asarray, ref.params))
    have = _tree_bits(params_to_numpy(got))
    assert len(have) == len(want)
    for a, b in zip(have, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_mask_matches_jax(rate):
    x = np.random.default_rng(1).standard_normal((2, 9, 33)).astype(np.float32)
    key = rng.fold_in(rng.SeedStream(4).root, 2)
    jkey = jax.random.fold_in(JaxSeedStream(4).root, 2)
    ref = np.asarray(jax_dropout(jnp.asarray(x), rate, True, jkey))
    got = _dropout(torch.from_numpy(x), rate, True, key).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(
        _dropout(torch.from_numpy(x), rate, False, key).numpy(), x)


def _close_after_adam(tree, jtree):
    """Parameters after Adam steps on both sides: within 1e-5 for 99.9 %
    of all elements and within 5e-4 (a tenth of the learning rate) for
    every one.  Adam divides each gradient element by its own running
    magnitude, so an element whose gradient sits near Adam's eps turns
    f32 summation noise into a visible part of a step
    (`tests/test_torch_training.py` holds the plain step the same way)."""
    err = np.concatenate([
        np.abs(a - b).ravel() for a, b in zip(
            jax.tree.leaves(tree), jax.tree.leaves(jax.tree.map(np.asarray, jtree)))])
    assert err.max() <= 5e-4, err.max()
    assert np.mean(err <= 1e-5) >= 0.999, np.mean(err <= 1e-5)


@pytest.mark.parametrize("chunked", [True, False])
def test_fit_batch_with_dropout_matches_jax(chunked):
    jconf = _with(JaxTE(vocab_size=64, d_model=32, n_heads=2, n_layers=2, seed=7,
                        chunked_vocab_loss=chunked, vocab_chunk=16,
                        learning_rate=5e-3).conf(), dropout_rate=0.1)
    jmodel = JaxSM(jconf).init()
    model = SequentialModel(_port_of(jconf), device="cpu").init()
    rs = np.random.default_rng(0)
    for _ in range(3):
        ids = rs.integers(0, 64, (2, 12)).astype(np.int32)
        y = np.roll(ids, -1, axis=1)
        if not chunked:
            y = np.eye(64, dtype=np.float32)[y]
        jmodel.fit_batch(JaxDataSet(ids, y))
        model.fit_batch(DataSet(ids, y))
        assert abs(model.score_value - float(jmodel.score_value)) <= 1e-5
    _close_after_adam(params_to_numpy(model), jmodel.params)
    # and dropout does change the step: the same model without it differs
    plain = SequentialModel(_port_of(_with(jconf, dropout_rate=None)),
                            device="cpu").init()
    ids = np.random.default_rng(0).integers(0, 64, (2, 12)).astype(np.int32)
    y = np.roll(ids, -1, axis=1) if chunked else np.eye(64, dtype=np.float32)[
        np.roll(ids, -1, axis=1)]
    plain.fit_batch(DataSet(ids, y))
    again = SequentialModel(_port_of(jconf), device="cpu").init()
    again.fit_batch(DataSet(ids, y))
    assert plain.score_value != again.score_value
