"""The port's random bits (`runtime/rng.py`) and sampled streams against
the JAX package, bit for bit and token for token.

- `key`, `fold_in`, `random_bits`, `uniform` and `gumbel` equal
  `jax.random`'s (threefry, partitionable layout, gumbel mode "low") bit
  for bit, for several seeds, folded counts and shapes, (V,) and (B, V)
  included; the noise of one (1, V) row is that of the (V,) row, and
  `bits_at` / `gumbel_at` give a whole draw's values at chosen indices
  (the sampler draws only its candidates').
- Sampled streams (temperature 0.8, top-k 50 and top-k 0) of the port's
  dense `generate` and of its `GenerationEngine` are token-identical to
  the JAX package's `generate` and engine, from the same weights carried
  across by `convert.params_from_jax` (vocab 61, d_model 32, 2 heads, 2
  layers).
"""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.ops.generation import generate as jax_generate
from deeplearning4j_tpu.serving.generation import (
    GenerationConfig as JaxConfig,
    GenerationEngine as JaxEngine,
)
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.ops.generation import generate
from deeplearning4j_tpu_torch.runtime import rng
from deeplearning4j_tpu_torch.serving.generation import (
    GenerationConfig,
    GenerationEngine,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

torch.set_num_threads(1)

VOCAB, D, HEADS, LAYERS = 61, 32, 2, 2
CFG = dict(slots=4, page_size=8, num_pages=64, max_pages_per_seq=4,
           max_queue=16)
MAX_NEW = 12
SEEDS = (0, 11, 123, -1, 2**31 - 1)


def _jax_key(seed, data):
    return jax.random.fold_in(jax.random.key(seed), data)


def _u32(a):
    return np.asarray(a).view(np.uint32).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_match_jax(seed):
    assert rng.key(seed) == tuple(_u32(jax.random.key_data(jax.random.key(seed))))
    for data in (0, 1, 31, 2**32 - 1):
        got = rng.fold_in(rng.key(seed), data)
        assert got == tuple(_u32(jax.random.key_data(_jax_key(seed, data))))


@pytest.mark.parametrize("shape", [(7,), (VOCAB,), (3, 1000), (2, 32000)])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_gumbel_match_jax_bit_for_bit(seed, shape):
    for data in (0, 5, 2**32 - 1):
        key, jkey = rng.fold_in(rng.key(seed), data), _jax_key(seed, data)
        np.testing.assert_array_equal(rng.random_bits(key, shape).numpy(),
                                      _u32(jax.random.bits(jkey, shape)))
        for name, ours, theirs in (
                ("uniform", rng.uniform(key, shape),
                 jax.random.uniform(jkey, shape)),
                ("gumbel", rng.gumbel(key, shape),
                 jax.random.gumbel(jkey, shape))):
            assert ours.dtype == torch.float32, name
            np.testing.assert_array_equal(ours.numpy().view(np.uint32),
                                          np.asarray(theirs).view(np.uint32),
                                          err_msg=name)


def test_noise_at_chosen_indices_is_the_noise_of_the_whole_draw():
    """`_sample` draws noise for its candidates' flat indices only."""
    key = rng.fold_in(rng.key(3), 9)
    whole = rng.gumbel(key, (2, 1000)).flatten()
    index = torch.tensor([0, 5, 999, 1000, 1999], dtype=torch.int64)
    assert torch.equal(rng.gumbel_at(key, index), whole[index])
    assert torch.equal(rng.bits_at(key, index),
                       rng.random_bits(key, (2, 1000)).flatten()[index])


def test_row_noise_is_the_same_in_both_shapes():
    """The engine samples one (V,) row as a (1, V) batch; the JAX engine
    draws (V,).  Threefry's partitionable layout numbers both alike."""
    key, jkey = rng.fold_in(rng.key(7), 3), _jax_key(7, 3)
    row = rng.gumbel(key, (VOCAB,))
    assert torch.equal(rng.gumbel(key, (1, VOCAB))[0], row)
    np.testing.assert_array_equal(np.asarray(jax.random.gumbel(jkey, (VOCAB,))),
                                  row.numpy())


def _zoo(cls):
    return cls(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS,
               causal=True, seed=5, chunked_vocab_loss=True)


@pytest.fixture(scope="module")
def jmodel():
    return _zoo(JaxTE).init_model()


@pytest.fixture(scope="module")
def model(jmodel):
    port = SequentialModel(_zoo(TransformerEncoder).conf(), device="cpu")
    return params_from_jax(jax.tree.map(np.asarray, jmodel.params), port)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


@pytest.mark.parametrize("top_k", [50, 0])
def test_dense_sampled_streams_match_jax(jmodel, model, top_k):
    """A batch of two prompts: one key draws the whole (B, V) noise."""
    prompts = np.stack([_prompt(9, seed=1), _prompt(9, seed=2)])
    kw = dict(temperature=0.8, top_k=top_k, seed=42)
    ref = np.asarray(jax_generate(jmodel, prompts, MAX_NEW, **kw))
    out = generate(model, prompts, MAX_NEW, **kw).numpy()
    np.testing.assert_array_equal(out, ref)
    assert not np.array_equal(out, generate(model, prompts, MAX_NEW,
                                            **dict(kw, seed=43)).numpy())


@pytest.mark.parametrize("top_k", [50, 0])
def test_engine_sampled_streams_match_jax_engine(jmodel, model, top_k):
    streams = [(_prompt(n, seed=n), dict(temperature=0.8, top_k=top_k, seed=n))
               for n in (4, 9, 13)]
    jeng = JaxEngine(model=jmodel, config=JaxConfig(**CFG)).start()
    try:
        refs = [r.result(120) for r in
                [jeng.submit(p, MAX_NEW, **kw) for p, kw in streams]]
    finally:
        jeng.stop()
    eng = GenerationEngine(model, GenerationConfig(**CFG)).start()
    try:
        outs = [r.result(120) for r in
                [eng.submit(p, MAX_NEW, **kw) for p, kw in streams]]
        assert eng.kv.leak_check() is None
    finally:
        eng.stop()
    for out, ref in zip(outs, refs):
        np.testing.assert_array_equal(out, np.asarray(ref))
