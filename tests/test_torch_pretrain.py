"""Layerwise unsupervised pretraining (`nn/conf/pretrain.py`, the models'
``pretrain`` and ``pretrain_layer``) against the JAX package, on the CPU.

The random bits are the JAX package's exactly: the denoising
autoencoder's corruption mask (``bernoulli`` on the step key) and the
VAE's reparameterisation noise (``normal`` on ``fold_in(step key, s)``).
Each layer's supervised ``apply``, its ``pretrain_loss`` and the loss's
gradients agree within 1e-5 of the largest reference element (f32,
another order of the sums).  ``pretrain_layer`` on a sequential stack
and on a graph, eight steps over four batches from the JAX weights,
returns the last loss within 1e-5 relative and leaves the layer's
parameters within 1e-5 of the largest element of JAX's, every other
parameter untouched.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.iterator import NumpyDataSetIterator as JaxIterator
from deeplearning4j_tpu.models.computation_graph import GraphModel as JaxGraph
from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSeq
from deeplearning4j_tpu.nn.conf import pretrain as jax_pretrain
from deeplearning4j_tpu.nn.conf.graph_conf import GraphConfiguration as JaxGraphConf
from deeplearning4j_tpu.nn.conf.input_type import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
    SequentialConfiguration as JaxSeqConf,
)
from deeplearning4j_tpu.runtime.rng import SeedStream as JaxSeedStream
from deeplearning4j_tpu_torch.convert import params_from_jax, params_to_numpy
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import NumpyDataSetIterator
from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn.conf import pretrain
from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder, GraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
    SequentialConfiguration,
)
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.runtime import rng

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} of max {scale:.3e}"


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _jkey(k):
    return jax.random.wrap_key_data(jnp.asarray(k, jnp.uint32))


@pytest.mark.parametrize("step", [0, 1, 7])
def test_corruption_mask_and_vae_noise_are_jaxs_bits(step):
    """The step key, ``bernoulli(key, 1 - c, shape)`` and ``normal(
    fold_in(key, s), shape)`` for samples s = 0, 1 (the JAX layers'
    draws) are the JAX package's bits."""
    seed = 123
    jroot = JaxSeedStream(seed).root
    jk = JaxSeedStream.fold(jroot, jnp.uint32(step))
    pk = rng.SeedStream.fold(rng.SeedStream(seed).root, step)
    assert tuple(int(v) for v in np.asarray(jax.random.key_data(jk))) == pk
    shape = (33, 70)
    np.testing.assert_array_equal(
        rng.bernoulli(pk, 1.0 - 0.3, shape).numpy(),
        np.asarray(jax.random.bernoulli(jk, 1.0 - 0.3, shape)))
    for s in range(2):
        np.testing.assert_array_equal(
            rng.normal(rng.fold_in(pk, s), shape).numpy(),
            np.asarray(jax.random.normal(jax.random.fold_in(jk, s), shape)))


LAYERS = {
    "ae_mse": ("AutoEncoder", dict(n_out=6, corruption_level=0.3)),
    "ae_xent_sparse": ("AutoEncoder", dict(n_out=5, corruption_level=0.2, loss="xent",
                                          sparsity=0.1, sparsity_beta=0.5,
                                          activation="tanh")),
    "ae_clean": ("AutoEncoder", dict(n_out=4, corruption_level=0.0, loss="mse")),
    "vae_gaussian": ("VariationalAutoencoder", dict(n_out=3, encoder_layer_sizes=(8, 6),
                                                   decoder_layer_sizes=(7,),
                                                   num_samples=2)),
    "vae_bernoulli": ("VariationalAutoencoder", dict(n_out=2, encoder_layer_sizes=(5,),
                                                    decoder_layer_sizes=(5, 4),
                                                    reconstruction_distribution="bernoulli",
                                                    pzx_activation="tanh")),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_apply_and_pretrain_loss_match_jax(case):
    cls, kw = LAYERS[case]
    jl, pl = getattr(jax_pretrain, cls)(**kw), getattr(pretrain, cls)(**kw)
    n_in = 9
    seed = sorted(LAYERS).index(case)
    jp, _ = jl.init(jax.random.key(seed), JaxInputType.feed_forward(n_in))
    pp, _ = pl.init(rng.key(seed), InputType.feed_forward(n_in), "cpu")
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(_tree(lambda t: t.numpy(), pp))):
        np.testing.assert_array_equal(np.asarray(a), b)
    r = np.random.default_rng(10 + seed)
    x = r.random((12, n_in)).astype(np.float32)
    jy, _ = jl.apply(jp, {}, jnp.asarray(x))
    py, _ = pl.apply(pp, {}, torch.from_numpy(x))
    _close(py.numpy(), jy, f"{case} apply")
    key = rng.SeedStream.fold(rng.SeedStream(5).root, 3)
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda p: jl.pretrain_loss(
        p, jnp.asarray(x), _jkey(key))))(jp)
    tp = _tree(lambda a: a.clone().requires_grad_(True), pp)
    loss = pl.pretrain_loss(tp, torch.from_numpy(x), key)
    loss.backward()
    _close(loss.item(), float(jloss), f"{case} pretrain loss")
    for (path, g), t in zip(jax.tree_util.tree_leaves_with_path(jgrad),
                            jax.tree.leaves(_tree(lambda t: t.grad.numpy(), tp))):
        _close(t, g, f"{case} d/d{jax.tree_util.keystr(path)}")


def test_vae_reconstruction_log_probability_and_generate_match_jax():
    kw = LAYERS["vae_gaussian"][1]
    jl, pl = jax_pretrain.VariationalAutoencoder(**kw), pretrain.VariationalAutoencoder(**kw)
    jp, _ = jl.init(jax.random.key(0), JaxInputType.feed_forward(9))
    pp, _ = pl.init(rng.key(0), InputType.feed_forward(9), "cpu")
    x = np.random.default_rng(1).random((5, 9)).astype(np.float32)
    key = rng.key(9)
    _close(pl.reconstruction_log_probability(pp, x, key, num_samples=3).numpy(),
           jl.reconstruction_log_probability(jp, x, _jkey(key), num_samples=3),
           "log p(x)")
    z = np.random.default_rng(2).normal(size=(4, 3)).astype(np.float32)
    _close(pl.generate(pp, z).numpy(), jl.generate(jp, z), "generate")


def _seq_conf():
    return (NeuralNetConfiguration.builder().seed(11).updater(Adam(3e-3)).list()
            .layer(Dense(n_out=12, activation="relu"))
            .layer(pretrain.AutoEncoder(n_out=8, corruption_level=0.25))
            .layer(pretrain.VariationalAutoencoder(n_out=3, encoder_layer_sizes=(6,),
                                                   decoder_layer_sizes=(6,), num_samples=2))
            .layer(OutputLayer(n_out=2))
            .set_input_type(InputType.feed_forward(10)).build())


def _graph_conf():
    g = (GraphBuilder().seed(12).updater(Adam(3e-3)).add_inputs("a", "b")
         .set_input_types(InputType.feed_forward(6), InputType.feed_forward(4)))
    g.add_layer("da", Dense(n_out=5, activation="tanh"), "a")
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import MergeVertex

    g.add_vertex("merge", MergeVertex(), "da", "b")
    g.add_layer("vae", pretrain.VariationalAutoencoder(
        n_out=2, encoder_layer_sizes=(7,), decoder_layer_sizes=(5,),
        reconstruction_distribution="bernoulli"), "merge")
    g.add_layer("ae", pretrain.AutoEncoder(n_out=3, loss="xent"), "vae")
    g.add_layer("out", OutputLayer(n_out=2), "ae")
    g.set_outputs("out")
    return g.build()


def _data(r, n=32):
    x = r.random((n, 10)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[r.integers(0, 2, n)]
    return x, y


@pytest.mark.parametrize("index", [1, 2])
def test_sequential_pretrain_layer_matches_jax(index):
    conf = _seq_conf()
    jm = JaxSeq(JaxSeqConf.from_json(conf.to_json())).init()
    pm = SequentialModel(SequentialConfiguration.from_json(jm.conf.to_json()), device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jm.params), pm)
    before = params_to_numpy(pm)
    x, y = _data(np.random.default_rng(index))
    jloss = jm.pretrain_layer(index, JaxIterator(x, y, 8), epochs=2)
    ploss = pm.pretrain_layer(index, NumpyDataSetIterator(x, y, 8), epochs=2)
    _close(ploss, jloss, "last pretrain loss")
    name = conf.layers[index].name
    after, want = params_to_numpy(pm), jax.tree.map(np.asarray, jm.params)
    for k in after:
        for a, b, c in zip(jax.tree.leaves(after[k]), jax.tree.leaves(want[k]),
                           jax.tree.leaves(before[k])):
            if k == name:
                _close(a, b, f"{k} after pretraining")
                assert not np.array_equal(a, c)
            else:
                np.testing.assert_array_equal(a, c)
    assert pm.opt_state is None and pm.iteration == 0


def test_sequential_pretrain_runs_every_pretrainable_layer_and_refuses_others():
    conf = _seq_conf()
    jm = JaxSeq(JaxSeqConf.from_json(conf.to_json())).init()
    pm = SequentialModel(SequentialConfiguration.from_json(jm.conf.to_json()), device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jm.params), pm)
    x, y = _data(np.random.default_rng(3), 16)
    jm.pretrain(JaxDataSet(x, y))
    pm.pretrain(DataSet(x, y))
    for a, b in zip(jax.tree.leaves(params_to_numpy(pm)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jm.params))):
        _close(a, b, "after pretrain()")
    with pytest.raises(ValueError, match="not pretrainable"):
        pm.pretrain_layer(0, NumpyDataSetIterator(x, y, 16))


@pytest.mark.parametrize("name", ["vae", "ae"])
def test_graph_pretrain_layer_matches_jax(name):
    conf = _graph_conf()
    jm = JaxGraph(JaxGraphConf.from_json(conf.to_json())).init()
    pm = GraphModel(GraphConfiguration.from_json(jm.conf.to_json()), device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jm.params), pm)
    r = np.random.default_rng(4)
    batches = [((r.random((8, 6)).astype(np.float32), r.random((8, 4)).astype(np.float32)),
                (np.eye(2, dtype=np.float32)[r.integers(0, 2, 8)],)) for _ in range(4)]
    from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMDS
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet

    jloss = jm.pretrain_layer(name, [JaxMDS(f, l) for f, l in batches], epochs=2)
    ploss = pm.pretrain_layer(name, [MultiDataSet(f, l) for f, l in batches], epochs=2)
    _close(ploss, jloss, "last pretrain loss")
    for a, b in zip(jax.tree.leaves(params_to_numpy(pm)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jm.params))):
        _close(a, b, "after pretraining")
    with pytest.raises(ValueError, match="not pretrainable"):
        pm.pretrain_layer("da", [MultiDataSet(f, l) for f, l in batches])
    with pytest.raises(KeyError):
        pm.pretrain_layer("nope", [])
