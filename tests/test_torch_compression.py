"""The port's int8 compressed gradients (`deeplearning4j_tpu_torch.
parallel.compression`) on a world of 4 gloo CPU ranks: the cases of
`tests/test_compression.py`, with `quantized_psum` held against the JAX
package's on the same inputs and keys.  One spawned world runs every
case (`tests/torch_dp_ranks.py` `compression_world`)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import torch_dp_ranks as ranks
from deeplearning4j_tpu.data import DataSet
from deeplearning4j_tpu.models import SequentialModel
from deeplearning4j_tpu.nn import Sgd
from deeplearning4j_tpu.nn.activations import Activation
from deeplearning4j_tpu.nn.conf import (
    LSTM,
    Dense,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu.nn.losses import Loss
from deeplearning4j_tpu.parallel import ParallelConfig, distribute
from deeplearning4j_tpu.parallel.compression import quantized_psum
from deeplearning4j_tpu.runtime.mesh import MeshSpec, make_mesh, shard_map
from deeplearning4j_tpu_torch.runtime import distributed

N = 4
REPS = 200


def model_conf(seed=9):
    return (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(0.1)).list()
            .layer(Dense(n_out=16, activation=Activation.TANH))
            .layer(OutputLayer(n_out=2, loss=Loss.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(4)).build())


def tbptt_conf():
    return (NeuralNetConfiguration.builder().seed(5).updater(Sgd(0.1)).list()
            .layer(LSTM(n_out=4, activation=Activation.TANH))
            .layer(RnnOutputLayer(n_out=2, loss=Loss.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.recurrent(3)).tbptt(4).build())


def data(n=256):
    rng = np.random.default_rng(4)
    cls = rng.integers(0, 2, n)
    x = rng.normal(0, 0.5, (n, 4)).astype(np.float32) + cls[:, None]
    return x, np.eye(2, dtype=np.float32)[cls]


X, Y = data()
# JAX `fit(ds, epochs=10, batch_size=64)`: the dataset's batches in order
EPOCHS = [[(X[i:i + 64], Y[i:i + 64]) for i in range(0, 256, 64)]] * 10
SHARDS = np.random.default_rng(0).normal(0, 1, (N, 64)).astype(np.float32)
UNBIASED = np.random.default_rng(1).normal(0, 1, (N, 32)).astype(np.float32)
RESID = np.random.default_rng(2).normal(0, 1, (N, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(MeshSpec.of(data=N), jax.devices()[:N])


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(3)
    case = {"psum_shards": SHARDS, "unbiased_shards": UNBIASED, "unbiased_reps": REPS,
            "resid_shards": RESID, "conf": model_conf().to_json(), "epochs": EPOCHS,
            "learn_epochs": EPOCHS * 3, "eval": (X, Y), "tbptt_conf": tbptt_conf().to_json(),
            "tbptt_batch": (rng.normal(size=(8, 8, 3)).astype(np.float32),
                            np.eye(2, dtype=np.float32)[rng.integers(0, 2, (8, 8))])}
    return distributed.spawn(ranks.compression_world, N, case, platform="cpu",
                             timeout=300)


def jax_psum_mean(mesh, shards, key_seed=0):
    f = jax.jit(shard_map(
        lambda x: quantized_psum(x[0], axis="data", key=jax.random.key(key_seed))[0][None],
        mesh=mesh, in_specs=P("data"), out_specs=P("data"), check_vma=False))
    return np.asarray(f(jnp.asarray(shards)))


def test_quantized_psum_is_the_jax_packages(world, mesh):
    """The same inputs and key: the port's mean is the JAX package's, on
    every rank, and approximates the exact mean."""
    ref = jax_psum_mean(mesh, SHARDS)
    for r, out in enumerate(world):
        np.testing.assert_array_equal(out["psum"], ref[r])
        np.testing.assert_array_equal(out["psum"], world[0]["psum"])
    tol = np.abs(SHARDS).max() / 127.0 * 1.5
    np.testing.assert_allclose(world[0]["psum"], SHARDS.mean(axis=0), atol=tol)


def test_quantization_unbiased(world):
    for out in world:
        np.testing.assert_allclose(out["unbiased"], UNBIASED.mean(axis=0), atol=2e-3)


def test_error_feedback_residual_bounded(world):
    scale = np.abs(RESID).max() / 127.0
    for r, out in enumerate(world):
        assert np.abs(out["resid"]).max() <= scale + 1e-6
        # the residual is what this rank's quantization dropped
        np.testing.assert_array_equal(out["resid_synced"], world[0]["resid_synced"])


def test_compressed_fit_tracks_exact_and_learns(world):
    """JAX `test_compressed_tracks_exact` (:167-182, 10 epochs) and
    `test_compressed_fit_learns` (30 epochs)."""
    for out in world:
        assert out["comp_mode"] == "int8"
        assert abs(out["exact_score"] - out["comp_score"]) < 0.05
        assert out["comp_acc"] > 0.95
        assert np.all(np.isfinite(out["comp_losses"]))
    for k, v in world[0]["comp_params"].items():
        np.testing.assert_array_equal(world[1]["comp_params"][k], v)


def test_compressed_steps_against_the_jax_compressed_step(world):
    """The JAX shard_map step (per-rank dropout keys, int8 exchange with
    error feedback, pmean'd loss) over 3 steps on a mesh of 4."""
    jm = SequentialModel(model_conf()).init()
    distribute(jm, ParallelConfig(data=N, grad_compression="int8"),
               devices=jax.devices()[:N])
    losses = []
    for x, y in EPOCHS[0][:3]:
        jm.fit_batch(DataSet(x, y))
        losses.append(float(jm.score_value))
    for out in world:
        np.testing.assert_allclose(out["first_losses"], losses, rtol=1e-5, atol=1e-6)
        for k in sorted(jm.params):
            for p in sorted(jm.params[k]):
                np.testing.assert_allclose(out["first_params"][f"{k}.{p}"],
                                           np.asarray(jm.params[k][p]),
                                           rtol=2e-4, atol=2e-5)


def test_redistribute_clears_compression(world):
    for out in world:
        assert out["cleared"]
        assert np.isfinite(out["cleared_score"])


def test_tbptt_refuses_compression_with_the_jax_message(world):
    for out in world:
        assert "does not compose with TBPTT" in out["tbptt_refusal"]
