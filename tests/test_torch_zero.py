"""The port's ZeRO-1/2 (`deeplearning4j_tpu_torch.parallel.zero`) on a
world of 2 gloo CPU ranks: the cases of `tests/test_zero1.py` and
`tests/test_zero2.py`.  Each rank holds its slices of the optimizer
state; the update is the replicated one within the JAX tests' bars and
the JAX package's ZeRO-1 over a mesh of 2.  One spawned world runs every
case (`tests/torch_dp_ranks.py` `zero_world`)."""

import os

import numpy as np
import pytest

import jax

import torch_dp_ranks as ranks
from deeplearning4j_tpu.data import DataSet, NumpyDataSetIterator
from deeplearning4j_tpu.models import SequentialModel
from deeplearning4j_tpu.nn import Adam
from deeplearning4j_tpu.nn.activations import Activation
from deeplearning4j_tpu.nn.conf import Dense, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu.nn.losses import Loss
from deeplearning4j_tpu.parallel import ParallelConfig, distribute
from deeplearning4j_tpu.train.checkpoint import ModelSerializer as JaxMS
from deeplearning4j_tpu_torch.parallel.strategy import zero1_spec_for_leaf
from deeplearning4j_tpu_torch.runtime import distributed

N, IN = 2, 8
RTOL, ATOL = 2e-4, 2e-5


def two_class_data(n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, IN)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(axis=1) > 0).astype(int)]
    return x, y


def mlp_conf(seed=9, clip=None):
    b = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
         .activation(Activation.RELU))
    if clip is not None:
        b = b.gradient_clip(norm=clip)
    return (b.list().layer(Dense(n_out=32)).layer(Dense(n_out=32))
            .layer(OutputLayer(n_out=2, loss=Loss.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(IN)).build())


def epochs_of(x, y, batch, seed, epochs):
    it = NumpyDataSetIterator(x, y, batch_size=batch, seed=seed)
    return [[(np.asarray(b.features), np.asarray(b.labels)) for b in it]
            for _ in range(epochs)]


X, Y = two_class_data(256)
EPOCHS = epochs_of(X, Y, 64, 3, 2)


def jax_table(m) -> dict:
    return {f"{k}.{p}": np.asarray(m.params[k][p])
            for k in sorted(m.params) for p in sorted(m.params[k])}


def float_leaves(tree) -> list:
    return [np.asarray(a) for a in jax.tree.leaves(tree)
            if np.issubdtype(np.asarray(a).dtype, np.floating)]


def assert_tables(port, ref, rtol=RTOL, atol=ATOL):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def jax_zero1(tmp_path_factory):
    """JAX ZeRO-1 over a mesh of 2 after the first epoch, its zip, and the
    same model one batch later."""
    jz = SequentialModel(mlp_conf()).init()
    distribute(jz, ParallelConfig(data=N, zero=1), devices=jax.devices()[:N])
    for x, y in EPOCHS[0]:
        jz.fit_batch(DataSet(x, y))
    path = str(tmp_path_factory.mktemp("jaxzip") / "jax_zero1.zip")
    JaxMS.write_model(jz, path)
    opt = float_leaves(jz.opt_state)
    nxt = EPOCHS[1][0]
    jz.fit_batch(DataSet(*nxt))
    return {"path": path, "opt": opt, "iteration": jz.iteration - 1,
            "next": jax_table(jz), "next_loss": float(jz.score_value), "next_batch": nxt}


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_zero1):
    d = tmp_path_factory.mktemp("zero")
    case = {"conf": mlp_conf().to_json(), "epochs": EPOCHS,
            "clip_conf": mlp_conf(clip=0.05).to_json(),
            "zip_out": str(d / "zero1.zip"), "jax_zip": jax_zero1["path"],
            "next_batch": jax_zero1["next_batch"], "store_dir": str(d / "stores")}
    res = distributed.spawn(ranks.zero_world, N, case, platform="cpu", timeout=300)
    return res, case


# -- numerics -----------------------------------------------------------------------

def test_zero1_matches_replicated_and_the_jax_mesh(world):
    res, _ = world
    jz = SequentialModel(mlp_conf()).init()
    distribute(jz, ParallelConfig(data=N, zero=1), devices=jax.devices()[:N])
    for batches in EPOCHS:
        for b in batches:
            jz.fit_batch(DataSet(*b))
    for r in res:
        assert_tables(r["zero1"], r["zero0"])
        assert_tables(r["zero1"], jax_table(jz))
    for k, v in res[0]["zero1"].items():
        np.testing.assert_array_equal(res[1]["zero1"][k], v)


def test_zero2_matches_replicated(world):
    """JAX `test_zero2_matches_replicated_across_fit_evaluate`'s bar."""
    res, _ = world
    for r in res:
        assert_tables(r["zero2"], r["zero0"], rtol=0, atol=1e-6)
        assert r["wrapped_2"] and r["acc_zero_2"]


def test_grad_accum_microbatches_allclose(world):
    res, _ = world
    for r in res:
        assert_tables(r["accum2"], r["zero0"])
        assert any("zero2x2" in k for k in r["accum_keys"])
        assert "divisible by 3" in r["accum_indivisible"]


def test_clip_by_global_norm_over_slices_matches_unsharded(world):
    """The norm is the sum over every rank's slices: clipping (active at
    a norm of 0.05) gives the replicated update."""
    res, _ = world
    for r in res:
        assert_tables(r["clip1"], r["clip0"])
    assert not np.allclose(res[0]["clip0"]["layer0.W"], res[0]["zero0"]["layer0.W"])


# -- placement ----------------------------------------------------------------------

def test_each_ranks_shard_shapes_follow_the_largest_divisible_dim(world):
    res, _ = world
    shapes = [(IN, 32), (32,), (32, 32), (32,), (32, 2), (2,)]   # tree_leaves order
    want_dims = [zero1_spec_for_leaf(np.zeros(s), N) for s in shapes]
    assert want_dims == [1, 0, 0, 0, 0, 0]
    for r in res:
        assert r["dims_1"] == want_dims
        sliced = [tuple(d // N if i == dim else d for i, d in enumerate(s))
                  for s, dim in zip(shapes, want_dims)]
        assert r["shapes_1"] == sliced + sliced        # Adam's mu, then nu
        assert r["bytes_1"] < r["bytes_0"]
        assert r["bytes_1_after"] == r["bytes_1"]


def test_spec_rule():
    assert zero1_spec_for_leaf(np.zeros((5, 5, 1, 32)), 8) == 3
    assert zero1_spec_for_leaf(np.zeros((16, 4)), 8) == 0
    assert zero1_spec_for_leaf(np.zeros((2450, 500)), 8) is None
    assert zero1_spec_for_leaf(np.zeros(()), 8) is None


def test_program_keys_and_gauges(world):
    res, _ = world
    for r in res:
        assert any("zero1" in k for k in r["keys1"])
        assert not any("zero" in k for k in r["keys0"])
        assert any("zero2x1" in k for k in r["keys2"])
        assert r["bytes_gauge"] == r["bytes_1"]
        assert r["update_secs"] > 0 and r["update_counter"] > 0
        assert r["grad_bytes_2"] > 0


def test_redistribute_and_env_knob(world):
    res, _ = world
    for r in res:
        assert r["redist_placement"]
        assert r["redist_shapes"] == [(IN, 32), (32,), (32, 32), (32,), (32, 2), (2,)] * 2
        assert r["env_placement"] and r["env_override"]


def test_composition_errors_keep_the_jax_messages():
    from deeplearning4j_tpu_torch.parallel import ParallelConfig as TPC
    from deeplearning4j_tpu_torch.parallel import distribute as tdist

    m = ranks.seq_model(mlp_conf().to_json())
    with pytest.raises(ValueError, match="pure data parallelism"):
        tdist(m, TPC(zero=1, grad_compression="int8"))
    with pytest.raises(ValueError, match="zero stage"):
        tdist(m, TPC(zero=3))
    with pytest.raises(ValueError, match="zero=2"):
        tdist(m, TPC(zero=1, grad_accum=2))


# -- checkpoints and recovery ---------------------------------------------------------

def test_zero_zip_restores_in_the_jax_package(world):
    """`write_model_distributed` of a ZeRO-1 world: one zip, the whole
    optimizer state, restored by the JAX package bit for bit."""
    res, case = world
    restored = JaxMS.restore(case["zip_out"])
    for k, v in jax_table(restored).items():
        np.testing.assert_array_equal(v, res[1]["zero1"][k])
    opt = float_leaves(restored.opt_state)
    assert len(opt) == len(res[0]["zero1_opt_full"])
    for a, b in zip(opt, res[1]["zero1_opt_full"]):
        np.testing.assert_array_equal(a, b)


def test_jax_zip_restores_into_a_zero_world(world, jax_zero1):
    """A JAX ZeRO-1 zip restored into the port's ZeRO-1 world: each rank
    holds its slices of the saved state, and the next step is the JAX
    model's."""
    res, _ = world
    full = jax_zero1["opt"]
    for r, out in enumerate(res):
        assert out["restored_iteration"] == jax_zero1["iteration"]
        for i, (a, b) in enumerate(zip(out["restored_shards"], full)):
            dim = zero1_spec_for_leaf(b, N)
            c = b.shape[dim] // N
            np.testing.assert_array_equal(a, np.take(b, range(r * c, (r + 1) * c), axis=dim))
        assert_tables(out["restored_next"], jax_zero1["next"])
        np.testing.assert_allclose(out["restored_next_loss"], jax_zero1["next_loss"],
                                   rtol=RTOL, atol=ATOL)


def test_recovery_rolls_back_in_place_in_a_zero_world(world):
    """A NaN batch on every rank: every rank rolls back to its store's
    checkpoint, the ZeRO-2 state restored into its live slices (the
    same tensors, wrapped), and training goes on."""
    res, _ = world
    for r in res:
        assert r["rollbacks"] == 1
        assert r["in_place"] and r["still_wrapped"]
        for k, v in r["saved"].items():
            np.testing.assert_array_equal(r["after_rollback"][k], v)
        assert np.isfinite(r["rollback_next_loss"])
    assert res[0]["rollback_next_loss"] == res[1]["rollback_next_loss"]


@pytest.mark.parametrize("kind", ["stash", "view"])
def test_listener_alias_guard_covers_sharded_state(world, kind):
    res, _ = world
    for r in res:
        assert "holds the model's live" in r[f"guard_{kind}"]


def test_copying_listener_passes(world):
    res, _ = world
    for r in res:
        assert r["guard_copy"] is None
