"""The port's process world (`deeplearning4j_tpu_torch.runtime.
distributed`): `DistributedConfig`, the rank-strided iterator (the cases
of `tests/test_distributed.py:291-413`, no spawn), a two-rank DP run
against the JAX package's mesh of 2 (the counterpart of
`tests/test_distributed.py:145-185`), `write_model_distributed`, and a
failing or hanging rank failing the whole world with no process left."""

import multiprocessing
import os
import sys
import time

import numpy as np
import pytest

import jax

import torch_dp_ranks as ranks
from deeplearning4j_tpu.data import DataSet
from deeplearning4j_tpu.parallel import ParallelConfig, distribute
from deeplearning4j_tpu.train.checkpoint import ModelSerializer as JaxMS
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.data.iterator import DataSetIterator, ExistingDataSetIterator
from deeplearning4j_tpu_torch.runtime import distributed
from deeplearning4j_tpu_torch.runtime.distributed import (
    DistributedConfig,
    DistributedDataSetIterator,
)
from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import elastic_worker as ew  # noqa: E402


def test_config_from_env(monkeypatch):
    monkeypatch.setenv("DL4JTPU_COORDINATOR", "127.0.0.1:1234")
    monkeypatch.setenv("DL4JTPU_NUM_PROCESSES", "4")
    monkeypatch.setenv("DL4JTPU_PROCESS_ID", "2")
    monkeypatch.setenv("DL4JTPU_PLATFORM", "cpu")
    assert DistributedConfig.from_env() == DistributedConfig(
        coordinator_address="127.0.0.1:1234", num_processes=4, process_id=2,
        platform="cpu")


def test_a_configured_world_never_drops_to_one_rank():
    with pytest.raises(ValueError, match="coordinator address"):
        distributed.initialize(DistributedConfig(num_processes=2, process_id=0,
                                                 platform="cpu"))
    assert not distributed.is_initialized()
    assert distributed.process_count() == 1 and distributed.is_chief()


def test_mesh_over_the_world_and_the_active_scope():
    from deeplearning4j_tpu_torch.runtime import mesh

    m = mesh.make_mesh(mesh.MeshSpec.of(data=-1, model=1), devices=range(4))
    assert m.shape == {"data": 4, "model": 1} and m.devices == (0, 1, 2, 3)
    assert mesh.make_mesh().shape == {"data": 1}          # no world: one rank
    # several axes larger than 1 lie row-major over the ranks (JAX's layout)
    m2 = mesh.make_mesh(mesh.MeshSpec.of(data=2, model=2), devices=range(4))
    assert m2.shape == {"data": 2, "model": 2}
    assert [tuple(m2.coords(r).values()) for r in range(4)] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert m2.line(3, ("data",)) == (1, 3) and m2.line(3, ("model",)) == (2, 3)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.make_mesh(mesh.MeshSpec.of(data=-1, pipe=3), devices=range(4))
    assert mesh.axis_size("data") == 1 and mesh.active_mesh() is None
    with mesh.active_mesh_scope(m):
        assert mesh.active_mesh() is m and mesh.axis_size("data") == 4
    assert mesh.active_mesh() is None
    assert mesh.single_device_mesh().shape == {"data": 1}


def test_zero_slices_and_the_zero2_wrapper():
    import torch

    from deeplearning4j_tpu_torch.parallel import zero as zmod
    from deeplearning4j_tpu_torch.parallel.strategy import shard_zero1, zero1_specs

    tree = {"W": torch.arange(24.).reshape(4, 6), "b": torch.arange(3.)}
    assert zero1_specs(tree, 2) == {"W": 1, "b": None}
    sl = shard_zero1(tree, 1, 2)
    assert torch.equal(sl["W"], tree["W"][:, 3:]) and torch.equal(sl["b"], tree["b"])
    leaves = [tree["W"], tree["b"]]
    wrapped = zmod.wrap_opt_state(leaves, (0, leaves))
    assert zmod.is_wrapped(wrapped) and zmod.wrap_opt_state(leaves, wrapped) is wrapped
    assert [a.shape for a in zmod.unwrap_opt_state(wrapped)[1]] == [(4, 6), (3,)]
    assert zmod.wrap_like(wrapped, (0, leaves), leaves)["opt"] == (0, leaves)
    assert zmod.wrap_like((0,), wrapped, leaves) == (0, leaves)
    micro = zmod.split_accum_microbatches((tree["W"], None), 2)
    assert [m[0].shape[0] for m in micro] == [2, 2] and micro[1][1] is None
    with pytest.raises(ValueError, match="divisible by 3"):
        zmod.split_accum_microbatches((tree["W"],), 3)


# -- DistributedDataSetIterator ------------------------------------------------------

def _batches(n, rows=2):
    return [TDataSet(np.full((rows, 3), i, np.float32), np.zeros((rows, 1), np.float32))
            for i in range(n)]


def test_rank_strided_partition_is_disjoint_and_complete():
    seen = []
    for rank in range(3):
        it = DistributedDataSetIterator(ExistingDataSetIterator(_batches(10)),
                                        rank=rank, world_size=3)
        mine = [int(b.features[0, 0]) for b in it]
        # the ragged tail (batch 9) is dropped on every rank
        assert mine == list(range(rank, 9, 3))
        seen.extend(mine)
        it.reset()
        assert [int(b.features[0, 0]) for b in it] == mine
    assert sorted(seen) == list(range(9))


def test_is_a_dataset_iterator_and_fit_accepts_it():
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        NeuralNetConfiguration,
    )

    batches = [TDataSet(np.random.default_rng(i).normal(0, 1, (4, 3)).astype(np.float32),
                        np.eye(2, dtype=np.float32)[np.arange(4) % 2]) for i in range(4)]
    it = DistributedDataSetIterator(ExistingDataSetIterator(batches), rank=0, world_size=2)
    assert isinstance(it, DataSetIterator)
    conf = (NeuralNetConfiguration.builder().list().layer(Dense(n_out=4))
            .layer(OutputLayer(n_out=2)).set_input_type(InputType.feed_forward(3)).build())
    m = SequentialModel(conf, device="cpu").init()
    m.fit(it, epochs=2)
    assert m.iteration == 4


def test_bad_rank_rejected():
    with pytest.raises(ValueError, match="outside world"):
        DistributedDataSetIterator([], rank=3, world_size=2)


def test_list_inner_reiterates_and_generator_raises():
    batches = _batches(4, rows=1)
    li = DistributedDataSetIterator(batches, rank=0, world_size=2)
    assert len(list(li)) == 2
    li.reset()
    assert len(list(li)) == 2
    gen = DistributedDataSetIterator((b for b in batches), rank=0, world_size=2)
    next(iter(gen))
    gen.reset()
    with pytest.raises(NotImplementedError, match="one-shot"):
        list(gen)


# -- a world of two against the JAX mesh ----------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    jm = ew.build_model()
    batches = [ew.global_batch(s) for s in range(ew.FIXED_STEPS)]
    path = str(tmp_path_factory.mktemp("dist") / "dp.zip")
    res = distributed.spawn(ranks.two_process_dp, 2, jm.conf.to_json(), batches, path,
                            platform="cpu", timeout=300)
    return res, batches, path


def test_two_rank_dp_matches_the_jax_mesh_of_two(two_ranks):
    """Two ranks, each fed its rows, against one JAX process whose mesh of
    2 devices takes the global batch: within rtol 2e-5 / atol 2e-6."""
    res, batches, _ = two_ranks
    m = ew.build_model()
    distribute(m, ParallelConfig(data=2), devices=jax.devices()[:2])
    for x, y in batches:
        m.fit_batch(DataSet(x, y))
    for r in res:
        for lname, sub in m.params.items():
            for pname, v in sub.items():
                np.testing.assert_allclose(r["params"][f"{lname}.{pname}"], np.asarray(v),
                                           rtol=2e-5, atol=2e-6, err_msg=f"{lname}/{pname}")


def test_fetch_global_gathers_every_ranks_rows(two_ranks):
    res, batches, _ = two_ranks
    for r in res:
        np.testing.assert_array_equal(r["fetched"], batches[0][0])


def test_write_model_distributed(two_ranks):
    """Every rank takes part, the chief writes one zip, and it restores in
    both packages equal to rank 1's state."""
    res, _, path = two_ranks
    assert all(r["zip_seen"] for r in res)
    port = ModelSerializer.restore(path, device="cpu")
    assert port.iteration == res[1]["iteration"]
    for k, v in port.param_table().items():
        np.testing.assert_array_equal(v, res[1]["params"][k])
    jm = JaxMS.restore(path)
    for lname, sub in jm.params.items():
        for pname, v in sub.items():
            np.testing.assert_array_equal(np.asarray(v), res[1]["params"][f"{lname}.{pname}"])


def test_flat_buckets_through_one_collective(two_ranks):
    """`all_reduce_flat` sums each tensor in the bucket's dtype,
    `all_gather_flat` returns every rank's tensors in their shapes, and
    `broadcast_flat` copies the source rank's into every rank's."""
    res, _, _ = two_ranks
    for r in res:
        b = r["buckets"]
        assert all(str(d) == "torch.float32" for d, _ in b["summed"])
        np.testing.assert_array_equal(b["summed"][0][1], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(b["summed"][1][1], np.arange(4) * 3.0)
        np.testing.assert_array_equal(b["summed"][2][1], np.array(2.0))
        for j, part in enumerate(b["gathered"]):
            np.testing.assert_array_equal(part[0], np.full((2, 3), j + 1.0))
            np.testing.assert_array_equal(part[1], np.array(j + 0.5))
        np.testing.assert_array_equal(b["broadcast"][0], np.full(3, 1.0))
        np.testing.assert_array_equal(b["broadcast"][1], np.full((1, 2), 10.0))


def test_tree_leaves_and_unflatten_round_trip():
    """`tree_leaves` walks dicts (keys sorted), lists and tuples in order;
    `tree_unflatten` puts leaves back in the same places."""
    from deeplearning4j_tpu_torch.models.model import tree_leaves, tree_unflatten

    tree = {"b": [1, (2, 3)], "a": {"y": 4, "x": 5}}
    assert tree_leaves(tree) == [5, 4, 1, 2, 3]
    back = tree_unflatten(tree, [x * 10 for x in tree_leaves(tree)])
    assert back == {"a": {"x": 50, "y": 40}, "b": [10, (20, 30)]}


# -- a failing world --------------------------------------------------------------------

def test_a_rank_that_raises_fails_the_world_quickly():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        distributed.spawn(ranks.fail_on_rank_one, 2, platform="cpu", timeout=120)
    assert time.monotonic() - t0 < 60
    assert not multiprocessing.active_children()


def test_a_rank_that_hangs_fails_the_world_at_its_time_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        distributed.spawn(ranks.hang_on_rank_one, 2, platform="cpu", timeout=8)
    assert time.monotonic() - t0 < 40
    assert not multiprocessing.active_children()
