"""The port's mesh of several axes and its differentiable collectives
(`deeplearning4j_tpu_torch.runtime.mesh`,
`deeplearning4j_tpu_torch.parallel.collectives`).

A (data=2, model=2) mesh over a gloo world of four CPU ranks lays the
ranks out row-major, as JAX reshapes its device list
(`deeplearning4j_tpu/runtime/mesh.py` `make_mesh`); each collective's
forward and backward (the transposes of ``psum``, ``all_gather``,
``ppermute`` and ``all_to_all``) is held against its definition on
every rank.  The world runs once (`tests/torch_mp_ranks.py`
`mesh_world`); each rank's input is ``arange(6).reshape(2, 3) + 10 r``
and its loss ``(r + 1) * sum(y)``.
"""

import numpy as np
import pytest

import jax

import torch_mp_ranks as ranks
from deeplearning4j_tpu.runtime.mesh import MeshSpec as JMeshSpec
from deeplearning4j_tpu.runtime.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu_torch.runtime import distributed

COORDS = {0: (0, 0), 1: (0, 1), 2: (1, 0), 3: (1, 1)}     # (data, model)


def x_of(r):
    return np.arange(6.0, dtype=np.float32).reshape(2, 3) + 10 * r


def w_of(r):
    return float(r + 1)


def model_line(r):
    return [q for q in COORDS if COORDS[q][0] == COORDS[r][0]]


def data_line(r):
    return [q for q in COORDS if COORDS[q][1] == COORDS[r][1]]


@pytest.fixture(scope="module")
def world4():
    return distributed.spawn(ranks.mesh_world, 4, {}, platform="cpu", timeout=180)


def test_ranks_lie_row_major_as_jax_lays_devices(world4):
    jm = jmake_mesh(JMeshSpec.of(data=2, model=2), devices=jax.devices()[:4])
    ids = {d.id: i for i, d in enumerate(jax.devices()[:4])}
    for r, res in enumerate(world4):
        (di,), (mi,) = np.nonzero(np.vectorize(lambda d: ids[d.id])(jm.devices) == r)
        assert res["coords"] == {"data": int(di), "model": int(mi)}
        assert res["index"] == {"data": int(di), "model": int(mi), "seq": 0}


def test_each_axis_line_has_its_process_group(world4):
    for r, res in enumerate(world4):
        assert res["lines"] == {"data": data_line(r), "model": model_line(r)}
        assert res["seq_group"] is None                 # an absent axis
        assert res["size_rank"] == (2, COORDS[r][1], 4)


def test_copy_to_is_identity_with_an_all_reduced_gradient(world4):
    for r, res in enumerate(world4):
        y, g = res["copy_to"]
        np.testing.assert_array_equal(y, x_of(r))
        np.testing.assert_array_equal(g, np.full((2, 3), sum(w_of(q) for q in model_line(r))))


def test_reduce_from_sums_with_an_identity_gradient(world4):
    for r, res in enumerate(world4):
        y, g = res["reduce_from"]
        np.testing.assert_array_equal(y, sum(x_of(q) for q in model_line(r)))
        np.testing.assert_array_equal(g, np.full((2, 3), w_of(r)))


def test_all_reduce_sum_sums_both_ways(world4):
    for r, res in enumerate(world4):
        y, g = res["all_reduce_sum"]
        np.testing.assert_array_equal(y, sum(x_of(q) for q in data_line(r)))
        np.testing.assert_array_equal(g, np.full((2, 3), sum(w_of(q) for q in data_line(r))))


@pytest.mark.parametrize("grad", ["slice", "sum"])
def test_gather_concatenates_and_returns_the_ranks_slice(grad, world4):
    for r, res in enumerate(world4):
        y, g = res[f"gather_{grad}"]
        np.testing.assert_array_equal(y, np.concatenate([x_of(q) for q in model_line(r)], 1))
        want = w_of(r) if grad == "slice" else sum(w_of(q) for q in model_line(r))
        np.testing.assert_array_equal(g, np.full((2, 3), want))


def test_block_is_the_ranks_slice(world4):
    for r, res in enumerate(world4):
        y, g = res["block"]
        c = COORDS[r][0]
        np.testing.assert_array_equal(y, x_of(r)[:, c:c + 1])
        want = np.zeros((2, 3), np.float32)
        want[:, c] = w_of(r)
        np.testing.assert_array_equal(g, want)


def test_ppermute_rotates_and_its_gradient_rotates_back(world4):
    for r, res in enumerate(world4):
        line = data_line(r)
        i = line.index(r)
        y, g = res["ppermute"]
        np.testing.assert_array_equal(y, x_of(line[(i - 1) % 2]))
        np.testing.assert_array_equal(g, np.full((2, 3), w_of(line[(i + 1) % 2])))


def test_all_to_all_swaps_blocks_and_back(world4):
    for r, res in enumerate(world4):
        line = model_line(r)
        j = line.index(r)
        y, g = res["all_to_all"]
        np.testing.assert_array_equal(y, np.concatenate([x_of(q)[j:j + 1] for q in line], 1))
        want = np.stack([np.full(3, w_of(q)) for q in line])
        np.testing.assert_array_equal(g, want)


def test_a_sum_over_two_axes_and_the_identity_without_a_mesh(world4):
    for r, res in enumerate(world4):
        np.testing.assert_array_equal(res["world_sum"], sum(x_of(q) for q in COORDS))
        np.testing.assert_array_equal(res["no_mesh"], x_of(r))


def test_a_mesh_on_a_world_of_one():
    (res,) = distributed.spawn(ranks.mesh_world_of_one, 1, {}, platform="cpu", timeout=120)
    assert res == {"shape": {"data": 1, "model": 1, "seq": 1}, "group": None, "index": 0}
