"""The port's pipelined fit (``ParallelConfig(pipe=k)``, GPipe and 1F1B)
of the narrow flagship against the JAX package's pipelined fit and
against the port's undistributed model.

The sizes are `tests/test_pipeline_fit.py`'s (vocabulary 16, width 16,
2 heads, 4 blocks, batches of 8 x 8).  Worlds of 2 and 4 gloo ranks on
the CPU (`tests/torch_pp_ranks.py` `fit_world`) run every case once a
module; JAX runs on the conftest's virtual CPU devices under the same
`ParallelConfig`, fed the whole batch, from the same weights.  The
tolerances are JAX's own (`tests/test_pipeline_fit.py` `params_close`):
rtol 2e-4, atol 2e-5.
"""

import numpy as np
import pytest

import jax

import torch_pp_ranks as ranks
from deeplearning4j_tpu.data.dataset import DataSet
from deeplearning4j_tpu.parallel import ParallelConfig, distribute
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder
from deeplearning4j_tpu_torch.runtime import distributed

RTOL, ATOL = 2e-4, 2e-5
VOCAB, D, HEADS, LAYERS = 16, 16, 2, 4
BATCH, SEQ, STEPS = 8, 8, 3

CONFIGS = {
    "p2": dict(data=1, pipe=2, microbatches=4),
    "p2_1f1b": dict(data=1, pipe=2, microbatches=4, schedule="1f1b"),
    "p4": dict(data=1, pipe=4, microbatches=4),
    "p4_1f1b": dict(data=1, pipe=4, microbatches=4, schedule="1f1b"),
    "d2p2": dict(data=2, pipe=2, microbatches=4),
    "d2p2_1f1b": dict(data=2, pipe=2, microbatches=4, schedule="1f1b"),
}


def make_model():
    return TransformerEncoder(vocab_size=VOCAB, d_model=D, n_heads=HEADS,
                              n_layers=LAYERS, causal=True, seq_parallel="none",
                              seed=11, learning_rate=1e-2).init_model()


def lm_batches(n=STEPS):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, (BATCH, SEQ))
        y = np.eye(VOCAB, dtype=np.float32)[np.roll(ids, -1, axis=1)]
        out.append((ids.astype(np.float32), y))
    return out


BATCHES = lm_batches()


def jax_table(params, path=""):
    out = {}
    for k in sorted(params):
        p = f"{path}.{k}" if path else k
        if isinstance(params[k], dict):
            out.update(jax_table(params[k], p))
        else:
            out[p] = np.asarray(params[k])
    return out


def assert_tables(port, ref, rtol=RTOL, atol=ATOL):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=rtol, atol=atol, err_msg=k)


def jax_fit(cfg=None):
    m = make_model()
    if cfg is not None:
        n = cfg.get("data", 1) * cfg["pipe"]
        distribute(m, ParallelConfig(**cfg), devices=jax.devices()[:n])
    losses = []
    for x, y in BATCHES:
        m.fit_batch(DataSet(x, y))
        losses.append(float(m.score_value))
    return m, losses


@pytest.fixture(scope="module")
def init():
    m = make_model()
    return m.conf.to_json(), jax.tree.map(np.asarray, m.params)


def _case(init, tmp):
    return {"model": init, "configs": CONFIGS, "batches": BATCHES, "tmp": tmp,
            "zip": "d2p2", "refusals": ("p2", "p2_1f1b")}


@pytest.fixture(scope="module")
def world2(init, tmp_path_factory):
    return distributed.spawn(ranks.fit_world, 2,
                             _case(init, str(tmp_path_factory.mktemp("pp2"))),
                             platform="cpu", timeout=300)


@pytest.fixture(scope="module")
def world4(init, tmp_path_factory):
    return distributed.spawn(ranks.fit_world, 4,
                             _case(init, str(tmp_path_factory.mktemp("pp4"))),
                             platform="cpu", timeout=300)


@pytest.fixture(scope="module")
def undistributed(init):
    """The port's undistributed model trained on the same batches."""
    from torch_dp_ranks import seq_model

    m = seq_model(*init)
    losses = []
    for x, y in BATCHES:
        m.fit_batch(DataSet(x, y))
        losses.append(m.score_value)
    return m, losses


def _world(name, world2, world4):
    return world2 if name.startswith("p2") else world4


@pytest.mark.parametrize("name", ["p2", "p4", "d2p2"])
def test_gpipe_matches_the_jax_pipelined_fit(name, world2, world4):
    """JAX `tests/test_pipeline_fit.py:63`: the pipelined fit, each rank's
    whole parameter tree and losses against JAX's pipeline of the same
    mesh."""
    jm, losses = jax_fit(CONFIGS[name])
    for r in _world(name, world2, world4):
        np.testing.assert_allclose(r[f"{name}_losses"], losses, rtol=RTOL, atol=ATOL)
        assert_tables(r[name], jax_table(jax.tree.map(np.asarray, jm.params)))
        assert r[f"{name}_plan"] == (2, 2 + LAYERS, CONFIGS[name]["pipe"], 4)


@pytest.mark.parametrize("name", ["p2_1f1b", "p4_1f1b", "d2p2_1f1b"])
def test_1f1b_matches_the_jax_1f1b_fit(name, world2, world4):
    """JAX `tests/test_pipeline_fit.py:95`: the 1F1B step really ran
    (its own program) and trains as JAX's 1F1B does."""
    jm, losses = jax_fit(CONFIGS[name])
    assert ("train_1f1b",) in jm._step_fns
    for r in _world(name, world2, world4):
        assert "('train_1f1b',)" in r[f"{name}_programs"]
        np.testing.assert_allclose(r[f"{name}_losses"], losses, rtol=RTOL, atol=ATOL)
        assert_tables(r[name], jax_table(jax.tree.map(np.asarray, jm.params)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pipelined_fit_matches_the_undistributed_port(name, undistributed, world2, world4):
    """Every schedule and mesh trains as the port's undistributed model,
    and every rank's leaves are the same bits."""
    m, losses = undistributed
    want = {k: np.array(v) for k, v in m.param_table().items()}
    world = _world(name, world2, world4)
    for r in world:
        np.testing.assert_allclose(r[f"{name}_losses"], losses, rtol=RTOL, atol=ATOL)
        assert_tables(r[name], want)
    for r in world[1:]:
        for k, v in world[0][name].items():
            np.testing.assert_array_equal(r[name][k], v, err_msg=k)


@pytest.mark.parametrize("mesh", ["p2", "p4", "d2p2"])
def test_1f1b_matches_gpipe(mesh, world2, world4):
    """JAX `tests/test_pipeline_fit.py:123`: the two schedules are the
    same math."""
    for r in _world(mesh, world2, world4):
        np.testing.assert_allclose(r[f"{mesh}_1f1b_losses"], r[f"{mesh}_losses"],
                                   rtol=RTOL, atol=ATOL)
        assert_tables(r[f"{mesh}_1f1b"], r[mesh])
        assert "('train_1f1b',)" not in r[f"{mesh}_programs"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_output_after_pipelined_training(name, world2, world4):
    """JAX `tests/test_pipeline_fit.py:146`: ``output()`` through the
    pipelined segment equals the undistributed model's on the trained
    weights, on every rank."""
    from torch_dp_ranks import seq_model

    world = _world(name, world2, world4)
    plain = seq_model(make_model().conf.to_json())
    tree = {}
    for k, v in world[0][name].items():
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    plain.load_params(tree)
    want = plain.output(BATCHES[0][0]).numpy()
    for r in world:
        assert np.all(np.isfinite(r[f"{name}_out"]))
        np.testing.assert_allclose(r[f"{name}_out"], want, rtol=RTOL, atol=ATOL)


def test_zip_of_a_pipelined_model_restores_undistributed(world4):
    """``write_model`` of the data=2, pipe=2 model is the whole tree (the
    blocks are whole on every rank); it restores undistributed to the
    same parameters and outputs."""
    r0 = world4[0]
    assert sorted(r0["zip"]) == sorted(r0["d2p2"])
    for k, v in r0["d2p2"].items():
        np.testing.assert_array_equal(r0["zip"][k], v, err_msg=k)
    np.testing.assert_allclose(r0["zip_out"], r0["d2p2_out"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,what,message", [
    ("p2", "mask_output", "sequence masks are not supported through a pipelined segment"),
    ("p2", "mask_fit", "sequence masks are not supported through a pipelined segment"),
    ("p2_1f1b", "mask_output",
     "sequence masks are not supported through a pipelined segment"),
    ("p2_1f1b", "mask_fit", "masks are not supported through the 1f1b pipeline schedule"),
])
def test_masks_through_a_pipelined_segment_raise(name, what, message, world2):
    """The JAX package's refusals, with its messages: ``_forward``'s for
    ``output()`` and a GPipe fit, ``_run_step_1f1b``'s for a 1F1B fit."""
    for r in world2:
        assert r[f"{name}_{what}"] is not None
        assert message in r[f"{name}_{what}"]
