"""The port's pipeline beside the model and expert axes, against the JAX
package's pipeline on the same mesh, and its refusal beside the seq axis.

Worlds of 4 gloo ranks (`tests/torch_pp_ranks.py` `fit_world`):
``data=1, pipe=2, model=2`` on the narrow flagship of
`tests/test_pipeline_fit.py` (the embedding split by columns, the
chunked head by vocabulary, the blocks whole), and ``data=1, pipe=2,
expert=2`` on a stack whose MoE layer follows the blocks; GPipe and 1F1B
each, 3 steps, within JAX's rtol 2e-4 / atol 2e-5.  Under 1F1B the
layers after the segment run a microbatch at a time and their
auxiliary loss is dropped, in both packages, so a MoE layer there
routes each microbatch alone.
"""

import numpy as np
import pytest

import jax

import torch_pp_ranks as ranks
from deeplearning4j_tpu.data.dataset import DataSet
from deeplearning4j_tpu.models import SequentialModel
from deeplearning4j_tpu.nn import Adam
from deeplearning4j_tpu.nn.conf import (
    Embedding,
    InputType,
    MoELayer,
    NeuralNetConfiguration,
    RnnOutputLayer,
)
from deeplearning4j_tpu.nn.conf.attention import PositionalEncoding, TransformerEncoderBlock
from deeplearning4j_tpu.nn.losses import Loss
from deeplearning4j_tpu.parallel import ParallelConfig, distribute
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder
from deeplearning4j_tpu_torch.runtime import distributed
from test_torch_pipeline_fit import BATCHES, assert_tables, jax_table

RTOL, ATOL = 2e-4, 2e-5
CONFIGS = {
    "pm": dict(data=1, pipe=2, model=2, microbatches=4),
    "pm_1f1b": dict(data=1, pipe=2, model=2, microbatches=4, schedule="1f1b"),
    "pe": dict(data=1, pipe=2, expert=2, microbatches=4),
    "pe_1f1b": dict(data=1, pipe=2, expert=2, microbatches=4, schedule="1f1b"),
}


def flagship():
    # Adam at 1e-3: at 1e-2 it turns the summation-order noise of a
    # near-zero gradient element (the vocabulary shards' chunks) into a
    # rate-sized step, past 2e-4 in 3 steps (as the tensor-parallel LM
    # parity tests step at 1e-3)
    return TransformerEncoder(vocab_size=16, d_model=16, n_heads=2, n_layers=4,
                              causal=True, seed=11, learning_rate=1e-3).conf()


def moe_stack():
    """Four blocks, then a MoE layer of 2 experts, then the head."""
    b = (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-2)).list()
         .layer(Embedding(n_in=16, n_out=16)).layer(PositionalEncoding()))
    for _ in range(4):
        b = b.layer(TransformerEncoderBlock(d_model=16, n_heads=2, causal=True))
    b = b.layer(MoELayer(n_out=16, n_experts=2, top_k=1))
    return b.layer(RnnOutputLayer(n_out=16, loss=Loss.MCXENT)).set_input_type(
        InputType.recurrent(1)).build()


def conf_of(name):
    return flagship() if name.startswith("pm") else moe_stack()


def jax_fit(name):
    m = SequentialModel(conf_of(name)).init()
    distribute(m, ParallelConfig(**CONFIGS[name]), devices=jax.devices()[:4])
    losses = []
    for x, y in BATCHES:
        m.fit_batch(DataSet(x, y))
        losses.append(float(m.score_value))
    return m, losses


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = {}
    for prefix in ("pm", "pe"):
        m = SequentialModel(conf_of(prefix)).init()
        case = {"model": (m.conf.to_json(), jax.tree.map(np.asarray, m.params)),
                "configs": {k: v for k, v in CONFIGS.items() if k.startswith(prefix)},
                "batches": BATCHES, "tmp": str(tmp_path_factory.mktemp(prefix))}
        for i, r in enumerate(distributed.spawn(ranks.fit_world, 4, case,
                                                platform="cpu", timeout=300)):
            out.setdefault(i, {}).update(r)
    return [out[i] for i in range(4)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pipeline_beside_another_axis_matches_jax(name, world):
    jm, losses = jax_fit(name)
    want = jax_table(jax.tree.map(np.asarray, jm.params))
    for r in world:
        np.testing.assert_allclose(r[f"{name}_losses"], losses, rtol=RTOL, atol=ATOL)
        assert_tables(r[name], want)
        assert r[f"{name}_plan"][:3] == (2, 6, 2)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_replicated_leaves_are_bit_identical(name, world):
    """Every leaf whole on a rank (the gathered tree) is the same bits on
    every rank."""
    for r in world[1:]:
        for k, v in world[0][name].items():
            np.testing.assert_array_equal(r[name][k], v, err_msg=k)


def test_pipe_beside_seq_raises_before_a_world_forms():
    """ROADMAP C29: the JAX package's distribute takes pipe=2, seq=2, but
    its step fails (a shard_map nested in the pipe's manual region); the
    port refuses it up front, with the reason."""
    from torch_dp_ranks import seq_model
    from deeplearning4j_tpu_torch.parallel import ParallelConfig as TPC
    from deeplearning4j_tpu_torch.parallel import distribute as tdist

    m = seq_model(TransformerEncoder(vocab_size=16, d_model=16, n_heads=2, n_layers=4,
                                     causal=True, seq_parallel="ulysses",
                                     seed=11).conf().to_json())
    with pytest.raises(NotImplementedError, match="ROADMAP C29"):
        tdist(m, TPC(pipe=2, seq=2))
    assert not distributed.is_initialized()
    jm = TransformerEncoder(vocab_size=16, d_model=16, n_heads=2, n_layers=4, causal=True,
                            seq_parallel="ulysses", seed=11).init_model()
    distribute(jm, ParallelConfig(data=1, pipe=2, seq=2), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="mesh"):
        jm.fit_batch(DataSet(*BATCHES[0]))
