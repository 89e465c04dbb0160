"""The port's sequence parallelism (``ParallelConfig(seq=s)``): ring and
Ulysses attention, and models trained on time blocks, against the JAX
package.

The attention ops run on each rank's time block of one gloo world and
are held against JAX's ``ring_attention`` / ``ulysses_attention`` under
``shard_map`` over the same number of virtual CPU devices (causal,
masked, gradients: `tests/test_attention.py:44-104`).  Models train under
the same `ParallelConfig` in a port world and a JAX mesh from the same
weights (`tests/torch_mp_ranks.py` `sp_world`), within
`tests/test_parallel.py`'s rtol 2e-4 / atol 2e-5.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import torch_mp_ranks as ranks
from deeplearning4j_tpu.data import DataSet
from deeplearning4j_tpu.models import SequentialModel
from deeplearning4j_tpu.nn import Adam
from deeplearning4j_tpu.nn.activations import Activation
from deeplearning4j_tpu.nn.conf import (
    LSTM,
    InputType,
    LastTimeStep,
    NeuralNetConfiguration,
    OutputLayer,
)
from deeplearning4j_tpu.nn.conf.attention import TransformerEncoderBlock
from deeplearning4j_tpu.nn.losses import Loss
from deeplearning4j_tpu.ops.attention import ring_attention, ulysses_attention
from deeplearning4j_tpu.parallel import ParallelConfig, distribute
from deeplearning4j_tpu.runtime.mesh import MeshSpec, make_mesh, shard_map
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder
from deeplearning4j_tpu_torch.runtime import distributed

RTOL, ATOL = 2e-4, 2e-5
B, T, H, D = 2, 32, 4, 8


def qkv(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))


def key_mask(lengths):
    return (np.arange(T)[None, :] < np.array(lengths)[:, None]).astype(np.float32)


OPS = {
    "ring": ("ring", *qkv(0), None, False),
    "ring_causal": ("ring", *qkv(1), None, True),
    "ring_masked": ("ring", *qkv(2), key_mask([20, 9]), False),
    "ulysses": ("ulysses", *qkv(3), None, False),
    "ulysses_causal": ("ulysses", *qkv(4), None, True),
    "ulysses_masked": ("ulysses", *qkv(5), key_mask([16, 28]), False),
}


def jax_op(kind, q, k, v, mask, causal, n):
    """JAX's op under shard_map over n devices: output and the gradients
    of sum(out ** 2)."""
    mesh = make_mesh(MeshSpec.of(seq=n), devices=jax.devices()[:n])
    core = ring_attention if kind == "ring" else ulysses_attention
    specs = (P(None, "seq"),) * (3 if mask is None else 4)
    fn = functools.partial(core, axis="seq", causal=causal)
    if mask is None:
        body = fn
    else:
        body = lambda q, k, v, m: fn(q, k, v, mask=m)
    op = jax.jit(shard_map(body, mesh=mesh, in_specs=specs, out_specs=P(None, "seq"),
                           check_vma=False))
    extra = () if mask is None else (jnp.asarray(mask),)

    def loss(q, k, v):
        return jnp.sum(op(q, k, v, *extra) ** 2)

    out = op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *extra)
    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def lm(seq_parallel, dropout=None, chunked=False):
    conf = TransformerEncoder(vocab_size=32, d_model=32, n_heads=4, n_layers=2,
                              seq_parallel=seq_parallel, learning_rate=1e-3, seed=4,
                              chunked_vocab_loss=chunked, vocab_chunk=16).conf()
    if dropout:
        conf = dataclasses.replace(conf, layers=tuple(
            dataclasses.replace(l, dropout_rate=dropout)
            if isinstance(l, TransformerEncoderBlock) else l for l in conf.layers))
    return conf


def lstm_conf():
    return (NeuralNetConfiguration.builder().seed(8).updater(Adam(1e-2)).list()
            .layer(LSTM(n_out=8, activation=Activation.TANH))
            .layer(LastTimeStep())
            .layer(OutputLayer(n_out=2, loss=Loss.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.recurrent(4)).build())


def lm_batches(n=2, b=4, t=16, vocab=32, seed=0, one_hot=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, t))
        nxt = np.roll(ids, -1, axis=1)
        y = np.eye(vocab, dtype=np.float32)[nxt] if one_hot else nxt.astype(np.float32)
        out.append((ids.astype(np.float32), y))
    return out


def lstm_batches():
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(8, 8, 4)).astype(np.float32),
             np.eye(2, dtype=np.float32)[(np.arange(8) + i) % 2]) for i in range(2)]


LM = lm_batches()
LM_IDS = lm_batches(one_hot=False, seed=1)
LSTM_B = lstm_batches()
CASES = {
    # name: (conf, ParallelConfig, batches)
    "tf_ring": (lm("ring"), dict(data=1, seq=2), LM),
    "tf_ulysses": (lm("ulysses"), dict(data=1, seq=2), LM),
    "tf_ulysses_dp": (lm("ulysses", dropout=0.1), dict(data=2, seq=2), LM),
    "tf_ring_chunked_dp": (lm("ring", chunked=True), dict(data=2, seq=2), LM_IDS),
    "lstm": (lstm_conf(), dict(data=2, seq=2), LSTM_B),
}


def jax_trained(conf, cfg, batches):
    m = SequentialModel(conf).init()
    params = jax.tree.map(np.asarray, m.params)
    n = int(np.prod(list(cfg.values())))
    distribute(m, ParallelConfig(**cfg), devices=jax.devices()[:n])
    losses = []
    for x, y in batches:
        m.fit_batch(DataSet(x, y))
        losses.append(float(m.score_value))
    return m, losses, params


@pytest.fixture(scope="module")
def refs():
    return {name: jax_trained(*c) for name, c in CASES.items()}


def _case(refs):
    return {"ops": OPS, "seq": {
        name: (conf.to_json(), refs[name][2], cfg, batches, batches[0][0])
        for name, (conf, cfg, batches) in CASES.items()}}


@pytest.fixture(scope="module")
def world2(refs):
    return distributed.spawn(ranks.sp_world, 2, _case(refs), platform="cpu", timeout=300)


@pytest.fixture(scope="module")
def world4(refs):
    case = _case(refs)
    del case["ops"]
    return distributed.spawn(ranks.sp_world, 4, case, platform="cpu", timeout=300)


def jax_table(params, path=""):
    out = {}
    for k in sorted(params):
        p = f"{path}.{k}" if path else k
        if isinstance(params[k], dict):
            out.update(jax_table(params[k], p))
        else:
            out[p] = np.asarray(params[k])
    return out


# -- the attention ops ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(OPS))
def test_attention_op_matches_jax_under_shard_map(name, world2):
    """Outputs and the gradients of q, k and v: the port's ranks' time
    blocks concatenated against JAX's op over two devices."""
    want = jax_op(*OPS[name], 2)
    got = [np.concatenate([r["ops"][name][i] for r in world2], axis=1)
           for i in range(4)]
    for g, w, what in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=what)


def test_ring_gradients_match_dense_attention(world2):
    """JAX `test_ring_gradients_match_dense`: the causal ring's gradients
    against dense attention's, in the JAX test's tolerance."""
    from deeplearning4j_tpu.ops.attention import mha

    q, k, v = (jnp.asarray(a) for a in OPS["ring_causal"][1:4])
    gd = jax.grad(lambda q, k, v: jnp.sum(mha(q, k, v, causal=True) ** 2),
                  argnums=(0, 1, 2))(q, k, v)
    for i, g in enumerate(gd):
        got = np.concatenate([r["ops"]["ring_causal"][i + 1] for r in world2], axis=1)
        np.testing.assert_allclose(got, np.asarray(g), rtol=5e-3, atol=5e-4)


def test_ulysses_refuses_heads_the_axis_does_not_divide():
    import torch

    from deeplearning4j_tpu_torch.nn.conf.attention import _attend
    from deeplearning4j_tpu_torch.runtime.mesh import Mesh, active_mesh_scope

    q = torch.zeros((1, 4, 3, 2))
    with active_mesh_scope(Mesh(("data",), (1,), (0,))):
        # no seq axis: the dense core, whatever the mode
        assert _attend(q, q, q, causal=False, mask=None,
                       seq_parallel="ulysses").shape == q.shape
    with pytest.raises(ValueError, match="seq_parallel='bogus'"):
        _attend(q, q, q, causal=False, mask=None, seq_parallel="bogus")


# -- models on time blocks ----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_training_on_time_blocks_matches_jax(name, refs, world2, world4):
    """The transformer with ring or Ulysses attention (dropout drawing
    the rank's block of the global mask), a vocabulary head on per-step
    labels cut to the block, and JAX `tests/test_parallel.py:256`'s
    LSTM + LastTimeStep (the recurrent layer on the gathered sequence,
    seq-to-one labels whole), trained against JAX's mesh."""
    jm, losses, _ = refs[name]
    cfg = CASES[name][1]
    world = world4 if cfg["data"] == 2 else world2
    for r in world:
        np.testing.assert_allclose(r[f"{name}_losses"], losses, rtol=RTOL, atol=ATOL)
        got, want = r[name], jax_table(jax.tree.map(np.asarray, jm.params))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_output_of_a_sequence_parallel_model(name, refs, world2, world4):
    """``output()`` answers for the whole sequence on every rank, equal
    to JAX's trained model's."""
    jm = refs[name][0]
    cfg = CASES[name][1]
    world = world4 if cfg["data"] == 2 else world2
    want = np.asarray(jm.output(CASES[name][2][0][0]))
    for r in world:
        np.testing.assert_allclose(r[f"{name}_out"], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_feed_forward_of_a_sequence_parallel_model(name, world2, world4):
    """``feed_forward`` answers for the whole sequence too: every layer's
    activation on every rank equals the same weights' undistributed
    model's, time blocks gathered."""
    world = world4 if CASES[name][1]["data"] == 2 else world2
    for r in world:
        got, want = r[f"{name}_ff"], r[f"{name}_ff_whole"]
        assert [g.shape for g in got] == [w.shape for w in want]
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"layer {i}")


def test_score_of_a_sequence_parallel_model(refs, world2):
    jm = refs["tf_ring"][0]
    x, y = LM[0]
    want = float(jm.score(DataSet(x, y)))
    for r in world2:
        assert r["tf_ring_score"] == pytest.approx(want, rel=RTOL, abs=ATOL)


def test_positional_rows_follow_global_positions():
    """A rank holding time block r adds the rows of its global positions
    (JAX `PositionalEncoding` adds ``P[:t]`` of the global array)."""
    import torch

    from deeplearning4j_tpu_torch.nn.conf.attention import PositionalEncoding
    from deeplearning4j_tpu_torch.parallel import context

    x = torch.zeros((1, 8, 6))
    whole = PositionalEncoding().apply({}, {}, x)[0]
    for r in range(2):
        with context.time_sharded(r, 2):
            part = PositionalEncoding().apply({}, {}, x[:, :4])[0]
        torch.testing.assert_close(part, whole[:, 4 * r:4 * r + 4], rtol=0, atol=0)
    table = {"P": torch.arange(80.0).reshape(10, 8)}
    with context.time_sharded(1, 2):
        part = PositionalEncoding(learned=True, max_length=10).apply(
            table, {}, torch.zeros((1, 4, 8)))[0]
    torch.testing.assert_close(part[0], table["P"][4:8])
