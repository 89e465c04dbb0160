"""The port's pipeline primitives (`parallel/pipeline.py`) against the
JAX package's.

- `pipeline_apply` (GPipe) and `pipeline_train_1f1b` on
  `tests/test_pipeline_1f1b.py`'s toy stage (stage s: tanh(h @ W_s)) at
  pipe 2 and 4: outputs, the mean loss, the stage gradients and dx
  against JAX's ``shard_map`` over as many virtual CPU devices, within
  1e-5 (worlds of gloo ranks, `tests/torch_pp_ranks.py` `toy_world`);
- `plan_sequential_pipeline`: the same segment and the same refusals
  with the same messages;
- the refusals of `distribute` before any world forms (an unknown
  schedule, a `GraphModel`) and of truncated BPTT inside one.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import torch_pp_ranks as ranks
from deeplearning4j_tpu.nn.conf import (
    LSTM,
    BatchNorm,
    Dense,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu.nn.losses import Loss
from deeplearning4j_tpu.parallel.pipeline import (
    pipeline_apply,
    pipeline_train_1f1b,
    plan_sequential_pipeline,
    split_microbatches,
)
from deeplearning4j_tpu.runtime.mesh import MeshSpec, make_mesh, shard_map
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder
from deeplearning4j_tpu_torch.runtime import distributed

D, N_MICRO, B_MICRO = 8, 6, 2
TOL = 1e-5


def toy(k, seed=0):
    rng = np.random.default_rng(seed)
    ws = rng.normal(0, 0.4, (k, D, D)).astype(np.float32)
    x = rng.normal(size=(N_MICRO * B_MICRO, D)).astype(np.float32)
    labels = rng.normal(size=(N_MICRO * B_MICRO, D)).astype(np.float32)
    return ws, x, labels


def stage_fn(w, h):
    return jnp.tanh(h @ w)


def jax_toy(k):
    """JAX's GPipe outputs, loss and gradients (autodiff through the
    pipeline), and its 1F1B loss, stage gradients and dx."""
    ws, x, labels = (jnp.asarray(a) for a in toy(k))
    mesh = make_mesh(MeshSpec.of(pipe=k), jax.devices()[:k])
    xm, lm = split_microbatches(x, N_MICRO), split_microbatches(labels, N_MICRO)
    piped = shard_map(lambda w, xx: pipeline_apply(stage_fn, w[0], xx, axis="pipe"),
                      mesh=mesh, in_specs=(P("pipe"), P()), out_specs=P(),
                      check_vma=False)

    def loss_fn(w, xx):
        y = piped(w, xx)
        return jnp.mean(jnp.mean(jnp.sum((y - lm) ** 2, axis=-1), axis=1))

    y = piped(ws, xm)
    loss, (gw, gx) = jax.value_and_grad(loss_fn, argnums=(0, 1))(ws, xm)

    def inner(w_local, xx, ll):
        def loss_grad(yy, m):
            return jax.value_and_grad(
                lambda v: jnp.mean(jnp.sum((v - ll[m]) ** 2, axis=-1)))(yy)

        l1, g1, dx = pipeline_train_1f1b(stage_fn, w_local[0], xx, loss_grad, axis="pipe")
        return l1, jax.tree.map(lambda g: g[None], g1), dx

    l1, g1, dx = jax.jit(shard_map(inner, mesh=mesh, in_specs=(P("pipe"), P(), P()),
                                   out_specs=(P(), P("pipe"), P()),
                                   check_vma=False))(ws, xm, lm)
    return {"y": np.asarray(y), "loss": float(loss), "gw": np.asarray(gw),
            "gx": np.asarray(gx), "1f1b_loss": float(l1), "1f1b_gw": np.asarray(g1),
            "1f1b_dx": np.asarray(dx)}


@pytest.fixture(scope="module", params=[2, 4])
def toy_pair(request):
    k = request.param
    world = distributed.spawn(ranks.toy_world, k, {"arrays": toy(k), "n_micro": N_MICRO},
                              platform="cpu", timeout=300)
    return k, world, jax_toy(k)


def test_gpipe_forward_and_gradients_match_jax(toy_pair):
    """`pipeline_apply` and autograd through it: the last stage's
    outputs on every rank, the loss, each rank's stage gradient and the
    microbatches' gradient on every rank."""
    k, world, ref = toy_pair
    for r in world:
        y, loss, gw, gx = r["gpipe"]
        np.testing.assert_allclose(y, ref["y"], rtol=TOL, atol=TOL)
        assert loss == pytest.approx(ref["loss"], rel=TOL)
        np.testing.assert_allclose(gw, ref["gw"][r["stage"]], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(gx, ref["gx"], rtol=TOL, atol=TOL)
    assert sorted(r["stage"] for r in world) == list(range(k))


def test_1f1b_matches_jax(toy_pair):
    """`pipeline_train_1f1b`: the mean loss and dx on every rank, each
    rank's stage gradient, against JAX's 1F1B, and against GPipe."""
    _, world, ref = toy_pair
    for r in world:
        loss, gw, dx = r["1f1b"]
        assert loss == pytest.approx(ref["1f1b_loss"], rel=TOL)
        np.testing.assert_allclose(gw, ref["1f1b_gw"][r["stage"]], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(dx, ref["1f1b_dx"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(gw, r["gpipe"][2], rtol=TOL, atol=TOL)
        assert loss == pytest.approx(r["gpipe"][1], rel=TOL)


# -- plan_sequential_pipeline ------------------------------------------------------------

def port_of(jm):
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel as TSeq
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        SequentialConfiguration,
    )

    return TSeq(SequentialConfiguration.from_json(jm.conf.to_json()), device="cpu").init()


def both_plans(jm, k, n_micro=0):
    """(JAX's plan or its error message, the port's)."""
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        plan_sequential_pipeline as port_plan,
    )

    pm = port_of(jm)
    out = []
    for fn, m in ((plan_sequential_pipeline, jm), (port_plan, pm)):
        try:
            p = fn(m.conf.layers, m.params, m._itypes, k, n_micro, net_state=m.net_state)
            out.append((p.start, p.end, p.block_names, p.k, p.n_micro,
                        type(p.block_config).__name__))
        except ValueError as e:
            out.append(str(e))
    return out


def seq(*layers, itype):
    from deeplearning4j_tpu.models import SequentialModel

    b = NeuralNetConfiguration.builder().seed(4).list()
    for l in layers:
        b = b.layer(l)
    return SequentialModel(b.set_input_type(itype).build()).init()


def flagship(n_layers=4, **kw):
    return TransformerEncoder(vocab_size=16, d_model=16, n_heads=2, n_layers=n_layers,
                              causal=True, seed=11, **kw).init_model()


@pytest.mark.parametrize("k,n_micro", [(2, 0), (4, 4), (2, 6)])
def test_plan_finds_the_jax_segment(k, n_micro):
    jax_plan, port_plan = both_plans(flagship(), k, n_micro)
    assert not isinstance(jax_plan, str)
    assert port_plan == jax_plan
    assert port_plan[:2] == (2, 6) and port_plan[4] == (n_micro or 2 * k)


def _dropout_blocks():
    from deeplearning4j_tpu.nn.conf.attention import TransformerEncoderBlock

    return seq(*[TransformerEncoderBlock(d_model=8, n_heads=2, dropout_rate=0.1)
                 for _ in range(2)],
               RnnOutputLayer(n_out=3, loss=Loss.MCXENT), itype=InputType.recurrent(8))


def _moe_blocks():
    from deeplearning4j_tpu.nn.conf import MoELayer

    return seq(*[MoELayer(n_out=8, n_experts=2, top_k=1) for _ in range(2)],
               RnnOutputLayer(n_out=3, loss=Loss.MCXENT), itype=InputType.recurrent(8))


@pytest.mark.parametrize("case,k,needle", [
    ("dropout", 2, "dropout inside the pipelined segment"),
    ("batchnorm", 2, "stateful layers"),
    ("moe", 2, "emits state/aux during training"),
    ("mlp", 2, "identical shape-preserving"),
    ("indivisible", 4, "not divisible"),
])
def test_plan_refusals_are_the_jax_refusals(case, k, needle):
    """Dropout and BatchNorm state inside the segment, a block that
    emits an auxiliary loss (the MoE layer, found by a run on fake
    tensors where JAX runs ``jax.eval_shape``), too few or indivisible
    blocks: the same reasons, word for word."""
    model = {
        "dropout": _dropout_blocks,
        "batchnorm": lambda: seq(Dense(n_out=8), BatchNorm(), BatchNorm(),
                                 OutputLayer(n_out=2, loss=Loss.MCXENT),
                                 itype=InputType.feed_forward(4)),
        "moe": _moe_blocks,
        "mlp": lambda: seq(Dense(n_out=16), Dense(n_out=8),
                           OutputLayer(n_out=2, loss=Loss.MCXENT),
                           itype=InputType.feed_forward(4)),
        "indivisible": lambda: flagship(6),
    }[case]()
    jax_plan, port_plan = both_plans(model, k)
    assert isinstance(jax_plan, str) and needle in jax_plan
    assert port_plan == jax_plan


# -- distribute's refusals -----------------------------------------------------------

def test_unknown_schedule_raises():
    """JAX `tests/test_pipeline_fit.py:141`, before any world forms."""
    from deeplearning4j_tpu_torch.parallel import ParallelConfig as TPC
    from deeplearning4j_tpu_torch.parallel import distribute as tdist

    with pytest.raises(ValueError, match="schedule"):
        tdist(port_of(flagship()), TPC(pipe=4, schedule="interleaved"))
    assert not distributed.is_initialized()


def test_graph_model_pipe_raises():
    """JAX `tests/test_pipeline_fit.py:171`."""
    from deeplearning4j_tpu.nn.conf.graph_conf import GraphBuilder
    from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphConfiguration
    from deeplearning4j_tpu_torch.parallel import ParallelConfig as TPC
    from deeplearning4j_tpu_torch.parallel import distribute as tdist

    conf = (GraphBuilder().add_inputs("in").set_input_types(InputType.feed_forward(6))
            .add_layer("d", Dense(n_out=8), "in")
            .add_layer("out", OutputLayer(n_out=2, loss=Loss.MCXENT), "d")
            .set_outputs("out").build())
    m = GraphModel(GraphConfiguration.from_json(conf.to_json()), device="cpu").init()
    with pytest.raises(NotImplementedError, match="pipeline"):
        tdist(m, TPC(data=2, pipe=4))
    assert not distributed.is_initialized()


def test_truncated_bptt_through_a_pipelined_segment_raises():
    """Two identical LSTMs pipeline over two stages; truncated BPTT's
    carries cannot cross the schedule, so its fit raises."""
    jm = seq(LSTM(n_out=4), LSTM(n_out=4), RnnOutputLayer(n_out=2, loss=Loss.MCXENT),
             itype=InputType.recurrent(4))
    conf = dataclasses.replace(jm.conf, backprop_type="tbptt", tbptt_length=2)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 4, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (4, 4))]
    params = jax.tree.map(np.asarray, jm.params)
    (r0, r1) = distributed.spawn(ranks.tbptt_world, 2, (conf.to_json(), params, x, y),
                                 platform="cpu", timeout=300)
    for r in (r0, r1):
        assert r["tbptt"] is not None and "pipelined segment" in r["tbptt"]


def test_the_parallel_package_exports_the_pipeline_and_the_planner():
    """JAX `parallel/__init__.py:9-30`'s names."""
    import deeplearning4j_tpu_torch.parallel as tp
    from deeplearning4j_tpu_torch.parallel import pipeline, planner

    assert tp.pipeline_apply is pipeline.pipeline_apply
    assert tp.pipeline_train_1f1b is pipeline.pipeline_train_1f1b
    assert tp.plan is planner.plan and tp.PlanError is planner.PlanError
    for name in ("pipeline_apply", "pipeline_train_1f1b", "plan", "PlanError"):
        assert name in tp.__all__
