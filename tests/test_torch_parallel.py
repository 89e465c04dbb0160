"""The port's data parallelism (`deeplearning4j_tpu_torch.parallel`)
against the JAX package's mesh of the same size.

A port world of N gloo ranks on the CPU (spawned processes, one thread
each), each rank fed its rows of every global batch, is held against
JAX ``distribute(ParallelConfig(data=N))`` over N of the conftest's
virtual CPU devices fed the whole batch: params within the JAX test's
rtol 2e-4 / atol 2e-5 (`tests/test_parallel.py`), BatchNorm statistics
and dropout masks global.  Each world runs every case in one spawn
(module-scoped fixtures); the rank bodies live in
`tests/torch_dp_ranks.py`.
"""

import numpy as np
import pytest

import jax

import torch_dp_ranks as ranks
from deeplearning4j_tpu.data import DataSet, NumpyDataSetIterator
from deeplearning4j_tpu.models import SequentialModel
from deeplearning4j_tpu.models.computation_graph import GraphModel
from deeplearning4j_tpu.nn import Adam
from deeplearning4j_tpu.nn.activations import Activation
from deeplearning4j_tpu.nn.conf import (
    LSTM,
    BatchNorm,
    Conv2D,
    Dense,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu.nn.conf.graph_conf import GraphBuilder
from deeplearning4j_tpu.nn.losses import Loss
from deeplearning4j_tpu.parallel import ParallelConfig, distribute
from deeplearning4j_tpu_torch.parallel import ParallelConfig as TParallelConfig
from deeplearning4j_tpu_torch.parallel import distribute as tdistribute
from deeplearning4j_tpu_torch.runtime import distributed

RTOL, ATOL = 2e-4, 2e-5


def two_class_data(n=512, seed=0, d=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(axis=1) > 0).astype(int)]
    return x, y


def mlp_conf(seed=9, l2=None):
    b = NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
    if l2 is not None:
        b = b.l2(l2)
    return (b.activation(Activation.RELU).list()
            .layer(Dense(n_out=32)).layer(Dense(n_out=32))
            .layer(OutputLayer(n_out=2, loss=Loss.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(4)).build())


def cnn_conf():
    return (NeuralNetConfiguration.builder().seed(11).updater(Adam(1e-2))
            .activation(Activation.RELU).list()
            .layer(Conv2D(n_out=4, kernel=(3, 3)))
            .layer(BatchNorm())
            .layer(Dense(n_out=16, dropout_rate=0.25))
            .layer(OutputLayer(n_out=3, loss=Loss.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())


def graph_conf():
    return (GraphBuilder().updater(Adam(1e-2)).seed(9).add_inputs("in")
            .set_input_types(InputType.feed_forward(4))
            .add_layer("d", Dense(n_out=32, activation=Activation.RELU), "in")
            .add_layer("out", OutputLayer(n_out=2, loss=Loss.MCXENT,
                                          activation=Activation.SOFTMAX), "d")
            .set_outputs("out").build())


def lstm_conf():
    return (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-2)).list()
            .layer(LSTM(n_out=8, activation=Activation.TANH))
            .layer(RnnOutputLayer(n_out=3, loss=Loss.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.recurrent(3)).tbptt(4).build())


def epochs_of(x, y, batch, seed, epochs):
    """The global batches JAX ``fit(it, epochs=...)`` sees, epoch by epoch."""
    it = NumpyDataSetIterator(x, y, batch_size=batch, seed=seed)
    return [[(np.asarray(b.features), np.asarray(b.labels)) for b in it]
            for _ in range(epochs)]


def jax_dp(conf, n):
    m = SequentialModel(conf).init()
    distribute(m, ParallelConfig(data=n), devices=jax.devices()[:n])
    return m


def jax_table(m) -> dict:
    out = {}
    for k in sorted(m.params):
        for p in sorted(m.params[k]):
            out[f"{k}.{p}"] = np.asarray(m.params[k][p])
    return out


def assert_tables(port, ref, rtol=RTOL, atol=ATOL):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=rtol, atol=atol, err_msg=k)


def fit_jax(m, epochs):
    losses = []
    for batches in epochs:
        for x, y in batches:
            m.fit_batch(DataSet(x, y))
            losses.append(float(m.score_value))
    return losses


# -- the worlds ------------------------------------------------------------------

X, Y = two_class_data(256)
MLP_EPOCHS = epochs_of(X, Y, 64, 3, 3)


def _cnn_batches():
    rng = np.random.default_rng(7)
    return [(rng.normal(size=(16, 8, 8, 1)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]) for _ in range(3)]


def _masked_batches():
    rng = np.random.default_rng(8)
    out = []
    for _ in range(2):
        x = rng.normal(size=(16, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
        mask = np.ones(16, np.float32)
        mask[1:6] = 0.0                 # rank 0 of 2 keeps 3 rows, rank 1 eight
        out.append((x, y, mask))
    return out


def _tbptt_batches():
    rng = np.random.default_rng(9)
    return [(rng.normal(size=(8, 10, 3)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, (8, 10))]) for _ in range(2)]


def _graph_batches():
    x, y = two_class_data(64, seed=4)
    return [(x[i:i + 32], y[i:i + 32]) for i in (0, 32)]


@pytest.fixture(scope="module")
def mlp_jax():
    jm = SequentialModel(mlp_conf()).init()
    return jm.conf.to_json(), jax.tree.map(np.asarray, jm.params)


@pytest.fixture(scope="module")
def world2(mlp_jax):
    conf, params = mlp_jax
    xl, yl = two_class_data(512)
    case = {
        "mlp_conf": conf, "mlp_params": params, "mlp_epochs": MLP_EPOCHS,
        "learn": (xl, yl, epochs_of(xl, yl, 128, 1, 10)),
        "wrapper_epochs": epochs_of(X, Y, 64, 2, 5),
        "cnn": (cnn_conf().to_json(), _cnn_batches()),
        "masked": (mlp_conf().to_json(), _masked_batches()),
        "penalty": (mlp_conf(l2=1e-2).to_json(), MLP_EPOCHS[0]),
        "grouped": MLP_EPOCHS[0],
        "graph": (graph_conf().to_json(), _graph_batches()),
        "tbptt": (lstm_conf().to_json(), _tbptt_batches()),
        "mask_draw": ((0, 5), 0.3, (8, 6)),
        "indivisible": 65,
    }
    return distributed.spawn(ranks.parallel_world, 2, case, platform="cpu", timeout=300)


@pytest.fixture(scope="module")
def world4(mlp_jax):
    conf, params = mlp_jax
    case = {"mlp_conf": conf, "mlp_params": params, "mlp_epochs": MLP_EPOCHS,
            "mask_draw": ((0, 5), 0.3, (8, 6))}
    return distributed.spawn(ranks.parallel_world, 4, case, platform="cpu", timeout=300)


# -- data parallelism against the JAX mesh ----------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_dp_matches_jax_mesh_of_the_same_size(n, world2, world4):
    """JAX `tests/test_parallel.py:51-71`: 3 epochs of the MLP, the port's
    world of n ranks against JAX DP over n devices, both from the JAX
    weights."""
    res = {2: world2, 4: world4}[n]
    jm = jax_dp(mlp_conf(), n)
    jm.fit(NumpyDataSetIterator(X, Y, batch_size=64, seed=3), epochs=3)
    for r in res:
        assert_tables(r["mlp"], jax_table(jm))
    for r in res[1:]:                  # the replicas stay equal, bit for bit
        for k, v in r["mlp"].items():
            np.testing.assert_array_equal(v, res[0]["mlp"][k])


@pytest.mark.parametrize("n", [2, 4])
def test_the_cost_analysis_counts_a_ranks_work(n, world2, world4):
    """`observe/cost.py` re-runs a DP model's step program with no
    collective: the FLOPs of the undistributed step on the rank's rows."""
    for r in {2: world2, 4: world4}[n]:
        dp, plain = r["flops"]
        assert dp and dp == plain and dp[0] > 0


def test_dp_learns_and_wrapper_facade(world2):
    """JAX `test_dp_learns` and `test_parallel_wrapper_facade`."""
    for r in world2:
        assert r["learn_acc"] > 0.95
        assert r["wrapper_acc"] > 0.9
    np.testing.assert_array_equal(world2[0]["wrapper_out"], world2[1]["wrapper_out"])


def test_world_of_one_is_the_undistributed_step_bit_for_bit(mlp_jax):
    """JAX `test_distribute_with_size_one_data_axis`: a world of one runs
    its collectives and computes the undistributed step's bits."""
    conf, params = mlp_jax
    (r,) = distributed.spawn(ranks.world_of_one, 1, conf, params, MLP_EPOCHS[:2],
                             platform="cpu", timeout=300)
    assert r["lp"] == r["ld"]
    for k, v in r["plain"].items():
        np.testing.assert_array_equal(r["dp"][k], v, err_msg=k)


def test_cnn_batchnorm_and_dropout_are_global(world2):
    """BatchNorm's statistics and dropout's masks are the global batch's:
    params, running statistics and losses against JAX DP over 2
    devices."""
    conf = cnn_conf()
    jm = jax_dp(conf, 2)
    losses = fit_jax(jm, [_cnn_batches()])
    ref_state = {f"{k}/{kk}": np.asarray(vv) for k, v in jm.net_state.items()
                 for kk, vv in v.items()}
    for r in world2:
        np.testing.assert_allclose(r["cnn_losses"], losses, rtol=RTOL, atol=ATOL)
        assert_tables(r["cnn"], jax_table(jm))
        assert sorted(r["cnn_state"]) == sorted(ref_state)
        for k, v in ref_state.items():
            np.testing.assert_allclose(r["cnn_state"][k], v, rtol=RTOL, atol=ATOL, err_msg=k)
    for k, v in world2[0]["cnn_state"].items():
        np.testing.assert_array_equal(world2[1]["cnn_state"][k], v)


@pytest.mark.parametrize("n", [2, 4])
def test_dropout_draws_the_ranks_rows_of_the_global_mask(n, world2, world4):
    key, rate, shape = (0, 5), 0.3, (8, 6)
    mask = np.asarray(jax.random.bernoulli(
        jax.random.wrap_key_data(np.asarray(key, np.uint32)), 1 - rate, shape))
    res = {2: world2, 4: world4}[n]
    c = shape[0] // n
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["mask_rows"], mask[r * c:(r + 1) * c])


def test_masked_loss_is_normalised_by_the_global_count(world2):
    """Ranks with different counts of kept rows: the loss is the global
    masked mean (the JAX step's), not the mean of the ranks' means."""
    jm = jax_dp(mlp_conf(), 2)
    losses = []
    for x, y, mask in _masked_batches():
        jm.fit_batch(DataSet(x, y, labels_mask=mask))
        losses.append(float(jm.score_value))
    for r in world2:
        np.testing.assert_allclose(r["masked_losses"], losses, rtol=RTOL, atol=ATOL)
        assert_tables(r["masked"], jax_table(jm))


def test_the_penalty_counts_once_over_the_world(world2):
    """An l2 penalty on every replica: each rank adds its share, so the
    summed gradient and the reported loss count it once, as the JAX
    step's objective does."""
    jm = jax_dp(mlp_conf(l2=1e-2), 2)
    losses = fit_jax(jm, [MLP_EPOCHS[0]])
    for r in world2:
        np.testing.assert_allclose(r["penalty_losses"], losses, rtol=RTOL, atol=ATOL)
        assert_tables(r["penalty"], jax_table(jm))


def test_grouped_steps_run_under_dp(world2):
    """``steps_per_execution=2`` over DP: the JAX package's per-batch DP
    steps, each step's loss kept."""
    jm = jax_dp(mlp_conf(), 2)
    losses = fit_jax(jm, [MLP_EPOCHS[0]])
    for r in world2:
        assert_tables(r["grouped"], jax_table(jm))
        np.testing.assert_allclose(r["grouped_scores"], losses[-2:], rtol=RTOL, atol=ATOL)


def test_graph_model_in_a_world_of_two(world2):
    jm = GraphModel(graph_conf()).init()
    distribute(jm, ParallelConfig(data=2), devices=jax.devices()[:2])
    losses = []
    for x, y in _graph_batches():
        jm.fit_batch(DataSet(x, y))
        losses.append(float(jm.score_value))
    for r in world2:
        np.testing.assert_allclose(r["graph_losses"], losses, rtol=RTOL, atol=ATOL)
        assert_tables(r["graph"], jax_table(jm))


def test_tbptt_on_a_sharded_batch(world2):
    """JAX `models/sequential.py:1330-1349`: a distributed model keeps the
    per-window path, carries per rank."""
    jm = jax_dp(lstm_conf(), 2)
    losses = []
    for x, y in _tbptt_batches():
        before = jm.iteration
        jm.fit_batch(DataSet(x, y))
        assert jm.iteration - before == 3          # windows 4, 4 and 2
        losses.append(float(jm.score_value))
    for r in world2:
        # the last window's loss of each batch
        np.testing.assert_allclose(np.asarray(r["tbptt_losses"])[[2, 5]], losses,
                                   rtol=RTOL, atol=ATOL)
        assert_tables(r["tbptt"], jax_table(jm))


def test_a_world_that_does_not_divide_the_batch(world2):
    for r in world2:
        assert "does not divide over a world of 2" in r["indivisible"]


# -- refusals -----------------------------------------------------------------------

def _port_mlp():
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel as TSeq
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        SequentialConfiguration,
    )

    return TSeq(SequentialConfiguration.from_json(mlp_conf().to_json()), device="cpu").init()


@pytest.mark.parametrize("cfg", [dict(model=2), dict(pipe=2), dict(seq=2), dict(expert=2)])
def test_other_axes_name_roadmap_a11(cfg):
    """The model, seq, expert and pipe axes are ported
    (`tests/test_torch_tensor_parallel.py`, `test_torch_seq_parallel.py`,
    `test_torch_expert_parallel.py`, `test_torch_pipeline_fit.py`): their
    mesh lays two ranks out on the axis, and ZeRO refuses them with the
    JAX message, before any world forms; an MLP has no run of identical
    blocks to pipeline, which the JAX package's message says, before
    any world forms too."""
    if "pipe" in cfg:
        with pytest.raises(ValueError, match="identical shape-preserving"):
            tdistribute(_port_mlp(), TParallelConfig(**cfg))
    (axis,) = cfg
    mesh = TParallelConfig(data=1, **cfg).build_mesh(devices=[0, 1])
    assert mesh.shape == {"data": 1, axis: 2}
    assert [mesh.coords(r)[axis] for r in (0, 1)] == [0, 1]
    with pytest.raises(ValueError, match="pure data parallelism"):
        tdistribute(_port_mlp(), TParallelConfig(zero=1, **cfg))
    assert not distributed.is_initialized()


def test_planner_and_parallel_inference_name_roadmap_a11(monkeypatch):
    """The planner is ported (`tests/test_torch_planner.py`): the env knob
    sends a distribute without a config to it, which installs its pick
    in this process's world of one; `ParallelInference` still raises,
    naming ROADMAP A11."""
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.runtime.flags import environment

    monkeypatch.setattr(environment(), "auto_plan", True)
    model = _port_mlp()
    try:
        tdistribute(model)
        assert model._plan_report.pick_candidate().label() == "data=1 zero=0"
        assert model._mesh.shape == {"data": 1}
    finally:
        distributed.shutdown()
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        ParallelInference(_port_mlp())


@pytest.mark.parametrize("cfg,exc,match", [
    (dict(zero=3), ValueError, "unknown zero stage"),
    (dict(zero=1, grad_compression="int8"), ValueError, "pure data parallelism"),
    (dict(zero=1, grad_accum=2), ValueError, "set zero=2"),
    (dict(grad_compression="fp4"), ValueError, "unknown grad_compression"),
])
def test_refusals_keep_the_jax_messages(cfg, exc, match):
    with pytest.raises(exc, match=match):
        distribute(SequentialModel(mlp_conf()).init(), ParallelConfig(data=2, **cfg),
                   devices=jax.devices()[:2])
    with pytest.raises(exc, match=match):
        tdistribute(_port_mlp(), TParallelConfig(**cfg))
    assert not distributed.is_initialized()        # refused before any world


def test_grad_accum_refused_on_recurrent_stacks():
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel as TSeq
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        SequentialConfiguration,
    )

    with pytest.raises(NotImplementedError, match="accumulation"):
        distribute(SequentialModel(lstm_conf()).init(),
                   ParallelConfig(data=2, zero=2, grad_accum=2), devices=jax.devices()[:2])
    port = TSeq(SequentialConfiguration.from_json(lstm_conf().to_json()), device="cpu")
    with pytest.raises(NotImplementedError, match="accumulation"):
        tdistribute(port, TParallelConfig(zero=2, grad_accum=2))
