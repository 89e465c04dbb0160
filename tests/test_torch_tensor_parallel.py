"""The port's tensor parallelism (``ParallelConfig(model=m)``) against the
JAX package's mesh of the same shape.

Worlds of 2 and 4 gloo ranks on the CPU (spawned processes, one thread
each) run every case once a module (`tests/torch_mp_ranks.py`
`tp_world`); JAX runs on the conftest's virtual CPU devices under the
same `ParallelConfig`, fed the whole batch, from the same weights.
Parameters are compared whole (the port's slices gathered) within
`tests/test_parallel.py`'s rtol 2e-4 / atol 2e-5.
"""

import warnings

import numpy as np
import pytest

import jax

import torch_mp_ranks as ranks
from deeplearning4j_tpu.data import DataSet, NumpyDataSetIterator
from deeplearning4j_tpu.models import SequentialModel
from deeplearning4j_tpu.models.computation_graph import GraphModel
from deeplearning4j_tpu.nn import Adam, Sgd
from deeplearning4j_tpu.nn.activations import Activation
from deeplearning4j_tpu.nn.conf import (
    BatchNorm,
    Conv2D,
    Dense,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
)
from deeplearning4j_tpu.nn.conf.graph_conf import GraphBuilder
from deeplearning4j_tpu.nn.losses import Loss
from deeplearning4j_tpu.parallel import ParallelConfig, distribute
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder
from deeplearning4j_tpu_torch.runtime import distributed

RTOL, ATOL = 2e-4, 2e-5


def two_class_data(n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(axis=1) > 0).astype(int)]
    return x, y


def mlp_conf(updater=None, dropout=None):
    return (NeuralNetConfiguration.builder().seed(9).updater(updater or Adam(1e-2))
            .activation(Activation.RELU).list()
            .layer(Dense(n_out=32, dropout_rate=dropout)).layer(Dense(n_out=32))
            .layer(OutputLayer(n_out=2, loss=Loss.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(4)).build())


def cnn_graph_conf():
    return (GraphBuilder().updater(Adam(1e-2)).seed(12).add_inputs("in")
            .set_input_types(InputType.convolutional(8, 8, 2))
            .add_layer("c1", Conv2D(n_out=8, kernel=(3, 3), activation=Activation.RELU), "in")
            .add_layer("bn", BatchNorm(), "c1")
            .add_layer("c2", Conv2D(n_out=4, kernel=(3, 3), activation=Activation.RELU), "bn")
            .add_layer("d", Dense(n_out=16, activation=Activation.RELU), "c2")
            .add_layer("out", OutputLayer(n_out=3, loss=Loss.MCXENT,
                                          activation=Activation.SOFTMAX), "d")
            .set_outputs("out").build())


def flagship(vocab=64):
    """The small flagship: its vocabulary shards of 32 are two 16-wide
    chunks; at vocab 40 each shard of 20 pads its second chunk, and the
    ids 20-31 of rank 1's shard fall in rank 0's padding columns."""
    return TransformerEncoder(vocab_size=vocab, d_model=32, n_heads=4, n_layers=2,
                              chunked_vocab_loss=True, vocab_chunk=16,
                              learning_rate=1e-2, seed=3)


def epochs_of(x, y, batch, seed, epochs):
    it = NumpyDataSetIterator(x, y, batch_size=batch, seed=seed)
    return [(np.asarray(b.features), np.asarray(b.labels))
            for _ in range(epochs) for b in it]


def lm_batches(n=2, b=4, t=16, vocab=64, seed=0):
    """Next-token batches; at vocab 40 the first row's labels include
    ids 20-31, which rank 0's padding columns would otherwise take."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, t))
        if vocab == 40:
            ids[0, 1:13] = np.arange(20, 32)
        out.append((ids.astype(np.float32), np.roll(ids, -1, axis=1).astype(np.float32)))
    return out


def cnn_batches():
    rng = np.random.default_rng(7)
    return [(rng.normal(size=(8, 8, 8, 2)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]) for _ in range(2)]


X, Y = two_class_data()
MLP = epochs_of(X, Y, 64, 3, 2)
LM = lm_batches()
LM_PAD = lm_batches(vocab=40, seed=5)
CNN = cnn_batches()


def jax_params(m):
    return jax.tree.map(np.asarray, m.params)


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


def jax_trained(conf, cfg, batches, graph=False, params=None):
    m = (GraphModel(conf) if graph else SequentialModel(conf)).init()
    if params is not None:
        m.params = jax.tree.map(jax.numpy.asarray, params)
    n = int(np.prod(list(cfg.values())))
    distribute(m, ParallelConfig(**cfg), devices=jax.devices()[:n])
    losses = []
    for x, y in batches:
        m.fit_batch(DataSet(x, y))
        losses.append(float(m.score_value))
    return m, losses


# -- the worlds ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def inits():
    mlp = SequentialModel(mlp_conf()).init()
    lm = flagship().init_model()
    pad = flagship(40).init_model()
    sgd = SequentialModel(mlp_conf(Sgd(1.0))).init()
    return {"mlp": (mlp.conf.to_json(), jax_params(mlp)),
            "lm": (lm.conf.to_json(), jax_params(lm)),
            "lm_pad": (pad.conf.to_json(), jax_params(pad)),
            "sgd": (sgd.conf.to_json(), jax_params(sgd))}


def _case(inits, tmp):
    mlp, lm, sgd = inits["mlp"], inits["lm"], inits["sgd"]
    return {
        "tmp": tmp,
        "seq": {
            "mlp": (*mlp, dict(data=2, model=2), MLP, X[:8]),
            "mlp_alone": (*mlp, dict(data=1, model=2), MLP, X[:8]),
            "lm": (*lm, dict(data=1, model=2), LM, LM[0][0]),
            "lm_dp": (*lm, dict(data=2, model=2), LM, LM[0][0]),
            "lm_pad": (*inits["lm_pad"], dict(data=1, model=2), LM_PAD, LM_PAD[0][0]),
        },
        "grad": (*sgd, 4, X[:64], Y[:64]),
        "grad_cfg": dict(data=2, model=2),
        "graph": {"cnn": (cnn_graph_conf().to_json(), dict(data=2, model=2), CNN)},
    }


@pytest.fixture(scope="module")
def world2(inits, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp2"))
    return distributed.spawn(ranks.tp_world, 2, _case(inits, tmp), platform="cpu",
                             timeout=300)


@pytest.fixture(scope="module")
def world4(inits, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp4"))
    return distributed.spawn(ranks.tp_world, 4, _case(inits, tmp), platform="cpu",
                             timeout=300)


# -- against the JAX mesh --------------------------------------------------------------

@pytest.mark.parametrize("name,cfg", [("mlp", dict(data=2, model=2)),
                                      ("mlp_alone", dict(data=1, model=2))])
def test_mlp_matches_the_jax_mesh(name, cfg, world2, world4):
    """JAX `tests/test_parallel.py:82`: the MLP's hidden layers split on
    the model axis, trained against JAX's mesh of the same shape."""
    jm, losses = jax_trained(mlp_conf(), cfg, MLP)
    world = world4 if cfg["data"] == 2 else world2
    for r in world:
        assert_tables(r[name], jax_table(jax_params(jm)))
        np.testing.assert_allclose(r[f"{name}_losses"], losses, rtol=RTOL, atol=ATOL)
        # the hidden layers hold their column slices, the head is whole
        assert r[f"{name}_local"]["layer0.W"].shape == (4, 16)
        assert r[f"{name}_local"]["layer0.b"].shape == (16,)
        assert r[f"{name}_local"]["layer2.W"].shape == (32, 2)


def test_each_ranks_gradient_is_the_undistributed_gradient(world4):
    """Under data=2, model=2 one SGD(1.0) step moves each rank's leaves by
    its slice of the undistributed gradient: neither the model copies
    nor the data ranks count twice."""
    for r in world4:
        coords, shape = r["grad_coords"], r["grad_shape"]
        for i, g in r["grad"].items():
            full = r["grad_plain"][i]
            split = r["grad_splits"][i]
            if split is not None:
                axis, dim = split
                c = full.shape[dim] // shape[axis]
                full = np.take(full, range(coords[axis] * c, (coords[axis] + 1) * c),
                               axis=dim)
            np.testing.assert_allclose(g, full, rtol=RTOL, atol=1e-6, err_msg=str(i))


def test_replicated_leaves_are_bit_identical_across_model_ranks(world4):
    for name in ("mlp", "lm_dp"):
        for r in world4[1:]:
            for k, v in world4[0][name].items():
                np.testing.assert_array_equal(r[name][k], v, err_msg=k)


@pytest.mark.parametrize("name,cfg,vocab", [("lm", dict(data=1, model=2), 64),
                                            ("lm_dp", dict(data=2, model=2), 64),
                                            ("lm_pad", dict(data=1, model=2), 40)])
def test_flagship_embedding_and_vocab_parallel_head(name, cfg, vocab, inits, world2,
                                                     world4):
    """The small flagship (embedding, blocks, chunked vocabulary head):
    the embedding split by columns, the head by vocabulary (each shard
    padded to its chunks on its own; no padding column takes a label),
    trained against JAX."""
    conf = flagship(vocab).conf()
    jm, losses = jax_trained(conf, cfg, LM_PAD if vocab == 40 else LM)
    world = world4 if cfg["data"] == 2 else world2
    for r in world:
        np.testing.assert_allclose(r[f"{name}_losses"], losses, rtol=RTOL, atol=ATOL)
        assert_tables(r[name], jax_table(jax_params(jm)))
        local = r[f"{name}_local"]
        assert local["layer0.W"].shape == (vocab, 16)           # d_model / 2
        assert local["layer4.W"].shape == (32, vocab // 2)      # vocab / 2
        assert local["layer4.b"].shape == (vocab // 2,)
        assert local["layer2.W1"].shape == (32, 128)            # blocks whole


def test_tensor_sharded_cnn_graph(world4):
    """A small CNN graph: both convolutions split by output channels,
    BatchNorm whole with global statistics, against JAX."""
    jm, losses = jax_trained(cnn_graph_conf(), dict(data=2, model=2), CNN, graph=True)
    for r in world4:
        np.testing.assert_allclose(r["cnn_losses"], losses, rtol=RTOL, atol=ATOL)
        assert_tables(r["cnn"], jax_table(jax_params(jm)))
        np.testing.assert_allclose(r["cnn_out"], np.asarray(jm.output(CNN[0][0])),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["mlp", "mlp_alone", "lm", "lm_dp", "lm_pad"])
def test_output_of_a_tensor_parallel_model(name, world2, world4):
    """``output()`` of the split model equals the undistributed model's
    on the trained weights (every rank answers the whole batch)."""
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel as TSeq
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        SequentialConfiguration,
    )

    world = world4 if name in ("mlp", "lm_dp") else world2
    conf = (mlp_conf() if name.startswith("mlp")
            else flagship(40 if name == "lm_pad" else 64).conf()).to_json()
    plain = TSeq(SequentialConfiguration.from_json(conf), device="cpu").init()
    tree = {}
    for k, v in world[0][name].items():
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    plain.load_params(tree)
    probe = X[:8] if name.startswith("mlp") else (LM_PAD if name == "lm_pad" else LM)[0][0]
    want = plain.output(probe).numpy()
    for r in world:
        np.testing.assert_allclose(r[f"{name}_out"], want, rtol=RTOL, atol=ATOL)


def test_zip_of_a_tensor_parallel_model_is_the_undistributed_zip(world4):
    """``write_model`` on every rank writes the whole, gathered tree; it
    restores undistributed to the gathered parameters, and score /
    evaluate answer for the whole model."""
    r0 = world4[0]
    zipped = r0["zip"]
    assert sorted(zipped) == sorted(r0["mlp"])
    for k, v in r0["mlp"].items():
        np.testing.assert_array_equal(zipped[k], v, err_msg=k)
    np.testing.assert_allclose(r0["zip_out"], r0["mlp_out"], rtol=1e-6, atol=1e-7)
    for r in world4:
        assert r["mlp_score"] == pytest.approx(world4[0]["mlp_score"], rel=1e-6)
        assert r["mlp_eval"] == world4[0]["mlp_eval"]


# -- the partition rules --------------------------------------------------------------

def test_partition_rules_are_the_jax_rules():
    from deeplearning4j_tpu.parallel.strategy import param_specs as jspecs
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel as TSeq
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        SequentialConfiguration,
    )
    from deeplearning4j_tpu_torch.parallel.strategy import param_specs, spec_leaves

    jm = flagship().init_model()
    port = TSeq(SequentialConfiguration.from_json(jm.conf.to_json()), device="cpu").init()
    want = jspecs(jm.params, jm.conf, expert_axis="expert")
    got = param_specs(port.params, port.conf, expert_axis="expert")
    flat_w = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert [tuple(s) for s in flat_w] == spec_leaves(got)


def test_unsharded_large_param_warns():
    """JAX `TestTPUnshardedWarning`: a sizable leaf no rule matches warns
    under tensor parallelism, and stays quiet without the flag."""
    import torch

    from deeplearning4j_tpu_torch.parallel.strategy import param_specs

    params = {"custom": {"kernel_matrix": torch.zeros((128, 64))}}

    class FakeConf:
        layers = [type("L", (), {"name": "custom"})()]

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        param_specs(params, FakeConf(), warn_unsharded=True)
    assert any("REPLICATED" in str(c.message) for c in caught)
    with warnings.catch_warnings(record=True) as silent:
        warnings.simplefilter("always")
        param_specs(params, FakeConf())
    assert not [c for c in silent if "REPLICATED" in str(c.message)]


def test_recurrent_layers_under_the_model_axis_name_roadmap_a11():
    """Tensor parallelism of recurrent layers (per-step gate gathers
    inside the captured window steps) is ROADMAP A11's; refused before
    any world forms."""
    from deeplearning4j_tpu.nn.conf import LSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel as TSeq
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        SequentialConfiguration,
    )
    from deeplearning4j_tpu_torch.parallel import ParallelConfig as TParallelConfig
    from deeplearning4j_tpu_torch.parallel.data_parallel import _check_model_parallel
    from deeplearning4j_tpu_torch.parallel.strategy import param_specs

    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(LSTM(n_out=8)).layer(RnnOutputLayer(n_out=2))
            .set_input_type(InputType.recurrent(4)).build())
    port = TSeq(SequentialConfiguration.from_json(conf.to_json()), device="cpu").init()
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        _check_model_parallel(port, param_specs(port.params, port.conf), False)
    assert TParallelConfig(model=2).mesh_spec().axes == (("data", -1), ("model", 2))
    assert not distributed.is_initialized()
