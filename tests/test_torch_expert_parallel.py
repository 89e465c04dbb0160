"""The port's expert parallelism (``ParallelConfig(expert=x)``) and the
global MoE routing of data- and sequence-parallel steps, against the
JAX package.

`moe_apply` with its experts split over a world's expert axis is held
against the function whole; MoE transformers train in gloo worlds of 2
and 4 ranks (`tests/torch_mp_ranks.py` `ep_world`) against JAX's mesh of
the same shape from the same weights, within the MoE tests' rtol 3e-4
/ atol 3e-5.  At a capacity factor of 0.5 the routers drop choices, so
routing the rank's rows instead of the global batch (ROADMAP C27) shows.
"""

import dataclasses

import numpy as np
import pytest

import jax

import torch_mp_ranks as ranks
from deeplearning4j_tpu.data import DataSet
from deeplearning4j_tpu.models import SequentialModel
from deeplearning4j_tpu.nn.conf import MoELayer
from deeplearning4j_tpu.parallel import ParallelConfig, distribute
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder
from deeplearning4j_tpu_torch.runtime import distributed

RTOL, ATOL = 3e-4, 3e-5
VOCAB, D = 16, 16


def moe_conf(capacity_factor=None, seq_parallel="none"):
    """JAX `tests/test_moe_dsl.py`'s MoE transformer at Adam 1e-3 (at 1e-2
    Adam's first steps magnify the summation-order noise of a near-zero
    gradient element past the tolerance, in JAX's mesh as in the port)."""
    conf = TransformerEncoder(vocab_size=VOCAB, d_model=D, n_heads=2, n_layers=2,
                              causal=True, seed=5, learning_rate=1e-3, moe_experts=4,
                              seq_parallel=seq_parallel).conf()
    if capacity_factor is not None:
        conf = dataclasses.replace(conf, layers=tuple(
            dataclasses.replace(l, capacity_factor=capacity_factor)
            if isinstance(l, MoELayer) else l for l in conf.layers))
    return conf


def batch(seed=0, batch_size=8, seq=8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (batch_size, seq))
    y = np.eye(VOCAB, dtype=np.float32)[np.roll(ids, -1, axis=1)]
    return ids.astype(np.float32), y


BATCHES = [batch(i) for i in range(3)]
CASES = {
    # name: (conf, ParallelConfig)
    "ep": (moe_conf(), dict(data=1, expert=2)),
    "ep_dp": (moe_conf(0.5), dict(data=2, expert=2)),
    "c27": (moe_conf(0.5), dict(data=2)),
    "c27_seq": (moe_conf(0.5, "ring"), dict(data=1, seq=2)),
    "c27_dp4": (moe_conf(0.5), dict(data=4)),
}


def jax_trained(conf, cfg):
    m = SequentialModel(conf).init()
    params = jax.tree.map(np.asarray, m.params)
    n = int(np.prod(list(cfg.values())))
    distribute(m, ParallelConfig(**cfg), devices=jax.devices()[:n])
    losses = []
    for x, y in BATCHES:
        m.fit_batch(DataSet(x, y))
        losses.append(float(m.score_value))
    return m, losses, params


@pytest.fixture(scope="module")
def refs():
    return {name: jax_trained(*c) for name, c in CASES.items()}


MOE_CFG = dict(n_experts=4, d_model=16, d_hidden=32, top_k=2, capacity_factor=0.75)


def _case(refs):
    x = np.random.default_rng(1).normal(size=(2, 16, 16)).astype(np.float32)
    return {"moe_cfg": MOE_CFG, "moe_x": x, "seq": {
        name: (conf.to_json(), refs[name][2], cfg, BATCHES, BATCHES[0][0])
        for name, (conf, cfg) in CASES.items()}}


@pytest.fixture(scope="module")
def world2(refs):
    return distributed.spawn(ranks.ep_world, 2, _case(refs), platform="cpu", timeout=300)


@pytest.fixture(scope="module")
def world4(refs):
    return distributed.spawn(ranks.ep_world, 4, _case(refs), platform="cpu", timeout=300)


def _world(name, world2, world4):
    n = int(np.prod(list(CASES[name][1].values())))
    return {2: world2, 4: world4}[n]


def jax_table(params, path=""):
    out = {}
    for k in sorted(params):
        p = f"{path}.{k}" if path else k
        if isinstance(params[k], dict):
            out.update(jax_table(params[k], p))
        else:
            out[p] = np.asarray(params[k])
    return out


# -- moe_apply on the expert axis --------------------------------------------------

@pytest.mark.parametrize("what", ["y", "dx", "router", "Wi", "Wo"])
def test_moe_apply_split_over_the_expert_axis(what, world2):
    """JAX `test_moe_sharded_over_expert_axis` and `test_moe_gradients_flow`:
    each rank's experts' slots, the partial outputs summed, equal the
    whole function (and its gradients: the router and the input whole
    on every rank, Wi / Wo the rank's experts')."""
    for r in world2:
        a = r["apply"]
        want = a["whole"][what]
        if what in ("Wi", "Wo"):
            want = want[a["e0"]:a["e0"] + a["el"]]
        np.testing.assert_allclose(a["split"][what], want, rtol=RTOL, atol=ATOL)
        assert a["split"]["aux"] == pytest.approx(a["whole"]["aux"], rel=1e-6)


# -- MoE transformers against the JAX mesh -----------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_transformer_matches_jax(name, refs, world2, world4):
    """The MoE transformer (`tests/test_moe_dsl.py:76`'s setting) with its
    experts split (``ep``, ``ep_dp``), and under data or sequence
    parallelism at a capacity that drops choices: routing the global
    batch (ROADMAP C27), its losses and parameters equal JAX's."""
    jm, losses, _ = refs[name]
    for r in _world(name, world2, world4):
        np.testing.assert_allclose(r[f"{name}_losses"], losses, rtol=RTOL, atol=ATOL)
        got, want = r[name], jax_table(jax.tree.map(np.asarray, jm.params))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_output_of_an_expert_parallel_model(name, refs, world2, world4):
    jm = refs[name][0]
    want = np.asarray(jm.output(BATCHES[0][0]))
    for r in _world(name, world2, world4):
        np.testing.assert_allclose(r[f"{name}_out"], want, rtol=RTOL, atol=ATOL)


def test_c27_routing_drops_the_global_batchs_share(refs, world2):
    """ROADMAP C27: under ``data=2`` at capacity factor 0.5 the first MoE
    layer drops the share of the global batch's choices that JAX's
    global routing drops, the same on both ranks (the rank's rows routed
    alone drop another share)."""
    import torch

    from deeplearning4j_tpu_torch.convert import params_from_jax
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel as TSeq
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        SequentialConfiguration,
    )
    from deeplearning4j_tpu_torch.parallel.expert import dropped_share

    conf, _ = CASES["c27"]
    port = params_from_jax(refs["c27"][2], TSeq(SequentialConfiguration.from_json(
        conf.to_json()), device="cpu").init())
    emb, moe = port.conf.layers[0], port.conf.layers[3]
    x = BATCHES[0][0]
    lp = port.compute_params()
    h = emb.apply(lp[emb.name], {}, torch.from_numpy(x))[0].float()
    want = dropped_share(lp[moe.name], h, moe._cfg())
    alone = dropped_share(lp[moe.name], h[:4], moe._cfg())
    print(f"dropped share at capacity 0.5: global {want:.4f}, rank 0's rows "
          f"alone {alone:.4f}")
    assert want > 0.1
    for r in world2:
        assert r["c27_dropped"] == pytest.approx(want, abs=1e-6)
