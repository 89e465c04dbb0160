"""The zoo's SeparableConv2D (Xception) and Deconv2D (UNet) graphs under
tensor parallelism, on the CPU.

The port's partition rules (`parallel/strategy.py` `param_specs`) for
both trees under a model axis are the JAX package's: SeparableConv2D's
pointwise kernel and bias split on their output channels, its depthwise
kernel whole, Deconv2D's kernel and bias split on their output
channels.  A world of 2 gloo ranks (`tests/torch_mp_ranks.py`
`zoo_tp_world`) then runs each graph under ``model=2`` from the same
seeded weights as the undistributed port model: ``output()`` and one
training step's loss within 1e-5 relative, and one step of plain SGD
(the zoo's updater swapped, at a rate of 2^10) changing each leaf of
the whole tree within 5e-2 relative (L2) of the undistributed change,
plus 1e-6 of the largest leaf's change (`tests/test_torch_zoo_tail.py`
says why: a ReLU whose input sits within rounding of zero).
"""

import json

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.zoo as jax_zoo
import torch_mp_ranks as ranks
from deeplearning4j_tpu.parallel.strategy import param_specs as jax_param_specs
from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphConfiguration
from deeplearning4j_tpu_torch.nn.weights import skip_draws
from deeplearning4j_tpu_torch.parallel.strategy import param_specs, spec_leaves
from deeplearning4j_tpu_torch.runtime import distributed
from deeplearning4j_tpu_torch.zoo.unet import UNet
from deeplearning4j_tpu_torch.zoo.xception import Xception
from test_torch_zoo_tail import LEAF_FLOOR, LEAF_TOL, LR, _seeded

torch.set_num_threads(1)

ZOO = {
    "xception": (Xception, "Xception", dict(num_classes=4, height=64, width=64,
                                            middle_blocks=1)),
    # two classes: the port splits a leaf only where the axis divides it
    "unet": (UNet, "UNet", dict(num_classes=2, height=32, width=32, channels=3,
                                base_filters=4, depth=2)),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_partition_rules_are_the_jax_rules(name):
    port_cls, jax_name, kw = ZOO[name]
    jz = getattr(jax_zoo, jax_name)(**kw)
    jconf = jz.conf()
    shapes = jax.eval_shape(lambda: jz.init_model().params)
    want = jax_param_specs(shapes, jconf, model_axis="model")
    with skip_draws():
        pm = GraphModel(port_cls(**kw).conf(), device="cpu").init()
    got = param_specs(pm.params, pm.conf, model_axis="model")
    flat = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert [tuple(s) for s in flat] == spec_leaves(got)
    kinds = {"xception": ("SeparableConv2D", {"pointW": (None, None, None, "model"),
                                               "depthW": (), "b": ("model",)}),
             "unet": ("Deconv2D", {"W": (None, None, None, "model"), "b": ("model",)})}
    kind, rules = kinds[name]
    nodes = [n.name for n in pm.conf.nodes if type(n.layer).__name__ == kind]
    assert nodes
    for n in nodes:
        for pname, spec in got[n].items():
            assert spec == rules[pname], (n, pname, spec)


@pytest.fixture(scope="module")
def world2():
    r = np.random.default_rng(0)
    case, plain = {}, {}
    for name, (port_cls, jax_name, kw) in ZOO.items():
        d = json.loads(port_cls(**kw).conf().to_json())
        d["updater"] = {"@type": "Sgd", "learning_rate": LR}
        text = json.dumps(d)
        jz = getattr(jax_zoo, jax_name)(**kw)
        shapes = jax.eval_shape(lambda: (lambda m: (m.params, m.net_state))(jz.init_model()))
        params, state = _seeded(shapes[0], r), _seeded(shapes[1], r)
        x = r.normal(size=(4, kw["height"], kw["width"], 3)).astype(np.float32)
        y = ((x[..., :2] > 0).astype(np.float32) if name == "unet"
             else np.eye(4, dtype=np.float32)[r.integers(0, 4, 4)])
        case[name] = (text, params, state, x, y)
        m = GraphModel(GraphConfiguration.from_json(text), device="cpu")
        m.load_params(params).load_net_state(state)
        out = m.output(x).numpy()
        before = ranks.full_table(m)
        m.fit_batch(MultiDataSet((x,), (y,)))
        plain[name] = (out, m.score_value, before, ranks.full_table(m))
    got = distributed.spawn(ranks.zoo_tp_world, 2, case, platform="cpu", timeout=600)
    return got, plain


@pytest.mark.parametrize("name", sorted(ZOO))
def test_model_parallel_graph_matches_the_undistributed_graph(name, world2):
    got, plain = world2
    out, loss, before, table = plain[name]
    for r in got:
        assert any(s is not None for s in r[f"{name}_splits"])
        np.testing.assert_allclose(r[f"{name}_out"], out, rtol=1e-5,
                                   atol=1e-5 * np.abs(out).max())
        assert r[f"{name}_loss"] == pytest.approx(loss, rel=1e-5)
        assert sorted(r[name]) == sorted(table)
        floor = LEAF_FLOOR * max(np.linalg.norm(table[k].astype(np.float64) - before[k])
                                 for k in table)
        for k, want in table.items():
            dw = want.astype(np.float64) - before[k]
            err = np.linalg.norm(r[name][k].astype(np.float64) - before[k] - dw)
            assert err <= LEAF_TOL * np.linalg.norm(dw) + floor, (k, err, np.linalg.norm(dw))
