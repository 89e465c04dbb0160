"""The attention layers of the port against the JAX package's, on the CPU.

Each layer is built from the same fields in both packages and initialised
from the same key: the port's initial weights equal the JAX layer's bit
for bit.  Then both apply to the same numpy inputs (weights perturbed
from a seed, so no weight is special), and the output, the input's
gradient and every weight's gradient of ``sum(y * g)`` agree within
1e-5 of the largest JAX element (f32 on both sides; the port sums the
same products in another order).  Cases:

- `SelfAttentionLayer` with ``project_input`` on and off, causal or not,
  without a mask and with a (B, T) key mask one of whose rows masks every
  key (that row's output is zeros on both sides);
- `LearnedSelfAttentionLayer` (4 learned queries), masked and not;
- `GlobalPooling`: AVG, MAX, SUM and PNORM over a sequence (B, T, F) and
  over maps (B, H, W, C), masked and not (every masked row keeps a step:
  a fully-masked MAX pools -inf on both sides);
- the masked `TransformerEncoderBlock`, causal and not.

Configurations holding the four new layer types round-trip through JSON
both ways, and `quantize` of a stack with a `SelfAttentionLayer` gives
the JAX package's int8 leaves and scales bit for bit.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import attention as jax_attention
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf import moe as jax_moe
from deeplearning4j_tpu.nn.conf.input_type import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
    SequentialConfiguration as JaxSC,
)
from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSM
from deeplearning4j_tpu.quant import quantize as jax_quantize
from deeplearning4j_tpu_torch.convert import params_from_jax, params_to_numpy
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn.conf import attention, layers, moe
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
    SequentialConfiguration,
)
from deeplearning4j_tpu_torch.quant import quantize
from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor
from deeplearning4j_tpu_torch.runtime import rng

torch.set_num_threads(1)

TOL = 1e-5
B, T, F = 3, 6, 8

# name -> (layer class, fields, input shape, masked?)
CASES = {}
for proj in (True, False):
    for causal in (False, True):
        for masked in (False, True):
            CASES[f"self_attn_proj{int(proj)}_causal{int(causal)}_mask{int(masked)}"] = (
                "SelfAttentionLayer",
                dict(n_out=F, n_heads=2, project_input=proj, causal=causal),
                (B, T, F), masked)
for masked in (False, True):
    CASES[f"learned_attn_mask{int(masked)}"] = (
        "LearnedSelfAttentionLayer", dict(n_out=6, n_heads=2, n_queries=4),
        (B, T, F), masked)
    for causal in (False, True):
        CASES[f"block_causal{int(causal)}_mask{int(masked)}"] = (
            "TransformerEncoderBlock", dict(d_model=F, n_heads=2, d_ff=16,
                                            causal=causal), (B, T, F), masked)
for pooling in ("avg", "max", "sum", "pnorm"):
    for kind, shape in (("rnn", (B, T, F)), ("cnn", (B, 5, 4, 3))):
        for masked in (False, True):
            CASES[f"pool_{pooling}_{kind}_mask{int(masked)}"] = (
                "GlobalPooling", dict(pooling=pooling), shape, masked)


def _module(pkg_jax: bool, cls: str):
    if cls == "GlobalPooling":
        return jax_layers if pkg_jax else layers
    return jax_attention if pkg_jax else attention


def _itype(shape):
    if len(shape) == 4:
        return (JaxInputType.convolutional(*shape[1:]),
                InputType.convolutional(*shape[1:]))
    return JaxInputType.recurrent(shape[2], shape[1]), InputType.recurrent(shape[2], shape[1])


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= TOL * scale, f"{what}: max |diff| {err:.3e} of max {scale:.3e}"


def _mask(case, shape, r):
    """A (B, shape[1]) keep-mask: row 0 whole, the others random; an
    attention case's last row masks every key; a pooling case's rows
    each keep their first step."""
    m = (r.random((shape[0], shape[1])) > 0.4).astype(np.float32)
    m[0] = 1.0
    if CASES[case][0] == "GlobalPooling":
        m[:, 0] = 1.0
    else:
        m[-1] = 0.0
    return m


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_the_jax_layer(case):
    cls, kw, shape, masked = CASES[case]
    jl = getattr(_module(True, cls), cls)(**kw)
    pl = getattr(_module(False, cls), cls)(**kw)
    jit_, pit = _itype(shape)
    assert pl.output_type(pit).shape == jl.output_type(jit_).shape
    seed = sorted(CASES).index(case)
    jp, _ = jl.init(jax.random.key(seed), jit_)
    pp, _ = pl.init(rng.key(seed), pit, "cpu")
    jleaves = jax.tree.leaves(jp)
    pleaves = jax.tree.leaves(_tree(lambda t: t, pp))
    assert len(jleaves) == len(pleaves)
    for a, b in zip(jleaves, pleaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    r = np.random.default_rng(100 + seed)
    params = _tree(lambda a: (np.asarray(a) + r.normal(scale=0.1, size=a.shape)
                              ).astype(np.float32), jp)
    x = r.normal(size=shape).astype(np.float32)
    m = _mask(case, shape, r) if masked else None
    jm = None if m is None else jnp.asarray(m)
    jy, _ = jl.apply(params, {}, jnp.asarray(x), mask=jm)
    g = r.normal(size=np.asarray(jy).shape).astype(np.float32)

    def jax_fn(p, xx):
        y, _ = jl.apply(p, {}, xx, mask=jm)
        return jnp.sum(y * g), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        _tree(jnp.asarray, params), jnp.asarray(x))
    tp = _tree(lambda a: torch.tensor(a, requires_grad=True), params)
    tx = torch.tensor(x, requires_grad=True)
    ty, _ = pl.apply(tp, {}, tx, mask=None if m is None else torch.from_numpy(m))
    (ty * torch.from_numpy(g)).sum().backward()
    _close(ty.detach().numpy(), jy, f"{case} output")
    _close(tx.grad.numpy(), jgx, f"{case} input gradient")
    for path, a in zip(jax.tree.leaves(_tree(lambda t: t, tp)), jax.tree.leaves(jgp)):
        _close(path.grad.numpy(), a, f"{case} weight gradient")
    if masked and cls == "SelfAttentionLayer":       # no key left to attend
        assert np.all(ty.detach().numpy()[-1] == 0)


def _stack(pkg_jax: bool):
    """Every new layer type in one small stack, built through either DSL."""
    nnc, lay, att, mo, it = ((JaxNNC, jax_layers, jax_attention, jax_moe, JaxInputType)
                             if pkg_jax else
                             (NeuralNetConfiguration, layers, attention, moe, InputType))
    return (nnc.builder().seed(3).list()
            .layer(lay.Embedding(n_in=20, n_out=16))
            .layer(att.SelfAttentionLayer(n_out=16, n_heads=2, causal=True))
            .layer(mo.MoELayer(n_out=16, n_experts=4, top_k=2, capacity_factor=1.5))
            .layer(att.SelfAttentionLayer(n_out=16, n_heads=4, project_input=False))
            .layer(att.LearnedSelfAttentionLayer(n_out=12, n_heads=2, n_queries=3))
            .layer(lay.GlobalPooling(pooling="max"))
            .layer(lay.OutputLayer(n_out=5))
            .set_input_type(it.recurrent(1))
            .build())


def test_new_layer_types_round_trip_json_both_ways():
    jconf, conf = _stack(True), _stack(False)
    js = jconf.to_json()
    ported = SequentialConfiguration.from_json(js)
    assert json.loads(ported.to_json()) == json.loads(js)
    assert ported == conf
    assert JaxSC.from_json(conf.to_json()) == jconf
    # the port's model of the JAX configuration has the JAX model's weights
    jm = JaxSM(jconf).init()
    pm = SequentialModel(ported, device="cpu").init()
    for a, b in zip(jax.tree.leaves(jm.params), jax.tree.leaves(params_to_numpy(pm))):
        np.testing.assert_array_equal(np.asarray(a), b)
    # a changed JAX tree carries into the port and back, leaf for leaf
    moved = jax.tree.map(lambda a: np.asarray(a) * 2 + 1, jm.params)
    carried = params_from_jax(moved, SequentialModel(ported, device="cpu"))
    back = params_to_numpy(carried)
    assert jax.tree.structure(back) == jax.tree.structure(moved)
    for a, b in zip(jax.tree.leaves(moved), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_ptq_of_self_attention_gives_the_jax_int8_leaves():
    jm = JaxSM(_stack(True)).init()
    pm = SequentialModel(SequentialConfiguration.from_json(jm.conf.to_json()),
                         device="cpu").init()
    jq, pq = jax_quantize(jm), quantize(pm)
    jtree = jax.tree.map(np.asarray, jq.params)
    ptree = params_to_numpy(pq)
    for name in ("layer1",):                      # the projecting SelfAttentionLayer
        for w in ("Wq", "Wk", "Wv", "Wo"):
            assert isinstance(ptree[name][w], QuantizedTensor)
            np.testing.assert_array_equal(ptree[name][w].q, jtree[name][w].q)
            np.testing.assert_array_equal(ptree[name][w].scale, jtree[name][w].scale)
    # the MoE and learned-query layers stay f32, as in the JAX package
    for name in ("layer2", "layer4"):
        for w, a in ptree[name].items():
            assert not isinstance(a, QuantizedTensor), (name, w)
            np.testing.assert_array_equal(a, jtree[name][w])
    ids = np.random.default_rng(0).integers(0, 20, (2, 7))
    _close(pq.output(ids).numpy(), np.asarray(jq.output(ids.astype(np.float32))),
           "quantized output")
