"""The port's Mixture-of-Experts layer against the JAX package, on the CPU.

- `moe_apply` against JAX `moe_apply` on the same inputs and weights:
  output, aux loss and the gradients of ``sum(y * g) + aux`` within 1e-5
  of the largest JAX element (f32: the port gathers where JAX contracts
  one-hot einsums, so the same products meet in another order).  Cases
  at a capacity factor small enough that choices are dropped, at one so
  large that none is, with top-1 and top-3, in bf16 input (the layer
  casts to f32 and back), with a forced tie (two experts with the
  same router column: `jax.lax.top_k` takes the lower index, so must the
  port) and with a saturated router (inputs 100x: XLA flushes the tail
  probabilities to exact zeros, so a token's second choice among them
  goes to the lowest index, and the capacity counts follow);
- `init_moe` equals the JAX draws bit for bit;
- `TransformerEncoder(moe_experts=4)`: the port's model of the JAX
  configuration has the JAX weights bit for bit, and 5 `fit_batch`
  losses agree within 1e-5; the step's loss is data + penalty + the
  layers' weighted aux losses, and no aux entry reaches ``net_state``;
- the checkpoint zip of a trained MoE model crosses both ways bit for
  bit;
- `generate` over a stack with a `MoELayer` or a `SelfAttentionLayer`
  raises the JAX `_plan`'s error;
- `observe/cost.py` counts a MoE step's products exactly (the router and
  the experts' batched products, forward and backward); the gathers and
  scatters of the dispatch count nothing.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSM
from deeplearning4j_tpu.nn.conf import attention as jax_attention
from deeplearning4j_tpu.ops.generation import generate as jax_generate
from deeplearning4j_tpu.parallel import expert as jax_expert
from deeplearning4j_tpu.train.checkpoint import ModelSerializer as JaxMS
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.convert import params_to_numpy
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models._common import AUX_LOSS_KEY, pop_aux_losses
from deeplearning4j_tpu_torch.models.sequential import SequentialModel, tree_leaves
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    SequentialConfiguration,
)
from deeplearning4j_tpu_torch.nn.updaters import state_leaves
from deeplearning4j_tpu_torch.observe import cost
from deeplearning4j_tpu_torch.ops.generation import generate
from deeplearning4j_tpu_torch.parallel import expert
from deeplearning4j_tpu_torch.runtime import rng
from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

torch.set_num_threads(1)

TOL = 1e-5
VOCAB, D, HEADS, LAYERS, EXPERTS = 50, 32, 2, 2, 4

# name -> (MoEConfig fields, (B, T), input dtype, "tie" / "saturated" / "")
CASES = {
    "drops": (dict(n_experts=4, d_model=16, d_hidden=24, top_k=2,
                   capacity_factor=0.5), (3, 10), "float32", ""),
    "no_drops": (dict(n_experts=4, d_model=16, d_hidden=24, top_k=2,
                      capacity_factor=4.0), (3, 10), "float32", ""),
    "top1": (dict(n_experts=8, d_model=16, d_hidden=8, top_k=1,
                  capacity_factor=1.0), (2, 12), "float32", ""),
    "top3_drops": (dict(n_experts=6, d_model=8, d_hidden=16, top_k=3,
                        capacity_factor=0.75), (2, 9), "float32", ""),
    "tie": (dict(n_experts=4, d_model=16, d_hidden=24, top_k=2,
                 capacity_factor=0.75), (3, 10), "float32", "tie"),
    "saturated": (dict(n_experts=6, d_model=16, d_hidden=24, top_k=2,
                       capacity_factor=0.75), (3, 10), "float32", "saturated"),
    "bf16": (dict(n_experts=4, d_model=16, d_hidden=24, top_k=2,
                  capacity_factor=1.0), (2, 8), "bfloat16", ""),
}


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} of max {scale:.3e}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_jax(case):
    kw, (b, t), dtype, kind = CASES[case]
    jcfg, cfg = jax_expert.MoEConfig(**kw), expert.MoEConfig(**kw)
    seed = sorted(CASES).index(case)
    jp = jax_expert.init_moe(jax.random.key(seed), jcfg)
    pp = expert.init_moe(rng.key(seed), cfg)
    for name in ("router", "Wi", "Wo"):
        np.testing.assert_array_equal(pp[name].numpy(), np.asarray(jp[name]))
    params = {k: np.asarray(v) for k, v in jp.items()}
    if kind == "tie":   # experts 1 and 2 score every token the same
        params["router"] = params["router"].copy()
        params["router"][:, 2] = params["router"][:, 1]
    r = np.random.default_rng(seed)
    x = r.normal(size=(b, t, kw["d_model"])).astype(np.float32)
    if kind == "saturated":
        x *= 100.0
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    jprobs = jax.nn.softmax(jx.reshape(-1, kw["d_model"]).astype(jnp.float32)
                            @ params["router"])
    jgate, idx = jax.lax.top_k(jprobs, kw["top_k"])
    if kind == "tie":
        assert (np.asarray(idx) == 1).any()           # the tie is reached
    if kind == "saturated":
        # JAX's second choice is an exact zero somewhere, where torch's
        # own softmax leaves subnormals that would order the tail
        tprobs = torch.softmax(torch.tensor(x).reshape(-1, kw["d_model"])
                               @ torch.tensor(params["router"]), -1)
        assert (np.asarray(jgate)[:, 1] == 0).any()
        assert ((tprobs > 0) & (tprobs < torch.finfo(torch.float32).tiny)).any()
    g = r.normal(size=x.shape).astype(np.float32)

    def jax_fn(p, xx):
        y, aux = jax_expert.moe_apply(p, xx, jcfg)
        return jnp.sum(y.astype(jnp.float32) * g) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)({k: jnp.asarray(v) for k, v in params.items()}, jx)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx.requires_grad_(True)
    ty, taux = expert.moe_apply(tp, tx, cfg)
    assert ty.dtype == tx.dtype
    ((ty.float() * torch.from_numpy(g)).sum() + taux).backward()
    tol = TOL if dtype == "float32" else 2 ** -8      # one bf16 rounding of y
    _close(ty.detach().float().numpy(), np.asarray(jy, np.float32), f"{case} y", tol)
    _close(float(taux.detach()), float(jaux), f"{case} aux")
    _close(tx.grad.float().numpy(), np.asarray(jgx, np.float32), f"{case} dx", tol)
    for k in params:
        _close(tp[k].grad.numpy(), jgp[k], f"{case} d{k}", tol)
    # the share of dropped choices, counted again in numpy from JAX's top-k
    n = b * t
    cap = expert.capacity(cfg, n)
    assert cap == max(1, int(kw["capacity_factor"] * n * kw["top_k"] / kw["n_experts"]))
    probs = jax.nn.softmax(jx.reshape(n, -1).astype(jnp.float32) @ params["router"])
    choice = np.eye(kw["n_experts"])[np.asarray(jax.lax.top_k(probs, kw["top_k"])[1]).ravel()]
    want = np.mean((np.cumsum(choice, 0) * choice).sum(-1) - 1 >= cap)
    share = expert.dropped_share(tp, tx.detach(), cfg)
    assert share == pytest.approx(want, abs=1e-7)
    assert (share > 0) == (case != "no_drops"), share


def _zoo(cls, **kw):
    return cls(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS, seed=7,
               chunked_vocab_loss=True, vocab_chunk=16, learning_rate=5e-3,
               moe_experts=EXPERTS, **kw)


def _pair():
    jm = _zoo(JaxTE).init_model()
    pm = SequentialModel(SequentialConfiguration.from_json(jm.conf.to_json()),
                         device="cpu").init()
    return jm, pm


def _batches(seed, n=5):
    r = np.random.default_rng(seed)
    return [r.integers(0, VOCAB, (2, 12)).astype(np.int32) for _ in range(n)]


def test_moe_transformer_trains_as_the_jax_model():
    jm, pm = _pair()
    assert pm.conf == _zoo(TransformerEncoder).conf()
    for a, b in zip(jax.tree.leaves(jm.params), tree_leaves(params_to_numpy(pm))):
        np.testing.assert_array_equal(b, np.asarray(a))
    for ids in _batches(0):
        y = np.roll(ids, -1, axis=1)
        jm.fit_batch(JaxDataSet(ids, y))
        pm.fit_batch(DataSet(ids, y))
        assert abs(pm.score_value - float(jm.score_value)) <= TOL * max(
            1.0, abs(float(jm.score_value))), (pm.score_value, jm.score_value)
        assert pm.net_state == {} and jm.net_state == {}


def test_at_width_the_port_follows_the_jax_models_rising_loss():
    """The MoE flagship's configuration at d_model 256 (8 blocks, 8
    experts top-2, Adam 3e-4; vocab 8192), 8 steps on one (1, 256) batch
    of ids: the JAX model's loss rises more than 20% above its first
    before it falls, so the rise is the model's.  Before each JAX step the
    port takes the JAX weights and its own step's loss, computed on them,
    is within 1e-5 of JAX's (its routers saturate: this fails unless the
    port flushes subnormal router probabilities to zero as XLA does).
    Trained on its own from the same first weights, the port rises the
    same way; the two runs do not stay within 1e-5, since Adam's first
    step moves a weight by about lr times the sign of its gradient, and
    for some weights that sign is rounding's.  Run with ``-s`` to print
    the three loss curves."""
    kw = dict(vocab_size=8192, d_model=256, n_heads=2, n_layers=8, causal=True,
              chunked_vocab_loss=True, vocab_chunk=8192, seed=123,
              moe_experts=8, moe_top_k=2)
    jm = JaxTE(**kw).init_model()
    conf = SequentialConfiguration.from_json(jm.conf.to_json())
    ids = np.random.default_rng(3).integers(0, 8192, (1, 256))
    y = np.roll(ids, -1, axis=1)
    jl, pl, al = [], [], []
    threads = torch.get_num_threads()
    torch.set_num_threads(4)          # the file's one thread takes minutes here
    try:
        alone = SequentialModel(conf, device="cpu").init()
        for a, b in zip(jax.tree.leaves(jm.params), tree_leaves(params_to_numpy(alone))):
            np.testing.assert_array_equal(b, np.asarray(a))
        on_jax = alone.clone()
        for _ in range(8):
            on_jax.load_params(jax.tree.map(np.asarray, jm.params))
            on_jax.fit_batch(DataSet(ids, y))
            jm.fit_batch(JaxDataSet(ids.astype(np.int32), y.astype(np.int32)))
            alone.fit_batch(DataSet(ids, y))
            jl.append(float(jm.score_value))
            pl.append(on_jax.score_value)
            al.append(alone.score_value)
    finally:
        torch.set_num_threads(threads)
    print(f"\nJAX {jl}\nport on JAX's weights {pl}\nport alone {al}")
    for j, p in zip(jl, pl):
        assert abs(p - j) <= TOL * abs(j), (jl, pl)
    assert max(jl) > 1.2 * jl[0] and jl[-1] < max(jl), jl
    assert max(al) > 1.2 * al[0], al


def test_the_step_loss_is_data_plus_penalty_plus_aux():
    _, pm = _pair()
    ids = _batches(1, 1)[0]
    y = np.roll(ids, -1, axis=1)
    keys = pm._layer_keys(pm.iteration)
    moe_layers = [l.name for l in pm.conf.layers if type(l).__name__ == "MoELayer"]
    with torch.no_grad():
        out, state = pm._forward(pm.params, pm.net_state, ids, training=True,
                                 keys=keys)
        assert sorted(state) == sorted(moe_layers) == sorted(
            n for n, s in state.items() if AUX_LOSS_KEY in s)
        aux, clean = pop_aux_losses(state)
        assert clean == {} and float(aux) > 0
        data = pm._data_loss(pm.params, out, y, None)
        loss, new_state = pm._step_loss(pm.params, pm.net_state, ids, y, keys=keys)
        assert new_state == {}
        assert float(loss) == float(data + pm._reg_loss(pm.params) + aux)
        # inference emits no aux entry
        assert pm._forward(pm.params, pm.net_state, ids)[1] == {}


def test_moe_checkpoint_zips_cross_both_ways(tmp_path):
    jm, pm = _pair()
    for ids in _batches(2, 2):
        y = np.roll(ids, -1, axis=1)
        jm.fit_batch(JaxDataSet(ids, y))
        pm.fit_batch(DataSet(ids, y))
    jpath, ppath = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    JaxMS.write_model(jm, jpath)
    restored = ModelSerializer.restore(jpath, device="cpu")
    for a, b in zip(jax.tree.leaves(jm.params), tree_leaves(params_to_numpy(restored))):
        np.testing.assert_array_equal(b, np.asarray(a))
    for a, b in zip(jax.tree.leaves(jm.opt_state), state_leaves(restored.opt_state)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    ModelSerializer.write_model(pm, ppath)
    back = JaxMS.restore(ppath)
    for a, b in zip(jax.tree.leaves(back.params), tree_leaves(params_to_numpy(pm))):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert back.iteration == pm.iteration == 2
    ids = _batches(3, 1)[0]
    _close(restored.output(ids).numpy(), np.asarray(jm.output(ids)), "restored output")


def test_generate_refuses_moe_and_self_attention_stacks_as_jax_does():
    jm, pm = _pair()
    prompt = np.arange(5, dtype=np.int32)
    with pytest.raises(ValueError) as jerr:
        jax_generate(jm, prompt, 3)
    with pytest.raises(ValueError) as perr:
        generate(pm, prompt, 3)
    assert str(perr.value) == str(jerr.value) and "MoELayer" in str(perr.value)
    from deeplearning4j_tpu_torch.nn.conf import attention

    jconf = jm.conf
    sa = jax_attention.SelfAttentionLayer(n_out=D, n_heads=HEADS, causal=True,
                                          name="layer3")
    jconf = dataclasses.replace(jconf, layers=jconf.layers[:3] + (sa,)
                                + jconf.layers[4:])
    jm2 = JaxSM(jconf).init()
    pm2 = SequentialModel(SequentialConfiguration.from_json(jconf.to_json()),
                          device="cpu").init()
    assert isinstance(pm2.conf.layers[3], attention.SelfAttentionLayer)
    with pytest.raises(ValueError) as jerr:
        jax_generate(jm2, prompt, 3)
    with pytest.raises(ValueError) as perr:
        generate(pm2, prompt, 3)
    assert str(perr.value) == str(jerr.value)


def test_cost_counts_the_moe_products_and_no_gathers():
    _, pm = _pair()
    ids = _batches(4, 1)[0]
    pm.fit_batch(DataSet(ids, np.roll(ids, -1, axis=1)))
    rec, = [r for r in cost.analyze_model(pm) if r.kind == "train"]
    b, t = ids.shape
    m, dh, h = b * t, D // HEADS, 4 * D
    cap = expert.capacity(expert.MoEConfig(n_experts=EXPERTS, d_model=D, d_hidden=h), m)
    dense = LAYERS * (4 * D * D + 2 * D * 4 * D)
    head = 8 * m * D * (-(-VOCAB // 16) * 16)
    pairs = b * HEADS * t * (t + 1) // 2
    attn = LAYERS * 2 * dh * pairs * (2 + 3 + 4)
    moe = LAYERS * (6 * m * D * EXPERTS + 2 * 6 * EXPERTS * cap * D * h)
    assert rec.flops == 6 * m * dense + head + attn + moe
