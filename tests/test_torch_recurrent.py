"""The recurrent slice (`nn/conf/recurrent.py`, truncated BPTT and
streaming inference in `models/sequential.py`, `zoo/textgen.py`)
against the JAX package, on the CPU, case by case after
`tests/test_recurrent.py`.

Tolerances, f32 on both sides:

- a layer's outputs, final carries and gradients (of ``sum(y * g)`` for
  a fixed random ``g``, with respect to the input and every parameter):
  within 1e-5 of the largest reference element: the same f32 arithmetic,
  with the products summed in another order;
- a model's ``output()`` within 1e-5, and its losses within 1e-5 at
  every step (a loss of ~1.5 sums a few hundred terms);
- parameters after Adam steps as the training tests hold them: all
  within a tenth of the learning rate, 99.9% within 1e-5 (Adam divides
  by sqrt(v) + eps, which turns summation noise on a near-zero gradient
  into a step of up to the rate);
- masks, refusals, window counts, seeded weights, the configuration
  JSON and checkpoint leaves exactly.

The fused stack against the same stack layer by layer within 1e-6 (the
fused product sums ``[h_below; h] @ [Wx; Wh]`` in one pass), and
streamed chunks against the whole sequence within 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models._common import regularization_loss as jax_reg
from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSM
from deeplearning4j_tpu.nn.conf import recurrent as jax_rec
from deeplearning4j_tpu.nn.conf.input_type import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.quant import quantize as jax_quantize
from deeplearning4j_tpu.train.checkpoint import ModelSerializer as JaxMS
from deeplearning4j_tpu.utils import serde as jax_serde
from deeplearning4j_tpu.zoo.textgen import TextGenerationLSTM as JaxTextGen
from deeplearning4j_tpu_torch.convert import params_from_jax, params_to_numpy
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models._common import regularization_loss
from deeplearning4j_tpu_torch.models.sequential import SequentialModel, tree_leaves
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.conf import recurrent as rec
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
    SequentialConfiguration,
)
from deeplearning4j_tpu_torch.quant import is_quantized, quantize
from deeplearning4j_tpu_torch.train import recovery
from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer
from deeplearning4j_tpu_torch.utils import serde
from deeplearning4j_tpu_torch.zoo.textgen import TextGenerationLSTM

torch.set_num_threads(1)

TOL = 1e-5
LR = 5e-3
KEY = jax.random.key(0)


def _close(a, b, tol=TOL, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    err = float(np.abs(a - b).max()) if b.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def _t(a, grad=False):
    return torch.tensor(np.array(a), dtype=torch.float32, requires_grad=grad)


def _pair(jax_layer):
    """The port's layer of the same JSON as ``jax_layer``."""
    return serde.loads(jax_serde.dumps(jax_layer))


# -- the cells -----------------------------------------------------------------

CELLS = {
    "lstm": ("LSTM", dict(n_out=6)),
    "graves": ("GravesLSTM", dict(n_out=5)),
    "graves_forget2_relu": ("GravesLSTM", dict(n_out=4, forget_gate_bias=2.0,
                                                activation="relu")),
    "gru": ("GRU", dict(n_out=6)),
    "simple": ("SimpleRnn", dict(n_out=7, activation="tanh")),
}


def _layer_case(name, masked, seed=0):
    cls, kw = CELLS[name]
    jl = getattr(jax_rec, cls)(name="r", **kw)
    pl = _pair(jl)
    rs = np.random.default_rng(seed)
    B, T, F = 3, 7, 4
    jp, _ = jl.init(KEY, JaxInputType.recurrent(F))
    jp = jax.tree.map(np.asarray, jp)
    # the peepholes and a GRU recurrent bias start at zero: give them values
    jp = {k: (rs.normal(0, 0.3, v.shape).astype(np.float32)
              if k in ("pI", "pF", "pO") else v) for k, v in jp.items()}
    if cls == "GRU":
        jp["bh"] = rs.normal(0, 0.3, (3 * kw["n_out"],)).astype(np.float32)
    x = rs.normal(size=(B, T, F)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[0, 4:] = 0
        mask[1, 2] = 0          # a hole
    carry = tuple(rs.normal(0, 0.5, (B, kw["n_out"])).astype(np.float32)
                  for _ in jl.init_carry(B, jnp.float32))
    g = rs.normal(size=(B, T, kw["n_out"])).astype(np.float32)
    return jl, pl, jp, x, mask, carry, g


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_cell_matches_jax_outputs_carries_and_gradients(name, masked):
    jl, pl, jp, x, mask, carry, g = _layer_case(name, masked)
    jm = None if mask is None else jnp.asarray(mask)

    def f(p, xx, c):
        y, fin = jl.apply_with_carry(p, xx, c, mask=jm)
        return jnp.sum(y * g), (y, fin)

    (_, (jy, jfin)), (gp, gx, gc) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(jp, jnp.asarray(x),
                                              tuple(map(jnp.asarray, carry)))
    pp = {k: _t(v, True) for k, v in jp.items()}
    px, pc = _t(x, True), tuple(_t(c, True) for c in carry)
    y, fin = pl.apply_with_carry(pp, px, pc, mask=None if mask is None else _t(mask))
    (y * _t(g)).sum().backward()
    assert tuple(y.shape) == (3, 7, pl.n_out) and len(fin) == pl.CARRY
    _close(y.detach(), jy, what="y")
    for a, b in zip(fin, jfin):
        _close(a.detach(), b, what="carry")
    _close(px.grad, gx, what="dx")
    for a, b in zip(pc, gc):
        _close(a.grad, b, what="dcarry")
    for k in jp:
        _close(pp[k].grad, gp[k], what=f"d{k}")
    # apply(): from zero carries, the carry dropped
    y0, _ = pl.apply({k: v.detach() for k, v in pp.items()}, {}, px.detach(),
                     mask=None if mask is None else _t(mask))
    jy0 = jax.jit(lambda p, xx: jl.apply(p, {}, xx, mask=jm)[0])(jp, jnp.asarray(x))
    _close(y0, jy0, what="apply")


def test_masked_steps_carry_state_and_zero_output():
    """Outputs at masked steps are zeros, and the carry freezes at the
    mask boundary: the final carry equals the truncated sequence's within
    1e-6."""
    jl, pl, jp, x, _, _, _ = _layer_case("lstm", False)
    p = {k: _t(v) for k, v in jp.items()}
    mask = _t([[1, 1, 1, 0, 0, 0, 0], [1] * 7, [1, 1, 0, 1, 1, 0, 0]])
    y, _ = pl.apply(p, {}, _t(x), mask=mask)
    assert torch.all(y[0, 3:] == 0) and torch.all(y[2, 5:] == 0)
    _, full = pl.apply_with_carry(p, _t(x), pl.init_carry(3, torch.float32),
                                  mask=mask)
    _, trunc = pl.apply_with_carry(p, _t(x)[:, :3], pl.init_carry(3, torch.float32),
                                   mask=mask[:, :3])
    # (the hoisted products of 7 and of 3 steps may block their sums apart)
    _close(full[0][0], trunc[0][0], tol=1e-6)
    _close(full[1][0], trunc[1][0], tol=1e-6)


def test_weights_are_the_jax_packages_bit_for_bit():
    """A cell's init from the same key gives the JAX package's weights
    exactly, here with a forget bias of 1.5 and a uniform init; every
    model below (each cell, the peepholes, Bidirectional's two keys,
    TimeDistributed, ConvLSTM2D) is built from its seed and checked the
    same way (`_both`)."""
    key = jax.random.key(42)
    raw = tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
    for jl in (jax_rec.LSTM(name="a", n_out=5, forget_gate_bias=1.5),
               jax_rec.SimpleRnn(name="d", n_out=6, weight_init="xavier_uniform")):
        jp, _ = jl.init(key, JaxInputType.recurrent(4))
        pp, _ = _pair(jl).init(raw, InputType.recurrent(4), "cpu")
        ja, pa = jax.tree.leaves(jp), tree_leaves(pp)
        assert len(ja) == len(pa)
        for a, b in zip(ja, pa):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert float(pp["b"].max()) == 0.0 and float(_pair(jl).init(
        raw, InputType.recurrent(4), "cpu")[0]["Wh"].abs().max()) > 0


def _jax_dense(n):
    from deeplearning4j_tpu.nn.conf.layers import Dense

    return Dense(n_out=n, activation="relu")


# -- the wrappers ----------------------------------------------------------------

@pytest.mark.parametrize("mode,seqs,masked", [
    ("concat", True, False), ("add", True, True), ("mul", True, False),
    ("ave", True, True), ("concat", False, False), ("concat", False, True)])
def test_bidirectional_matches_jax(mode, seqs, masked):
    jl = jax_rec.Bidirectional(name="bi", layer=jax_rec.LSTM(n_out=4), mode=mode,
                               return_sequences=seqs)
    pl = _pair(jl)
    jp, _ = jl.init(KEY, JaxInputType.recurrent(3))
    jp = jax.tree.map(np.asarray, jp)
    rs = np.random.default_rng(1)
    x = rs.normal(size=(3, 6, 3)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 0, 1, 1, 1, 0], [1] * 6],
                    np.float32) if masked else None
    out_size = pl.output_type(InputType.recurrent(3, 6))
    g = rs.normal(size=(3, 6, out_size.size) if seqs else (3, out_size.size)
                  ).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)

    def f(p, xx):
        y, _ = jl.apply(p, {}, xx, mask=jm)
        return jnp.sum(y * g), y

    (_, jy), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x))
    pp = jax.tree.map(lambda v: _t(v, True), jp)
    px = _t(x, True)
    y, _ = pl.apply(pp, {}, px, mask=None if mask is None else _t(mask))
    (y * _t(g)).sum().backward()
    _close(y.detach(), jy)
    _close(px.grad, gx)
    for half in ("fwd", "bwd"):
        for k in jp[half]:
            _close(pp[half][k].grad, gp[half][k], what=f"{half}/{k}")


def test_bidirectional_last_step_vs_sequences():
    lstm = rec.LSTM(name="i", n_out=3)
    seq = rec.Bidirectional(name="b", layer=lstm, return_sequences=True)
    last = rec.Bidirectional(name="b2", layer=lstm, return_sequences=False)
    params, _ = seq.init((0, 0), InputType.recurrent(4, 6), "cpu")
    x = _t(np.random.default_rng(2).normal(size=(2, 6, 4)))
    ys, _ = seq.apply(params, {}, x)
    yl, _ = last.apply(params, {}, x)
    assert tuple(ys.shape) == (2, 6, 6) and tuple(yl.shape) == (2, 6)
    # the forward half collapses at T-1, the backward half at 0
    assert torch.equal(yl[:, :3], ys[:, -1, :3]) and torch.equal(yl[:, 3:], ys[:, 0, 3:])


def test_last_timestep_non_contiguous_mask():
    layer = rec.LastTimeStep(name="lts")
    x = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    mask = _t([[1, 0, 1, 0], [1, 1, 1, 1]])
    y, _ = layer.apply({}, {}, x, mask=mask)
    assert torch.equal(y[0], x[0, 2]) and torch.equal(y[1], x[1, 3])
    jy, _ = jax_rec.LastTimeStep(name="lts").apply(
        {}, {}, jnp.asarray(x.numpy()), mask=jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_rnn_l2_regularization_not_noop():
    layer = jax_rec.LSTM(n_out=4, name="r", l2=0.1)
    jp, _ = layer.init(KEY, JaxInputType.recurrent(3))
    reg = regularization_loss({"r": jax.tree.map(_t, jp)}, [("r", _pair(layer))])
    assert float(reg) > 0.0
    _close(float(reg), float(jax_reg({"r": jp}, [("r", layer)])))
    # b and the peepholes are not regularized: only Wx and Wh
    want = 0.5 * 0.1 * sum(float((np.asarray(jp[k]) ** 2).sum()) for k in ("Wx", "Wh"))
    assert float(reg) == pytest.approx(want, rel=1e-6)


def test_bidirectional_inner_regularization_counts():
    layer = jax_rec.Bidirectional(layer=jax_rec.LSTM(n_out=4, l2=0.1), name="bi")
    jp, _ = layer.init(KEY, JaxInputType.recurrent(3))
    pl = _pair(layer)
    reg = regularization_loss({"bi": jax.tree.map(_t, jp)}, [("bi", pl)])
    assert float(reg) > 0.0
    _close(float(reg), float(jax_reg({"bi": jp}, [("bi", layer)])))


def test_time_distributed_rejects_rnn_inner():
    with pytest.raises(ValueError, match="feed-forward"):
        rec.TimeDistributed(layer=rec.LSTM(n_out=3))


def test_convlstm2d_matches_jax_with_gradients():
    # VALID at stride (2, 1) here; the model test below runs SAME
    for kw in (dict(n_out=2, kernel=(3, 2), stride=(2, 1), return_sequences=True),):
        jl = jax_rec.ConvLSTM2D(name="c", **kw)
        pl = _pair(jl)
        jp, _ = jl.init(KEY, JaxInputType.convolutional3d(3, 7, 6, 2))
        jp = jax.tree.map(np.asarray, jp)
        rs = np.random.default_rng(3)
        x = rs.normal(size=(2, 3, 7, 6, 2)).astype(np.float32)
        shape = (2,) + pl.output_type(InputType.convolutional3d(3, 7, 6, 2)).shape
        g = rs.normal(size=shape).astype(np.float32)

        def f(p, xx):
            y = jl.apply(p, {}, xx)[0]
            return jnp.sum(y * g), y

        (_, jy), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
        pp = {k: _t(v, True) for k, v in jp.items()}
        px = _t(x, True)
        y, _ = pl.apply(pp, {}, px)
        (y * _t(g)).sum().backward()
        _close(y.detach(), jy)
        _close(px.grad, gx)
        for k in jp:
            _close(pp[k].grad, gp[k], what=k)


# -- models ------------------------------------------------------------------------

def _conf(pkg, layers, input_type, seed=4, tbptt=0, lr=LR, **kw):
    nnc, it = ((JaxNNC, JaxInputType) if pkg == "jax"
               else (NeuralNetConfiguration, InputType))
    from deeplearning4j_tpu.nn.updaters import Adam as JAdam

    b = nnc.builder().seed(seed).updater(
        JAdam(lr) if pkg == "jax" else updaters.Adam(lr))
    if tbptt:
        b = b.tbptt(tbptt)
    b = b.list()
    for layer in layers:
        b = b.layer(layer)
    return b.set_input_type(input_type(it)).build()


def _both(jax_layers, input_type, **kw):
    """The JAX model and the port's of the same configuration (the port's
    from the JAX configuration's JSON: the same weights)."""
    jconf = _conf("jax", jax_layers, input_type, **kw)
    jm = JaxSM(jconf).init()
    pm = SequentialModel(SequentialConfiguration.from_json(jconf.to_json()),
                         device="cpu").init()
    _same_params(pm, jm)
    return jm, pm


def _same_params(pm, jm):
    a = [np.asarray(v) for v in tree_leaves(params_to_numpy(pm))]
    b = [np.asarray(v) for v in jax.tree.leaves(jm.params)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _after_adam(pm, jm, lr=LR):
    a = [np.asarray(v) for v in tree_leaves(params_to_numpy(pm))]
    b = [np.asarray(v) for v in jax.tree.leaves(jm.params)]
    err = np.concatenate([np.abs(x - y).ravel() for x, y in zip(a, b)])
    assert err.max() <= lr / 10, err.max()
    assert np.mean(err <= 1e-5) >= 0.999, np.mean(err <= 1e-5)


def _char_data(V, T, n, seed):
    rs = np.random.default_rng(seed)
    ids = rs.integers(0, V, (n, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _fit_both(jm, pm, batches):
    for b in batches:
        jm.fit_batch(JaxDataSet(*b))
        pm.fit_batch(DataSet(*b))
        _close(pm.score_value, float(jm.score_value), what="loss")
    assert pm.iteration == jm.iteration


def _stack():
    return [jax_rec.GravesLSTM(n_out=7, activation="tanh"), jax_rec.GRU(n_out=6),
            jax_rec.SimpleRnn(n_out=5), jax_rec.LastTimeStep(),
            _jax_out(3)]


def _jax_out(n):
    from deeplearning4j_tpu.nn.conf.layers import OutputLayer

    return OutputLayer(n_out=n, loss="mcxent", activation="softmax")


def test_fused_rnn_stack_matches_jax_and_per_layer():
    """A GravesLSTM-GRU-SimpleRnn stack runs as ONE fused loop in both
    packages; masked ``output()`` and 3 masked training steps match the
    JAX model, and the port's fused stack matches its own per-layer run."""
    rs = np.random.default_rng(9)
    x = rs.normal(0, 1, (8, 12, 5)).astype(np.float32)
    fmask = (np.arange(12)[None, :] < rs.integers(4, 13, 8)[:, None]).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.integers(0, 3, 8)]
    jm, pm = _both(_stack(), lambda it: it.recurrent(5), seed=21, lr=1e-2)
    assert pm._rnn_runs == jm._rnn_runs == {0: 3}
    plain = pm.clone()
    plain._rnn_runs = {}
    _close(pm.output(x, fmask).numpy(), np.asarray(jm.output(x, fmask)))
    _close(pm.output(x, fmask).numpy(), plain.output(x, fmask).numpy(), tol=1e-6)
    assert len(pm.feed_forward(x, fmask)) == 5
    for _ in range(3):
        jm.fit_batch(JaxDataSet(x, y, features_mask=fmask))
        pm.fit_batch(DataSet(x, y, features_mask=fmask))
        plain.fit_batch(DataSet(x, y, features_mask=fmask))
        _close(pm.score_value, float(jm.score_value))
    _after_adam(pm, jm, lr=1e-2)
    for a, b in zip(tree_leaves(pm.params), tree_leaves(plain.params)):
        _close(a.detach(), b.detach(), tol=1e-4)


def test_rnn_run_detection_respects_dropout():
    """Dropout on a non-first member ends a run there; a run's first
    layer may drop out (the fused run draws its mask from that layer's
    key) and trains as the JAX model does, mask for mask."""
    layers = [jax_rec.LSTM(n_out=6, activation="tanh", dropout_rate=0.3),
              jax_rec.LSTM(n_out=6, activation="tanh"),
              jax_rec.LSTM(n_out=6, activation="tanh", dropout_rate=0.5),
              jax_rec.LSTM(n_out=6, activation="tanh"),
              jax_rec.RnnOutputLayer(n_out=3, loss="mcxent", activation="softmax")]
    jm, pm = _both(layers, lambda it: it.recurrent(4), seed=22)
    assert pm._rnn_runs == jm._rnn_runs == {0: 2, 2: 2}
    x, y = _char_data(3, 9, 4, 5)
    x = np.concatenate([x, x[..., :1]], -1)
    _fit_both(jm, pm, [(x, y)] * 2)


@pytest.mark.parametrize("cell", ["LSTM", "GravesLSTM", "GRU", "SimpleRnn"])
def test_sequence_classification_step_matches_jax(cell):
    layers = [getattr(jax_rec, cell)(n_out=8), jax_rec.LastTimeStep(), _jax_out(2)]
    jm, pm = _both(layers, lambda it: it.recurrent(3), seed=1)
    rs = np.random.default_rng(0)
    x = rs.normal(size=(6, 9, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.integers(0, 2, 6)]
    fmask = (np.arange(9)[None, :] < rs.integers(3, 10, 6)[:, None]).astype(np.float32)
    _close(pm.output(x, fmask).numpy(), np.asarray(jm.output(x, fmask)))
    for _ in range(2):
        jm.fit_batch(JaxDataSet(x, y, features_mask=fmask))
        pm.fit_batch(DataSet(x, y, features_mask=fmask))
        _close(pm.score_value, float(jm.score_value))
    _after_adam(pm, jm)


def test_time_distributed_and_bidirectional_train_as_jax():
    from deeplearning4j_tpu.nn.conf.layers import Dense

    layers = [jax_rec.TimeDistributed(layer=Dense(n_out=8, activation="relu")),
              jax_rec.Bidirectional(layer=jax_rec.LSTM(n_out=5), mode="concat"),
              jax_rec.LastTimeStep(), _jax_out(2)]
    jm, pm = _both(layers, lambda it: it.recurrent(4, 5), seed=0)
    rs = np.random.default_rng(0)
    x = rs.normal(size=(6, 5, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.integers(0, 2, 6)]
    assert tuple(pm.output(x).shape) == (6, 2)
    _fit_both(jm, pm, [(x, y)] * 3)
    _after_adam(pm, jm)


def test_convlstm2d_model_trains_as_jax():
    from deeplearning4j_tpu.nn.conf.layers import GlobalPooling

    layers = [jax_rec.ConvLSTM2D(n_out=4, kernel=(3, 3), padding="same"),
              GlobalPooling(), _jax_out(3)]
    jm, pm = _both(layers, lambda it: it.convolutional3d(4, 6, 6, 2), seed=0)
    rs = np.random.default_rng(1)
    x = rs.normal(size=(2, 4, 6, 6, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.integers(0, 3, 2)]
    _close(pm.output(x).numpy(), np.asarray(jm.output(x)))
    _fit_both(jm, pm, [(x, y)] * 2)


# -- truncated BPTT ----------------------------------------------------------------

def _char_rnn(cell="GravesLSTM", tbptt=8, hidden=10, V=4, seed=11, dropout=None):
    layers = [getattr(jax_rec, cell)(n_out=hidden, activation="tanh",
                                     dropout_rate=dropout),
              jax_rec.RnnOutputLayer(n_out=V, loss="mcxent", activation="softmax")]
    return _both(layers, lambda it: it.recurrent(V), seed=seed, tbptt=tbptt)


@pytest.mark.parametrize("T,windows", [(16, 2), (21, 3), (5, 1)])
def test_tbptt_windows_and_remainder_match_jax(T, windows):
    """T 16 in windows of 8: 2 steps a batch; T 21: 2 full windows and a
    remainder of 5; T 5: one short window.  Losses of 2 batches and the
    parameters after them match the JAX model's."""
    jm, pm = _char_rnn()
    batches = [_char_data(4, T, 8, s) for s in (7, 8)]
    seen = []
    pm.add_listener(type("L", (), {
        "iteration_done": lambda self, m, it, ep, score: seen.append(it),
        "on_epoch_start": lambda *a: None, "on_epoch_end": lambda *a: None})())
    _fit_both(jm, pm, batches)
    assert pm.iteration == 2 * windows and seen == list(range(1, 2 * windows + 1))
    assert ("train_tbptt", False, False) in pm._step_fns
    _after_adam(pm, jm)


def test_tbptt_dropout_keys_a_window_match_jax():
    """Window i of the fit draws its dropout from step iteration + i, as
    the JAX window scan's counter does: the losses agree step by step."""
    jm, pm = _char_rnn(cell="LSTM", dropout=0.3, seed=3)
    _fit_both(jm, pm, [_char_data(4, 16, 6, 1), _char_data(4, 16, 6, 2)])
    _after_adam(pm, jm)


def test_tbptt_variable_length_masked_batch_matches_jax():
    """Features and labels masks of random lengths (numpy seed 1) through
    the windows match the JAX model; the recurrent layer outputs zeros at
    masked steps (``feed_forward``; the head adds its bias after it)."""
    jm, pm = _char_rnn(cell="LSTM")
    x, y = _char_data(4, 16, 6, 4)
    rs = np.random.default_rng(1)
    m = (np.arange(16)[None, :] < rs.integers(3, 17, 6)[:, None]).astype(np.float32)
    for _ in range(2):
        jm.fit_batch(JaxDataSet(x, y, features_mask=m, labels_mask=m))
        pm.fit_batch(DataSet(x, y, features_mask=m, labels_mask=m))
        _close(pm.score_value, float(jm.score_value))
    assert ("train_tbptt", True, True) in pm._step_fns
    _after_adam(pm, jm)
    hidden = pm.feed_forward(x, m)[0].numpy()
    assert np.all(hidden[m == 0] == 0) and np.any(hidden[m == 1] != 0)


def test_tbptt_grouped_matches_per_batch_and_jax():
    """fit(steps_per_execution=4) runs 4 batches x 2 windows as one
    program, the carries zeroed at each batch boundary: the parameters
    and iteration equal batch-by-batch fitting's, and the JAX grouped
    program's."""
    jm, pm = _char_rnn(seed=31)
    x, y = _char_data(4, 16, 64, 13)
    batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    ref = pm.clone()
    for b in batches:
        ref.fit_batch(DataSet(*b))
    jm.fit([JaxDataSet(*b) for b in batches], epochs=1, steps_per_execution=4)
    pm.fit([DataSet(*b) for b in batches], epochs=1, steps_per_execution=4)
    assert pm.iteration == ref.iteration == jm.iteration == 8
    assert ("train_tbptt_grouped",) in pm._step_fns
    assert ("train_tbptt_grouped",) not in ref._step_fns
    for a, b in zip(tree_leaves(pm.params), tree_leaves(ref.params)):
        assert torch.equal(a, b)
    _after_adam(pm, jm)


def test_grouped_tbptt_falls_back_where_jax_does():
    """A masked batch, or T not a multiple of the window, steps the group
    batch by batch: no grouped program, the same iterations."""
    _, pm = _char_rnn()
    x, y = _char_data(4, 12, 8, 2)
    m = np.ones((8, 12), np.float32)
    pm.fit([DataSet(x, y), DataSet(x, y, features_mask=m)], steps_per_execution=2)
    pm.fit([DataSet(x, y), DataSet(x, y)], steps_per_execution=2)   # T 12 % 8
    assert pm.iteration == 4 * 2
    assert ("train_tbptt_grouped",) not in pm._step_fns


def test_tbptt_refusals_carry_the_jax_messages():
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer

    def model(layers, it):
        return SequentialModel(_conf("port", layers, it, tbptt=4), device="cpu").init()

    seq2one = model([rec.LSTM(n_out=4), rec.LastTimeStep(), OutputLayer(n_out=12)],
                    lambda it: it.recurrent(2))
    # 12 classes == T: a shape-only check would pass it
    with pytest.raises(ValueError, match="per-timestep output"):
        seq2one.fit_batch(DataSet(np.zeros((2, 12, 2), np.float32),
                                  np.eye(12, dtype=np.float32)[[0, 1]]))
    bi = model([rec.Bidirectional(layer=rec.LSTM(n_out=4)),
                rec.RnnOutputLayer(n_out=2)], lambda it: it.recurrent(3))
    with pytest.raises(ValueError, match="bidirectional"):
        bi.fit_batch(DataSet(np.zeros((2, 8, 3), np.float32),
                             np.zeros((2, 8, 2), np.float32)))
    flat = model([rec.LSTM(n_out=4), rec.RnnOutputLayer(n_out=2)],
                 lambda it: it.recurrent(3))
    with pytest.raises(ValueError, match="per-timestep labels"):
        flat.fit_batch(DataSet(np.zeros((2, 8, 3), np.float32),
                               np.zeros((2, 2), np.float32)))
    assert seq2one.iteration == bi.iteration == flat.iteration == 0


def test_tbptt_recovery_resets_the_carries(monkeypatch):
    """A rollback and an OOM split each reset the model's carries."""
    _, pm = _char_rnn()
    calls = []
    monkeypatch.setattr(pm, "_reset_carries", lambda: calls.append(1))
    recovery._reset_carries(pm)
    assert calls == [1]
    policy = recovery.RecoveryPolicy(None, max_split=4)
    real, n = pm.fit_batch, [0]

    def flaky(b):
        n[0] += 1
        if n[0] == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        real(b)

    monkeypatch.setattr(pm, "fit_batch", flaky)
    policy.attach(pm)
    policy.run_step(pm, DataSet(*_char_data(4, 8, 4, 0)))
    assert calls == [1, 1] and pm.iteration == 2      # two pieces of one window


# -- streaming ---------------------------------------------------------------------

def test_streaming_equals_full_sequence_and_jax():
    layers = [jax_rec.GravesLSTM(n_out=6, activation="tanh"),
              jax_rec.LSTM(n_out=5, activation="tanh"),
              jax_rec.RnnOutputLayer(n_out=3, loss="mcxent", activation="softmax")]
    jm, pm = _both(layers, lambda it: it.recurrent(2), seed=4)
    x = np.random.default_rng(0).normal(size=(2, 8, 2)).astype(np.float32)
    full = pm.output(x).numpy()
    jm.rnn_clear_previous_state()
    parts = [pm.rnn_time_step(x[:, i:i + 2]).numpy() for i in range(0, 8, 2)]
    jparts = [np.asarray(jm.rnn_time_step(x[:, i:i + 2])) for i in range(0, 8, 2)]
    _close(np.concatenate(parts, 1), full, tol=1e-6)
    _close(np.concatenate(parts, 1), np.concatenate(jparts, 1))
    assert ("rnn_step",) in pm._step_fns
    pm.rnn_clear_previous_state()
    again = [pm.rnn_time_step(x[:, i:i + 1]).numpy() for i in range(8)]
    _close(np.concatenate(again, 1), full, tol=1e-6)
    with pytest.raises(ValueError, match="rnn_clear_previous_state"):
        pm.rnn_time_step(x[:1, :1])


def test_rnn_time_step_rejects_bidirectional():
    conf = _conf("port", [rec.Bidirectional(layer=rec.LSTM(n_out=4)),
                          rec.RnnOutputLayer(n_out=2)], lambda it: it.recurrent(3))
    m = SequentialModel(conf, device="cpu").init()
    with pytest.raises(ValueError, match="bidirectional"):
        m.rnn_time_step(np.zeros((1, 2, 3), np.float32))


# -- the char-RNN: zoo, quantization, JSON, checkpoints ----------------------------

def _textgen(pkg):
    kw = dict(vocab_size=10, hidden=16, tbptt_length=5)
    return JaxTextGen(**kw) if pkg == "jax" else TextGenerationLSTM(**kw)


def test_textgen_zoo_has_the_jax_weights_and_trains_as_jax():
    jm = _textgen("jax").init_model()
    pm = _textgen("port").init_model(device="cpu")
    assert pm.conf == SequentialConfiguration.from_json(jm.conf.to_json())
    assert pm._rnn_runs == {0: 2}
    _same_params(pm, jm)
    assert tuple(pm.output(np.zeros((2, 7, 10), np.float32)).shape) == (2, 7, 10)
    # T 13 in windows of 5: 2 + a remainder of 3
    _fit_both(jm, pm, [_char_data(10, 13, 4, s) for s in (0, 1)])
    assert pm.iteration == 6
    _after_adam(pm, jm, lr=1e-2)


def test_quantized_char_rnn_matches_jax():
    """`quantize` makes the head's W int8 and leaves the gates f32, as the
    JAX package does; ``output()`` and ``rnn_time_step`` agree with the
    JAX quantized model's."""
    jm = _textgen("jax").init_model()
    pm = _textgen("port").init_model(device="cpu")
    jq, pq = jax_quantize(jm), quantize(pm)
    assert is_quantized(pq) and not is_quantized(pm)
    assert pq.params["layer2"]["W"].q.dtype == torch.int8
    assert all(isinstance(v, torch.Tensor) for n in ("layer0", "layer1")
               for v in pq.params[n].values())
    for a, b in zip(tree_leaves(params_to_numpy(pq)), jax.tree.leaves(jq.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x, _ = _char_data(10, 6, 3, 2)
    _close(pq.output(x).numpy(), np.asarray(jq.output(x)))
    steps = [pq.rnn_time_step(x[:, i:i + 1]).numpy() for i in range(6)]
    jsteps = [np.asarray(jq.rnn_time_step(x[:, i:i + 1])) for i in range(6)]
    _close(np.concatenate(steps, 1), np.concatenate(jsteps, 1))
    _close(np.concatenate(steps, 1), pq.output(x).numpy(), tol=1e-6)


RECURRENT_TAGS = ["LSTM", "GravesLSTM", "GRU", "SimpleRnn", "Bidirectional",
                  "LastTimeStep", "TimeDistributed", "ConvLSTM2D"]


def test_every_recurrent_tag_and_tbptt_round_trip_their_json_both_ways():
    from deeplearning4j_tpu.nn.conf.layers import Dense

    layers = [jax_rec.TimeDistributed(layer=Dense(n_out=6)),
              jax_rec.LSTM(n_out=5, forget_gate_bias=2.0, gate_activation="hardsigmoid"),
              jax_rec.GravesLSTM(n_out=5, l2=1e-3),
              jax_rec.GRU(n_out=4), jax_rec.SimpleRnn(n_out=4, dropout_rate=0.1),
              jax_rec.Bidirectional(layer=jax_rec.LSTM(n_out=3), mode="ave",
                                    return_sequences=True),
              jax_rec.LastTimeStep(), _jax_out(2)]
    jconf = _conf("jax", layers, lambda it: it.recurrent(4), tbptt=7)
    conf = SequentialConfiguration.from_json(jconf.to_json())
    assert {type(l).__name__ for l in conf.layers} >= set(RECURRENT_TAGS) - {"ConvLSTM2D"}
    assert (conf.backprop_type, conf.tbptt_length) == ("tbptt", 7)
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    assert conf.layers[1].gate_activation.value == "hardsigmoid"
    SequentialModel(conf, device="cpu").init()
    cl = jax_rec.ConvLSTM2D(name="c", n_out=3, kernel=(3, 3), stride=(2, 2))
    assert json.loads(serde.dumps(_pair(cl))) == json.loads(jax_serde.dumps(cl))
    assert not set(RECURRENT_TAGS) & set(serde.UNPORTED)


def _leaves(tree):
    return [np.asarray(v) for v in tree]


def test_jax_zip_restores_and_resumes_in_the_port(tmp_path):
    """A TextGenerationLSTM zip the JAX package wrote after 2 TBPTT batches
    (and a Bidirectional model's: nested ``fwd`` / ``bwd``): parameters,
    Adam state (keys sorted: Wh, Wx, b, pF, pI, pO) and counters bit for
    bit, then 2 more batches' losses match."""
    jm = _textgen("jax").init_model()
    for s in (0, 1):
        jm.fit_batch(JaxDataSet(*_char_data(10, 10, 4, s)))
    path = str(tmp_path / "jax.zip")
    JaxMS.write_model(jm, path)
    pm = ModelSerializer.restore(path, device="cpu")
    assert pm.iteration == 4 and sorted(pm.params["layer0"]) == [
        "Wh", "Wx", "b", "pF", "pI", "pO"]
    for a, b in zip(_leaves(tree_leaves(params_to_numpy(pm))),
                    _leaves(jax.tree.leaves(jm.params))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(updaters.state_leaves(pm.opt_state), jax.tree.leaves(jm.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _fit_both(jm, pm, [_char_data(10, 10, 4, s) for s in (2, 3)])
    # a Bidirectional tree
    jb, _ = _both([jax_rec.Bidirectional(layer=jax_rec.GravesLSTM(n_out=3)),
                   jax_rec.LastTimeStep(), _jax_out(2)], lambda it: it.recurrent(2))
    x = np.random.default_rng(0).normal(size=(3, 4, 2)).astype(np.float32)
    jb.fit_batch(JaxDataSet(x, np.eye(2, dtype=np.float32)[[0, 1, 0]]))
    JaxMS.write_model(jb, path)
    pb = ModelSerializer.restore(path, device="cpu")
    assert sorted(pb.params["layer0"]) == ["bwd", "fwd"]
    for a, b in zip(updaters.state_leaves(pb.opt_state), jax.tree.leaves(jb.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _close(pb.output(x).numpy(), np.asarray(jb.output(x)))


def test_port_zip_restores_and_resumes_in_jax(tmp_path):
    pm = _textgen("port").init_model(device="cpu")
    for s in (0, 1):
        pm.fit_batch(DataSet(*_char_data(10, 10, 4, s)))
    path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(pm, path)
    assert not os.path.exists(path + ".tmp")
    jm = JaxMS.restore(path)
    assert jm.iteration == 4 and jm.conf == _textgen("jax").conf()
    for a, b in zip(_leaves(jax.tree.leaves(jm.params)),
                    _leaves(tree_leaves(params_to_numpy(pm)))):
        np.testing.assert_array_equal(a, b)
    _fit_both(jm, pm, [_char_data(10, 10, 4, s) for s in (2, 3)])


def test_params_from_jax_takes_the_recurrent_trees():
    jm, pm = _both([jax_rec.Bidirectional(layer=jax_rec.GRU(n_out=3)),
                    jax_rec.RnnOutputLayer(n_out=2)], lambda it: it.recurrent(2))
    trained = jax.tree.map(lambda v: np.asarray(v) + 0.25, jm.params)
    params_from_jax(trained, pm)
    for a, b in zip(tree_leaves(params_to_numpy(pm)), jax.tree.leaves(trained)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_tbptt_and_stream_programs_count_their_work():
    """The window step registers as ``("train_tbptt", lmask, fmask)`` and
    the stream as ``("rnn_step",)`` (the JAX package's keys); a batch's
    dispatch counts its windows' work (W x a window's FLOPs)."""
    from deeplearning4j_tpu_torch.observe import cost
    from deeplearning4j_tpu_torch.observe.metrics import registry

    _, pm = _char_rnn()
    pm.fit_batch(DataSet(*_char_data(4, 16, 4, 0)))
    pm.rnn_time_step(_char_data(4, 3, 4, 1)[0])
    recs = {r.kind: r for r in cost.analyze_model(pm)}
    assert set(recs) == {"train_tbptt", "rnn_step"}
    window = recs["train_tbptt"]
    assert window.key == repr(("train_tbptt", False, False))
    assert window.flops > 0 and window.dispatches == 2 and recs["rnn_step"].flops > 0
    counter = registry().counter("dl4jtpu_step_model_flops_total")
    before = counter.value()
    pm.fit_batch(DataSet(*_char_data(4, 16, 4, 2)))
    assert counter.value() - before == pytest.approx(2 * window.flops)
    assert window.dispatches == 4


class _StandInGraph:
    """A stand-in `CapturedProgram` for the card's window path on the CPU:
    its warm-up runs ``fn`` as the real one does; a replay runs it again
    as if capturing, and returns that run's outputs (a real graph
    overwrites its static outputs in place)."""

    capturing = False

    def __init__(self, fn, inputs, *, keep=(), pool=None, stream=None):
        import types

        self.fn, self.inputs = fn, tuple(inputs)
        self.stream = object()
        self.graph = types.SimpleNamespace(pool=lambda: None)
        self.warmup_outputs = self.outputs = fn(*self.inputs)

    def replay(self):
        _StandInGraph.capturing = True
        try:
            self.outputs = self.fn(*self.inputs)
        finally:
            _StandInGraph.capturing = False
        return self.outputs


def test_the_cards_window_path_replays_as_it_runs_eagerly(monkeypatch):
    """The card's TBPTT path on the CPU with stand-in graphs: staged
    inputs, one graph a window signature (the remainder window its own),
    carries copied between replays and zeroed at each batch's first
    window (poisoned with NaN between batches here), counts advanced
    once a window.  Against its eager form (``capture_steps = False``):
    the same losses, parameters and Adam state, bit for bit; against the
    CPU path (Python step values, not staged f32 ones) within 1e-6."""
    from deeplearning4j_tpu_torch.runtime import graphs

    monkeypatch.setattr(graphs, "CapturedProgram", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: _StandInGraph.capturing)
    _, base = _char_rnn()
    x, y = _char_data(4, 21, 12, 3)      # T 21: windows of 8, 8 and 5
    batches = [DataSet(x[i:i + 4], y[i:i + 4]) for i in (0, 4, 8)]
    ref, graph, eager = base.clone(), base.clone(), base.clone()
    eager.capture_steps = False
    for m in (graph, eager):
        monkeypatch.setattr(m, "_tbptt_eager", m._tbptt_cuda)
    for b in batches:
        for m in (ref, graph, eager):
            m.fit_batch(b)
        assert torch.equal(graph._last_score, eager._last_score)
        _close(graph._last_score, ref._last_score, tol=1e-6)
        for prog in graph._captured.values():
            for t in prog.inputs[4:4 + len(prog.outputs[0])]:
                t.fill_(float("nan"))
    assert len(graph._captured) == 2 and not eager._captured
    assert graph.iteration == eager.iteration == ref.iteration == 9
    for a, b in zip(tree_leaves(graph.params), tree_leaves(eager.params)):
        assert torch.equal(a, b)
    for a, b in zip(updaters.state_leaves(graph.opt_state),
                    updaters.state_leaves(eager.opt_state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert [int(a) for a in updaters.state_leaves(graph.opt_state)
            if not isinstance(a, torch.Tensor)] == [9, 9]
    for a, b in zip(tree_leaves(graph.params), tree_leaves(ref.params)):
        _close(a.detach(), b.detach(), tol=1e-6)
