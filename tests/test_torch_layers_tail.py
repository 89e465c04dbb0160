"""The long tail's layers (`nn/conf/layers.py`: `LossLayer`, `ScaleShift`,
`SeparableConv2D`, `Deconv2D`, `SpaceToDepth`, `Upsampling2D`,
`LocalResponseNormalization`, `CenterLossOutputLayer`) against the JAX
package's, on the CPU.

Each layer's ``apply`` runs on the same parameters and input as the JAX
layer's (numpy seeds), in f32, with its gradient of ``sum(y * g)`` for a
fixed random ``g`` with respect to the input and every parameter.
Outputs and gradients must agree within 1e-5 of the largest reference
element (the same f32 arithmetic in another order); initial parameters
bit for bit.  `Deconv2D` runs every case of ``lax.conv_transpose``'s
padding (k = s, k > s, k < s, odd k, SAME and VALID), `SeparableConv2D`
depth multipliers 1 and 2 at strides 1 and 2.  The center loss and its
gradients are held to JAX's, the centers' gradient scaled by alpha.
Every tag this slice ports (the eight layers, `Yolo2OutputLayer`,
`AutoEncoder`, `VariationalAutoencoder`) writes the JAX package's JSON
and reads back in both packages.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf import objdetect as jax_objdetect
from deeplearning4j_tpu.nn.conf import pretrain as jax_pretrain
from deeplearning4j_tpu.nn.conf.input_type import InputType as JaxInputType
from deeplearning4j_tpu.utils import serde as jax_serde
from deeplearning4j_tpu_torch.nn.conf import layers, objdetect, pretrain
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.runtime import rng
from deeplearning4j_tpu_torch.utils import serde

torch.set_num_threads(1)

TOL = 1e-5

CASES = {
    "loss_layer": ("LossLayer", dict(loss="mse", activation="tanh"), (4, 6)),
    "scale_shift": ("ScaleShift", dict(scale=0.5, shift=-1.0, activation="tanh"),
                    (2, 5, 4, 3)),
    "sep_m1_same": ("SeparableConv2D", dict(n_out=5, padding="same"), (2, 7, 6, 3)),
    "sep_m2_same_stride2": ("SeparableConv2D", dict(n_out=4, stride=(2, 2),
                                                    padding="same", depth_multiplier=2,
                                                    activation="relu"), (2, 7, 8, 3)),
    "sep_m1_same_stride2": ("SeparableConv2D", dict(n_out=4, stride=(2, 2), padding="same"),
                            (2, 8, 8, 2)),
    "sep_m2_valid_even": ("SeparableConv2D", dict(n_out=3, kernel=(2, 3), padding="valid",
                                                  depth_multiplier=2, has_bias=False),
                          (2, 6, 7, 2)),
    "deconv_k2_s2_valid": ("Deconv2D", dict(n_out=3), (2, 4, 5, 3)),
    "deconv_k2_s2_same": ("Deconv2D", dict(n_out=3, padding="same"), (2, 4, 5, 3)),
    "deconv_k3_s2_valid": ("Deconv2D", dict(n_out=3, kernel=(3, 3)), (2, 4, 5, 2)),
    "deconv_k3_s2_same": ("Deconv2D", dict(n_out=3, kernel=(3, 3), padding="same"),
                          (2, 4, 5, 2)),
    "deconv_k4_s2_same": ("Deconv2D", dict(n_out=2, kernel=(4, 4), padding="same",
                                           activation="relu"), (2, 3, 4, 3)),
    "deconv_k4_s2_valid": ("Deconv2D", dict(n_out=2, kernel=(4, 4)), (2, 3, 4, 3)),
    "deconv_k1_s2_valid": ("Deconv2D", dict(n_out=2, kernel=(1, 1)), (2, 3, 4, 3)),
    "deconv_k1_s2_same": ("Deconv2D", dict(n_out=2, kernel=(1, 1), padding="same"),
                          (2, 3, 4, 3)),
    "deconv_k2_s3_valid": ("Deconv2D", dict(n_out=2, kernel=(2, 2), stride=(3, 3)),
                           (2, 3, 3, 2)),
    "deconv_k3_s1_same": ("Deconv2D", dict(n_out=4, kernel=(3, 3), stride=(1, 1),
                                           padding="same"), (2, 5, 4, 3)),
    "deconv_k3_s1_valid": ("Deconv2D", dict(n_out=4, kernel=(3, 3), stride=(1, 1),
                                            has_bias=False), (2, 5, 4, 3)),
    "deconv_k5x3_s2x1_same": ("Deconv2D", dict(n_out=2, kernel=(5, 3), stride=(2, 1),
                                               padding="same"), (2, 4, 5, 2)),
    "space_to_depth_2": ("SpaceToDepth", dict(), (2, 4, 6, 3)),
    "space_to_depth_3": ("SpaceToDepth", dict(block=3), (1, 6, 3, 2)),
    "upsampling2d": ("Upsampling2D", dict(size=(2, 3)), (2, 3, 4, 2)),
    "lrn": ("LocalResponseNormalization", dict(), (2, 4, 4, 7)),
    "lrn_wide": ("LocalResponseNormalization", dict(n=3, k=1.0, alpha=0.5, beta=0.5),
                 (2, 3, 3, 4)),
    "center_loss_apply": ("CenterLossOutputLayer", dict(n_out=3), (4, 6)),
}


def _itype(shape):
    if len(shape) == 4:
        return JaxInputType.convolutional(*shape[1:]), InputType.convolutional(*shape[1:])
    return JaxInputType.feed_forward(shape[1]), InputType.feed_forward(shape[1])


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} of max {scale:.3e}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_the_jax_layer(case):
    cls, kw, shape = CASES[case]
    jl, pl = getattr(jax_layers, cls)(**kw), getattr(layers, cls)(**kw)
    jit_, pit = _itype(shape)
    assert pl.output_type(pit).shape == jl.output_type(jit_).shape
    seed = sorted(CASES).index(case)
    jp, js = jl.init(jax.random.key(seed), jit_)
    pp, ps = pl.init(rng.key(seed), pit, "cpu")
    assert not js and not ps
    assert sorted(jp) == sorted(pp)
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jp[k]), pp[k].numpy())
    r = np.random.default_rng(100 + seed)
    params = _tree(lambda a: (np.asarray(a) + r.normal(scale=0.1, size=a.shape)
                              ).astype(np.float32), jp)
    x = r.normal(size=shape).astype(np.float32)
    shape_y = jax.eval_shape(lambda xx: jl.apply(jp, {}, xx)[0], jnp.asarray(x)).shape
    assert tuple(shape_y[1:]) == tuple(pl.output_type(pit).shape)
    g = r.normal(size=shape_y).astype(np.float32)

    def jax_fn(p, xx):
        y, _ = jl.apply(p, {}, xx, training=True)
        return jnp.sum(y * g), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True))(
        _tree(jnp.asarray, params), jnp.asarray(x))
    tp = _tree(lambda a: torch.tensor(a, requires_grad=True), params)
    tx = torch.tensor(x, requires_grad=True)
    ty, _ = pl.apply(tp, {}, tx, training=True)
    (ty * torch.from_numpy(g)).sum().backward()
    _close(ty.detach().numpy(), jy, f"{case} output")
    _close(tx.grad.numpy(), jgx, f"{case} input gradient")
    for k in params:
        if k == "centers":     # apply() never reads them; the loss does
            assert tp[k].grad is None
            continue
        _close(tp[k].grad.numpy(), jgp[k], f"{case} d/d{k}")


def test_space_to_depth_orders_channels_as_jax_and_not_as_pixel_unshuffle():
    """Output channel (bi b + bj) C + c holds input (b i + bi, b j + bj, c)."""
    n, h, w, c, b = 1, 4, 6, 3, 2
    x = torch.arange(n * h * w * c, dtype=torch.float32).reshape(n, h, w, c)
    y, _ = layers.SpaceToDepth(block=b).apply({}, {}, x)
    for bi in range(b):
        for bj in range(b):
            for ch in range(c):
                assert torch.equal(y[0, :, :, (bi * b + bj) * c + ch],
                                   x[0, bi::b, bj::b, ch])
    jy, _ = jax_layers.SpaceToDepth(block=b).apply({}, {}, jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    unshuffled = torch.nn.functional.pixel_unshuffle(x.permute(0, 3, 1, 2), b)
    assert not torch.equal(unshuffled.permute(0, 2, 3, 1), y)


def test_lrn_is_the_jax_formula_and_not_torchs():
    """x / (k + alpha sum x^2)^beta over n zero-padded channels, against
    the formula in numpy (f64); `F.local_response_norm` (alpha / n, and
    its own padding) is another function."""
    r = np.random.default_rng(5)
    x = r.normal(size=(2, 3, 3, 6)).astype(np.float32)
    lrn = layers.LocalResponseNormalization(k=1.5, n=3, alpha=0.3, beta=0.6)
    y, _ = lrn.apply({}, {}, torch.from_numpy(x))
    sq = np.pad(x.astype(np.float64) ** 2, ((0, 0), (0, 0), (0, 0), (1, 1)))
    s = sum(sq[..., i:i + 6] for i in range(3))
    want = x / (1.5 + 0.3 * s) ** 0.6
    _close(y.numpy(), want, "lrn", tol=1e-6)
    theirs = torch.nn.functional.local_response_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2), 3, alpha=0.3, beta=0.6, k=1.5)
    assert not torch.allclose(theirs.permute(0, 2, 3, 1), y, atol=1e-3)


@pytest.mark.parametrize("alpha", [0.1, 1.0])
def test_center_loss_and_gradients_match_jax(alpha):
    """The loss of the concatenated output against one-hot labels (with
    and without a mask), and its gradients for the centers and the
    output; the centers' gradient is alpha times the gradient at
    alpha 1."""
    kw = dict(n_out=3, alpha=alpha, lambda_coeff=0.5)
    jl, pl = jax_layers.CenterLossOutputLayer(**kw), layers.CenterLossOutputLayer(**kw)
    r = np.random.default_rng(7)
    params = {"W": r.normal(size=(5, 3)).astype(np.float32),
              "b": r.normal(size=3).astype(np.float32),
              "centers": r.normal(size=(3, 5)).astype(np.float32)}
    preds = r.normal(size=(6, 8)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[r.integers(0, 3, 6)]
    mask = (r.random(6) > 0.3).astype(np.float32)
    for m in (None, mask):
        jloss, (jgp, jgo) = jax.jit(jax.value_and_grad(
            lambda p, o: jl.compute_loss_with_params(
                p, o, jnp.asarray(labels), None if m is None else jnp.asarray(m)),
            argnums=(0, 1)))(_tree(jnp.asarray, params), jnp.asarray(preds))
        tp = _tree(lambda a: torch.tensor(a, requires_grad=True), params)
        to = torch.tensor(preds, requires_grad=True)
        loss = pl.compute_loss_with_params(tp, to, torch.from_numpy(labels),
                                           None if m is None else torch.from_numpy(m))
        loss.backward()
        _close(loss.item(), float(jloss), "center loss")
        _close(to.grad.numpy(), jgo, "d/d output")
        _close(tp["centers"].grad.numpy(), jgp["centers"], "d/dcenters")
        for k in ("W", "b"):      # the loss reads the output, not the head's weights
            assert tp[k].grad is None and not np.asarray(jgp[k]).any()
    grads = []
    for layer in (pl, layers.CenterLossOutputLayer(n_out=3, alpha=1.0, lambda_coeff=0.5)):
        c = torch.tensor(params["centers"], requires_grad=True)
        layer.compute_loss_with_params({"centers": c}, torch.from_numpy(preds),
                                       torch.from_numpy(labels)).backward()
        grads.append(c.grad.numpy())
    _close(grads[0], alpha * grads[1], "centers' gradient / alpha", tol=1e-6)
    logits, emb = pl.split_output(torch.from_numpy(preds))
    assert logits.shape == (6, 3) and emb.shape == (6, 5)
    probs = pl.evaluation_output({}, torch.from_numpy(preds))
    np.testing.assert_allclose(probs.numpy(), np.asarray(
        jl.evaluation_output({}, jnp.asarray(preds))), rtol=1e-6, atol=1e-7)


JSON_CASES = {
    **{case: (getattr(jax_layers, cls), getattr(layers, cls), kw)
       for case, (cls, kw, _) in CASES.items()},
    "yolo2": (jax_objdetect.Yolo2OutputLayer, objdetect.Yolo2OutputLayer,
              dict(anchors=((1.0, 1.5), (2.5, 2.0)), num_classes=3, lambda_coord=4.0)),
    "autoencoder": (jax_pretrain.AutoEncoder, pretrain.AutoEncoder,
                    dict(n_out=7, corruption_level=0.2, sparsity=0.05,
                         sparsity_beta=0.1, loss="xent")),
    "vae": (jax_pretrain.VariationalAutoencoder, pretrain.VariationalAutoencoder,
            dict(n_out=4, encoder_layer_sizes=(16, 8), decoder_layer_sizes=(8,),
                 reconstruction_distribution="bernoulli", num_samples=2,
                 pzx_activation="tanh")),
}


@pytest.mark.parametrize("case", sorted(JSON_CASES))
def test_layer_json_is_the_jax_layers(case):
    """The port writes the JAX layer's JSON, and each package reads the
    other's back to a configuration of the same class that writes the
    same JSON again."""
    jcls, pcls, kw = JSON_CASES[case]
    jl, pl = jcls(name="l0", **kw), pcls(name="l0", **kw)
    pj, jj = serde.dumps(pl), jax_serde.dumps(jl)
    assert json.loads(pj) == json.loads(jj)
    ours, theirs = serde.loads(jj), jax_serde.loads(pj)
    assert type(ours) is pcls and type(theirs) is jcls
    assert ours == pl
    assert json.loads(serde.dumps(ours)) == json.loads(jj)
    assert json.loads(jax_serde.dumps(theirs)) == json.loads(pj)


def test_separable_and_transposed_kernels_are_quantizable():
    """SeparableConv2D's two kernels and Deconv2D's quantize (per output
    channel) as the JAX package's do."""
    from deeplearning4j_tpu_torch.quant.ptq import _quant_spec

    assert _quant_spec(layers.SeparableConv2D(n_out=2)) == {"": ("depthW", "pointW")}
    assert _quant_spec(layers.Deconv2D(n_out=2)) == {"": ("W",)}
    assert _quant_spec(layers.SpaceToDepth()) == {}
