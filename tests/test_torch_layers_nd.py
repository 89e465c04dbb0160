"""The N-d layers of the ResNet-50 slice (`nn/conf/layers_nd.py`,
`ZeroPadding2D`, `ops/conv.py`'s 1-D and 3-D paths) against the JAX
package's, on the CPU.

Each layer's ``apply`` runs on the same parameters and input as the JAX
layer's (numpy seeds), in f32, with its gradient of ``sum(y * g)`` for a
fixed random ``g`` with respect to the input and every parameter.
Outputs and gradients must agree within 1e-5 of the largest reference
element (the same f32 arithmetic in another summation order); initial
parameters bit for bit.  The cases cover SAME and VALID padding (XLA's
SAME is asymmetric for an even kernel or a stride above 1), strides,
dilation, every pooling kind at ranks 1 and 3, the croppings' argument
forms, PReLU at three ranks, the upsamplings and the zero mask.  Each
layer's JSON is the JAX layer's and reads back in both packages.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf import layers_nd as jax_nd
from deeplearning4j_tpu.nn.conf.input_type import InputType as JaxInputType
from deeplearning4j_tpu.utils import serde as jax_serde
from deeplearning4j_tpu_torch.nn.conf import layers, layers_nd
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.runtime import rng
from deeplearning4j_tpu_torch.utils import serde

torch.set_num_threads(1)

TOL = 1e-5

CASES = {
    "conv1d_same": ("Conv1D", dict(n_out=4, kernel=3, activation="relu"), (2, 9, 3)),
    "conv1d_valid_stride2": ("Conv1D", dict(n_out=3, kernel=4, stride=2,
                                            padding="valid"), (2, 11, 2)),
    "conv1d_same_even_stride2": ("Conv1D", dict(n_out=3, kernel=2, stride=2),
                                 (2, 9, 2)),
    "conv1d_dilation": ("Conv1D", dict(n_out=2, kernel=3, dilation=2,
                                       has_bias=False), (2, 10, 3)),
    "conv3d_same": ("Conv3D", dict(n_out=3, kernel=(3, 3, 3)), (2, 5, 6, 5, 2)),
    "conv3d_valid_stride": ("Conv3D", dict(n_out=2, kernel=(2, 3, 2), stride=(1, 2, 2),
                                           padding="valid", activation="tanh"),
                            (2, 5, 7, 6, 2)),
    "conv3d_same_even": ("Conv3D", dict(n_out=2, kernel=(2, 2, 2), stride=(2, 2, 2)),
                         (1, 5, 5, 6, 3)),
    "sub1d_max": ("Subsampling1D", dict(), (2, 9, 3)),
    "sub1d_max_same": ("Subsampling1D", dict(kernel=3, stride=2, padding="same"),
                       (2, 9, 3)),
    "sub1d_avg_same": ("Subsampling1D", dict(pooling="avg", kernel=3, stride=2,
                                             padding="same"), (2, 8, 2)),
    "sub1d_sum": ("Subsampling1D", dict(pooling="sum", kernel=3, stride=1), (2, 7, 2)),
    "sub1d_pnorm": ("Subsampling1D", dict(pooling="pnorm", pnorm=3.0), (2, 8, 2)),
    "sub3d_max": ("Subsampling3D", dict(), (2, 4, 6, 4, 2)),
    "sub3d_max_same": ("Subsampling3D", dict(kernel=(3, 3, 3), stride=(2, 2, 2),
                                             padding="same"), (1, 5, 5, 4, 2)),
    "sub3d_avg_same": ("Subsampling3D", dict(pooling="avg", kernel=(2, 3, 2),
                                             stride=(2, 2, 1), padding="same"),
                       (2, 5, 5, 4, 2)),
    "sub3d_sum": ("Subsampling3D", dict(pooling="sum"), (2, 4, 4, 4, 2)),
    "sub3d_pnorm": ("Subsampling3D", dict(pooling="pnorm"), (1, 4, 4, 2, 3)),
    "crop1d": ("Cropping1D", dict(cropping=(1, 2)), (2, 8, 3)),
    "crop1d_int": ("Cropping1D", dict(cropping=1), (2, 6, 3)),
    "crop2d_pairs": ("Cropping2D", dict(cropping=((1, 0), (2, 1))), (2, 7, 8, 3)),
    "crop2d_ints": ("Cropping2D", dict(cropping=(1, 2)), (2, 7, 8, 3)),
    "crop3d": ("Cropping3D", dict(cropping=((1, 0), (0, 1), (1, 1))), (2, 4, 5, 6, 2)),
    "crop3d_int": ("Cropping3D", dict(cropping=1), (1, 4, 5, 6, 2)),
    "prelu_ff": ("PReLU", dict(alpha_init=0.1), (4, 6)),
    "prelu_seq": ("PReLU", dict(), (2, 5, 4)),
    "prelu_maps": ("PReLU", dict(), (2, 4, 4, 3)),
    "up1d": ("Upsampling1D", dict(size=3), (2, 4, 3)),
    "up3d": ("Upsampling3D", dict(size=(1, 2, 3)), (2, 2, 3, 2, 2)),
    "up3d_int": ("Upsampling3D", dict(size=2), (1, 2, 2, 2, 3)),
    "mask_zero": ("MaskZeroLayer", dict(mask_value=-1.5), (3, 6, 4)),
    "zero_pad2d": ("ZeroPadding2D", dict(padding=(1, 2, 0, 3)), (2, 5, 4, 3)),
}
# tied max windows: small integers, so most windows hold their max twice
TIED = {"sub1d_max", "sub3d_max"}


def _itype(shape):
    if len(shape) == 5:
        return (JaxInputType.convolutional3d(*shape[1:]),
                InputType.convolutional3d(*shape[1:]))
    if len(shape) == 4:
        return JaxInputType.convolutional(*shape[1:]), InputType.convolutional(*shape[1:])
    if len(shape) == 3:
        return JaxInputType.recurrent(shape[2], shape[1]), InputType.recurrent(shape[2], shape[1])
    return JaxInputType.feed_forward(shape[1]), InputType.feed_forward(shape[1])


def _classes(cls):
    if cls == "ZeroPadding2D":
        return getattr(jax_layers, cls), getattr(layers, cls)
    return getattr(jax_nd, cls), getattr(layers_nd, cls)


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= TOL * scale, f"{what}: max |diff| {err:.3e} of max {scale:.3e}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_the_jax_layer(case):
    cls, kw, shape = CASES[case]
    jcls, pcls = _classes(cls)
    jl, pl = jcls(**kw), pcls(**kw)
    jit_, pit = _itype(shape)
    assert pl.output_type(pit).shape == jl.output_type(jit_).shape
    assert pl.output_type(pit).kind == jl.output_type(jit_).kind
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
    if case in TIED:
        x = r.integers(0, 3, shape).astype(np.float32)
    else:
        x = r.normal(size=shape).astype(np.float32)
    mask = None
    if cls == "MaskZeroLayer":
        mask = (r.random(shape[:2]) > 0.4).astype(np.float32)
    kwargs = {} if mask is None else {"mask": jnp.asarray(mask)}
    jy, _ = jl.apply(jp, {}, jnp.asarray(x), **kwargs)
    g = r.normal(size=np.asarray(jy).shape).astype(np.float32)

    def jax_fn(p, xx):
        y, _ = jl.apply(p, {}, xx, training=True, **kwargs)
        return jnp.sum(y * g), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        _tree(jnp.asarray, params), jnp.asarray(x))
    tp = _tree(lambda a: torch.tensor(a, requires_grad=True), params)
    tx = torch.tensor(x, requires_grad=True)
    pkw = {} if mask is None else {"mask": torch.from_numpy(mask)}
    ty, _ = pl.apply(tp, {}, tx, training=True, **pkw)
    (ty * torch.from_numpy(g)).sum().backward()
    _close(ty.detach().numpy(), jy, f"{case} output")
    _close(tx.grad.numpy(), jgx, f"{case} input gradient")
    for k in params:
        _close(tp[k].grad.numpy(), jgp[k], f"{case} d/d{k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_json_is_the_jax_layers(case):
    """The port writes the JAX layer's JSON, and each package reads the
    other's back to a configuration of the same class that writes the
    same JSON again."""
    cls, kw, _ = CASES[case]
    jcls, pcls = _classes(cls)
    jl, pl = jcls(name="l0", **kw), pcls(name="l0", **kw)
    pj, jj = serde.dumps(pl), jax_serde.dumps(jl)
    assert json.loads(pj) == json.loads(jj)
    ours, theirs = serde.loads(jj), jax_serde.loads(pj)
    assert type(ours) is pcls and type(theirs) is jcls
    assert json.loads(serde.dumps(ours)) == json.loads(jj)
    assert json.loads(jax_serde.dumps(theirs)) == json.loads(pj)


def test_conv_kernels_are_quantizable():
    """Conv1D and Conv3D kernels quantize (per output channel) as the
    JAX package's do."""
    from deeplearning4j_tpu_torch.quant.ptq import _quant_spec

    assert _quant_spec(layers_nd.Conv1D(n_out=2)) == {"": ("W",)}
    assert _quant_spec(layers_nd.Conv3D(n_out=2)) == {"": ("W",)}
    assert _quant_spec(layers_nd.PReLU()) == {}
