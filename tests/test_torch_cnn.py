"""The LeNet slice's layers (`nn/conf/layers.py`, `ops/conv.py`) against
the JAX package's, on the CPU.

Every layer's ``apply`` runs on the same parameters, state and input as
the JAX layer's (numpy seeds), in f32, and so does its gradient: of
``sum(y * g)`` for a fixed random ``g``, with respect to the input and
every parameter.  Outputs, new state and gradients must agree within
1e-5 of the largest reference element (the same f32 arithmetic in
another summation order).  The cases cover SAME and VALID padding,
strides 1 and 2, odd and even kernels (XLA's SAME is asymmetric for an
even kernel or a stride above 1), dilation, groups, all four poolings
(SAME average pooling divides by the real elements), max windows with
deliberate ties (the gradient must reach the element XLA's
``select_and_scatter`` picks), BatchNorm in training (batch statistics,
new running stats) and in inference, and Dropout's mask bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.input_type import InputType as JaxInputType
from deeplearning4j_tpu_torch.nn.conf import layers
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.runtime import rng

torch.set_num_threads(1)

TOL = 1e-5

CASES = {
    "dense_relu": ("Dense", dict(n_out=7, activation="relu"), (5, 12)),
    "dense_no_bias": ("Dense", dict(n_out=3, has_bias=False), (4, 6)),
    "output_layer": ("OutputLayer", dict(n_out=4, loss="mcxent",
                                         activation="softmax"), (5, 9)),
    "activation_tanh": ("ActivationLayer", dict(activation="tanh"), (3, 8)),
    "activation_leaky_alpha": ("ActivationLayer",
                               dict(activation="leakyrelu", alpha=0.3), (3, 8)),
    "activation_elu_alpha": ("ActivationLayer",
                             dict(activation="elu", alpha=0.5), (3, 8)),
    "conv_same_odd": ("Conv2D", dict(n_out=4, kernel=(3, 3), padding="same",
                                     activation="relu"), (2, 9, 9, 3)),
    "conv_valid_odd": ("Conv2D", dict(n_out=4, kernel=(5, 5)), (2, 9, 8, 2)),
    "conv_same_even": ("Conv2D", dict(n_out=3, kernel=(2, 4), padding="same"),
                       (2, 7, 9, 2)),
    "conv_same_stride2": ("Conv2D", dict(n_out=3, kernel=(3, 3), stride=(2, 2),
                                         padding="same"), (2, 9, 10, 2)),
    "conv_valid_stride2_even": ("Conv2D", dict(n_out=2, kernel=(4, 2),
                                               stride=(2, 2)), (2, 10, 9, 3)),
    "conv_same_dilation": ("Conv2D", dict(n_out=3, kernel=(3, 3), dilation=(2, 2),
                                          padding="same"), (2, 9, 9, 2)),
    "conv_valid_dilation": ("Conv2D", dict(n_out=3, kernel=(3, 2),
                                           dilation=(2, 3)), (2, 10, 11, 2)),
    "conv_groups": ("Conv2D", dict(n_out=6, kernel=(3, 3), groups=2,
                                   padding="same"), (2, 7, 7, 4)),
    "conv_depthwise": ("Conv2D", dict(n_out=4, kernel=(3, 3), groups=4), (2, 7, 7, 4)),
    "max_valid": ("Subsampling", dict(pooling="max"), (2, 8, 7, 3)),
    "max_same_3s2": ("Subsampling", dict(pooling="max", kernel=(3, 3),
                                         stride=(2, 2), padding="same"), (2, 9, 8, 3)),
    "max_overlap": ("Subsampling", dict(pooling="max", kernel=(3, 3),
                                        stride=(1, 1)), (2, 6, 6, 2)),
    "avg_valid": ("Subsampling", dict(pooling="avg", kernel=(3, 2),
                                      stride=(2, 2)), (2, 9, 8, 3)),
    "avg_same": ("Subsampling", dict(pooling="avg", kernel=(3, 3), stride=(2, 2),
                                     padding="same"), (2, 9, 8, 3)),
    "sum_same": ("Subsampling", dict(pooling="sum", kernel=(2, 2), stride=(2, 2),
                                     padding="same"), (2, 7, 9, 3)),
    "pnorm_valid": ("Subsampling", dict(pooling="pnorm", kernel=(2, 2)), (2, 8, 8, 3)),
    "pnorm3_same": ("Subsampling", dict(pooling="pnorm", pnorm=3, kernel=(3, 3),
                                        stride=(2, 2), padding="same"), (2, 7, 7, 2)),
    "batchnorm_maps": ("BatchNorm", dict(activation="relu"), (4, 5, 5, 3)),
    "batchnorm_ff": ("BatchNorm", dict(decay=0.7, epsilon=1e-3), (6, 5)),
    "batchnorm_locked": ("BatchNorm", dict(lock_gamma_beta=True), (4, 3, 3, 2)),
}
# tied max windows: small integers, so most windows hold their max twice
TIED = {"max_valid", "max_same_3s2", "max_overlap"}


def _itype(shape):
    if len(shape) == 4:
        return JaxInputType.convolutional(*shape[1:]), InputType.convolutional(*shape[1:])
    return JaxInputType.feed_forward(shape[1]), InputType.feed_forward(shape[1])


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _np_tree(tree):
    return _tree(lambda a: np.array(a, dtype=np.float32), tree)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= TOL * scale, f"{what}: max |diff| {err:.3e} of max {scale:.3e}"


def _inputs(case, shape, seed):
    r = np.random.default_rng(seed)
    if case in TIED:
        return r.integers(0, 3, shape).astype(np.float32)
    return r.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_the_jax_layer(case, training):
    cls, kw, shape = CASES[case]
    jl, pl = getattr(jax_layers, cls)(**kw), getattr(layers, cls)(**kw)
    jit_, pit = _itype(shape)
    assert pl.output_type(pit).shape == jl.output_type(jit_).shape
    seed = sorted(CASES).index(case)
    jp, js = jl.init(jax.random.key(seed), jit_)
    pp, ps = pl.init(rng.key(seed), pit, "cpu")
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(_tree(lambda t: t, pp))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    r = np.random.default_rng(100 + seed)
    params = _tree(lambda a: (np.asarray(a) + r.normal(scale=0.1, size=a.shape)
                              ).astype(np.float32), jp)
    state = _tree(lambda a: (np.asarray(a) + np.abs(r.normal(scale=0.3, size=a.shape))
                             ).astype(np.float32), js)
    x = _inputs(case, shape, 200 + seed)
    jy, _ = jl.apply(jp, js, jnp.asarray(x))
    g = r.normal(size=np.asarray(jy).shape).astype(np.float32)

    def jax_fn(p, xx):
        y, ns = jl.apply(p, _tree(jnp.asarray, state), xx, training=training)
        return jnp.sum(y * g), (y, ns)

    (_, (jy, jns)), (jgp, jgx) = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(_tree(jnp.asarray, params), jnp.asarray(x))

    tp = _tree(lambda a: torch.tensor(a, requires_grad=True), params)
    tx = torch.tensor(x, requires_grad=True)
    ty, tns = pl.apply(tp, _tree(torch.tensor, state), tx, training=training)
    (ty * torch.from_numpy(g)).sum().backward()

    _close(ty.detach().numpy(), jy, f"{case} output")
    _close(tx.grad.numpy(), jgx, f"{case} input gradient")
    for k in params:
        _close(tp[k].grad.numpy(), jgp[k], f"{case} d/d{k}")
    assert set(tns) == set(jns)
    for k in jns:
        _close(tns[k].detach().numpy(), jns[k], f"{case} state {k}")


def test_dropout_draws_the_jax_mask_bits():
    """`Dropout` in training keeps exactly the elements the JAX layer
    keeps, scaled the same; in inference it is the identity."""
    x = np.random.default_rng(0).normal(size=(4, 6, 6, 3)).astype(np.float32)
    for rate in (0.1, 0.5, 0.9):
        jl, pl = jax_layers.Dropout(rate=rate), layers.Dropout(rate=rate)
        for seed in (0, 7):
            jy, _ = jl.apply({}, {}, jnp.asarray(x), training=True,
                             rng=jax.random.key(seed))
            py, _ = pl.apply({}, {}, torch.from_numpy(x), training=True,
                             rng=rng.key(seed))
            jy = np.asarray(jy)
            np.testing.assert_array_equal(py.numpy() == 0, jy == 0)
            np.testing.assert_array_equal(py.numpy(), jy)
        py, _ = pl.apply({}, {}, torch.from_numpy(x), training=False)
        np.testing.assert_array_equal(py.numpy(), x)


def test_tied_max_windows_route_the_gradient_where_xla_does():
    """A 2 x 2 window whose four elements are equal sends its whole
    gradient to the first (top-left) element, in both packages."""
    x = np.ones((1, 4, 4, 1), np.float32)
    pl = layers.Subsampling(pooling="max")
    tx = torch.tensor(x, requires_grad=True)
    pl.apply({}, {}, tx)[0].sum().backward()
    jg = jax.grad(lambda xx: jnp.sum(jax_layers.Subsampling(pooling="max").apply(
        {}, {}, xx)[0]))(jnp.asarray(x))
    want = np.zeros((4, 4), np.float32)
    want[::2, ::2] = 1.0
    np.testing.assert_array_equal(np.asarray(jg)[0, :, :, 0], want)
    np.testing.assert_array_equal(tx.grad.numpy()[0, :, :, 0], want)


@pytest.mark.parametrize("size,k,s,d", [(7, 2, 1, 1), (9, 3, 2, 1), (10, 3, 2, 1),
                                        (8, 4, 3, 1), (9, 3, 1, 2), (5, 1, 2, 1)])
def test_same_padding_is_xlas(size, k, s, d):
    """``same_pads`` gives XLA's SAME split: total // 2 before."""
    from jax import lax

    from deeplearning4j_tpu_torch.ops.conv import same_pads

    (before, after), = lax.padtype_to_pads((size,), ((k - 1) * d + 1,), (s,), "SAME")
    assert same_pads(size, k, s, d) == (before, after)


def test_padding_and_pooling_names_coerce():
    assert layers.Conv2D(padding="SAME").padding == "same"
    assert layers.Subsampling(pooling="AVG").pooling is layers.PoolingType.AVG
    assert layers.Subsampling(pooling="pnorm").pooling is layers.PoolingType.PNORM
    assert [(m.name, m.value) for m in layers.PoolingType] == \
        [(m.name, m.value) for m in jax_layers.PoolingType]
    assert (layers.Dense.EXPECTS, layers.Conv2D.EXPECTS, layers.Subsampling.EXPECTS,
            layers.BatchNorm.EXPECTS) == ("ff", "cnn", "cnn", "any")
    assert not layers.Subsampling.HAS_PARAMS and layers.BatchNorm.HAS_PARAMS


def test_exact_flag_windows_in_threads_restore_the_callers_flags():
    """cuDNN's flags are the process's: windows of `ops.conv._exact` opened
    from many threads at once (a server's forwards, autograd's backward)
    each see the exact flags inside, and leave the caller's flags as they
    were.  Without the module's lock a window restores what another
    window set.  (Only the flags are set here; no card is needed.)"""
    import threading
    import time

    from deeplearning4j_tpu_torch.ops.conv import _exact

    cudnn = torch.backends.cudnn
    flags = lambda: (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,  # noqa: E731
                     cudnn.allow_tf32)
    seen, errors = [], []

    def worker():
        try:
            for _ in range(40):
                with _exact(torch.device("cuda")):
                    time.sleep(1e-4)
                    seen.append(flags())
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)

    with cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                     allow_tf32=True):
        caller = flags()
        threads = [threading.Thread(target=worker) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors and flags() == caller
    assert len(seen) == 6 * 40 and set(seen) == {(True, False, True, False)}
