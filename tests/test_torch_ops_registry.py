"""The port's SameDiff op registry (`deeplearning4j_tpu_torch/autodiff/
ops_registry.py`) against the JAX package's, op by op: every ported op
on the inputs the JAX package's coverage suite builds for it
(`tests/test_op_validation_coverage.py` `_example_for`), the same values
fed to both, results within f32 1e-5 (rtol and atol) and of the same
dtype; the random ops bit for bit.  Every op that waits raises naming
ROADMAP A13, and ported plus waiting is the JAX package's op set."""

import numpy as np
import pytest
import torch

import test_op_validation_coverage as cov
from deeplearning4j_tpu.autodiff.ops_registry import OPS as JAX_OPS
from deeplearning4j_tpu_torch.autodiff import ops_registry as reg

F32_TOL = dict(rtol=1e-5, atol=1e-5)
# ops whose inputs need structure the coverage suite builds elsewhere
_RNG = np.random.default_rng(17)
EXTRA = {
    "ctc_loss": cov.Ex(np.log(_RNG.dirichlet(np.ones(5), (2, 6))).astype(np.float32),
                       np.array([[1, 2, 2], [3, 1, 4]], np.int32)),
    "ctc_greedy_decode": cov.Ex(_RNG.normal(size=(2, 7, 4)).astype(np.float32)),
}
RANDOM = {"random_normal", "random_uniform", "random_bernoulli",
          "random_truncated_normal", "truncated_normal", "random_categorical",
          "alpha_dropout"}


def _example(name):
    return EXTRA.get(name) or cov._example_for(name)


def _torch(a):
    a = np.asarray(a)
    if a.dtype == np.int64:
        a = a.astype(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", sorted(reg.PORTED))
def test_ported_op_matches_jax(name):
    ex = _example(name)
    want = _leaves(JAX_OPS[name](*ex.args, **ex.attrs))
    got = _leaves(reg.get_op(name)(*[_torch(a) for a in ex.args], **ex.attrs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
        if name in RANDOM:
            np.testing.assert_array_equal(g, w)
        elif w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, equal_nan=True, **F32_TOL)


@pytest.mark.parametrize("name", sorted(reg.WAITING))
def test_waiting_op_raises_naming_a13(name):
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        reg.get_op(name)(torch.zeros(2, 2), shape=(2,))


def test_ported_and_waiting_are_the_jax_op_set():
    assert reg.PORTED.isdisjoint(reg.WAITING)
    assert set(reg.PORTED) | set(reg.WAITING) == set(JAX_OPS) == set(reg.OPS)
    # the families the port may leave waiting, and nothing else
    assert set(reg.WAITING.values()) <= {"image", "signal", "random", "special"}


def test_results_narrow_to_32_bits_and_creation_follows_the_device():
    assert reg.get_op("argmax")(torch.tensor([[1.0, 3.0]])).dtype == torch.int32
    assert reg.get_op("sum")(torch.tensor([1, 2], dtype=torch.int32)).dtype == torch.int32
    assert reg.get_op("cast")(torch.tensor([1.5]), dtype="float64").dtype == torch.float32
    with reg.device_scope("cpu"):
        assert reg.get_op("eye")(n=2).device.type == "cpu"
    with pytest.raises(KeyError, match="unknown autodiff op"):
        reg.get_op("no_such_op")


@pytest.mark.parametrize("spec", [
    dict(begin=(3, 5), end=(0, 0), strides=(-1, -2)),                    # reversed
    dict(begin=(0, 1), end=(4, 6), strides=(2, 1), shrink_axis_mask=0b01),
    dict(begin=(0, 0, 2), end=(0, 0, 6), strides=(1, 1, 1), ellipsis_mask=0b001),
    dict(begin=(1, 0, 0), end=(3, 0, 5), strides=(1, 1, 2), new_axis_mask=0b010),
    dict(begin=(-1, -2), end=(-5, -6), strides=(-1, -1), begin_mask=0b10),
    dict(begin=(0, 0), end=(4, 6), strides=(1, 1), end_mask=0b11),
])
def test_strided_slice_specs_match_jax(spec):
    x = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
    want = np.asarray(JAX_OPS["strided_slice"](x, **spec))
    got = reg.get_op("strided_slice")(torch.from_numpy(x), **spec).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
