"""The port's flash-forward plain version and `mha` against the JAX
package.

The JAX side runs its Pallas forward kernel in interpret mode with f32
matmuls (``mxu_f32=True``), as its own CPU tests do.  Tolerance: atol
and rtol 1e-5 — both sides are f32 and differ only in summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops.attention import mha as jax_mha
from deeplearning4j_tpu.ops.flash_attention import _flash_fwd_bhtd
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops.attention import mha

# small shapes: one intra-op thread keeps these files from competing with
# the multi-process tests that share the host under pytest-xdist
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [16, 128, 144])
def test_plain_flash_fwd_matches_jax_kernel(t, causal):
    q, k, v = _qkv((2, t, 16), seed=t + int(causal))
    block = 16 if t % 128 else 128      # the JAX kernel's blocks must tile T
    ref_out, ref_lse = _flash_fwd_bhtd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=block, block_k=block, interpret=True, mxu_f32=True)
    out, lse = fa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal)
    assert out.dtype == torch.float32 and lse.shape == (2, t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_matches_jax_mha(causal):
    """(B, T, H, D) layout through the port's flash route vs the JAX
    dense path."""
    q, k, v = _qkv((2, 24, 2, 16), seed=3)
    ref = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal))
    out = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
              causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_masked_mha_takes_the_dense_path_and_matches_jax():
    q, k, v = _qkv((2, 12, 2, 16), seed=4)
    mask = np.ones((2, 12), np.float32)
    mask[0, 7:] = 0.0
    assert not fa.flash_eligible(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(mask))
    ref = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, mask=jnp.asarray(mask)))
    out = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
              causal=True, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_plain_flash_fwd_keeps_bf16_output_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv((2, 32, 16), seed=5))
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, _ = fa.flash_fwd_plain(q.float(), k.float(), v.float(), causal=True)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=1e-2)


def test_flash_fwd_rejects_bad_inputs():
    q = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="shape"):
        fa.flash_fwd(q, torch.zeros((2, 9, 16)), q, causal=True)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_fwd(q.double(), q.double(), q.double(), causal=True)


def test_jax_reference_runs_on_cpu():
    assert jax.devices()[0].platform == "cpu"
