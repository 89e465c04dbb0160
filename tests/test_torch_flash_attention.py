"""The port's flash-forward plain version and `mha` against the JAX
package.

- f32: the JAX side runs its Pallas forward kernel in interpret mode
  with f32 matmuls (``mxu_f32=True``), as its own CPU tests do.
  Tolerance: atol and rtol 1e-5 — both sides are f32 and differ only in
  summation order.
- bf16: the Pallas kernel as the JAX package runs it, with bf16 matmuls
  (``mxu_f32=False``, interpret mode).  Both sides round Q * scale and P
  to bf16 before their products and keep the max, the normaliser and
  the sums in f32.  Tolerances: lse within 1e-5 (f32 sums in another
  order); out within 2^-7 of max |JAX|, one bf16 ulp of the largest
  element — the kernel rounds P against the running max of its KV
  blocks, the plain version against the row's max, so a stored element
  can land one rounding boundary away; and row by row within 2^-6 of
  each query row's own max |JAX| (that ulp, read here up to 2^-7, with
  room for the f32 sums' order), so that rows of small outputs are held
  to their own scale.
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
@pytest.mark.parametrize("d", [16, 64, 128])
def test_plain_f32_flash_fwd_keeps_exact_f32_as_the_mxu_f32_kernel(d, causal):
    """The port's f32 decision (ROADMAP C7): f32 inputs follow the Pallas
    kernel with ``mxu_f32=True``, not its bf16 default, at every head
    dim the card's kernel takes from 16 to 128."""
    t = 144
    q, k, v = _qkv((2, t, d), seed=d + int(causal))
    ref_out, ref_lse = _flash_fwd_bhtd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=16, block_k=16, interpret=True, mxu_f32=True)
    out, lse = fa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)


def _bf16_qkv(shape, seed):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(shape, seed)]


def _as_jax_bf16(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [128, 144, 256])
@pytest.mark.parametrize("d", [64, 128])
def test_plain_bf16_flash_fwd_matches_jax_pallas_bf16_kernel(d, t, causal):
    q, k, v = _bf16_qkv((2, t, d), seed=d + t + int(causal))
    block = 16 if t % 128 else 128      # the JAX kernel's blocks must tile T
    ref_out, ref_lse = _flash_fwd_bhtd(
        *(_as_jax_bf16(x) for x in (q, k, v)), causal=causal,
        block_q=block, block_k=block, interpret=True, mxu_f32=False)
    out, lse = fa.flash_fwd(q, k, v, causal=causal)
    assert out.dtype == torch.bfloat16 and ref_out.dtype == jnp.bfloat16
    ref = np.asarray(ref_out.astype(jnp.float32))
    diff = np.abs(out.float().numpy() - ref)
    assert diff.max() <= 2**-7 * np.abs(ref).max()
    assert (diff.max(-1) / np.abs(ref).max(-1)).max() <= 2**-6
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_lse_normalises_the_backward_p(causal):
    """The forward's lse against the P that the backward recomputes from
    it, exp(round(Q * scale) K^T - lse): rows sum to 1 within 1e-5 (f32
    sums of 256 terms)."""
    t, d = 256, 128
    q, k, v = _bf16_qkv((2, t, d), seed=31 + int(causal))
    _, lse = fa.flash_fwd_plain(q, k, v, causal=causal)
    qs = (q.float() * (1.0 / np.sqrt(d))).to(torch.bfloat16).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    if causal:
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), float("-inf"))
    rows = torch.exp(s - lse[..., None]).sum(-1)
    assert (rows - 1).abs().max().item() <= 1e-5


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
