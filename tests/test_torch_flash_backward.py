"""The port's flash backward (kernels B2 dQ and B3 dK/dV) against the JAX
package, and its autograd wiring.

- `flash_bwd_plain` against JAX's Pallas backward `_flash_bwd_pallas`
  (interpret mode, f32 matmuls, blocks that tile T as its kernels need)
  and against its lax.scan reference `_flash_bwd_bhtd`.  Both sides get
  the same q, k, v, g and the same forward out / lse, made from a numpy
  seed.  Tolerance atol 2e-5, rtol 1e-4: f32 on both sides; the JAX
  kernels sum dQ, dK and dV block by block, the plain version in one
  product, so the sums differ in order over up to 128 terms of O(1).
- On bf16 inputs, `flash_bwd_plain` against the same Pallas kernels with
  bf16 matmuls (``mxu_f32=False``, interpret mode): both round Q * scale,
  P and dS to bf16 before their products and sum in f32, so they differ
  only in the order of the f32 sums (blocks of 64 against one product).
  That can move a stored gradient across one bf16 rounding boundary: at
  most one bf16 ulp, 2^-7 of the largest element, hence a tolerance of
  8e-3 of max |JAX|, and at least 99% of the elements bit-identical (the
  plain version without the kernels' rounding matches ~60% of them).
- The `FlashAttention` Function's gradients against torch autograd of
  the dense `flash_fwd_plain`, at a ragged T (144, D 16) that no 64-row
  tile divides: atol 1e-5 (f32, two formulas of one gradient).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops.flash_attention import (
    _flash_bwd_bhtd,
    _flash_bwd_pallas,
)
from deeplearning4j_tpu_torch.ops import flash_attention as fa

# small shapes: one intra-op thread keeps these files from competing with
# the multi-process tests that share the host under pytest-xdist
torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=1e-4)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _forward(q, k, v, causal):
    out, lse = fa.flash_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal)
    return out.numpy(), lse.numpy()


def _port_bwd(q, k, v, out, lse, g, causal):
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, out, lse, g)]
    return [x.numpy() for x in fa.flash_bwd(*t, causal=causal)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [16, 128])
def test_plain_flash_bwd_matches_jax_pallas_kernels(t, causal):
    q, k, v, g = _inputs((2, t, 16), seed=t + int(causal))
    out, lse = _forward(q, k, v, causal)
    block = min(64, t)                      # the JAX kernels' blocks tile T
    ref = _flash_bwd_pallas(*(jnp.asarray(a) for a in (q, k, v, out, lse, g)),
                            causal=causal, block_q=block, block_k=block,
                            interpret=True, mxu_f32=True)
    got = _port_bwd(q, k, v, out, lse, g, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [16, 128])
def test_plain_bf16_flash_bwd_matches_jax_pallas_bf16_kernels(t, causal):
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs((2, t, 32), seed=20 + t + int(causal)))
    out, lse = fa.flash_fwd_plain(q, k, v, causal=causal)     # bf16 out
    block = min(64, t)
    ref = _flash_bwd_pallas(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          for x in (q, k, v, out)),
        jnp.asarray(lse.numpy()),
        jnp.asarray(g.float().numpy()).astype(jnp.bfloat16),
        causal=causal, block_q=block, block_k=block, interpret=True,
        mxu_f32=False)
    got = fa.flash_bwd(q, k, v, out, lse, g, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        assert np.abs(a - b).max() <= 8e-3 * np.abs(b).max(), name
        assert (a == b).mean() >= 0.99, name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [16, 128])
def test_plain_flash_bwd_matches_jax_scan_reference(t, causal):
    q, k, v, g = _inputs((3, t, 32), seed=10 + t + int(causal))
    out, lse = _forward(q, k, v, causal)
    ref = _flash_bwd_bhtd(*(jnp.asarray(a) for a in (q, k, v, out, lse, g)),
                          causal=causal, block_k=min(32, t))
    got = _port_bwd(q, k, v, out, lse, g, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_function_gradients_match_dense_autograd(causal):
    q, k, v, w = (torch.from_numpy(a) for a in _inputs((2, 144, 16), seed=7))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out, lse = fa.FlashAttention.apply(*leaves, causal)
    assert not lse.requires_grad
    got = torch.autograd.grad((out * w).sum(), leaves)
    dense = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref_out, _ = fa.flash_fwd_plain(*dense, causal=causal)
    ref = torch.autograd.grad((ref_out * w).sum(), dense)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   err_msg=name)


def test_mha_is_differentiable_through_the_flash_route():
    """(B, T, H, D) layout: gradients of `mha` on the flash route equal
    those of the dense softmax written out in torch."""
    from deeplearning4j_tpu_torch.ops.attention import mha

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 20, 2, 16))
                                .astype(np.float32)).requires_grad_(True)
               for _ in range(3))
    out = mha(q, k, v, causal=True)
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    s = s.masked_fill(torch.ones(20, 20, dtype=torch.bool).triu(1), -torch.inf)
    ref_out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    ref = torch.autograd.grad(ref_out.square().sum(), (q, k, v))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_plain_flash_bwd_keeps_the_input_dtype():
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs((2, 32, 16), seed=5))
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, g, causal=True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    ref = fa.flash_bwd_plain(q.float(), k.float(), v.float(), out, lse,
                             g.float(), causal=True)
    for a, b in zip((dq, dk, dv), ref):
        # one bf16 rounding of each O(1) gradient element
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=3e-2,
                                   rtol=1e-2)


def test_flash_bwd_rejects_bad_inputs():
    q = torch.zeros((2, 8, 16))
    lse = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="shape"):
        fa.flash_bwd(q, q, q, q, lse, torch.zeros((2, 9, 16)), causal=True)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd(q, q, q, q, lse.double(), q, causal=True)
