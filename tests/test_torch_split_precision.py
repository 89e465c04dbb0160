"""How many bf16 parts an f32 operand needs on the tensor cores: a CPU
emulation of the split arithmetic of kernels B5 (`dequant_matmul_wgmma`),
B1 in f32 (`flash_fwd_split`) and B2 / B3 in f32 (`flash_bwd_dq_split`,
`flash_bwd_dkdv_split`), against exact f32.

Each f32 operand a is cut into bf16 parts, a_1 = bf16(a),
a_i = bf16(a - a_1 - ... - a_{i-1}); every product of two bf16 values is
exact in f32, so the emulation multiplies the parts in f32 and sums in
f32, as the kernels' accumulators do (in another order).  The parts are
a test helper here; no path of the port runs this file's code.

- B5: y = sum_i x_i q, then the scale (|q| <= 127 is exact in bf16, so the
  weight is never split).  At the K of each of `chip_smoke.py`'s six
  B5 shapes, with its data recipe (randn x, q in [-127, 127], positive
  scales), narrowed to 512 rows and 256 columns: two parts must hold the
  card's tolerances (1e-5 of max |y| at K 1024, 2e-5 at K 4096) with a 2x
  margin, and one part must not.  So the kernel takes two.
- B1 in f32: S = Q_1 K_1^T + Q_1 K_2^T + Q_2 K_1^T (Q * scale split) and
  O = (P_1 V_1 + P_1 V_2 + P_2 V_1) / l, with l, the max and the lse in
  f32 from the unsplit P, at T 2048 and D 128, causal: out and lse within
  half the card's 2e-4, where one part a side misses it.
- B2 / B3 in f32: Q * scale, K, V and g split; S, dP, dQ = dS K,
  dK = dS^T (Q * scale) and dV = P^T g each three part products, with
  P = exp(S - lse) and dS = P * (dP - delta) in f32 from the unsplit S and
  dP and then split themselves, at T 2048 and D 128, causal: dQ, dK and dV
  each within half the card's 1e-4 of its max |exact| (where dP - delta
  cancels, the split's error could have grown), and each misses 1e-4 with
  one part a side.
"""

import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops.dequant_matmul import dequant_matmul_plain
from deeplearning4j_tpu_torch.ops.flash_attention import flash_bwd_plain, flash_fwd_plain

# one intra-op thread keeps this file from competing with the
# multi-process tests that share the host under pytest-xdist
torch.set_num_threads(1)

#: chip_smoke.py's B5 shapes (M, K, N) and its tolerances by K
DM_SHAPES = [(4096, 1024, 1024), (4096, 1024, 4096), (4096, 4096, 1024),
             (4096, 1024, 32000), (8, 1024, 4096), (1, 4096, 4096)]
DM_TOL = {1024: 1e-5, 4096: 2e-5}
FLASH_TOL = 2e-4          # B1 f32 out and lse, absolute
BWD_TOL = 1e-4            # B2 / B3 f32, relative to max |exact| of each gradient
MARGIN = 2


def bf16_parts(a: torch.Tensor, n: int) -> list:
    """``n`` bf16 parts of f32 ``a`` (as f32 tensors) whose sum is ``a``
    to ~8n significant bits."""
    parts, rest = [], a
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        parts.append(p)
        rest = rest - p
    return parts


def _dm_data(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    scale = torch.from_numpy((rng.random(n) / 127 + 1e-4).astype(np.float32))
    return x, q, scale


def dm_split_error(x, q, scale, n_parts: int) -> float:
    """max |emulated - exact f32| relative to max |exact f32|."""
    qf = q.float()
    y = sum(p @ qf for p in bf16_parts(x, n_parts)) * scale
    ref = dequant_matmul_plain(x, q, scale)
    return ((y - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("m,k,n", DM_SHAPES)
def test_two_x_parts_hold_the_dequant_matmul_tolerance(m, k, n):
    x, q, scale = _dm_data(min(m, 512), k, min(n, 256), seed=m + k + n)
    tol = DM_TOL[k]
    assert dm_split_error(x, q, scale, 2) <= tol / MARGIN
    assert dm_split_error(x, q, scale, 1) > tol


def split_product(a, b, n_parts: int):
    """a @ b with both operands cut into parts: with two parts a side it
    keeps three part products (the lo x lo one is dropped, as in the
    kernels); with one it is plain bf16 operands."""
    pa, pb = bf16_parts(a, n_parts), bf16_parts(b, n_parts)
    out = pa[0] @ pb[0]
    if n_parts == 2:
        out = out + pa[0] @ pb[1] + pa[1] @ pb[0]
    return out


def _causal(t):
    return torch.ones(t, t, dtype=torch.bool).triu(1)


def flash_split(q, k, v, causal: bool, n_parts: int):
    """The split forward of (BH, T, D) f32 q, k, v: (out, lse)."""
    d = q.shape[-1]

    def product(a, b):
        return split_product(a, b, n_parts)

    s = product(q * (1.0 / math.sqrt(d)), k.transpose(-1, -2))
    if causal:
        s = s.masked_fill(_causal(s.shape[-1]), float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return product(p, v) / l, (m + torch.log(l)).squeeze(-1)


def test_split_attention_holds_the_f32_flash_tolerance():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2048, 128)).astype(np.float32))
               for _ in range(3))
    ref, ref_lse = flash_fwd_plain(q, k, v, causal=True)
    out, lse = flash_split(q, k, v, True, 2)
    assert (out - ref).abs().max().item() <= FLASH_TOL / MARGIN
    assert (lse - ref_lse).abs().max().item() <= FLASH_TOL / MARGIN
    out1, lse1 = flash_split(q, k, v, True, 1)
    assert max((out1 - ref).abs().max().item(),
               (lse1 - ref_lse).abs().max().item()) > FLASH_TOL


def flash_bwd_split(q, k, v, out, lse, g, causal: bool, n_parts: int):
    """The split backward of (BH, T, D) f32 inputs: (dq, dk, dv).  delta,
    P and dS are f32 from unsplit products, as in the kernels; P and dS
    are split again as operands of dV, dQ and dK."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)

    def product(a, b):
        return split_product(a, b, n_parts)

    qs = q * scale
    delta = (g * out).sum(-1)
    p = torch.exp(product(qs, k.transpose(-1, -2)) - lse[..., None])
    if causal:
        p = p.masked_fill(_causal(p.shape[-1]), 0.0)
    ds = p * (product(g, v.transpose(-1, -2)) - delta[..., None])
    return (product(ds, k) * scale, product(ds.transpose(-1, -2), qs),
            product(p.transpose(-1, -2), g))


def test_split_backward_holds_the_f32_flash_bwd_tolerance():
    rng = np.random.default_rng(6)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 2048, 128)).astype(np.float32))
                  for _ in range(4))
    out, lse = flash_fwd_plain(q, k, v, causal=True)
    ref = flash_bwd_plain(q, k, v, out, lse, g, causal=True)

    def errors(n_parts):
        got = flash_bwd_split(q, k, v, out, lse, g, True, n_parts)
        return [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, ref)]

    two, one = errors(2), errors(1)
    assert max(two) <= BWD_TOL / MARGIN, two
    assert min(one) > BWD_TOL, one


def test_bf16_parts_sum_back_to_the_f32_value():
    a = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                         .astype(np.float32))
    two, three = bf16_parts(a, 2), bf16_parts(a, 3)
    assert ((two[0] + two[1] - a).abs() <= 2.0**-16 * a.abs()).all()
    assert torch.equal(three[0] + three[1] + three[2], a)
