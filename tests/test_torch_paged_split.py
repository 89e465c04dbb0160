"""The split that the paged-attention kernel (B4) runs on the card,
emulated on the CPU and held against the JAX package.

The kernel cuts each slot's live positions into chunks of
``pages_per_chunk`` pages, computes each chunk's partial softmax
(running max m, normaliser l, accumulator acc) with int8 scales applied
once per score (K) and once per row (V), and merges the partials in
chunk order: each head's largest chunk max first, then every chunk's
weight against it.  `split_emulation` does the same arithmetic in torch,
at chunks of 1, 2, 3 and 4 pages, and is compared with
``deeplearning4j_tpu.ops.paged_attention.paged_attention`` on both of
its routes (the Pallas kernel in interpret mode and the XLA gather
reference) and with the port's `paged_attention_plain`.  Tolerance:
atol and rtol 1e-5 (f32 both sides; another summation order, and int8
scales applied after the sums instead of in each element).

Lengths sit on chunk boundaries and one off them, one slot fills its
whole table, and one slot is idle: exact zeros, held against the XLA
route only (the Pallas kernel gives an idle slot the mean of its table's
V rows; see tests/test_torch_paged_attention.py).  Head dims 16 and 48
take the kernel's strided lanes.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops.paged_attention import paged_attention as jax_paged
from deeplearning4j_tpu.serving.kv_cache import (
    quantize_page_rows as jax_quantize,
)
from deeplearning4j_tpu_torch.ops.paged_attention import (
    SMEM_PAGE_BYTES,
    paged_attention_plain,
    split_plan,
)

# small shapes: one intra-op thread keeps these files from competing with
# the multi-process tests that share the host under pytest-xdist
torch.set_num_threads(1)

H, PS, MAXP = 4, 8, 6
TOL = dict(atol=1e-5, rtol=1e-5)


def split_emulation(q, k_pages, v_pages, page_tbl, seq_lens, pages_per_chunk,
                    k_scale=None, v_scale=None):
    """Per-chunk partials (m, l, acc) of each slot and head, merged in chunk
    order, as the kernel computes them.  Returns (S, H, Dh) f32."""
    s_n, h_n, dh = q.shape
    ps, max_pages = k_pages.shape[1], page_tbl.shape[1]
    span = pages_per_chunk * ps
    out = torch.zeros((s_n, h_n, dh))
    for s in range(s_n):
        n = min(int(seq_lens[s]), max_pages * ps)
        if n <= 0:
            continue                                   # idle: exact zeros
        parts = []
        for c in range(-(-n // span)):
            pos = torch.arange(c * span, min((c + 1) * span, n))
            page, row = page_tbl[s, pos // ps].long(), pos % ps
            k = k_pages[page, row].float()             # (n, H, Dh)
            v = v_pages[page, row].float()
            sc = torch.einsum("hd,nhd->hn", q[s].float(), k)
            if k_scale is not None:
                sc = sc * k_scale[page, row].T         # once per score
            sc = sc * (1.0 / math.sqrt(dh))
            m = sc.max(-1).values
            p = torch.exp(sc - m[:, None])
            l = p.sum(-1)
            if v_scale is not None:
                p = p * v_scale[page, row].T           # once per row
            parts.append((m, l, torch.einsum("hn,nhd->hd", p, v)))
        # each head's largest chunk max, every chunk's weight against it,
        # sums in chunk order
        big = torch.stack([m for m, _, _ in parts]).max(0).values
        l_sum, acc_sum = torch.zeros(h_n), torch.zeros((h_n, dh))
        for m, l, acc in parts:
            w = torch.exp(m - big)
            l_sum = l_sum + l * w
            acc_sum = acc_sum + acc * w[:, None]
        out[s] = acc_sum / l_sum[:, None]
    return out


def _case(ppc, dh, seed):
    """Lengths on a chunk boundary, one either side of it, a full table,
    an idle slot and a one-row slot; each live slot its own pages."""
    span = ppc * PS
    lens = np.array([span, span - 1, span + 1, MAXP * PS, 0, 1, 2 * span - 1],
                    np.int32).clip(0, MAXP * PS)
    s_n = len(lens)
    need = [-(-int(n) // PS) for n in lens]
    n_pages = sum(need) + 3
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((s_n, H, dh)).astype(np.float32)
    kp = rng.standard_normal((n_pages, PS, H, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, PS, H, dh)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tbl = np.zeros((s_n, MAXP), np.int32)              # dead entries: page 0
    used = 0
    for s, k in enumerate(need):
        tbl[s, :k] = perm[used:used + k]
        used += k
    return q, kp, vp, tbl, lens


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dh", [16, 48])
@pytest.mark.parametrize("ppc", [1, 2, 3, 4])
def test_split_and_merge_matches_jax(ppc, dh, quant, impl):
    q, kp, vp, tbl, lens = _case(ppc, dh, seed=10 * ppc + dh + int(quant))
    kw = {}
    if quant:
        kp, ks = (np.asarray(a) for a in jax_quantize(jnp.asarray(kp)))
        vp, vs = (np.asarray(a) for a in jax_quantize(jnp.asarray(vp)))
        kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    ref = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                               jnp.asarray(tbl), jnp.asarray(lens), impl=impl,
                               interpret=True, **kw))
    t = [torch.from_numpy(np.array(a)) for a in (q, kp, vp, tbl, lens)]
    scales = ([torch.from_numpy(np.array(a)) for a in (ks, vs)] if quant
              else [None, None])
    out = split_emulation(*t, ppc, *scales).numpy()
    plain = paged_attention_plain(*t, *scales).numpy()
    live = lens > 0
    np.testing.assert_allclose(out[live], ref[live], **TOL)
    np.testing.assert_allclose(out, plain, **TOL)
    if impl == "xla":
        np.testing.assert_allclose(out, ref, **TOL)
        assert np.all(out[~live] == 0.0) and np.all(ref[~live] == 0.0)


@pytest.mark.parametrize("quant,ppc,items", [(False, 2, 256), (True, 4, 128)])
def test_split_plan_at_the_flagship_widths(quant, ppc, items):
    """8 heads of 128 in 16-row pages: groups of 2 heads; chunks of 2 f32
    pages (64 KB of shared memory) or 4 int8 pages, so the serve mix's
    2017-position slot is 64 (f32) or 32 (int8) chunks x 4 groups."""
    assert split_plan(8, 128, 16, quant) == (2, ppc)
    assert -(-(-(-2017 // 16)) // ppc) * (8 // 2) == items


@pytest.mark.parametrize("heads,dh,ps,quant,want", [
    (4, 16, 8, False, (4, 4)),       # group x Dh <= 256: 4 heads
    (3, 48, 8, False, (1, 4)),       # 3 heads: no group of 2 or 4 divides
    (2, 256, 16, False, (1, 2)),     # 32 KB a page: two in 64 KB
    (2, 256, 64, False, (1, 1)),     # 128 KB a page: one, within 200 KB
    (8, 64, 16, True, (4, 4)),
])
def test_split_plan_groups_and_chunks(heads, dh, ps, quant, want):
    assert split_plan(heads, dh, ps, quant) == want


def test_split_plan_raises_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        split_plan(2, 256, 128, False)
    assert 2 * 128 * 256 * 4 > SMEM_PAGE_BYTES
