"""The port's paged attention (plain version) and page quantizer against
the JAX package.

The JAX side runs both of its routes: the Pallas kernel in interpret
mode and the XLA gather reference.  Pools hold garbage past every
``seq_len`` and one slot is idle (``seq_len`` 0).  Tolerance: atol and
rtol 1e-5 (f32 both sides; different summation order).  The int8
quantizer must agree bit for bit, scales within 1e-7.

The idle slot is held to the XLA reference only: the JAX Pallas kernel
masks every position of a ``seq_len`` 0 slot to the same -1e30 score,
so its online softmax weighs them all equally and returns the mean of
the slot's (scratch) V rows instead of zeros.  The engine never reads an
idle slot's output; the port writes exact zeros, as the XLA route does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops.paged_attention import paged_attention as jax_paged
from deeplearning4j_tpu.serving.kv_cache import (
    quantize_page_rows as jax_quantize,
)
from deeplearning4j_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_fwd,
)
from deeplearning4j_tpu_torch.serving.kv_cache import (
    SCRATCH_PAGE,
    PagedKVCache,
    quantize_page_rows,
)

# small shapes: one intra-op thread keeps these files from competing with
# the multi-process tests that share the host under pytest-xdist
torch.set_num_threads(1)

S, H, DH, P, PS, MAXP = 4, 2, 16, 12, 8, 3
LENS = np.array([5, 17, 0, 24], np.int32)
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, DH)).astype(np.float32)
    kp = rng.standard_normal((P, PS, H, DH)).astype(np.float32)
    vp = rng.standard_normal((P, PS, H, DH)).astype(np.float32)
    pages = rng.permutation(np.arange(1, P)).astype(np.int32)
    tbl = np.full((S, MAXP), SCRATCH_PAGE, np.int32)
    used = 0
    for s, n in enumerate(LENS):
        k = -(-int(n) // PS)
        tbl[s, :k] = pages[used:used + k]
        used += k
    return q, kp, vp, tbl


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]   # writable copies


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_f32_pages_match_jax(impl):
    q, kp, vp, tbl = _inputs(1)
    ref = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                               jnp.asarray(tbl), jnp.asarray(LENS), impl=impl,
                               interpret=True))
    out = paged_attention(*_t(q, kp, vp, tbl, LENS))
    _compare(out.numpy(), ref, impl)


def _compare(out, ref, impl):
    live = LENS > 0 if impl == "pallas" else slice(None)
    np.testing.assert_allclose(out[live], ref[live], **TOL)
    assert np.all(out[2] == 0.0)                    # idle slot: exact zeros


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_int8_pages_match_jax(impl):
    q, kp, vp, tbl = _inputs(2)
    kq, ks = jax_quantize(jnp.asarray(kp))
    vq, vs = jax_quantize(jnp.asarray(vp))
    ref = np.asarray(jax_paged(jnp.asarray(q), kq, vq, jnp.asarray(tbl),
                               jnp.asarray(LENS), k_scale=ks, v_scale=vs,
                               impl=impl, interpret=True))
    tq, tk, tv, tt, tl = _t(q, kq, vq, tbl, LENS)
    out = paged_attention(tq, tk, tv, tt, tl,
                          k_scale=torch.from_numpy(np.array(ks)),
                          v_scale=torch.from_numpy(np.array(vs)))
    _compare(out.numpy(), ref, impl)


def test_jax_pallas_idle_slot_returns_the_mean_of_scratch_v():
    """Pins the reference divergence described in the module docstring."""
    q, kp, vp, tbl = _inputs(1)
    ref = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                               jnp.asarray(tbl), jnp.asarray(LENS),
                               impl="pallas", interpret=True))
    mean_v = vp[tbl[2]].reshape(MAXP * PS, H, DH).mean(axis=0)
    np.testing.assert_allclose(ref[2], mean_v, **TOL)


def test_quantize_page_rows_is_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, 5, H, DH)).astype(np.float32) * 3.0
    a[0, 0, 0] = 0.0                                # an all-zero row
    a[1, 1, 1, :4] = [0.5, -0.5, 1.5, 127.0 / 254]  # exact .5 ties
    jq, js = jax_quantize(jnp.asarray(a))
    tq, ts = quantize_page_rows(torch.from_numpy(a))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-7, rtol=0)
    assert ts.numpy()[0, 0, 0] == 1.0


def test_scale_pairing_and_dtype_are_checked():
    q, kp, vp, tbl = _t(*_inputs(4))
    lens = torch.from_numpy(LENS)
    with pytest.raises(ValueError, match="BOTH"):
        paged_attention(q, kp, vp, tbl, lens, k_scale=torch.ones(P, PS, H))
    with pytest.raises(ValueError, match="int32"):
        paged_attention_fwd(q, kp, vp, tbl.long(), lens)
    with pytest.raises(TypeError, match="int8"):
        paged_attention_fwd(q, kp, vp, tbl, lens, torch.ones(P, PS, H),
                            torch.ones(P, PS, H))


def test_kv_cache_writes_pages_in_place():
    kv = PagedKVCache(n_layers=2, n_heads=H, head_dim=DH, num_pages=6,
                      page_size=8, device="cpu")
    pool = kv.k_pages
    kv.alloc("a", 2)
    k = torch.randn(2, 16, H, DH)
    tbl = kv.write_prefill("a", k, k * 2)
    assert kv.k_pages is pool                       # same storage, written in place
    np.testing.assert_array_equal(kv.k_pages[:, tbl].reshape(2, 16, H, DH), k)
    kv.write_rows(1, torch.tensor([tbl[1]]), torch.tensor([3]),
                  torch.ones(1, H, DH), torch.ones(1, H, DH))
    assert torch.all(kv.k_pages[1, tbl[1], 3] == 1.0)
    kv.release("a")
    assert kv.leak_check() is None and kv.used_pages == 0
