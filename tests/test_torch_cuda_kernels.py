"""The port's hand-written CUDA kernels against their plain versions, on
the card.  Without a CUDA device every test here skips (the CPU suite
holds the plain versions against the JAX package instead).  On the card:

    python -m pytest --noconftest -m torch_port tests/test_torch_cuda_kernels.py

(``--noconftest`` skips the suite's conftest, which sets JAX up: a CUDA
environment need not have JAX.)

Tolerances: f32 kernels within 2e-4 (flash) and 1e-4 (paged) absolute —
the same arithmetic in another summation order; the bf16 flash output
within 1.6e-2, one bf16 rounding of an O(1) value.  The bf16 flash
forward (`flash_fwd_wgmma`) against its plain version, which rounds
Q * scale and P to bf16 where the kernel does: out within 2^-7 of
max |plain| (one bf16 ulp of the largest element: the kernel rounds P
against the running max of its 128-key tiles, the plain version against
the row's max) and, row by row, within 2^-6 of each query row's own
max |plain| (that ulp plus the f32 sums' order; a row that averages n
keys has outputs of ~sqrt(e/n), which the first measure cannot see),
lse within 1e-5 absolute (f32 sums of up to T
exponentials in another order, and exp2 with log2(e) folded into the
scores; a Q * scale left unrounded moves it by ~2e-3), and two launches
on the same inputs give the same bits.  The flash backward
is held relative to the largest gradient element: 1e-4 in f32 (sums of
up to T products in another order), 8e-3 in bf16 (the plain version
rounds Q * scale, P and dS where the kernels do, so what differs is the
f32 summation order, which can move a stored gradient by one bf16 ulp:
at most 2^-7 of the largest), and two launches on the same inputs give
the same bits (one writer per element, no atomics).  `runtime.rng`
draws the same bits on the card as on the CPU.  The
dequant-matmul is held relative to max |plain|: 1e-5 (f32 sums of K <=
1024 products in another order, the scale applied after the sum), and a
quantized transformer's probabilities on the card within 2e-5 of max p
of the same model on the CPU (f32 both sides, every product and the
attention summed in another order).  Both of its routes are held at
any M: the tensor-core route (x split into two bf16 parts) within the
same 1e-5, and 2e-5 at K 4096, as the f32 FMAs.  The f32 flash forward
(`flash_fwd_split`, bf16 parts on the tensor cores) is held to the same
2e-4 as before, out and lse, and gives the same bits twice.  The paged
attention kernel is held at every head dim family it is built for:
multiples of 32 (contiguous lanes) and the others (strided lanes), and,
at the flagship's widths (8 heads of 128, 16-row pages, 160-wide
tables), where it splits each slot into chunks of pages merged in a
fixed order: one long slot alone, lengths on chunk boundaries and one
off them, pages shared between slots, the same bits from a second
launch (1e-4 against plain, both page types), and a pool view that
`cp.async.bulk` cannot read raising before a launch.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.convert import params_to_numpy
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.ops.dequant_matmul import (
    dequant_matmul,
    dequant_matmul_plain,
    kernel_route,
    launch_dequant_matmul,
)
from deeplearning4j_tpu_torch.ops.flash_attention import (
    flash_bwd,
    flash_bwd_plain,
    flash_fwd,
    flash_fwd_plain,
)
from deeplearning4j_tpu_torch.ops.generation import _sample, generate
from deeplearning4j_tpu_torch.ops.paged_attention import (
    paged_attention_fwd,
    paged_attention_plain,
    split_plan,
)
from deeplearning4j_tpu_torch.quant import quantize
from deeplearning4j_tpu_torch.runtime import kernels, rng
from deeplearning4j_tpu_torch.serving.generation import (
    GenerationConfig,
    GenerationEngine,
)
from deeplearning4j_tpu_torch.serving.kv_cache import quantize_page_rows
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

pytestmark = pytest.mark.torch_port


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("t", [16, 144, 2000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_kernel_matches_plain(cuda, t, d, causal, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(t * d)
    q, k, v = (torch.randn((3, t, d), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = kernels.launches().get("flash_fwd", 0)
    out, lse = flash_fwd(q, k, v, causal=causal)
    ref, ref_lse = flash_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launches()["flash_fwd"] == before + 1
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 2e-4


def _bf16_qkv(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
            for _ in range(3)]


def _fwd_errors(out, lse, ref, ref_lse):
    """(max |out - ref| relative to max |ref|, the largest of each query
    row's max |out - ref| relative to that row's max |ref|,
    max |lse - ref_lse|)."""
    diff, mag = (out.float() - ref.float()).abs(), ref.float().abs()
    return ((diff.max() / mag.max()).item(),
            (diff.amax(-1) / mag.amax(-1).clamp_min(1e-30)).max().item(),
            (lse - ref_lse).abs().max().item())


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 63, 65, 127, 129, 144, 2000])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_flash_fwd_kernel_matches_rounding_plain(cuda, t, d, causal):
    q, k, v = _bf16_qkv((3, t, d), t * d + 2, cuda)
    before = kernels.launches().get("flash_fwd", 0)
    out, lse = flash_fwd(q, k, v, causal=causal)
    again = flash_fwd(q, k, v, causal=causal)
    ref, ref_lse = flash_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launches()["flash_fwd"] == before + 2
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    rel, row, lse_err = _fwd_errors(out, lse, ref, ref_lse)
    assert rel <= 2**-7 and row <= 2**-6 and lse_err <= 1e-5, (rel, row, lse_err)


def test_bf16_flash_fwd_rejects_views_tma_cannot_read(cuda):
    q, k, v = _bf16_qkv((2, 64, 32), 8, cuda)
    flat = torch.zeros(2 * 64 * 32 + 1, dtype=torch.bfloat16, device=cuda)
    off = flat[1:].view(2, 64, 32)                              # 2 bytes off
    rows = torch.zeros((2, 64, 36), dtype=torch.bfloat16, device=cuda)[..., :32]
    before = kernels.launches().get("flash_fwd", 0)
    for bad, match in ((off, "16-byte"), (rows, "contiguous")):
        for args in ((bad, k, v), (q, bad, v), (q, k, bad)):
            with pytest.raises(ValueError, match=match):
                flash_fwd(*args, causal=True)
    assert kernels.launches().get("flash_fwd", 0) == before


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("t", [1, 16, 63, 65, 144, 2000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels_match_plain(cuda, t, d, causal, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(t * d + 1)
    q, k, v, go = (torch.randn((3, t, d), generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    out, lse = flash_fwd_plain(q, k, v, causal=causal)
    before = kernels.launches()
    got = flash_bwd(q, k, v, out, lse, go, causal=causal)
    ref = flash_bwd_plain(q, k, v, out, lse, go, causal=causal)
    torch.cuda.synchronize()
    after = kernels.launches()
    for name in ("flash_bwd_dq", "flash_bwd_dkdv"):
        assert after[name] == before.get(name, 0) + 1
    for a, b in zip(got, ref):
        assert a.dtype == dtype
        scale = b.float().abs().max().item()
        # at T = 1 dq and dk vanish (dP = delta exactly), and each side
        # reaches 0 only to the f32 cancellation error of dP - delta
        floor = 1e-5 if t == 1 else 0.0
        assert (a.float() - b.float()).abs().max().item() <= tol * scale + floor


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels_are_deterministic(cuda, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, go = (torch.randn((4, 300, 128), generator=g, device=cuda)
                   .to(dtype) for _ in range(4))
    out, lse = flash_fwd(q, k, v, causal=causal)
    first = flash_bwd(q, k, v, out, lse, go, causal=causal)
    second = flash_bwd(q, k, v, out, lse, go, causal=causal)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_random_bits_on_the_card_are_the_cpu_bits(cuda):
    """`runtime.rng` on CUDA tensors gives the bits and Gumbel values the
    CPU gives (and the CPU's are jax's, `tests/test_torch_rng.py`); a
    token sampled from card logits is the one sampled from the same
    logits on the CPU."""
    key = rng.fold_in(rng.key(11), 3)
    assert torch.equal(rng.random_bits(key, (2, 32000), cuda).cpu(),
                       rng.random_bits(key, (2, 32000)))
    assert torch.equal(rng.gumbel(key, (2, 32000), cuda).cpu(),
                       rng.gumbel(key, (2, 32000)))
    logits = torch.randn((2, 32000), generator=torch.Generator().manual_seed(5))
    for top_k in (50, 0):
        for g in range(4):
            kw = dict(temperature=0.8, top_k=top_k, seed=11, g=g)
            assert torch.equal(_sample(logits.to(cuda), **kw).cpu(),
                               _sample(logits, **kw))


def test_training_on_the_card_matches_the_cpu(cuda):
    """f32 compute, 3 Adam steps of a small transformer on the card
    (every kernel, forward and backward) against the same steps on the
    CPU (the plain versions): losses within 1e-4."""
    kw = dict(vocab_size=97, d_model=256, n_heads=2, n_layers=2,
              chunked_vocab_loss=True, vocab_chunk=32, bf16_compute=False)
    card = TransformerEncoder(**kw).init_model(device=cuda)
    cpu = TransformerEncoder(**kw).init_model(device="cpu")
    cpu.load_params(_to_cpu(card.params))
    rng = np.random.default_rng(0)
    kernels.reset_launches()
    for _ in range(3):
        ids = rng.integers(0, 97, (2, 144))
        batch = DataSet(ids, np.roll(ids, -1, axis=1))
        card.fit_batch(batch)
        cpu.fit_batch(batch)
        assert abs(card.score_value - cpu.score_value) <= 1e-4
    counts = kernels.launches()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        assert counts.get(name, 0) == 2 * 3, counts


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.detach().cpu()
            for k, v in tree.items()}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dh", [16, 48, 80, 96, 128, 192, 256])
def test_paged_attention_kernel_matches_plain(cuda, quant, dh):
    s, h, n_pages, ps, mp = 5, 4, 40, 16, 12
    # seed 1 at dh 128, the inputs this test ran before it took other dims
    g = torch.Generator(device=cuda).manual_seed(1 if dh == 128 else dh)
    lens = torch.tensor([0, 1, 17, 190, 64], dtype=torch.int32, device=cuda)
    tbl = torch.randint(1, n_pages, (s, mp), generator=g, device=cuda,
                        dtype=torch.int32)
    q = torch.randn((s, h, dh), generator=g, device=cuda)
    kp = torch.randn((n_pages, ps, h, dh), generator=g, device=cuda)
    vp = torch.randn((n_pages, ps, h, dh), generator=g, device=cuda)
    ks = vs = None
    if quant:
        kp, ks = quantize_page_rows(kp)
        vp, vs = quantize_page_rows(vp)
    out = paged_attention_fwd(q, kp, vp, tbl, lens, ks, vs)
    ref = paged_attention_plain(q, kp, vp, tbl, lens, ks, vs)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4
    assert torch.all(out[0] == 0)


FLAG_H, FLAG_DH, FLAG_PS, FLAG_MP = 8, 128, 16, 160


def _flagship_pages(cuda, quant, lens, seed, tbl=None, n_pages=None):
    """q, pools and table at the flagship's widths; each live slot gets its
    own pages unless ``tbl`` is given."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    s = len(lens)
    if tbl is None:
        need = [-(-n // FLAG_PS) for n in lens]
        n_pages = n_pages or sum(need) + 1
        perm = (torch.randperm(n_pages - 1, generator=g, device=cuda) + 1).int()
        tbl = torch.zeros((s, FLAG_MP), dtype=torch.int32, device=cuda)
        used = 0
        for i, k in enumerate(need):
            tbl[i, :k] = perm[used:used + k]
            used += k
    q = torch.randn((s, FLAG_H, FLAG_DH), generator=g, device=cuda)
    kp = torch.randn((n_pages, FLAG_PS, FLAG_H, FLAG_DH), generator=g, device=cuda)
    vp = torch.randn((n_pages, FLAG_PS, FLAG_H, FLAG_DH), generator=g, device=cuda)
    ks = vs = None
    if quant:
        kp, ks = quantize_page_rows(kp)
        vp, vs = quantize_page_rows(vp)
    seq = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, kp, vp, tbl, seq, ks, vs


def _paged_against_plain(args, idle=()):
    out = paged_attention_fwd(*args)
    ref = paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4
    for i in idle:
        assert torch.all(out[i] == 0)
    return out


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_one_long_slot_alone(cuda, quant):
    """Slot 2 fills its whole 160-page table (80 chunks merged by the last
    block); every other slot is idle."""
    lens = [0, 0, FLAG_MP * FLAG_PS, 0]
    _paged_against_plain(_flagship_pages(cuda, quant, lens, seed=21), idle=(0, 1, 3))


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_lengths_on_chunk_boundaries(cuda, quant):
    _, ppc = split_plan(FLAG_H, FLAG_DH, FLAG_PS, quant)
    span = ppc * FLAG_PS
    lens = [span - 1, span, span + 1, 2 * span - 1, 2 * span, 2 * span + 1, 0, 1]
    _paged_against_plain(_flagship_pages(cuda, quant, lens, seed=22), idle=(6,))


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_pages_shared_between_slots(cuda, quant):
    """Tables that name the same pages in several slots and twice in one
    slot (a shared prompt prefix; the kernel only reads the pool)."""
    n_pages = 12
    g = torch.Generator(device=cuda).manual_seed(23)
    tbl = torch.randint(1, n_pages, (5, FLAG_MP), generator=g, device=cuda,
                        dtype=torch.int32)
    tbl[1] = tbl[0]
    tbl[2, 10:20] = tbl[2, :10]
    lens = [300, 300, 333, 0, 40]
    _paged_against_plain(_flagship_pages(cuda, quant, lens, seed=23, tbl=tbl,
                                         n_pages=n_pages), idle=(3,))


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_second_launch_gives_the_same_bits(cuda, quant):
    """Which block merges a slot's chunks varies between launches; what it
    computes must not."""
    args = _flagship_pages(cuda, quant, [2017, 20, 150, 300, 5, 64, 0, 90], seed=24)
    first = _paged_against_plain(args, idle=(6,))
    for _ in range(3):
        assert torch.equal(paged_attention_fwd(*args), first)


def test_paged_attention_rejects_a_misaligned_pool(cuda):
    q, kp, vp, tbl, seq, _, _ = _flagship_pages(cuda, False, [40, 0], seed=25)
    flat = torch.empty(kp.numel() + 1, device=cuda)
    shifted = flat[1:].view(kp.shape)            # contiguous, 4 bytes off
    shifted.copy_(kp)
    with pytest.raises(ValueError, match="16-byte"):
        paged_attention_fwd(q, shifted, vp, tbl, seq)


def test_engine_on_the_card_matches_dense_generate(cuda):
    """f32 compute, greedy: paged decode through both kernels agrees with
    the dense reference token for token at a small width."""
    model = TransformerEncoder(vocab_size=97, d_model=256, n_heads=2,
                               n_layers=2, chunked_vocab_loss=True,
                               bf16_compute=False).init_model(device=cuda)
    prompts = [np.random.default_rng(n).integers(0, 97, n) for n in (5, 33, 80)]
    refs = [generate(model, p[None], 12)[0].cpu().numpy() for p in prompts]
    eng = GenerationEngine(model, GenerationConfig(
        slots=4, page_size=16, num_pages=32, max_pages_per_seq=8)).start()
    try:
        kernels.reset_launches()
        outs = [r.result(120) for r in [eng.submit(p, 12) for p in prompts]]
    finally:
        eng.stop()
    counts = kernels.launches()
    assert counts.get("flash_fwd", 0) > 0 and counts.get("paged_attention_fwd", 0) > 0
    for out, ref in zip(outs, refs):
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("m,k,n", [(4096, 1024, 4096), (8, 1024, 4096),
                                   (5, 100, 72)])
def test_dequant_matmul_kernel_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    q = torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    scale = torch.rand((n,), generator=g, device=cuda) / 127 + 1e-4
    before = kernels.launches().get("dequant_matmul", 0)
    y = dequant_matmul(x, q, scale)
    ref = dequant_matmul_plain(x, q, scale)
    torch.cuda.synchronize()
    assert kernels.launches()["dequant_matmul"] == before + 1
    assert y.dtype == torch.float32 and y.shape == (m, n)
    assert (y - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("route", ["wgmma", "rows"])
@pytest.mark.parametrize("m,k,n", [(1, 1024, 4096), (8, 1024, 4096),
                                   (64, 1024, 4096), (65, 1024, 4096),
                                   (4096, 1024, 4096), (4096, 4096, 1024),
                                   (200, 100, 48), (5, 100, 72)])
def test_dequant_matmul_routes_match_plain(cuda, m, k, n, route):
    """Both routes of B5 at any M: within 1e-5 (K 1024) or 2e-5 (K 4096) of
    max |plain|, the same bits from a second launch.  N 72 is no multiple
    of 16, so TMA cannot read it: the tensor-core route refuses it."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    q = torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    scale = torch.rand((n,), generator=g, device=cuda) / 127 + 1e-4
    if route == "wgmma" and n % 16:
        with pytest.raises(ValueError, match="multiple of 16"):
            launch_dequant_matmul(x, q, scale, route)
        return
    before = kernels.launches().get("dequant_matmul", 0)
    y = launch_dequant_matmul(x, q, scale, route)
    again = launch_dequant_matmul(x, q, scale, route)
    ref = dequant_matmul_plain(x, q, scale)
    torch.cuda.synchronize()
    assert kernels.launches()["dequant_matmul"] == before + 2
    assert torch.equal(y, again)
    tol = 1e-5 if k <= 1024 else 2e-5
    assert (y - ref).abs().max().item() <= tol * ref.abs().max().item()


def test_dequant_matmul_picks_the_route_by_shape(cuda):
    q = torch.zeros((64, 48), dtype=torch.int8, device=cuda)
    assert kernel_route(64, 48, 64, q) == "rows"
    assert kernel_route(65, 48, 64, q) == "wgmma"
    assert kernel_route(65, 40, 64, q) == "rows"          # TMA: N % 16


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 17, 144, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_flash_fwd_split_kernel_matches_plain(cuda, t, d, causal):
    """f32 B1 on the tensor cores (split bf16 parts) against the exact f32
    plain version: out and lse within 2e-4, the same bits again."""
    g = torch.Generator(device=cuda).manual_seed(t * d + 3)
    q, k, v = (torch.randn((3, t, d), generator=g, device=cuda) for _ in range(3))
    out, lse = flash_fwd(q, k, v, causal=causal)
    again = flash_fwd(q, k, v, causal=causal)
    ref, ref_lse = flash_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert (out - ref).abs().max().item() <= 2e-4
    assert (lse - ref_lse).abs().max().item() <= 2e-4


def test_quantized_output_on_the_card_matches_the_cpu(cuda):
    """A 2-layer quantized transformer with its softmax head: ``output()``
    on the card (B5 and f32 B1) against the same int8 tree on the CPU
    (the plain versions)."""
    kw = dict(vocab_size=97, d_model=256, n_heads=2, n_layers=2)
    cpu = quantize(TransformerEncoder(**kw).init_model(device="cpu"))
    card = SequentialModel(TransformerEncoder(**kw).conf(), device=cuda)
    card.load_params(params_to_numpy(cpu))
    assert card.compute_dtype == torch.float32          # bf16 default ignored
    ids = np.random.default_rng(0).integers(0, 97, (2, 144))
    kernels.reset_launches()
    got = card.output(ids)
    torch.cuda.synchronize()
    assert kernels.launches() == {"dequant_matmul": 2 * 6 + 1, "flash_fwd": 2}
    ref = cpu.output(ids)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert (got.cpu() - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()
