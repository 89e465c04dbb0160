"""The port's hand-written CUDA kernels against their plain versions, on
the card.  Without a CUDA device every test here skips (the CPU suite
holds the plain versions against the JAX package instead).  On the card:

    python -m pytest --noconftest -m torch_port tests/test_torch_cuda_kernels.py

(``--noconftest`` skips the suite's conftest, which sets JAX up: a CUDA
environment need not have JAX.)

Tolerances: f32 kernels within 2e-4 (flash) and 1e-4 (paged) absolute —
the same arithmetic in another summation order; the bf16 flash output
within 1.6e-2, one bf16 rounding of an O(1) value.  The f32 flash
backward (`flash_bwd_dq_split`, `flash_bwd_dkdv_split`: bf16 parts on the
tensor cores) at every head dim it is built for, and views from a 4-byte
offset start read as the aligned ones while padded rows raise.  The bf16 flash
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
draws the same bits on the card as on the CPU (uniform, Gumbel, normal
and bernoulli), and a checkpoint zip written on the card restores on
the CPU bit for bit.  The
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
`cp.async.bulk` cannot read raising before a launch.  The speculative
verify's chunk attention (the same kernel on S x C pseudo-slots) is held
to the same 1e-4 and the same bits on a second launch.  The engine's
decode and verify steps captured as CUDA graphs give the eager steps'
logits and tokens bit for bit over 16 dispatches, count each kernel the
graph holds once a replay, and are captured again when a training step
rebuilds the model's compute parameters.  The serving plane on captured
steps: a watchdog abort while a step is held inside its arm fails the
streams, the held loop enqueues nothing after the release (the pools
keep their bits) and the respawned loop serves the same greedy tokens;
a hot-swap between replays captures once more, drops no stream, and
each replay still counts one paged-attention launch a layer.  The
serving fleet: two replicas in one process capture and replay their
decode graphs concurrently with exact launch totals, and a rolling
deploy's canary passes an honest deploy at tolerance 1e-4 under routed
traffic.  Int8 serving: the quantized model's captured decode and verify
steps give the eager steps' bits and count 13 B5 launches a replay (2
layers x 6 products and the head); its engine agrees with dense
`generate` (>= 0.95, first tokens identical) before and after a
quantized hot-swap that re-captures the step; ``DL4JTPU_QUANT_KERNEL``
unset, auto or ``pallas`` launches B5 on the card, and ``xla`` or
``blocked`` raises there.  The LeNet slice: 3 f32 LeNet steps on the
card (cuDNN in exact f32, the captured step), each from the CPU's trees,
with Sgd and with Adam: the loss within 1e-5, Dense and the head's
parameters (Sgd) and moments (Adam) within 1e-5 of each leaf's largest
element, every Adam step the Adam formula on the card's own moments and
staged step values; LeNet's conv and pooling layers on identical inputs,
forward and backward, within 1e-5 of the CPU's; a step after
`load_params` trains the new weights; the captured training step's
replays against the same program run eagerly, bit for bit (LeNet in f32
and bf16, SimpleCNN with dropout and BatchNorm); convolutions from 4
threads give the single thread's bits and leave cuDNN's flags as they
were; quantized LeNet with exactly 2 B5 launches a call, within 2e-5 of
max p of the CPU's quantized model.  The attention slice: the captured
training step of a MoE transformer (bf16 and f32) and of a masked
classifier over batches whose masks differ (one capture) against the
eager step, bit for bit.  The ResNet-50 slice: a narrow ResNet in f32
on the card against the CPU (``output()`` within 1e-5 of max p, 3 steps'
losses within 1e-5), a graph step after `load_params`, and side-stream
staging (pinned memory, an event) bit for bit.  The recurrent slice: a
small GravesLSTM char-RNN under truncated BPTT with
``steps_per_execution=2``: the captured window steps against the same
windows run eagerly, bit for bit, with the graph's carry inputs filled
with NaN between groups (each batch's first window zeros them).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.convert import params_to_numpy
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.sequential import SequentialModel, tree_leaves
from deeplearning4j_tpu_torch.nn.updaters import Adam, Sgd, state_leaves
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
    paged_attention_chunk,
    paged_attention_chunk_plain,
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
from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer
from deeplearning4j_tpu_torch.zoo.lenet import LeNet
from deeplearning4j_tpu_torch.zoo.simplecnn import SimpleCNN
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
@pytest.mark.parametrize("d", [16, 32, 64, 128])
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


def test_f32_flash_bwd_rejects_views_tma_cannot_read(cuda):
    """f32 B2 / B3 read q * scale, k, v and g through TMA maps over the
    bf16 parts their pre-pass writes, and the pre-pass reads the f32
    inputs as flat arrays with plain loads: a contiguous view from any
    4-byte aligned start goes and gives the aligned inputs' bits; padded
    rows, or a head dim no kernel is built for, raise before a launch."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, go = (torch.randn((2, 64, 32), generator=g, device=cuda) for _ in range(4))
    out, lse = flash_fwd_plain(q, k, v, causal=True)
    rows = torch.zeros((2, 64, 36), device=cuda)[..., :32]
    wide = torch.zeros((2, 64, 48), device=cuda)
    names = ("flash_bwd_dq", "flash_bwd_dkdv")
    before = [kernels.launches().get(n, 0) for n in names]
    args = [q, k, v, out, lse, go]
    for i in (0, 1, 2, 5):
        bad = list(args)
        bad[i] = rows
        with pytest.raises(ValueError, match="contiguous"):
            flash_bwd(*bad, causal=True)
    with pytest.raises(ValueError, match="head dim"):
        flash_bwd(wide, wide, wide, wide, lse, wide, causal=True)
    assert [kernels.launches().get(n, 0) for n in names] == before
    off = torch.zeros(2 * 64 * 32 + 1, device=cuda)[1:].view(2, 64, 32)   # 4 bytes off
    off.copy_(q)
    got = flash_bwd(off, k, v, out, lse, go, causal=True)
    want = flash_bwd(q, k, v, out, lse, go, causal=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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


def test_normal_and_bernoulli_bits_on_the_card_are_the_cpu_bits(cuda):
    """`runtime.rng`'s normal (XLA's erfinv, its multiply-adds rounded
    once) and bernoulli draws on the card equal the CPU's (which equal
    jax's, `tests/test_torch_init_rng.py`), at odd and even sizes; so a
    model initialised on the card has the CPU's, and the JAX package's,
    weights bit for bit."""
    for seed, shape in ((3, (2, 32000)), (11, (7, 333)), (-1, (1024, 1025))):
        key = rng.fold_in(rng.key(seed), 5)
        assert torch.equal(rng.normal(key, shape, cuda).cpu(),
                           rng.normal(key, shape))
        assert torch.equal(rng.bernoulli(key, 0.9, shape, cuda).cpu(),
                           rng.bernoulli(key, 0.9, shape))
    kw = dict(vocab_size=97, d_model=256, n_heads=2, n_layers=2)
    card = TransformerEncoder(**kw).init_model(device=cuda)
    cpu = TransformerEncoder(**kw).init_model(device="cpu")
    for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        assert torch.equal(a.cpu(), b)


def test_zip_written_on_the_card_restores_on_the_cpu(cuda, tmp_path):
    """A model trained on the card (bf16 compute, Adam, dropout 0.1) and
    written with its updater restores on the CPU with every parameter,
    optimizer leaf and counter bit for bit, and back on the card."""
    kw = dict(vocab_size=97, d_model=256, n_heads=2, n_layers=2,
              chunked_vocab_loss=True, vocab_chunk=32)
    conf = TransformerEncoder(**kw).conf()
    conf = dataclasses.replace(conf, layers=tuple(
        dataclasses.replace(l, dropout_rate=0.1) for l in conf.layers))
    card = SequentialModel(conf, device=cuda).init()
    ids = np.random.default_rng(0).integers(0, 97, (2, 144))
    for _ in range(2):
        card.fit_batch(DataSet(ids, np.roll(ids, -1, axis=1)))
    path = str(tmp_path / "card.zip")
    ModelSerializer.write_model(card, path)
    for device in ("cpu", cuda):
        back = ModelSerializer.restore(path, device=device)
        assert back.device.type == torch.device(device).type
        assert back.iteration == 2 and back.epoch == 0
        for a, b in zip(tree_leaves(card.params), tree_leaves(back.params)):
            assert torch.equal(a.cpu(), b.cpu())
        got, want = (state_leaves(m.opt_state) for m in (back, card))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a.cpu(), b.cpu())
            else:
                assert int(a) == int(b)


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


def _lenet_batches(n, batch=32, seed=0):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.random((batch, 28, 28, 1)).astype(np.float32),
                    np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)])
            for _ in range(n)]


LENET_UPDATERS = {"sgd": lambda: Sgd(0.1), "adam": lambda: Adam(1e-3)}
# LeNet's leaves that no max window routes a gradient to: Dense and the head
LENET_UNPOOLED = ("layer4", "layer5")


def _lenet_on_both(cuda, updater):
    conf = dataclasses.replace(LeNet().conf(), bf16_compute=False, updater=updater)
    return (SequentialModel(conf, device=cuda).init(),
            SequentialModel(conf, device="cpu").init())


def _rel_gap(got, want) -> float:
    """The largest gap over the largest reference element."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-30))


def _unpooled(tree) -> list:
    return tree_leaves({k: tree[k] for k in LENET_UNPOOLED})


def _adam_moments(model, names) -> list:
    """(mu, nu) of each named layer's leaves, in the parameter order.  The
    state is ``((adam (count, mu, nu), rate (count,)),)``: Adam's chain
    under the (absent) clipping."""
    ((_, mu, nu), _), = model.opt_state
    order = sorted(model.params)
    n = [len(tree_leaves(model.params[k])) for k in order]
    first = dict(zip(order, np.cumsum([0] + n[:-1])))
    idx = [first[k] + j for k in names for j in range(len(tree_leaves(model.params[k])))]
    return [(mu[i], nu[i]) for i in idx]


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_lenet_steps_on_the_card_match_the_cpu(cuda, updater):
    """f32 compute: 3 LeNet steps on the card (the captured step: one
    capture, then replays) against the same steps on the CPU, each from
    the same trees: before steps 2 and 3 the CPU's parameters and
    optimizer state are copied into the card's own tensors (its graph
    reads them).  After each step:

    - the loss within 1e-5;
    - Dense and the head (the leaves no max window routes to): Sgd(0.1)'s
      parameters (0.1 x the gradient off the old weights) and Adam's
      moments (0.1 g and 0.001 g^2) within 1e-5 of each leaf's largest
      element, so a gradient off by a scale, or on part of a leaf,
      fails;
    - Adam: every leaf's step is Adam's on the card's own new moments
      and the step count (the rate and the f32 bias corrections the host
      stages for the graph), each element within 1e-6 of the leaf's
      largest step plus half an f32 ulp of the new parameter (p + u is
      rounded once).

    The conv leaves are held by `test_lenet_layers_on_the_card_match_the_cpu`
    instead: in a whole step a max window whose two largest inputs lie
    within rounding of each other sends its whole gradient to either one,
    as each device's f32 sums fall, and that moves the conv leaves'
    gradients by far more than rounding (the JAX package's CPU step and
    the card both route some of these batches' windows unlike the port's
    CPU step)."""
    from deeplearning4j_tpu_torch.nn.updaters import load_state_leaves

    card, cpu = _lenet_on_both(cuda, LENET_UPDATERS[updater]())
    upd = card.conf.updater
    for i, b in enumerate(_lenet_batches(3)):
        if i:
            with torch.no_grad():
                for p, v in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
                    p.copy_(v)
            card.opt_state = load_state_leaves(card.opt_state,
                                               state_leaves(cpu.opt_state))
        before = [p.detach().clone() for p in tree_leaves(card.params)]
        card.fit_batch(b)
        cpu.fit_batch(b)
        assert abs(card.score_value - cpu.score_value) <= 1e-5, i
        if updater == "sgd":
            gaps = [_rel_gap(a, w) for a, w in zip(_unpooled(card.params),
                                                   _unpooled(cpu.params))]
            assert max(gaps) <= 1e-5, (i, gaps)
            continue
        gaps = [_rel_gap(a, w) for (ma, va), (mw, vw) in zip(
            _adam_moments(card, LENET_UNPOOLED), _adam_moments(cpu, LENET_UNPOOLED))
            for a, w in ((ma, mw), (va, vw))]
        assert max(gaps) <= 1e-5, (i, gaps)
        t = np.float32(card.iteration)
        c1, c2 = (float(1 - np.float32(beta) ** t) for beta in (upd.beta1, upd.beta2))
        for p0, p, (mu, nu) in zip(before, tree_leaves(card.params),
                                   _adam_moments(card, sorted(card.params))):
            p = p.detach().cpu().double()
            mu, nu = mu.cpu().double(), nu.cpu().double()
            step = -float(np.float32(upd.learning_rate)) * (mu / c1) / (
                (nu / c2).sqrt() + float(np.float32(upd.epsilon)))
            err = (p - p0.cpu().double() - step).abs()
            assert bool((err <= 1e-6 * step.abs().max() + p.abs() * 2.0**-24).all()), i
    stats = card.compile_stats()
    assert stats["step_programs"] == 1 and stats["jit_cache_misses"] == 1


def test_lenet_layers_on_the_card_match_the_cpu(cuda):
    """Each of LeNet's convolution and pooling layers on the card, forward
    and backward (of ``sum(y * g)``, g seeded), on the CPU's own inputs
    to it (its activations at batch 32): output and the gradients of the
    input, the kernel and the bias within 1e-5 of each one's largest
    element (cuDNN in exact f32 against the CPU, the same sums in
    another order).  Identical inputs route every max window alike."""
    conf = dataclasses.replace(LeNet().conf(), bf16_compute=False)
    cpu = SequentialModel(conf, device="cpu").init()
    x = _lenet_batches(1)[0].features
    acts = [torch.from_numpy(x)] + cpu.feed_forward(x)
    gen = torch.Generator().manual_seed(3)
    for i, layer in enumerate(conf.layers[:4]):
        params = cpu.params.get(layer.name, {})
        g = torch.randn(acts[i + 1].shape, generator=gen)
        res = []
        for dev in ("cpu", cuda):
            a = acts[i].detach().to(dev).requires_grad_()
            p = {k: v.detach().to(dev).requires_grad_() for k, v in params.items()}
            y, _ = layer.apply(p, {}, a)
            y.mul(g.to(dev)).sum().backward()
            res.append([y, a.grad] + [p[k].grad for k in sorted(p)])
        for got, want in zip(res[1], res[0]):
            assert _rel_gap(got, want) <= 1e-5, (layer.name, _rel_gap(got, want))


def test_a_step_after_load_params_trains_the_new_weights(cuda):
    """Sgd LeNet (no optimizer tensors, no layer state) on the card: a
    step, then `load_params` of other weights, then a step.  The second
    step must move every new parameter and match the CPU's step from the
    same weights: the loss within 1e-5, Dense and the head within 1e-5 of
    each leaf's largest element (a graph kept from the old tensors would
    train those and leave the new ones as they were)."""
    card, cpu = _lenet_on_both(cuda, LENET_UPDATERS["sgd"]())
    b0, b1 = _lenet_batches(2)
    card.fit_batch(b0)
    other = SequentialModel(dataclasses.replace(cpu.conf, seed=7), device="cpu").init()
    card.load_params(_to_cpu(other.params))
    cpu.load_params(_to_cpu(other.params))
    card.fit_batch(b1)
    cpu.fit_batch(b1)
    assert abs(card.score_value - cpu.score_value) <= 1e-5
    moved = [not torch.equal(a.detach().cpu(), b)
             for a, b in zip(tree_leaves(card.params), tree_leaves(other.params))]
    assert all(moved)
    gaps = [_rel_gap(a, w) for a, w in zip(_unpooled(card.params), _unpooled(cpu.params))]
    assert max(gaps) <= 1e-5, gaps
    assert card.compile_stats()["jit_cache_misses"] == 2


def test_conv_flag_windows_in_threads_on_the_card(cuda):
    """Convolution forwards and backwards from 4 threads at once (each
    backward on autograd's thread): every result is the single-thread
    result's bits (deterministic, no TF32, inside every window), and
    cuDNN's global flags are the caller's afterwards."""
    import threading

    from deeplearning4j_tpu_torch.ops.conv import conv2d_nhwc

    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((64, 28, 28, 20), generator=g, device=cuda)
    w = torch.randn((5, 5, 20, 50), generator=g, device=cuda)

    def run():
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = conv2d_nhwc(xr, wr, padding="same")
        y.square().sum().backward()
        return y.detach(), xr.grad, wr.grad

    cudnn = torch.backends.cudnn
    flags = lambda: (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,  # noqa: E731
                     cudnn.allow_tf32)
    with cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                     allow_tf32=True):
        caller = flags()
        want = run()
        got, errors = [], []

        def worker():
            try:
                for _ in range(5):
                    got.append(run())
            except Exception as e:      # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        assert not errors and flags() == caller
    assert len(got) == 20
    for res in got:
        assert all(torch.equal(a, b) for a, b in zip(res, want))


def _snapshot_state(model):
    return ([p.detach().clone() for p in tree_leaves(model.params)],
            [x.clone() if isinstance(x, torch.Tensor) else x
             for x in state_leaves(model.opt_state)],
            [x.clone() for x in tree_leaves(model.net_state)], model.iteration)


def _masked_batches(n, vocab=64, rows=4, t=24):
    """Padded id batches whose masks differ batch to batch, two-class."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        mask = (np.arange(t)[None] < rng.integers(4, t + 1, (rows, 1))).astype(np.float32)
        ids = (rng.integers(1, vocab, (rows, t)) * mask).astype(np.int64)
        out.append(DataSet(ids, np.eye(2, dtype=np.float32)[rng.integers(0, 2, rows)],
                           features_mask=mask))
    return out


def _masked_conf():
    """A small non-causal classifier: blocks, `GlobalPooling`, softmax."""
    from deeplearning4j_tpu_torch.nn.conf.attention import (
        PositionalEncoding,
        TransformerEncoderBlock,
    )
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        Embedding,
        GlobalPooling,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        NeuralNetConfiguration,
    )

    return (NeuralNetConfiguration.builder().seed(4).updater(Adam(1e-3)).list()
            .layer(Embedding(n_in=64, n_out=64))
            .layer(PositionalEncoding(learned=True, max_length=32))
            .layer(TransformerEncoderBlock(d_model=64, n_heads=2, causal=False))
            .layer(TransformerEncoderBlock(d_model=64, n_heads=2, causal=False))
            .layer(GlobalPooling(pooling="avg"))
            .layer(OutputLayer(n_out=2))
            .set_input_type(InputType.recurrent(1)).build())


@pytest.mark.parametrize("name,bf16", [("lenet", False), ("lenet", True),
                                       ("simplecnn", True), ("moe", True),
                                       ("moe", False), ("masked", True)])
def test_captured_training_steps_are_the_eager_steps(cuda, name, bf16):
    """From one snapshot, 3 replays of the captured step and 3 eager runs
    of the same step program give the same losses, parameters, Adam state
    and BatchNorm state, bit for bit (SimpleCNN: dropout keys and
    BatchNorm stats through the graph's device inputs; the MoE
    transformer: the routed dispatch and the aux loss; the masked
    classifier: batches whose features masks differ, one capture)."""
    from deeplearning4j_tpu_torch.nn.updaters import load_state_leaves

    if name == "lenet":
        conf, batches = LeNet().conf(), _lenet_batches(4)
    elif name == "moe":
        conf = TransformerEncoder(vocab_size=64, d_model=64, n_heads=2, n_layers=2,
                                  chunked_vocab_loss=True, vocab_chunk=32,
                                  moe_experts=4).conf()
        rng = np.random.default_rng(2)
        batches = [DataSet(ids, np.roll(ids, -1, axis=1)) for ids in
                   (rng.integers(0, 64, (2, 32)) for _ in range(4))]
    elif name == "masked":
        conf, batches = _masked_conf(), _masked_batches(4)
    else:
        conf = SimpleCNN(height=32, width=32).conf()
        rng = np.random.default_rng(1)
        batches = [DataSet(rng.random((16, 32, 32, 3)).astype(np.float32),
                           np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)])
                   for _ in range(4)]
    model = SequentialModel(dataclasses.replace(conf, bf16_compute=bf16),
                            device=cuda).init()
    model.fit_batch(batches[0])                  # runs and captures
    params, opt, state, it = _snapshot_state(model)
    runs = []
    for capture in (True, False):
        model.capture_steps = capture
        with torch.no_grad():
            for p, v in zip(tree_leaves(model.params), params):
                p.copy_(v)
            for x, v in zip(tree_leaves(model.net_state), state):
                x.copy_(v)
        model.opt_state = load_state_leaves(model.opt_state, opt)
        model.iteration = it
        losses = []
        for b in batches[1:]:
            model.fit_batch(b)
            losses.append(model._last_score.clone())
        runs.append((losses, _snapshot_state(model)))
    model.capture_steps = True
    (lc, sc), (le, se) = runs
    assert all(torch.equal(a, b) for a, b in zip(lc, le))
    for got, want in zip(sc[:3], se[:3]):
        for a, b in zip(got, want):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else int(a) == int(b))
    assert sc[3] == se[3] == it + 3
    assert model.compile_stats()["jit_cache_misses"] == 1


def test_quantized_lenet_launches_b5_twice_a_call(cuda):
    """Quantized LeNet on the card: Dense and the head through B5 (2
    launches a call), the convs on the dequantized kernels; probabilities
    within 2e-5 of max p of the same quantized model on the CPU."""
    conf = dataclasses.replace(LeNet().conf(), bf16_compute=False)
    q = quantize(SequentialModel(conf, device=cuda).init())
    qc = quantize(SequentialModel(conf, device="cpu").init())
    x = np.random.default_rng(2).random((64, 28, 28, 1)).astype(np.float32)
    kernels.reset_launches()
    p = q.output(x)
    torch.cuda.synchronize()
    assert kernels.launches() == {"dequant_matmul": 2}
    ref = qc.output(x)
    assert (p.cpu() - ref).abs().max() <= 2e-5 * ref.abs().max()


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


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_chunk_kernel_matches_plain(cuda, quant):
    """The verify shape: 8 slots x 5 rows of the serve mix, row j
    attending seq_len + j + 1 positions; slot 6 idle."""
    lens = [2017, 20, 150, 300, 5, 64, 0, 90]
    c = 5
    _, kp, vp, tbl, _, ks, vs = _flagship_pages(cuda, quant, [n + c for n in lens],
                                                seed=26)
    g = torch.Generator(device=cuda).manual_seed(27)
    q = torch.randn((len(lens), c, FLAG_H, FLAG_DH), generator=g, device=cuda)
    seq = torch.tensor(lens, dtype=torch.int32, device=cuda)
    attend = torch.where(seq[:, None] > 0,
                         seq[:, None] + torch.arange(1, c + 1, device=cuda), 0).int()
    name = "paged_attention_chunk_int8" if quant else "paged_attention_chunk"
    before = kernels.launches().get(name, 0)
    out = paged_attention_chunk(q, kp, vp, tbl, attend, k_scale=ks, v_scale=vs)
    ref = paged_attention_chunk_plain(q, kp, vp, tbl, attend, ks, vs)
    torch.cuda.synchronize()
    assert kernels.launches()[name] == before + 1
    assert (out - ref).abs().max().item() <= 1e-4
    assert torch.all(out[6] == 0)
    assert torch.equal(paged_attention_chunk(q, kp, vp, tbl, attend, k_scale=ks,
                                             v_scale=vs), out)


def _card_engine(cuda, bf16, **cfg):
    model = TransformerEncoder(vocab_size=97, d_model=256, n_heads=2,
                               n_layers=2, chunked_vocab_loss=True,
                               bf16_compute=bf16).init_model(device=cuda)
    return model, GenerationEngine(model, GenerationConfig(**{
        **dict(slots=4, page_size=16, num_pages=64, max_pages_per_seq=8), **cfg}))


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("c", [1, 5])
def test_captured_steps_match_the_eager_steps(cuda, c, bf16, kv_dtype):
    """Three streams admitted (one slot idle); 16 dispatches of C rows a
    slot, each run eagerly and then as the graph replay on the same
    state: the same logits and tokens, bit for bit, and each replay
    counts the layers' paged-attention launches once."""
    model, eng = _card_engine(cuda, bf16, kv_dtype=kv_dtype)
    rng_np = np.random.default_rng(c)
    for slot, n in enumerate((5, 33, 80)):
        req = eng.submit(rng_np.integers(0, 97, n), 40)
        eng._admit_to_slot(eng._loop_gen, slot, eng.queue.take_batch(
            1, 0.0, eng._stop)[0])
        assert eng._slot_req[slot] is req
    name = "paged_attention_fwd" if c == 1 else "paged_attention_chunk"
    name += "_int8" if kv_dtype == "int8" else ""
    for i in range(16):
        toks = np.concatenate([eng._last_tok[:, None],
                               rng_np.integers(0, 97, (4, c - 1))], axis=1).astype(np.int32)
        host = eng._inputs(eng._page_tbl.copy(), eng._seq_lens.copy(), toks)
        logits, greedy = (t.clone() for t in eng._run_eager(c, host))
        before = kernels.launches().get(name, 0)
        (got, got_greedy), _ = eng._replay(c, host)
        torch.cuda.synchronize()
        assert kernels.launches()[name] - before == 2 * (1 + (i == 0))   # + warm-up
        assert torch.equal(got, logits) and torch.equal(got_greedy, greedy)
        nxt = greedy.view(4, c)[:, 0].cpu().numpy()
        for s in range(3):
            eng._seq_lens[s] += 1
            eng._last_tok[s] = nxt[s]
    assert eng.stats()["graph_captures"] == 1
    for s in range(3):
        eng.kv.release(eng._slot_req[s].rid)


def test_graph_is_captured_again_after_a_training_step(cuda):
    """A training step rebuilds the compute parameters: the next dispatch
    captures a new graph, and the streams follow the new weights."""
    model, eng = _card_engine(cuda, False)
    ids = np.random.default_rng(5).integers(0, 97, (2, 32))
    prompts = [np.random.default_rng(n).integers(0, 97, n) for n in (5, 33)]
    eng.start()
    try:
        for step in range(2):
            refs = [generate(model, p[None], 12)[0].cpu().numpy() for p in prompts]
            outs = [r.result(120) for r in [eng.submit(p, 12) for p in prompts]]
            for out, ref in zip(outs, refs):
                np.testing.assert_array_equal(out, ref)
            assert eng.stats()["graph_captures"] == step + 1
            model.fit_batch(DataSet(ids, np.roll(ids, -1, axis=1)))
    finally:
        eng.stop()


def _hold_inputs(eng, n):
    """Hold the engine's n-th step in `_inputs` (inside its watchdog arm,
    before its enqueue) until ``gate`` is set."""
    import threading

    entered, gate, calls = threading.Event(), threading.Event(), [0]
    inputs = eng._inputs

    def held(*a):
        calls[0] += 1
        if calls[0] == n:
            entered.set()
            assert gate.wait(60.0)
        return inputs(*a)

    eng._inputs = held
    return entered, gate


def test_watchdog_abort_during_replays_then_a_new_loop(cuda, tmp_path,
                                                       monkeypatch):
    """A step held inside its arm while captured replays run: the abort
    fails the streams and gives back their pages; the held (stale) loop
    wakes and enqueues nothing, so no page is written after the release;
    the respawned loop serves the same greedy tokens as before."""
    import threading

    from deeplearning4j_tpu_torch.runtime.watchdog import StepWatchdog

    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
    model, eng = _card_engine(cuda, False)
    prompts = [np.random.default_rng(n).integers(0, 97, n) for n in (5, 33, 80)]
    eng.start()
    try:
        want = [r.result(120) for r in [eng.submit(p, 12) for p in prompts]]
    finally:
        eng.stop()
    clock = [0.0]
    eng.watchdog = StepWatchdog(floor_s=1.0, cold_floor_s=1.0,
                                abort=eng._on_wedged, threaded=False,
                                clock=lambda: clock[0], name="generation")
    entered, gate = _hold_inputs(eng, 4)
    reqs = [eng.submit(p, 20) for p in prompts]
    enqueued = []
    run = eng._run
    eng._run = lambda c, host, **kw: enqueued.append(c) or run(c, host, **kw)
    eng.start()
    try:
        assert entered.wait(60.0)
        eng.watchdog.poll(now=100.0)
        for r in reqs:
            with pytest.raises(Exception, match="wedged"):
                r.result(60)
        assert eng.kv.leak_check() is None and eng.kv.used_pages == 0
        torch.cuda.synchronize()
        pools = (eng.kv.k_pages.clone(), eng.kv.v_pages.clone())
        n_enqueued = len(enqueued)
        gate.set()
        for t in threading.enumerate():
            if t.name == "dl4j-torch-generation" and t is not eng._thread:
                t.join(30.0)
        torch.cuda.synchronize()
        assert len(enqueued) == n_enqueued
        assert torch.equal(eng.kv.k_pages, pools[0])
        assert torch.equal(eng.kv.v_pages, pools[1])
        got = [r.result(120) for r in [eng.submit(p, 12) for p in prompts]]
    finally:
        gate.set()
        eng.stop()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.stats()["graph_recaptures"] >= 1     # fresh graphs after it


def test_hot_swap_between_replays_captures_once_more(cuda):
    """`push_weights` while streams decode: the swap lands between two
    replays, the next dispatch captures one new graph, no stream drops,
    and each replay still counts one paged-attention launch a layer."""
    from deeplearning4j_tpu_torch.serving.server import InferenceServer

    model, _ = _card_engine(cuda, False)
    srv = InferenceServer(model)
    eng = GenerationEngine(server=srv, config=GenerationConfig(
        slots=4, page_size=16, num_pages=64, max_pages_per_seq=8)).start()
    prompts = [np.random.default_rng(n).integers(0, 97, n) for n in (5, 17, 20)]
    try:
        reqs = [eng.submit(p, 100) for p in prompts]
        for r in reqs:
            while len(r.tokens_so_far()) < 3:
                time.sleep(0.001)
        new = {k: {kk: (vv.detach() * 1.01 if not isinstance(vv, dict) else
                        {a: b.detach() * 1.01 for a, b in vv.items()})
                   for kk, vv in v.items()} for k, v in model.params.items()}
        assert srv.push_weights(new)
        at_push = [len(r.tokens_so_far()) for r in reqs]
        for r in reqs:
            assert len(r.result(120)) == len(r.prompt) + 100
        assert max(at_push) < 100              # the swap landed mid-stream
        st = eng.stats()
        assert st["graph_captures"] == 2 and st["graph_recaptures"] == 1
        refs = [generate(model, p[None], 12)[0].cpu().numpy() for p in prompts]
        steps0 = eng.stats()["decode_steps"]
        kernels.reset_launches()
        outs = [r.result(120) for r in [eng.submit(p, 12) for p in prompts]]
        steps = eng.stats()["decode_steps"] - steps0
        assert kernels.launches()["paged_attention_fwd"] == 2 * steps
        for out, ref in zip(outs, refs):
            np.testing.assert_array_equal(out, ref)
        assert eng.stats()["graph_captures"] == 2
    finally:
        eng.stop()
        srv.stop()


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


def _card_qengine(cuda, **cfg):
    model = quantize(TransformerEncoder(vocab_size=97, d_model=256, n_heads=2,
                                        n_layers=2, chunked_vocab_loss=True,
                                        ).init_model(device=cuda))
    return model, GenerationEngine(model, GenerationConfig(**{
        **dict(slots=4, page_size=16, num_pages=64, max_pages_per_seq=8), **cfg}))


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("c", [1, 5])
def test_quantized_captured_steps_match_the_eager_steps(cuda, c, kv_dtype):
    """The int8 model's decode and verify steps: the graph replay gives the
    eager step's logits and tokens bit for bit, and counts B5 once a
    product and the head (2 x 6 + 1) and B4 once a layer a replay."""
    model, eng = _card_qengine(cuda, kv_dtype=kv_dtype)
    rng_np = np.random.default_rng(c)
    for slot, n in enumerate((5, 33, 80)):
        eng.submit(rng_np.integers(0, 97, n), 40)
        eng._admit_to_slot(eng._loop_gen, slot, eng.queue.take_batch(
            1, 0.0, eng._stop)[0])
    name = "paged_attention_fwd" if c == 1 else "paged_attention_chunk"
    name += "_int8" if kv_dtype == "int8" else ""
    for i in range(6):
        toks = np.concatenate([eng._last_tok[:, None],
                               rng_np.integers(0, 97, (4, c - 1))], axis=1).astype(np.int32)
        host = eng._inputs(eng._page_tbl.copy(), eng._seq_lens.copy(), toks)
        logits, greedy = (t.clone() for t in eng._run_eager(c, host))
        before = kernels.launches()
        (got, got_greedy), _ = eng._replay(c, host)
        torch.cuda.synchronize()
        after = kernels.launches()
        runs = 1 + (i == 0)                                      # + warm-up
        assert after[name] - before.get(name, 0) == 2 * runs
        assert after["dequant_matmul"] - before.get("dequant_matmul", 0) == 13 * runs
        assert torch.equal(got, logits) and torch.equal(got_greedy, greedy)
        nxt = greedy.view(4, c)[:, 0].cpu().numpy()
        for s in range(3):
            eng._seq_lens[s] += 1
            eng._last_tok[s] = nxt[s]
    assert eng.stats()["graph_captures"] == 1
    for s in range(3):
        eng.kv.release(eng._slot_req[s].rid)


def test_quantized_engine_and_a_swap_on_the_card(cuda):
    """The int8 engine's greedy streams against dense `generate` over the
    same model, before and after a quantized hot-swap that re-captures
    the step over the new q and scale buffers."""
    from deeplearning4j_tpu_torch.quant import QuantizedTensor
    from deeplearning4j_tpu_torch.serving.server import InferenceServer

    model, _ = _card_qengine(cuda)
    srv = InferenceServer(model)
    assert srv.quantized
    eng = GenerationEngine(server=srv, config=GenerationConfig(
        slots=4, page_size=16, num_pages=64, max_pages_per_seq=8)).start()
    prompts = [np.random.default_rng(n).integers(0, 97, n) for n in (5, 33, 80)]

    def agreement():
        refs = [generate(model, p[None], 12)[0].cpu().numpy() for p in prompts]
        outs = [r.result(120) for r in [eng.submit(p, 12) for p in prompts]]
        same = sum(int((np.asarray(o) == r).sum()) for o, r in zip(outs, refs))
        assert all(o[len(p)] == r[len(p)] for o, r, p in zip(outs, refs, prompts))
        return same / sum(len(r) for r in refs)

    def scaled(t):
        if isinstance(t, dict):
            return {k: scaled(v) for k, v in t.items()}
        if isinstance(t, QuantizedTensor):
            return QuantizedTensor(t.q.clone(), t.scale * 1.01)
        return t.detach() * 1.01

    try:
        assert agreement() >= 0.95
        assert srv.push_weights(scaled(model.params))
        assert agreement() >= 0.95
        st = eng.stats()
        assert st["graph_captures"] == 2 and st["graph_recaptures"] == 1
    finally:
        eng.stop()
        srv.stop()


def test_quant_kernel_override_on_the_card(cuda, monkeypatch):
    """Unset, ``auto`` and ``pallas`` launch B5 on a CUDA tensor and count
    ``pallas``; ``xla`` or ``blocked`` raises there, launching and
    counting nothing: the quantized products never fall back to a plain
    version on the card."""
    from deeplearning4j_tpu_torch.observe.metrics import registry
    from deeplearning4j_tpu_torch.ops.dequant_matmul import ENV_KERNEL, IMPLS

    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((8, 1024), generator=g, device=cuda)
    q = torch.randint(-127, 128, (1024, 512), generator=g, device=cuda,
                      dtype=torch.int8)
    scale = torch.rand((512,), generator=g, device=cuda) / 127 + 1e-4
    ref = dequant_matmul_plain(x, q, scale)
    c = registry().counter("dl4jtpu_quant_dequant_matmul_total")
    for env in ("", "auto", "pallas", "xla", "blocked"):
        monkeypatch.setenv(ENV_KERNEL, env)
        n0 = kernels.launches().get("dequant_matmul", 0)
        c0 = {i: c.value(impl=i) for i in IMPLS}
        if env in ("xla", "blocked"):
            with pytest.raises(RuntimeError, match="kernel B5"):
                dequant_matmul(x, q, scale)
            launched, counted = 0, {}
        else:
            y = dequant_matmul(x, q, scale)
            assert (y - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
            launched, counted = 1, {"pallas": 1}
        torch.cuda.synchronize()
        assert kernels.launches().get("dequant_matmul", 0) - n0 == launched
        assert {i: c.value(impl=i) - c0[i] for i in IMPLS} == {
            i: counted.get(i, 0) for i in IMPLS}


def _card_fleet(cuda, bf16, goldens=None):
    from deeplearning4j_tpu_torch.serving.fleet import ServingFleet
    from deeplearning4j_tpu_torch.serving.router import RouterConfig
    from deeplearning4j_tpu_torch.serving.server import ServingConfig

    return ServingFleet(
        lambda: TransformerEncoder(vocab_size=97, d_model=256, n_heads=2,
                                   n_layers=2, chunked_vocab_loss=True,
                                   bf16_compute=bf16).init_model(device=cuda),
        n_replicas=2, config=ServingConfig(max_batch=4, default_deadline_s=120.0),
        router_config=RouterConfig(default_deadline_s=120.0),
        golden_inputs=goldens,
        generation_config=GenerationConfig(slots=4, page_size=16, num_pages=64,
                                           max_pages_per_seq=8))


def _threads(fns):
    import threading

    out, errs = [None] * len(fns), []

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as exc:        # re-raised below
            errs.append(exc)

    ts = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    assert not errs, errs
    assert not any(t.is_alive() for t in ts)
    return out


def test_two_replicas_capture_and_replay_concurrently(cuda):
    """Two replicas of one process on one card, both `both`: streams
    through `fleet.generate` prefill on one and decode on either, so each
    engine captures and replays its decode graph while the other runs;
    after a rolling deploy each captures again, again concurrently.  The
    streams equal dense `generate` (f32) before and after, and the launch
    totals over each round are exact: B1 once a layer a prompt, B4 once a
    layer a decode step of either engine (and a capture's eager
    warm-up)."""
    from deeplearning4j_tpu_torch.runtime import compile_stats

    fleet = _card_fleet(cuda, bf16=False).start()
    prompts = [np.random.default_rng(n).integers(0, 97, n) for n in (5, 9, 17, 33,
                                                                     40, 64, 70, 90)]
    engines = list(fleet.engines.values())
    try:
        for rnd, scale in enumerate((None, 1.01)):
            if scale is not None:
                model = fleet.replicas[0].model
                new = {k: {kk: (vv.detach() * scale if not isinstance(vv, dict) else
                                {a: b.detach() * scale for a, b in vv.items()})
                           for kk, vv in v.items()} for k, v in model.params.items()}
                assert fleet.deployer.deploy(new)["installed"]
            model = fleet.replicas[0].model
            refs = [generate(model, p[None], 12)[0].cpu().numpy() for p in prompts]
            steps0 = sum(e.stats()["decode_steps"] for e in engines)
            caps0 = compile_stats.snapshot()
            torch.cuda.synchronize()
            kernels.reset_launches()
            outs = _threads([lambda p=p: fleet.generate(p, 12, timeout=120)
                             for p in prompts])
            torch.cuda.synchronize()
            counts = kernels.launches()
            steps = sum(e.stats()["decode_steps"] for e in engines) - steps0
            for out, ref in zip(outs, refs):
                np.testing.assert_array_equal(out, ref)
            assert all(e.stats()["decode_steps"] > 0 for e in engines)
            assert counts["flash_fwd"] == 2 * len(prompts)
            # each replica's capture runs its step once eagerly (warm-up),
            # which counts; every replay counts the graph's launches
            captured = (compile_stats.snapshot() - caps0).jit_cache_misses
            assert captured == 2
            assert counts["paged_attention_fwd"] == 2 * (steps + captured)
            assert [e.stats()["graph_captures"] for e in engines] == [rnd + 1] * 2
    finally:
        fleet.stop()


def test_canary_passes_an_honest_deploy_under_traffic(cuda):
    """bf16 replicas (the card's compute) under routed infer traffic: a
    rolling deploy's canary compares the served golden rows, batched with
    whatever traffic shared their dispatch, against the staged weights at
    the same batch bucket, at tolerance 1e-4: the honest deploy
    installs, with no canary failure, and the fleet serves the new
    weights."""
    import threading

    rng_np = np.random.default_rng(3)
    rows = rng_np.integers(0, 97, (8, 24)).astype(np.int64)
    fleet = _card_fleet(cuda, bf16=True, goldens=[rows[0], rows[1]]).start()
    stop, served, errs = threading.Event(), [0], []

    def client(i):
        try:
            while not stop.is_set():
                fleet.infer(rows[i % len(rows)], deadline_s=60)
                served[0] += 1
        except BaseException as exc:        # re-raised below
            errs.append(exc)

    ts = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    try:
        for t in ts:
            t.start()
        time.sleep(0.2)
        model = fleet.replicas[0].model
        new = {k: {kk: (vv.detach() * 1.01 if not isinstance(vv, dict) else
                        {a: b.detach() * 1.01 for a, b in vv.items()})
                   for kk, vv in v.items()} for k, v in model.params.items()}
        res = fleet.deployer.deploy(new)
    finally:
        stop.set()
        for t in ts:
            t.join(60)
        fleet.stop()
    assert not errs, errs
    assert res["installed"] and res["replicas_updated"] == 2, res
    assert fleet.deployer.tolerance == 1e-4 and fleet.deployer.canary_failures == 0
    assert served[0] > 0
    assert [s.generation for s in fleet.replicas] == [1, 1]


# -- the ResNet-50 slice: graphs on the card ------------------------------------

def _narrow_resnet(device, **kw):
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50

    class Narrow(ResNet50):
        STAGES = (1, 1, 1, 1)
        FILTERS = (8, 8, 16, 16)

    model = Narrow(num_classes=10, height=32, width=32, **kw)
    conf = dataclasses.replace(model.conf(), bf16_compute=False)
    from deeplearning4j_tpu_torch.models.computation_graph import GraphModel

    return GraphModel(conf, device=device).init()


def _narrow_batch(seed=0):
    r = np.random.default_rng(seed)
    return DataSet(r.normal(size=(8, 32, 32, 3)).astype(np.float32),
                   np.eye(10, dtype=np.float32)[r.integers(0, 10, 8)])


def test_narrow_resnet_on_the_card_matches_the_cpu(cuda):
    """The narrow ResNet in f32 (cuDNN in exact f32, the captured step):
    the same initial trees, ``output()`` within 1e-5 of max p of the CPU's,
    and 3 Adam steps on one batch whose losses are within 1e-5 of the
    CPU's (the same f32 arithmetic in another order)."""
    card, cpu = _narrow_resnet(cuda), _narrow_resnet("cpu")
    for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        assert torch.equal(a.detach().cpu(), b.detach())
    batch = _narrow_batch()
    p_card, p_cpu = card.output(batch.features).cpu(), cpu.output(batch.features)
    assert (p_card - p_cpu).abs().max().item() <= 1e-5 * p_cpu.abs().max().item()
    for _ in range(3):
        card.fit_batch(batch)
        cpu.fit_batch(batch)
        assert abs(card.score_value - cpu.score_value) <= 1e-5
    assert card.compile_stats()["step_programs"] == 1


def test_a_graph_step_after_load_params_trains_the_new_weights(cuda):
    """A captured graph step, then `load_params` of other weights, then a
    step: the graph is dropped and the step trains the new tensors, as the
    CPU's step from the same weights does (the loss within 1e-5)."""
    card, cpu = _narrow_resnet(cuda), _narrow_resnet("cpu")
    card.fit_batch(_narrow_batch(0))
    other = _narrow_resnet("cpu", seed=7)
    new = _to_cpu(other.params)
    card.load_params(new)
    cpu.load_params(new)
    before = [t.detach().cpu().clone() for t in tree_leaves(card.params)]
    card.fit_batch(_narrow_batch(1))
    cpu.fit_batch(_narrow_batch(1))
    assert abs(card.score_value - cpu.score_value) <= 1e-5
    moved = [not torch.equal(a, b.detach().cpu())
             for a, b in zip(before, tree_leaves(card.params))]
    assert sum(moved) > len(moved) // 2


def test_side_stream_staging_gives_the_same_bytes(cuda):
    """`stage_to_device` copies from pinned memory on a side stream; once
    the consumer's stream waits on its event the card holds the source's
    bytes (f32 and uint8, a `MultiDataSet` too), and a `PrefetchIterator`
    over a generator yields them in order."""
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.data.prefetch import (
        PrefetchIterator,
        stage_to_device,
        wait_staged,
    )

    r = np.random.default_rng(2)
    srcs = [DataSet(r.normal(size=(64, 32, 32, 3)).astype(np.float32),
                    r.integers(0, 256, (64, 10)).astype(np.uint8)) for _ in range(6)]
    staged = stage_to_device(srcs[0], cuda)
    assert staged._ready is not None
    wait_staged(staged)
    assert staged.features.is_cuda and staged.labels.dtype == torch.uint8
    np.testing.assert_array_equal(staged.features.cpu().numpy(), srcs[0].features)
    np.testing.assert_array_equal(staged.labels.cpu().numpy(), srcs[0].labels)
    mds = stage_to_device(MultiDataSet((srcs[1].features,), (srcs[1].labels,)), cuda)
    wait_staged(mds)
    np.testing.assert_array_equal(mds.features[0].cpu().numpy(), srcs[1].features)
    out = list(PrefetchIterator((b for b in srcs), depth=2, device=cuda))
    assert len(out) == len(srcs)
    for got, want in zip(out, srcs):
        np.testing.assert_array_equal(got.features.cpu().numpy(), want.features)
        np.testing.assert_array_equal(got.labels.cpu().numpy(), want.labels)


def _tiny_transformer(device, n_layers=4):
    return TransformerEncoder(vocab_size=64, d_model=64, n_heads=2, n_layers=n_layers,
                              causal=True, chunked_vocab_loss=True, vocab_chunk=32,
                              seed=7).init_model(device=device)


def _ids_batch(seed, b=2, t=128):
    ids = np.random.default_rng(seed).integers(0, 64, (b, t)).astype(np.int64)
    return DataSet(ids, np.roll(ids, -1, axis=1))


def test_a_rollback_on_a_captured_model_installs_in_place(cuda, tmp_path):
    """A `RecoveryPolicy` rollback on the card: the checkpoint's values are
    copied into the tensors the step graph reads, so the next steps replay
    the same graph (no capture) and start from the checkpoint bit for
    bit; the halved learning rate arrives as a staged step value."""
    from deeplearning4j_tpu_torch.runtime import faults
    from deeplearning4j_tpu_torch.train import CheckpointStore, RecoveryPolicy
    from deeplearning4j_tpu_torch.train.listeners import TrainingListener

    m = _tiny_transformer(cuda)
    store = CheckpointStore(str(tmp_path / "ck"), keep_last=2)

    class Saver(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score):
            if iteration == 2:
                store.save(model, step=iteration)

    m.add_listener(Saver())
    policy = RecoveryPolicy(store, skip_window=0).attach(m)
    batches = [_ids_batch(i) for i in range(6)]
    m.fit(batches[:3])
    captures = m.compile_stats()["jit_cache_misses"]
    ids = [id(t) for t in tree_leaves(m.params)]
    saved = ModelSerializer.restore(store.path_for(2), device="cpu")
    # a NaN batch: token ids cannot be NaN, so poison the step's loss
    real = m._data_loss
    m._data_loss = lambda *a: real(*a) * float("nan")
    m.capture_steps = False                      # the poisoned program runs eagerly
    try:
        m.fit(batches[3:4])
    finally:
        m._data_loss = real
        m.capture_steps = True
    assert policy.rollbacks == 1 and m.iteration == 2 and policy.lr_scale == 0.5
    assert [id(t) for t in tree_leaves(m.params)] == ids
    for a, b in zip(tree_leaves(m.params), tree_leaves(saved.params)):
        assert torch.equal(a.detach().cpu(), b.detach())
    m.fit(batches[4:6])
    assert m.compile_stats()["jit_cache_misses"] == captures
    assert m.iteration == 4 and np.isfinite(m.score_value)
    faults.disarm()


def test_a_frozen_prefix_step_launches_no_backward_for_the_prefix(cuda):
    """Blocks 0-2 of 4 frozen: a captured step launches B1 in every block
    and B2 / B3 only in the last block, each replay; the frozen leaves keep
    their bits."""
    from deeplearning4j_tpu_torch.train import TransferLearning

    base = _tiny_transformer(cuda)
    tl = TransferLearning.Builder(base).set_feature_extractor(4).build()
    frozen = [t.detach().clone() for k in sorted(tl._frozen) if k in tl.params
              for t in tree_leaves(tl.params[k])]
    tl.fit_batch(_ids_batch(0))                  # capture
    kernels.reset_launches()
    for i in range(3):
        tl.fit_batch(_ids_batch(i + 1))
    torch.cuda.synchronize()
    counts = kernels.launches()
    assert counts.get("flash_fwd", 0) == 4 * 3
    assert counts.get("flash_bwd_dq", 0) == 1 * 3
    assert counts.get("flash_bwd_dkdv", 0) == 1 * 3
    after = [t.detach() for k in sorted(tl._frozen) if k in tl.params
             for t in tree_leaves(tl.params[k])]
    assert all(torch.equal(a, b) for a, b in zip(frozen, after))


def test_a_host_snapshot_keeps_its_bytes_after_a_replay(cuda):
    """`_HostSnapshot` copies the live tensors to the host on the training
    thread: a replay that overwrites them afterwards leaves the snapshot's
    bytes as they were, and its zip restores them."""
    from deeplearning4j_tpu_torch.train.listeners import _host_snapshot

    m = _tiny_transformer(cuda, n_layers=2)
    m.fit_batch(_ids_batch(0))
    m.fit_batch(_ids_batch(1))                   # a replay
    snap = _host_snapshot(m)
    kept = [t.clone() for t in tree_leaves(snap.params)]
    live = [t.detach().cpu().clone() for t in tree_leaves(m.params)]
    m.fit_batch(_ids_batch(2))                   # overwrites the live tensors
    torch.cuda.synchronize()
    for a, b, c, now in zip(kept, tree_leaves(snap.params), live, tree_leaves(m.params)):
        assert not b.is_cuda and torch.equal(a, b) and torch.equal(b, c)
    assert any(not torch.equal(b, now.detach().cpu())
               for b, now in zip(tree_leaves(snap.params), tree_leaves(m.params)))


def _tiny_char_rnn(device, bf16=True):
    from deeplearning4j_tpu_torch.zoo.textgen import TextGenerationLSTM

    conf = TextGenerationLSTM(vocab_size=11, hidden=24, tbptt_length=4).conf()
    if not bf16:
        conf = dataclasses.replace(conf, bf16_compute=False)
    return SequentialModel(conf, device=device).init()


@pytest.mark.parametrize("bf16", [True, False])
def test_tbptt_captured_windows_equal_eager_and_zero_the_carries(cuda, bf16):
    """T 12 in windows of 4, groups of 2 batches: 6 window steps a group,
    one graph; the captured run equals the eager one bit for bit (every
    window loss, parameters, Adam state), also after the graph's carry
    inputs were poisoned with NaN: a batch's first window zeros them."""
    eye = torch.eye(11, device=cuda)

    def batch(seed):
        ids = torch.from_numpy(np.random.default_rng(seed).integers(0, 11, (6, 13)))
        ids = ids.to(cuda)
        return DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]])

    batches = [batch(i) for i in range(4)]
    cap, eag = _tiny_char_rnn(cuda, bf16), _tiny_char_rnn(cuda, bf16)
    eag.capture_steps = False
    for group in (batches[:2], batches[2:]):
        cap.fit(group, steps_per_execution=2)
        eag.fit(group, steps_per_execution=2)
        assert torch.equal(cap._last_score, eag._last_score)
        (prog,) = cap._captured.values()
        carry_inputs = prog.inputs[4:4 + len(prog.outputs[0])]
        assert len(carry_inputs) == 4            # (h, c) of two layers
        for t in carry_inputs:
            t.fill_(float("nan"))
    assert cap.iteration == eag.iteration == 12
    assert bool(torch.isfinite(cap._last_score).all())
    for a, b in zip(tree_leaves(cap.params), tree_leaves(eag.params)):
        assert torch.equal(a, b)
    for a, b in zip(state_leaves(cap.opt_state), state_leaves(eag.opt_state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    cap._reset_carries()
    assert all(bool((t == 0).all()) for t in carry_inputs)
    assert cap.compile_stats()["step_programs"] == 1


def test_dp_world_of_one_nccl_captured_against_eager_and_undistributed(cuda):
    """A world of one NCCL rank (a spawned process): the distributed
    model's captured steps run their collectives inside the graph and give
    the undistributed model's losses and parameters (within f32 rounding:
    every weight of the world of one is an exact 1.0), and two captured
    steps give the eager steps' bits from one snapshot."""
    import torch_dp_ranks as ranks
    from deeplearning4j_tpu_torch.runtime import distributed

    (r,) = distributed.spawn(ranks.cuda_world_of_one, 1, timeout=300)
    assert r["backend"] == "nccl" and r["graphs"] == 1
    np.testing.assert_allclose(r["ld"], r["lp"], rtol=1e-6, atol=0)
    assert r["gap"] <= 1e-6
    assert r["cap"] == r["eag"] and r["same_state"]


def test_dp_two_gloo_ranks_on_one_card_against_the_single_model(cuda):
    """Two gloo ranks with CUDA tensors on one card (eager steps: gloo
    collectives cannot be captured), 8 rows each, against the single
    model fed the 16-row concatenation: losses, parameters and BatchNorm
    statistics within `tests/test_parallel.py`'s rtol 2e-4 / atol 2e-5,
    and the ranks equal bit for bit."""
    import torch_dp_ranks as ranks
    from deeplearning4j_tpu_torch.runtime import distributed

    res = distributed.spawn(ranks.cuda_gloo_pair, 2, backend="gloo", timeout=300)
    r0 = res[0]
    assert r0["backend"] == "gloo" and not r0["capture"]
    np.testing.assert_allclose(r0["losses"], r0["single_losses"], rtol=2e-4, atol=2e-5)
    for k, v in r0["single_params"].items():
        np.testing.assert_allclose(r0["params"][k], v, rtol=2e-4, atol=2e-5, err_msg=k)
    for k, v in r0["single_state"].items():
        np.testing.assert_allclose(r0["state"][k], v, rtol=2e-4, atol=2e-5, err_msg=k)
    for k, v in r0["params"].items():
        np.testing.assert_array_equal(res[1]["params"][k], v)


def test_samediff_captured_attention_step_equals_eager_and_launches_b1_b3(cuda):
    """A SameDiff graph whose attention is `multi_head_dot_product_attention`
    (bf16 compute): from one state, 2 captured steps and 2 eager steps give
    the same losses, trainables and Adam state bit for bit, and each step
    launches B1, B2 and B3 once (one attention op)."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.nn.updaters import Adam, load_state_leaves, state_leaves

    rng = np.random.default_rng(0)
    sd = SameDiff(seed=1, device="cuda")
    x = sd.placeholder("x")
    w = {n: sd.var(n, 0.1 * rng.normal(size=(64, 64)).astype(np.float32)) for n in "qkvo"}
    heads = [(x.reshape((256, 64)) @ w[n]).reshape((2, 128, 4, 16)) for n in "qkv"]
    a = sd.nn.multi_head_dot_product_attention(*heads, causal=False)
    out = a.reshape((256, 64)) @ w["o"]
    sd.set_loss(sd.loss.mse_loss(out, sd.placeholder("y"), name="loss"))
    sd.set_training_config(TrainingConfig(updater=Adam(1e-3), bf16_compute=True))
    feed = {"x": rng.normal(size=(2, 128, 64)).astype(np.float32),
            "y": rng.normal(size=(256, 64)).astype(np.float32)}
    sd.fit_batch(feed)
    snap = ({n: t.clone() for n, t in sd._values.items()},
            [s.clone() if isinstance(s, torch.Tensor) else s for s in state_leaves(sd._opt_state)],
            sd._stream.state_dict())

    def state():
        return [t.clone() for t in sd._values.values()] + [
            s.clone() for s in state_leaves(sd._opt_state) if isinstance(s, torch.Tensor)]

    kernels.reset_launches()
    captured = [sd.fit_batch(feed) for _ in range(2)]
    torch.cuda.synchronize()
    launches = kernels.launches()
    after = state()
    for n, t in snap[0].items():
        sd._values[n].copy_(t)
    sd._opt_state = load_state_leaves(sd._opt_state, snap[1])
    sd._stream.load_state_dict(snap[2])
    sd.capture_steps = False
    eager = [sd.fit_batch(feed) for _ in range(2)]
    assert len(sd._captured) == 1 and captured == eager
    assert all(torch.equal(a_, b_) for a_, b_ in zip(after, state()))
    assert {k: launches.get(k, 0) for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")} == {
        "flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkdv": 2}


# -- the device data pipeline (ROADMAP A12) ---------------------------------------


def test_staging_a_read_only_replay_gives_its_bytes_without_a_warning(cuda, tmp_path):
    """A cache replay's batches are read-only memmaps: `stage_to_device`
    copies them into pinned memory and onto the card with their bytes,
    tags kept, and no warning (no tensor is made over read-only bytes)."""
    import warnings

    from deeplearning4j_tpu_torch.data.prefetch import stage_to_device, wait_staged

    r = np.random.default_rng(5)
    np.save(tmp_path / "f.npy", r.integers(0, 256, (16, 8, 8, 3)).astype(np.uint8))
    np.save(tmp_path / "y.npy", r.random((16, 4)).astype(np.float32))
    batch = DataSet(np.load(tmp_path / "f.npy", mmap_mode="r"),
                    np.load(tmp_path / "y.npy", mmap_mode="r"))
    batch._etl_source = "cache"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        staged = stage_to_device(batch, cuda)
    wait_staged(staged)
    assert staged._etl_source == "cache" and staged.features.dtype == torch.uint8
    np.testing.assert_array_equal(staged.features.cpu().numpy(), batch.features)
    np.testing.assert_array_equal(staged.labels.cpu().numpy(), batch.labels)


def _decode_chain(seed=3):
    from deeplearning4j_tpu_torch.datavec import device as dv

    return dv.TransformChain((dv.RandomCrop(12, 12), dv.RandomFlip(0.5),
                              dv.Scale(1 / 127.5, -1.0)), (dv.OneHot(4),), seed=seed)


def _decode_raw(n, seed=0, b=8):
    r = np.random.default_rng(seed)
    return [DataSet(r.integers(0, 256, (b, 16, 16, 3)).astype(np.uint8),
                    r.integers(0, 4, b)) for _ in range(n)]


def test_fused_decode_on_the_card_equals_the_host_decode(cuda):
    """`DeviceDecode.fn` on the card (keys computed on the host, and keys
    staged as a device tensor) against `DeviceDecode.host` in numpy on the
    same raw batch and step index: the crop window and the flip coins
    exactly (the uint8 pixels before the scale are equal), the scaled
    values within 1e-6."""
    from deeplearning4j_tpu_torch.datavec import device as dv

    chain = _decode_chain()
    decode = dv.try_lower(chain)[0]
    crop_flip = dv.DeviceDecode(dv.TransformChain(chain.features[:2], (), seed=3))
    batch = _decode_raw(1)[0]
    feats, labs = torch.from_numpy(batch.features).to(cuda), torch.from_numpy(batch.labels).to(cuda)
    for step in (0, 1, 2, 7, 100, 2**32 - 1):
        host = decode.host(step, batch)
        staged = torch.from_numpy(decode.keys(step)).to(cuda)
        for keys in (None, staged):
            f, y, fm, lm = decode.fn(step, feats, labs, keys=keys)
            assert fm is None and lm is None and f.dtype == torch.float32
            assert (f.cpu().numpy() - host.features).__abs__().max() <= 1e-6
            assert np.array_equal(y.cpu().numpy(), host.labels)
        pixels = crop_flip.fn(step, feats, labs)[0]
        assert pixels.dtype == torch.uint8
        assert np.array_equal(pixels.cpu().numpy(), crop_flip.host(step, batch).features)


def _fused_models(cuda, kind):
    from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
    from deeplearning4j_tpu_torch.nn.conf import graph_conf as g
    from deeplearning4j_tpu_torch.nn.conf import layers as lay
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        NeuralNetConfiguration,
    )

    if kind == "graph":
        conf = (g.GraphBuilder().seed(4).updater(Adam(1e-3)).bf16_compute(False)
                .add_inputs("in").set_input_types(InputType.convolutional(12, 12, 3))
                .add_layer("c", lay.Conv2D(n_out=8, kernel=(3, 3), activation="relu"), "in")
                .add_layer("d", lay.Dense(n_out=16, activation="relu"), "c")
                .add_layer("out", lay.OutputLayer(n_out=4, activation="softmax"), "d")
                .set_outputs("out").build())
        return GraphModel(conf, device=cuda).init()
    conf = (NeuralNetConfiguration.builder().seed(4).updater(Adam(1e-3))
            .bf16_compute(False).list()
            .layer(lay.Conv2D(n_out=8, kernel=(3, 3), activation="relu"))
            .layer(lay.Dense(n_out=16, activation="relu"))
            .layer(lay.OutputLayer(n_out=4, activation="softmax"))
            .set_input_type(InputType.convolutional(12, 12, 3)).build())
    return SequentialModel(conf, device=cuda).init()


def _model_state(model):
    return ([t.detach().clone() for t in tree_leaves(model.params)],
            [s.clone() if isinstance(s, torch.Tensor) else s
             for s in state_leaves(model.opt_state)],
            [t.clone() for t in tree_leaves(model.net_state)], model.iteration)


@pytest.mark.parametrize("kind,spe", [("sequential", 1), ("sequential", 2), ("graph", 1)])
def test_fused_captured_steps_equal_eager_over_replays(cuda, kind, spe):
    """A fused fit on the card: the first step of the raw-batch signature
    runs eagerly and is captured, the next replay the graph with their own
    staged decode keys (augmentation index 1, 2, ...).  From one state, the
    captured run and the same fit with ``capture_steps = False`` give the
    same losses, parameters and Adam state bit for bit over 4 replays (a
    replay reusing the capture step's keys would crop and flip otherwise);
    one graph, its staged inputs uint8."""
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.datavec import device as dv
    from deeplearning4j_tpu_torch.nn.updaters import load_state_leaves

    model = _fused_models(cuda, kind)
    raws = _decode_raw(6 if spe > 1 else 5, seed=1)
    model.fit_batch(dv.DeviceDecode(_decode_chain()).host(0, raws[0]))   # optimizer state
    snap = _model_state(model)

    class Losses:
        def __init__(self):
            self.v = []

        def iteration_done(self, m, it, ep, score):
            self.v.append(float(score))

        def on_epoch_start(self, m, ep):
            pass

        def on_epoch_end(self, m, ep):
            pass

    runs = []
    for captured in (True, False):
        if not captured:
            params, opt, state, it = snap
            with torch.no_grad():
                for dst, src in zip(tree_leaves(model.params), params):
                    dst.copy_(src)
                for dst, src in zip(tree_leaves(model.net_state), state):
                    dst.copy_(src)
            model.opt_state = load_state_leaves(model.opt_state, opt)
            model.iteration = it
        model.capture_steps = captured
        lst = Losses()
        model.set_listeners(lst)
        model.fit(dv.DeviceTransformIterator(ExistingDataSetIterator(raws), _decode_chain()),
                  steps_per_execution=spe)
        torch.cuda.synchronize()
        runs.append((lst.v, _model_state(model)))
    model.capture_steps = True
    fused = [k for k in model._captured if k[-1][0] == "fused"]
    assert len(fused) == 1 and fused[0][0][1] == torch.uint8
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == len(raws)
    for a, b in zip(runs[0][1][:3], runs[1][1][:3]):
        assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                   for x, y in zip(a, b))
