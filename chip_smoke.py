#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`deeplearning4j_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every default phase
    python3 chip_smoke.py --phases kernels   # a subset; `profile` is extra
    python3 chip_smoke.py --phases paged,serve,int8,profile --package-root DIR
        # the same phases over the port in another checkout DIR (a parent
        # commit unpacked with `git archive`): two trees in one call

Always first:

1. identity — card name and power limit (nvidia-smi), torch and CUDA
   versions.  Exits non-zero, printing no result, without a CUDA device.
2. build — compiles every ``csrc/*.cu`` of the checkout (one nvcc per
   source, in parallel) and prints ptxas' register / spill report, then
   counts the tensor-core MMAs (HGMMA, HMMA), TMA loads (UTMALDG) and bulk
   copies (UBLKCP) of each flash, dequant-matmul and paged-attention
   kernel in ``cuobjdump -sass``: fails if a bf16 backward kernel has no
   MMA, a forward kernel (bf16 or f32) or the large-M dequant-matmul
   kernel no HGMMA or no UTMALDG, a paged-attention kernel no UTMALDG
   (whole pages) or no UBLKCP (partial pages, int8 scales), or ptxas
   reports that it serialised a kernel's wgmma pipeline.

Then the phases:

3. kernels — each hand-written kernel against its plain PyTorch version
   at the shapes of the training and serving paths, bf16 and f32: max
   |kernel - plain| against a stated tolerance, kernel / plain / library
   times (CUDA events, cold L2, median of 10) and the kernel's lower
   bound.  The flash forward (B1) at BH 8, T 2048, 2000 (the serve
   prefill) and 144, and at BH 32, T 2048 (the training step), causal:
   out and lse each against their own tolerance (bf16 out both against
   the largest element and row by row), and a second launch must give
   the same bits, and a copy of the bf16 kernel with a planted fault in
   P V (its consumers read V from the next ring stage) must fail the
   row-by-row out check at the training and serve shapes; then
   `flash_attention` on the (B, T, H, D)
   training layout against the kernel alone (its layout copies).  The
   flash backward (dQ and dK/dV kernels) at the training
   shape (BH 32, T 2048 and 2000, D 128, causal), and in bf16 also
   non-causal at T 2048, at T 144 (a serve bucket) and at D 64, against
   `flash_bwd_plain` and the backward of `scaled_dot_product_attention`;
   a second launch of each must give the same bits.  The paged attention
   (B4), f32 and int8 pages, against `paged_attention_plain` within 1e-4:
   the serve mix (8 slots of lengths 2017 ... 0 over 160-wide tables),
   timed; the full pool (8 slots x 1008 positions, 504 of the 511 usable
   pages), timed; head dims 16 ... 256 on the serve mix, checked.  Each
   must give the same bits on a second launch, and the idle slot exact
   zeros.  The Timer's own floor (the event pair alone, and around one
   empty kernel launch) is timed beside them.
4. train — the full-width flagship (below) trained with Adam (lr 3e-4)
   through the chunked vocab loss on one fixed batch of 4 x 2048 token
   ids (numpy seed 3, int64): 2 warm-up and 6 measured `fit_batch`
   steps.  Prints step ms, tokens/s and every loss; gates on finite,
   falling loss and on exactly 8 launches a step of each of flash_fwd,
   flash_bwd_dq and flash_bwd_dkdv (counters zeroed just before the
   measured steps and read just after).
5. serve — the full-width flagship `TransformerEncoder` (vocab 32000,
   d 1024, 8 heads, 8 layers, chunked head, seed 123, bf16 compute) in a
   `GenerationEngine` (8 slots, 16-row pages, 512 pages, 160-wide
   tables): 8 concurrent streams of 32 tokens, one with a 2000-token
   prompt and one sampled.  Launch counters are zeroed just before and
   read just after; both kernels must have run.  Then the host time to
   sample one token from a (1, 32000) row, top-k 50 and top-k 0, with
   the port's sampler and with two yardsticks it does not call.
6. parity — an f32-compute engine against the port's dense `generate`
   on 4 greedy streams: token agreement >= 0.95, first token identical.
7. int8 — the same streams through an int8-KV engine, gated against
   the same reference as the JAX package gates int8 pages (>= 0.9).
   serve, parity and int8 make seven measured passes of their streams
   and print each pass's tokens/s and the medians.
8. quant — int8 post-training quantization and quantized inference.
   Kernel rows first: the dequant-matmul kernel (B5) against
   `dequant_matmul_plain` at the six product shapes (M, K, N) =
   (4096, 1024, 1024), (4096, 1024, 4096), (4096, 4096, 1024),
   (4096, 1024, 32000), (8, 1024, 4096) and (1, 4096, 4096), within
   1e-5 (K 1024) or 2e-5 (K 4096) of max |plain|, plus the ragged
   (5, 100, 72) and (200, 100, 48) for correctness, each on the route
   the wrapper picks by shape (the tensor cores above 64 rows, f32 FMAs
   split over K below) and then on the other route where TMA can read
   the weights; a second launch must give the same bits; the library
   yardstick is cuBLAS f32 on the dequantized weight (and
   ``torch._weight_int8pack_mm`` where this PyTorch has it for CUDA);
   and B1's f32 row at BH 16, T 2048.  Then
   the path: the flagship with its default `RnnOutputLayer` softmax head
   (vocab 32000, d 1024, 8 heads, 8 layers, seed 123), `quantize`d
   (its tree must shrink, by `quantized_bytes`), runs 1 warm-up and 3
   measured `output()` calls on 2 x 2048 ids (numpy seed 3), launch
   counters zeroed just before the measured calls and read just after:
   exactly 49 dequant_matmul launches (8 layers x 6 products + the
   head) and 8 f32 flash_fwd launches a call.  Its probabilities are
   held against an f32 model built from `dequantize_tree` of the same
   tree (cuBLAS f32 products, the same f32 B1): argmax agreement >= 0.99
   and max |dp| <= 1e-4 of max p.  The unquantized model's bf16
   ``output()`` time and the int8-vs-f32-weights argmax agreement are
   printed as information.
9. paged (only when asked for, and part of kernels) — B4's timed rows
   and the Timer's floor alone.  stages (only when asked for) — B4 built
   with time stamps at each stage of a block's work, on the same inputs:
   where its time goes (`stages_case`).
10. profile (only when asked for) — two training steps, the serve pass,
   the int8-KV engine's streams and two quantized ``output()`` calls
   under torch.profiler: device busy share, device time by kernel, and
   the paged-attention kernel's own device time in the serve and int8
   passes.
11. report — one ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Every phase that fails raises; nothing is caught on the way to exit 0.
Details also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

PHASES = ("kernels", "train", "serve", "parity", "int8", "quant")
EXTRA_PHASES = ("profile", "paged", "stages")

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}

VOCAB, D_MODEL, HEADS, LAYERS = 32000, 1024, 8, 8
ENGINE = dict(slots=8, page_size=16, num_pages=512, max_pages_per_seq=160)
# bench.py bench_longctx's training batch: 4 sequences of 2048 tokens
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 4, 2048, 2, 6

TOL = {  # max |kernel - plain| allowed, with the reason
    # flash forward out, f32: f32 both sides, different summation order;
    # the kernel also drops each operand's bits past two bf16 parts and
    # the lo x lo part product (~2^-16 of a product)
    "flash_fwd/f32": 2e-4,
    # flash forward out, bf16, relative to max |plain|: the plain version
    # rounds Q * scale and P to bf16 where the kernel does, but the kernel
    # rounds P against the running max of its 128-key tiles and the plain
    # version against the row's max, so a stored element can land one bf16
    # rounding away: at most 2^-7 of the largest
    "flash_fwd/bf16": 2**-7,
    # the same, row by row: max |kernel - plain| of each query row relative
    # to that row's max |plain|, so rows whose outputs are small (a row that
    # averages n keys is ~sqrt(e/n)) are held to their own scale; one bf16
    # ulp of the row's largest element from the stored rounding (read up
    # to 2^-7 on the CPU against the Pallas kernel, and on the card) plus
    # the f32 sums' order: 2^-6.  V read from the wrong ring stage reads
    # 2.6 (`flash_fwd_fault_case`)
    "flash_fwd_row/bf16": 2**-6,
    # flash forward lse, absolute: f32 sums of up to T exponentials in
    # another order (and exp2 with log2(e) folded into the scores in bf16:
    # measured up to 1.9e-6 on the card); in bf16 an unrounded Q * scale
    # would move it by ~2e-3
    "flash_fwd_lse/f32": 2e-4,
    "flash_fwd_lse/bf16": 1e-5,
    "paged_attention_fwd": 1e-4,       # f32 both sides, order of the sums
    # flash backward, relative to max |plain| of each gradient: f32 sums
    # of up to T products in another order; in bf16 the plain version
    # rounds Q * scale, P and dS where the kernels do, so the f32 sums'
    # order can still move a stored gradient by one bf16 ulp, at most
    # 2^-7 (7.8e-3) of the largest
    "flash_bwd/f32": 1e-4,
    "flash_bwd/bf16": 8e-3,
    "paged_attention_fwd_int8": 1e-4,  # same int8 values dequantised both sides
    # dequant-matmul, relative to max |plain|: f32 sums of K products in
    # another order (and the scale once after the sum, not in each
    # weight); the error grows as sqrt(K).  The tensor-core route also
    # drops x's bits past its two bf16 parts (~2^-17 of each product):
    # the CPU emulation (tests/test_torch_split_precision.py) reads
    # 2.0e-6 to 2.4e-6 of max |plain| at K 1024 and 4096
    "dequant_matmul/K1024": 1e-5,
    "dequant_matmul/K4096": 2e-5,
}
# the quant path: 2 x 2048 ids through the flagship with its softmax head
QUANT_BATCH, QUANT_SEQ, QUANT_WARMUP, QUANT_CALLS = 2, 2048, 1, 3
DM_SHAPES = [(4096, 1024, 1024), (4096, 1024, 4096), (4096, 4096, 1024),
             (4096, 1024, VOCAB), (8, 1024, 4096), (1, 4096, 4096)]
DM_RAGGED = (5, 100, 72)
# B4's head dims besides the flagship's 128: 32 lanes hold Dh / 32 values
# each where 32 divides Dh, else strided lanes
PAGED_CHECK_DIMS = (16, 48, 80, 96, 192, 256)
PAGED_DIMS = tuple(range(16, 257, 16))       # every instantiated head dim
# B4's timed mixes: the serve phase's (one long stream, short ones, one
# idle slot), and the full pool (504 of the 511 usable pages, 8 x 1008
# positions: ~66 MB of f32 K/V, past the 50 MB L2)
PAGED_MIXES = {"serve": [2017, 20, 150, 300, 5, 64, 0, 90], "full_pool": [1008] * 8}
# ragged in M, K and N for the tensor-core route, whose TMA loads need N a
# multiple of 16 (72 is not: that shape takes the rows route alone)
DM_RAGGED_TMA = (200, 100, 48)
# the quantized model against the f32 model of the same dequantized
# weights: argmax agreement, and max |dp| relative to max p (f32 both
# sides, the products summed in another order: a few 1e-6 of each logit)
QUANT_AGREEMENT, QUANT_DP_REL = 0.99, 1e-4


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Kernel time with CUDA events, cold L2: before each launch the GPU
    sleeps while the host enqueues an L2 flush and the launch, so host
    overhead never lands between the events.  The flush writes 64 MB, so
    the L2 the kernel finds is full of dirty lines that its own reads must
    write back; ``clean=True`` flushes by reading 64 MB instead (the L2 then
    holds clean lines), for bandwidth-bound kernels whose bound counts
    their reads alone."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.int8, device="cuda")

    def __call__(self, fn, iters: int = 10, clean: bool = False) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for a, b in ev:
            torch.cuda._sleep(20_000_000)
            if clean:
                self.flush.sum()
            else:
                self.flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in ev)


def bound_ms(n_bytes: float, n_ops: float, kind: str):
    """The least time the card could take: the larger of ``n_bytes`` over
    HBM's rate and ``n_ops`` (the function's own operations) over the
    ``kind`` peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UBLKCP")


def sass_mma_counts(lib_path) -> dict:
    """Tensor-core MMA instructions (HGMMA: wgmma; HMMA: mma.sync), TMA
    loads (UTMALDG) and bulk copies (UBLKCP) in each kernel of a built
    library, from ``cuobjdump -sass``."""
    from deeplearning4j_tpu_torch.runtime.kernels import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in SASS_OPS:
                if f" {op}." in line or f" {op} " in line:
                    counts[fn][op] += 1
    return counts


def check_sass(paths):
    """The bf16 flash-backward kernels must issue tensor-core MMAs; the
    flash-forward kernels (bf16 and f32) wgmma (HGMMA) and TMA loads
    (UTMALDG); the large-M dequant-matmul kernel wgmma and TMA loads; every
    paged-attention kernel TMA loads (whole pages) and bulk copies (a
    slot's partial last page, int8 scales)."""
    out = {}
    for stem in ("flash_fwd", "flash_bwd", "dequant_matmul", "paged_attention"):
        out[stem] = counts = sass_mma_counts(paths[stem])
        for fn, c in counts.items():
            log(f"[sass] {stem} {fn}: " + ", ".join(f"{op} {c[op]}" for op in SASS_OPS))
    bwd = [c for fn, c in out["flash_bwd"].items() if "wgmma" in fn]
    if not bwd or any(c["HGMMA"] + c["HMMA"] == 0 for c in bwd):
        raise AssertionError(f"bf16 flash-backward kernels without tensor-core "
                             f"MMAs in their SASS: {out['flash_bwd']}")
    for stem, names in (("flash_fwd", ("flash_fwd_wgmma", "flash_fwd_split")),
                        ("dequant_matmul", ("dequant_matmul_wgmma",))):
        for name in names:
            found = [c for fn, c in out[stem].items() if name in fn]
            if not found or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in found):
                raise AssertionError(f"{name} missing, or without HGMMA or TMA loads "
                                     f"in its SASS: {out[stem]}")
    paged = [c for fn, c in out["paged_attention"].items() if "paged_split_kernel" in fn]
    if len(paged) != 2 * len(PAGED_DIMS) or any(
            c["UTMALDG"] == 0 or c["UBLKCP"] == 0 for c in paged):
        raise AssertionError(f"paged-attention kernels missing, or without TMA loads or "
                             f"bulk copies in their SASS: {out['paged_attention']}")
    return out


# -- kernel phase -------------------------------------------------------------

def out_errors(out, ref) -> dict:
    """max |out - ref|; the same relative to max |ref|; and the largest of
    each row's max |out - ref| relative to that row's max |ref| (rows
    along every axis but the last)."""
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    return {"max_abs_err": diff.max().item(),
            "rel_err": (diff.max() / mag.max()).item(),
            "row_err": (diff.amax(-1) / mag.amax(-1).clamp_min(1e-30)).max().item()}


def flash_case(torch, timer, t, dtype, causal=True, bh=HEADS):
    """Kernel B1 against `flash_fwd_plain` at (BH, T, D 128): out and lse
    each against its tolerance (bf16 out relative to max |plain| and row
    by row), a second launch bit for bit."""
    from deeplearning4j_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    import torch.nn.functional as F

    d = D_MODEL // HEADS
    g = torch.Generator(device="cuda").manual_seed(t)
    q, k, v = (torch.randn((bh, t, d), generator=g, device="cuda").to(dtype)
               for _ in range(3))
    out, lse = flash_fwd(q, k, v, causal=causal)
    again = flash_fwd(q, k, v, causal=causal)
    ref, ref_lse = flash_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        raise AssertionError(f"flash forward at {[bh, t, d]}: a second launch "
                             "gave other bits")
    del again
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    errs = out_errors(out, ref)
    pairs = bh * (t * (t + 1) // 2 if causal else t * t)
    eb = q.element_size()
    n_bytes = 4 * bh * t * d * eb + bh * t * 4
    # the function's multiply-adds on the bf16 peak, in f32 too: the card
    # reaches f32 accuracy on bf16 tensor cores (by split parts)
    b_ms, b_by = bound_ms(n_bytes, 4 * d * pairs, "bf16")
    qs, ks, vs = (x[None] for x in (q, k, v))        # (1, BH, T, D) for sdpa
    row = {
        "name": "flash_fwd",
        "kernel": "flash_fwd_wgmma" if kind == "bf16" else "flash_fwd_split",
        "dtype": kind, "shape": [bh, t, d], "causal": causal,
        "max_abs_err": errs["max_abs_err"], "tol": TOL[f"flash_fwd/{kind}"],
        "lse_err": (lse - ref_lse).abs().max().item(),
        "lse_tol": TOL[f"flash_fwd_lse/{kind}"],
        "second_launch_identical": True,
        "ms": timer(lambda: flash_fwd(q, k, v, causal=causal)),
        "plain_ms": timer(lambda: flash_fwd_plain(q, k, v, causal=causal)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal)),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    if kind == "bf16":
        row.update(rel_err=errs["rel_err"], row_err=errs["row_err"],
                   row_tol=TOL["flash_fwd_row/bf16"])
    else:
        # log only: the split design's own floor, three bf16 part products
        # (hi hi, hi lo, lo hi) for each product, and the f32-FMA bound of
        # the CUDA-core kernel it replaced
        row["part_floor_ms"] = bound_ms(n_bytes, 3 * 4 * d * pairs, "bf16")[0]
        row["f32_fma_bound_ms"] = bound_ms(n_bytes, 4 * d * pairs, "f32")[0]
    return row


def layout_case(torch, timer):
    """`flash_attention` on the training step's (B, T, H, D) bf16 layout
    against kernel B1 alone on the same values: the difference is the
    (B, T, H, D) <-> (BH, T, D) copies around the kernel."""
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_fwd,
    )

    b, t, h, d = TRAIN_BATCH, TRAIN_SEQ, HEADS, D_MODEL // HEADS
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn((b, t, h, d), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    bhtd = [x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous() for x in (q, k, v)]
    res = {
        "shape_bthd": [b, t, h, d],
        "flash_attention_ms": timer(lambda: flash_attention(q, k, v, causal=True)
                                    .reshape(b, t, h * d)),
        "kernel_ms": timer(lambda: flash_fwd(*bhtd, causal=True)),
    }
    res["layout_copies_ms"] = res["flash_attention_ms"] - res["kernel_ms"]
    log(f"[kernels] flash_attention (B, T, H, D) = {[b, t, h, d]} bf16, with its "
        f"layout copies: {res['flash_attention_ms']:.4f} ms; B1 alone "
        f"{res['kernel_ms']:.4f} ms; copies {res['layout_copies_ms']:.4f} ms")
    return res


def flash_bwd_cases(torch, timer, t, dtype, causal=True, d=D_MODEL // HEADS):
    """Rows for kernels B2 (dQ) and B3 (dK/dV) at BH 32 (the training
    batch's heads): each against `flash_bwd_plain` on the same inputs,
    and a second launch of each against the first, bit for bit; plain
    and library times cover both kernels together (the plain version and
    the sdpa backward compute dq, dk and dv in one call)."""
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        flash_bwd_plain,
        flash_fwd,
        launch_bwd_dkdv,
        launch_bwd_dq,
    )
    import torch.nn.functional as F

    bh = TRAIN_BATCH * HEADS
    gen = torch.Generator(device="cuda").manual_seed(t + d + 1)
    q, k, v, g = (torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)
                  for _ in range(4))
    out, lse = flash_fwd(q, k, v, causal=causal)
    delta = (g.float() * out.float()).sum(-1)
    dq = launch_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = launch_bwd_dkdv(q, k, v, g, lse, delta, causal)
    rq, rk, rv = flash_bwd_plain(q, k, v, out, lse, g, causal=causal)
    again = (launch_bwd_dq(q, k, v, g, lse, delta, causal),
             *launch_bwd_dkdv(q, k, v, g, lse, delta, causal))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
        raise AssertionError(f"flash backward at {[bh, t, d]} causal={causal}: "
                             "a second launch gave other bits")
    del again

    def rel_err(a, b):
        diff = (a.float() - b.float()).abs().max().item()
        return diff, diff / b.float().abs().max().item()

    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    plain_ms = timer(lambda: flash_bwd_plain(q, k, v, out, lse, g, causal=causal))
    qs, ks, vs = (x.detach()[None].requires_grad_(True) for x in (q, k, v))
    gs = g[None]

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), gs)

    # the backward alone: forward + backward minus the forward
    library_ms = timer(sdpa_fwd_bwd) - timer(sdpa_fwd)
    pairs = bh * (t * (t + 1) // 2 if causal else t * t)
    eb = q.element_size()
    in_bytes = 4 * bh * t * d * eb + 2 * bh * t * 4       # q, k, v, g, lse, delta
    rows = []
    for name, n_out, n_ops, fn, errs in (
            ("flash_bwd_dq", 1, 6 * d * pairs,
             lambda: launch_bwd_dq(q, k, v, g, lse, delta, causal),
             [rel_err(dq, rq)]),
            ("flash_bwd_dkdv", 2, 8 * d * pairs,
             lambda: launch_bwd_dkdv(q, k, v, g, lse, delta, causal),
             [rel_err(dk, rk), rel_err(dv, rv)])):
        b_ms, b_by = bound_ms(in_bytes + n_out * bh * t * d * eb, n_ops, kind)
        rows.append({
            "name": name, "dtype": kind, "shape": [bh, t, d], "causal": causal,
            "max_abs_err": max(e[0] for e in errs),
            "rel_err": max(e[1] for e in errs), "tol": TOL[f"flash_bwd/{kind}"],
            "second_launch_identical": True,
            "ms": timer(fn), "plain_ms": plain_ms, "library_ms": library_ms,
            "plain_and_library_cover": "dq, dk and dv together",
            "bound_ms": b_ms, "bound_by": b_by,
        })
    del qs, ks, vs
    return rows


def paged_inputs(torch, quant: bool, dh, mix):
    """q, pools, table, lengths and (int8) scales over the engine's pool
    for one of `PAGED_MIXES`: each live slot its own pages, seed 7."""
    from deeplearning4j_tpu_torch.serving.kv_cache import quantize_page_rows

    s, h = ENGINE["slots"], HEADS
    ps, mp, n_pages = ENGINE["page_size"], ENGINE["max_pages_per_seq"], ENGINE["num_pages"]
    g = torch.Generator(device="cuda").manual_seed(7)
    perm = (torch.randperm(n_pages - 1, generator=g, device="cuda") + 1).int()
    tbl = torch.zeros((s, mp), dtype=torch.int32, device="cuda")
    used = 0
    for i, n in enumerate(PAGED_MIXES[mix]):
        k_n = -(-n // ps)
        tbl[i, :k_n] = perm[used:used + k_n]
        used += k_n
    seq = torch.tensor(PAGED_MIXES[mix], dtype=torch.int32, device="cuda")
    q = torch.randn((s, h, dh), generator=g, device="cuda")
    kp = torch.randn((n_pages, ps, h, dh), generator=g, device="cuda")
    vp = torch.randn((n_pages, ps, h, dh), generator=g, device="cuda")
    ksc = vsc = None
    if quant:
        kp, ksc = quantize_page_rows(kp)
        vp, vsc = quantize_page_rows(vp)
    return q, kp, vp, tbl, seq, ksc, vsc


def paged_case(torch, timer, quant: bool, dh=D_MODEL // HEADS, mix="serve"):
    """Kernel B4 against `paged_attention_plain` over the engine's pool and
    160-wide page tables, at head dim ``dh`` and one of `PAGED_MIXES`; a
    second launch must give the same bits, an idle slot exact zeros.  Timed
    only at the flagship's head dim."""
    from deeplearning4j_tpu_torch.ops.paged_attention import (
        paged_attention_fwd,
        paged_attention_plain,
    )

    s, h = ENGINE["slots"], HEADS
    ps, mp = ENGINE["page_size"], ENGINE["max_pages_per_seq"]
    lens = PAGED_MIXES[mix]
    q, kp, vp, tbl, seq, ksc, vsc = paged_inputs(torch, quant, dh, mix)
    out = paged_attention_fwd(q, kp, vp, tbl, seq, ksc, vsc)
    again = paged_attention_fwd(q, kp, vp, tbl, seq, ksc, vsc)
    ref = paged_attention_plain(q, kp, vp, tbl, seq, ksc, vsc)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    name = "paged_attention_fwd_int8" if quant else "paged_attention_fwd"
    if not torch.equal(out, again):
        raise AssertionError(f"{name} {mix} at head dim {dh}: a second launch gave "
                             "other bits")
    if any(out[i].abs().max().item() != 0.0 for i, n in enumerate(lens) if n == 0):
        raise AssertionError(f"{name} {mix}: idle slot output is not exact zero")
    row = {
        "name": name, "dtype": "int8" if quant else "f32", "mix": mix,
        "shape": [s, h, dh, ps, mp], "seq_lens": lens,
        "max_abs_err": err, "tol": TOL[name], "second_launch_identical": True,
    }
    if dh != D_MODEL // HEADS:
        return row
    live = sum(lens)
    eb = kp.element_size()
    n_bytes = (q.numel() * 4 + 2 * live * h * dh * eb
               + (2 * live * h * 4 if quant else 0)
               + sum(-(-n // ps) for n in lens) * 4 + s * 4 + out.numel() * 4)
    n_ops = 4 * live * h * dh + (2 * live * h * dh if quant else 0)
    b_ms, b_by = bound_ms(n_bytes, n_ops, "f32")

    def fn():
        return paged_attention_fwd(q, kp, vp, tbl, seq, ksc, vsc)

    row.update({
        "ms": timer(fn),
        "plain_ms": timer(lambda: paged_attention_plain(q, kp, vp, tbl, seq, ksc, vsc)),
        "library_ms": None,     # no single PyTorch call attends over a page table
        "bound_ms": b_ms, "bound_by": b_by,
        # log only: the same launch after an L2 flush that leaves no dirty
        # lines, and the host's time to enqueue one call (a decode step
        # makes one a layer and waits on the host)
        "clean_l2_ms": timer(fn, clean=True),
        "host_ms": host_ms(torch, fn),
    })
    return row


def host_ms(torch, fn, calls: int = 200) -> float:
    """Host milliseconds a call spends enqueueing ``fn`` (no sync between
    calls; the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return t


def timer_floor(torch, timer) -> dict:
    """What the Timer reads around nothing (its event pair) and around one
    empty kernel launch: the part of a short kernel's row that is not the
    kernel's work."""
    res = {"events_only_ms": timer(lambda: None),
           "empty_launch_ms": timer(lambda: torch.cuda._sleep(0))}
    log(f"[kernels] Timer floor: event pair alone {res['events_only_ms']:.4f} ms, "
        f"around one empty launch {res['empty_launch_ms']:.4f} ms")
    return res


def phase_kernels(torch, timer):
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for t in (2048, 2000, 144):
            rows.append(flash_case(torch, timer, t, dtype))
        rows.append(flash_case(torch, timer, TRAIN_SEQ, dtype,
                               bh=TRAIN_BATCH * HEADS))
        for t in (TRAIN_SEQ, 2000):
            rows.extend(flash_bwd_cases(torch, timer, t, dtype))
    # the tensor-core (bf16) backward off the training shape: non-causal,
    # a serve bucket, and a head dim of 64
    rows.extend(flash_bwd_cases(torch, timer, TRAIN_SEQ, torch.bfloat16, causal=False))
    rows.extend(flash_bwd_cases(torch, timer, 144, torch.bfloat16))
    rows.extend(flash_bwd_cases(torch, timer, TRAIN_SEQ, torch.bfloat16, d=64))
    # B4 at head dims the flagship does not serve, every multiple of 16 on
    # one lane mapping or the other: checked, not timed
    check_rows("kernels", [paged_case(torch, timer, quant, dh)
                           for dh in PAGED_CHECK_DIMS for quant in (False, True)])
    rows = check_rows("kernels", rows)
    paged, floor = phase_paged(torch, timer)
    return rows + paged, layout_case(torch, timer), floor


def phase_paged(torch, timer):
    """B4's timed rows (both page types, every mix of `PAGED_MIXES`) and the
    Timer's floor: part of the kernels phase, and alone a phase of its own
    for comparing two trees."""
    rows = [paged_case(torch, timer, quant, mix=mix)
            for mix in PAGED_MIXES for quant in (False, True)]
    return check_rows("paged", rows), timer_floor(torch, timer)


B4_DESIGN = ("flash-decoding: (slot, chunk of 2 f32 or 4 int8 pages, 2-head group) "
             "items, walked by twice as many blocks as the card holds, with no host "
             "read of seq_lens; whole pages by TMA box, a slot's partial last page by "
             "cp.async.bulk rows, into shared memory, one mbarrier a page; f32 online "
             "softmax per warp; the last block of a (slot, group), by ticket, merges "
             "the chunks' partials in chunk order through shared memory")


# the planted fault of `flash_fwd_fault_case`: P_j V_j reads V from the
# ring stage after tile j's
FLASH_FWD_FAULT = ("const uint32_t vs = sm_s + OS + (j % NSTAGE) * STAGE + KB;",
                   "const uint32_t vs = sm_s + OS + ((j + 1) % NSTAGE) * STAGE + KB;")


def flash_fwd_fault_case(torch):
    """Build `flash_fwd_wgmma` with the planted P V fault into
    ``build/fault/``, run it in place of the kernel (causal, bf16) at the
    training and serve-prefill shapes on `flash_case`'s inputs, and fail
    unless the row-by-row out tolerance rejects what it gives."""
    import ctypes

    from deeplearning4j_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    from deeplearning4j_tpu_torch.runtime import kernels

    src = (kernels.CSRC / "flash_fwd.cu").read_text()
    if src.count(FLASH_FWD_FAULT[0]) != 1:
        raise AssertionError("fault: the line to break is not once in csrc/flash_fwd.cu")
    work = kernels.build_dir().parent / "fault"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(kernels.CSRC, work)
    (work / "flash_fwd.cu").write_text(src.replace(*FLASH_FWD_FAULT))
    lib_path = work / "flash_fwd_fault.so"
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib_path),
                    str(work / "flash_fwd.cu")], check=True, capture_output=True, timeout=600)
    broken = ctypes.CDLL(str(lib_path))
    broken.dl4j_flash_fwd.argtypes = kernels.SIGNATURES["flash_fwd"]["dl4j_flash_fwd"]
    broken.dl4j_flash_fwd.restype = ctypes.c_int
    sound = kernels.library("flash_fwd")
    d, rows = D_MODEL // HEADS, []
    for bh, t in ((TRAIN_BATCH * HEADS, TRAIN_SEQ), (HEADS, SERVE_LENGTHS[0])):
        g = torch.Generator(device="cuda").manual_seed(t)
        q, k, v = (torch.randn((bh, t, d), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        ref, ref_lse = flash_fwd_plain(q, k, v, causal=True)
        kernels._LIBS["flash_fwd"] = broken
        try:
            out, lse = flash_fwd(q, k, v, causal=True)
            torch.cuda.synchronize()
        finally:
            kernels._LIBS["flash_fwd"] = sound
        r = {"shape": [bh, t, d], **out_errors(out, ref),
             "lse_err": (lse - ref_lse).abs().max().item()}
        r["caught_by_max"] = not r["rel_err"] <= TOL["flash_fwd/bf16"]
        r["caught_by_rows"] = not r["row_err"] <= TOL["flash_fwd_row/bf16"]
        log(f"[fault] V from the next stage, shape={r['shape']}: rel_err={r['rel_err']:.3e} "
            f"(tol {TOL['flash_fwd/bf16']:.1e}, caught {r['caught_by_max']}) "
            f"row_err={r['row_err']:.3e} (tol {TOL['flash_fwd_row/bf16']:.1e}, caught "
            f"{r['caught_by_rows']}) lse_err={r['lse_err']:.3e}")
        rows.append(r)
    if not all(r["caught_by_rows"] for r in rows):
        raise AssertionError(f"the row-by-row out tolerance let a P V fault through: {rows}")
    return rows


# `stages_case`: where kernel B4's time goes.  Each insertion goes right
# after its anchor line of csrc/paged_attention.cu (each anchor must be there
# once): block b stamps %globaltimer into stamp[b][0..6] at its start, when
# the slots' lengths are counted, and for its first item when every copy is
# issued, the last page has landed, the pages are computed, its ticket is
# taken (chunked slots) and the item is done (merged, where it merged).
STAGE_MARKS = (
    ("namespace {\n",
     "__device__ unsigned long long stamp[8192][8];\n"
     "__device__ __forceinline__ unsigned long long now_ns() {\n"
     "  unsigned long long t; asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("paged_split_kernel(const __grid_constant__ Args a) {\n",
     "  const unsigned long long t_start = now_ns();\n"
     "  const bool rec = threadIdx.x == 0 && blockIdx.x < 8192;\n  bool first = true;\n"),
    ("  const int n_items = carry;\n",
     "  if (rec) { stamp[blockIdx.x][0] = t_start; stamp[blockIdx.x][1] = now_ns(); }\n"),
    ("    // this warp's head, and its turn among the head's team\n",
     "    if (rec && first) stamp[blockIdx.x][2] = now_ns();\n"),
    ("      mbar_wait(smem_addr(&bars[j]), (phase >> j) & 1);\n",
     "      if (rec && first && j == np - 1) stamp[blockIdx.x][3] = now_ns();\n"),
    ("    phase ^= (1u << np) - 1;\n",
     "    if (rec && first) stamp[blockIdx.x][4] = now_ns();\n"),
    ("        const int t = atomicAdd(ticket, 1);\n",
     "        if (rec && first) stamp[blockIdx.x][5] = now_ns();\n"),
    ("    __syncthreads();   // the next item's copies reuse the page buffers\n",
     "    if (rec && first) stamp[blockIdx.x][6] = now_ns();\n    first = false;\n"),
)
STAGE_READ = """
extern "C" int dl4j_stamps(void* dst, int clear) {
  static unsigned long long zero[8192][8];
  return (int)(clear ? cudaMemcpyToSymbol(stamp, zero, sizeof(zero))
                     : cudaMemcpyFromSymbol(dst, stamp, sizeof(zero)));
}
"""


def stages_case(torch, timer):
    """Build kernel B4 with `STAGE_MARKS` into ``build/stages/``, launch it
    in place of the kernel on `paged_case`'s inputs after the Timer's L2
    flush, and print, in us from the first block's start: when the blocks
    start and finish counting lengths, and for the items (medians, and the
    last) when copies are issued, pages land, pages are computed, tickets
    are taken and items are done.  A diagnostic: its times include the
    stamps' own stores."""
    import ctypes

    import numpy as np

    from deeplearning4j_tpu_torch.ops.paged_attention import paged_attention_fwd
    from deeplearning4j_tpu_torch.runtime import kernels

    src = (kernels.CSRC / "paged_attention.cu").read_text()
    for anchor, text in STAGE_MARKS:
        if src.count(anchor) != 1:
            raise AssertionError(f"stages: anchor not once in paged_attention.cu: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    work = kernels.build_dir().parent / "stages"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(kernels.CSRC, work)
    (work / "paged_attention.cu").write_text(src + STAGE_READ)
    lib_path = work / "paged_attention_stages.so"
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib_path),
                    str(work / "paged_attention.cu")], check=True, capture_output=True,
                   timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    lib.dl4j_paged_attention.argtypes = \
        kernels.SIGNATURES["paged_attention"]["dl4j_paged_attention"]
    lib.dl4j_paged_attention.restype = ctypes.c_int
    sound = kernels.library("paged_attention")
    buf = np.zeros((8192, 8), np.uint64)
    out = {}
    for mix in PAGED_MIXES:
        for quant in (False, True):
            q, kp, vp, tbl, seq, ksc, vsc = paged_inputs(torch, quant, D_MODEL // HEADS, mix)
            kernels._LIBS["paged_attention"] = lib
            try:
                paged_attention_fwd(q, kp, vp, tbl, seq, ksc, vsc)
                torch.cuda.synchronize()
                lib.dl4j_stamps(None, 1)
                torch.cuda._sleep(20_000_000)
                timer.flush.zero_()
                paged_attention_fwd(q, kp, vp, tbl, seq, ksc, vsc)
                torch.cuda.synchronize()
                lib.dl4j_stamps(buf.ctypes.data, 0)
            finally:
                kernels._LIBS["paged_attention"] = sound
            blocks = buf[buf[:, 0] > 0].astype(np.int64)
            t = (blocks - blocks[:, 0].min()) / 1e3
            items = t[blocks[:, 2] > 0]
            ticketed = items[items[:, 5] > 0]

            def at(col, rows=items):
                return [float(np.median(rows[:, col])), float(rows[:, col].max())]

            r = {"blocks": len(blocks), "items_timed": len(items),
                 "block_start": at(0, t), "lengths_counted": at(1, t),
                 "copies_issued": at(2), "last_page_landed": at(3), "computed": at(4),
                 "ticket": at(5, ticketed) if len(ticketed) else None,
                 "item_done": at(6)}
            name = f"{mix}/{'int8' if quant else 'f32'}"
            out[name] = r
            log(f"[stages] {name}: {r['blocks']} blocks; us from the first block's start "
                f"(median, last): " + "; ".join(
                    f"{k} {v[0]:.2f}, {v[1]:.2f}" for k, v in r.items()
                    if isinstance(v, list)))
    return out


def check_rows(tag, rows):
    """Print each kernel row and fail if any disagrees with its plain
    version beyond its tolerance."""
    bad = []
    for r in rows:
        err = r.get("rel_err", r["max_abs_err"])
        extra = ""
        if "lse_err" in r:
            extra += f" lse_err={r['lse_err']:.3e} (tol {r['lse_tol']:.1e})"
        if "row_err" in r:
            extra += f" row_err={r['row_err']:.3e} (tol {r['row_tol']:.1e})"
        for key in ("part_floor_ms", "f32_fma_bound_ms", "clean_l2_ms", "host_ms"):
            if key in r:
                extra += f" {key}={r[key]:.5f}"
        timed = (f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                 f"library_ms={r['library_ms']} bound_ms={r['bound_ms']:.5f} "
                 f"({r['bound_by']})" if "ms" in r else "checked, not timed")
        mix = f" {r['mix']}" if "mix" in r else ""
        log(f"[{tag}] {r.get('kernel', r['name']):26s} {r['dtype']:4s}{mix} shape={r['shape']} "
            f"err={err:.3e} ({'relative, ' if 'rel_err' in r else ''}tol "
            f"{r['tol']:.1e}) {timed}{extra}")
        if (not err <= r["tol"] or not r.get("lse_err", 0.0) <= r.get("lse_tol", 0.0)
                or not r.get("row_err", 0.0) <= r.get("row_tol", 0.0)):
            bad.append(r)
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return rows


# -- serving phases -------------------------------------------------------------

def _prompts(np, seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, n).astype(np.int32) for n in lengths]


def _check_streams(np, prompts, outs, max_new):
    for p, o in zip(prompts, outs):
        o = np.asarray(o)
        if o.shape != (len(p) + max_new,) or not np.array_equal(o[:len(p)], p):
            raise AssertionError(f"stream shape {o.shape} for a {len(p)}-token prompt")
        gen = o[len(p):]
        if gen.min() < 0 or gen.max() >= VOCAB:
            raise AssertionError(f"out-of-vocab token in {gen}")


def _flagship(torch, bf16=None):
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

    model = TransformerEncoder(
        vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS, n_layers=LAYERS,
        causal=True, chunked_vocab_loss=True, vocab_chunk=8192, seed=123,
        bf16_compute=bf16,
    ).init_model(device="cuda")
    torch.cuda.synchronize()
    return model


def _profiled(torch, name, fn):
    """Run ``fn`` under torch.profiler: its wall time, the device busy
    share and the kernels that take the device time; the full tables go
    to ``chiprun_out/profile_<name>.txt``.  Busy time sums the device
    events only: a CPU op's row also carries its kernels' device time,
    and summing both counts each kernel twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extra = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    dev = [(e.self_device_time_total, e.key, e.count) for e in rows
           if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for t, _, _ in dev)
    top = sorted(dev, reverse=True)[:15]
    paged = [(t, n) for t, k, n in dev if "paged" in k]
    res = {"wall_s": wall, "device_busy_s": busy_us / 1e6,
           "device_busy_share": busy_us / 1e6 / wall,
           "top_device_kernels_ms": [[k, t / 1e3, n] for t, k, n in top],
           # kernel B4's own device time and launches
           "paged_attention_device_ms": sum(t for t, _ in paged) / 1e3,
           "paged_attention_launches": sum(n for _, n in paged)}
    res.update(extra or {})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"profile_{name}.txt"), "w") as f:
        f.write(rows.table(sort_by="self_device_time_total", row_limit=40))
        f.write("\n\n")
        f.write(rows.table(sort_by="self_cpu_time_total", row_limit=40))
    log(f"[profile] {name}: wall {wall:.3f}s (profiled), device busy "
        f"{res['device_busy_s']:.3f}s = {res['device_busy_share']:.3f}; paged attention "
        f"{res['paged_attention_device_ms']:.3f} ms in {res['paged_attention_launches']} "
        f"launches")
    for k, ms, n in res["top_device_kernels_ms"]:
        log(f"[profile]   {ms:10.3f} ms  {n:6d}x  {k[:100]}")
    return res


def phase_profile(torch, np):
    """Two training steps, the serve phase's streams again, the int8-KV
    engine's streams again and two quantized ``output()`` calls, under
    torch.profiler.  Not part of the default run (the profiler slows the
    host)."""
    from deeplearning4j_tpu_torch.serving.generation import (
        GenerationConfig,
        GenerationEngine,
    )

    out = {}
    model = _flagship(torch)
    batch = _train_batch(np)
    for _ in range(TRAIN_WARMUP):
        model.fit_batch(batch)

    def train():
        for _ in range(2):
            model.fit_batch(batch)
        return {"steps": 2}

    out["train"] = _profiled(torch, "train", train)
    del model, batch
    torch.cuda.empty_cache()

    model = _flagship(torch)
    eng = GenerationEngine(model, GenerationConfig(**ENGINE)).start()
    try:
        _serve_pass(torch, np, eng, seed=2)                 # meet every shape

        def serve():
            st = _serve_pass(torch, np, eng, seed=4)[2]
            return {k: st[k] for k in ("prefill_seconds", "prefills",
                                       "decode_seconds", "decode_steps")}

        out["serve"] = _profiled(torch, "serve", serve)
    finally:
        eng.stop()
    del model
    torch.cuda.empty_cache()

    model = _flagship(torch, bf16=False)
    prompts = _prompts(np, 3, PARITY_LENGTHS)
    eng = GenerationEngine(model, GenerationConfig(**ENGINE, kv_dtype="int8")).start()
    try:
        _parity_streams(eng, prompts, 32)                  # meet every shape

        def int8():
            base = eng.stats()
            _parity_streams(eng, prompts, 32)
            st = eng.stats()
            return {k: st[k] - base[k] for k in ("prefill_seconds", "prefills",
                                                 "decode_seconds", "decode_steps")}

        out["int8"] = _profiled(torch, "int8", int8)
    finally:
        eng.stop()
    del model
    torch.cuda.empty_cache()

    from deeplearning4j_tpu_torch.quant import quantize
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

    qmodel = quantize(TransformerEncoder(
        vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS, n_layers=LAYERS,
        causal=True, seed=123).init_model(device="cuda"))
    ids = np.random.default_rng(3).integers(
        0, VOCAB, (QUANT_BATCH, QUANT_SEQ)).astype(np.int64)
    qmodel.output(ids)                                      # warm-up

    def quant():
        for _ in range(2):
            qmodel.output(ids)
        return {"calls": 2}

    out["quant"] = _profiled(torch, "quant", quant)
    del qmodel
    torch.cuda.empty_cache()
    return out


def _train_batch(np):
    """bench_longctx's ids (numpy seed 3), fed as int64: the next-token
    labels of a causal LM."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet

    ids = np.random.default_rng(3).integers(0, VOCAB, (TRAIN_BATCH, TRAIN_SEQ))
    return DataSet(ids.astype(np.int64), np.roll(ids, -1, axis=1).astype(np.int64))


def phase_train(torch, np, kernels):
    """`fit_batch` of the full-width flagship on one fixed batch: warm-up
    steps, then the measured steps with the launch counters zeroed just
    before and read just after."""
    t0 = time.perf_counter()
    model = _flagship(torch)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] model: {n_params} params (f32 masters), compute "
        f"{model.compute_dtype}, Adam lr {model.conf.updater.learning_rate}, "
        f"built in {time.perf_counter() - t0:.1f}s")
    batch = _train_batch(np)
    losses = []
    for i in range(TRAIN_WARMUP):
        t1 = time.perf_counter()
        model.fit_batch(batch)
        losses.append(model.score_value)
        log(f"[train] warm-up step {i}: loss {losses[-1]:.5f}, "
            f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step_ms = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        model.fit_batch(batch)
        losses.append(model.score_value)           # synchronises
        step_ms.append((time.perf_counter() - t1) * 1e3)
        log(f"[train] step {i}: loss {losses[-1]:.5f}, {step_ms[-1]:.1f} ms")
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    tokens = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ
    res = {
        "params": n_params, "batch": [TRAIN_BATCH, TRAIN_SEQ],
        "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS, "losses": losses,
        "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": counts,
    }
    log(f"[train] {TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens in "
        f"{wall:.3f}s = {res['tokens_per_s']:.1f} tokens/s; median step "
        f"{res['median_step_ms']:.1f} ms; peak memory "
        f"{res['peak_memory_gib']:.2f} GiB; launches {counts}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    want = LAYERS * TRAIN_STEPS
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        if counts.get(name, 0) != want:
            raise AssertionError(f"{name} launched {counts.get(name, 0)} times "
                                 f"in {TRAIN_STEPS} steps, want {want}: {counts}")
    del model, batch
    torch.cuda.empty_cache()
    return res


SERVE_LENGTHS = [2000, 5, 40, 97, 150, 233, 300, 64]   # the last one samples


def _serve_pass(torch, np, eng, seed, max_new=32):
    """The 8 concurrent streams; returns prompts, requests, outputs, wall
    seconds and the engine's prefill / decode totals for the pass."""
    prompts = _prompts(np, seed, SERVE_LENGTHS)
    base = eng.stats()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new) for p in prompts[:-1]]
    reqs.append(eng.submit(prompts[-1], max_new, temperature=0.8, top_k=50,
                           seed=11))
    outs = [r.result(timeout=600) for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    _check_streams(np, prompts, outs, max_new)
    ttft = [r.ttft_s for r in reqs]
    res = {
        "streams": len(reqs), "max_new_tokens": max_new,
        "tokens": len(reqs) * max_new, "wall_s": wall,
        "tokens_per_s": len(reqs) * max_new / wall,
        "mean_ttft_s": sum(ttft) / len(ttft), "ttft_s": ttft,
        "long_prompt_ttft_s": ttft[0],
    }
    for k in ("decode_steps", "decode_seconds", "prefills", "prefill_seconds"):
        res[k] = st[k] - base[k]
    return prompts, outs, res


# measured passes a serving phase makes of its streams: one pass of the
# host-bound decode step swings +-30% between runs of one tree; the first
# counts the launches, and all give the medians
PASSES = 7


def _log_medians(tag, passes, res):
    """Medians over repeated measured passes, into ``res``."""
    tps = [p["tokens_per_s"] for p in passes]
    dec = [p["decode_seconds"] for p in passes]
    res.update(passes_tokens_per_s=tps, passes_decode_seconds=dec,
               median_tokens_per_s=statistics.median(tps),
               median_decode_seconds=statistics.median(dec))
    log(f"[{tag}] {len(passes)} measured passes: median {res['median_tokens_per_s']:.1f} "
        f"tokens/s (" + ", ".join(f"{t:.1f}" for t in tps) + "), median decode "
        f"{res['median_decode_seconds']:.4f}s")


def _log_pass(name, res):
    log(f"[serve] {name}: {res['tokens']} tokens in {res['wall_s']:.3f}s = "
        f"{res['tokens_per_s']:.1f} tokens/s; mean TTFT {res['mean_ttft_s']*1e3:.1f} ms "
        f"(2000-token prompt {res['long_prompt_ttft_s']*1e3:.1f} ms); "
        f"{res['prefills']} prefills {res['prefill_seconds']:.3f}s, "
        f"{res['decode_steps']} decode steps {res['decode_seconds']:.3f}s")


def phase_serve(torch, np, kernels):
    """Passes of the same 8-stream mix on one engine: the first meets
    every prefill shape for the first time (cuBLAS picks and loads its
    kernels then), the second is the measured main path, with the launch
    counters zeroed just before it and read just after, and it and the
    `PASSES` - 1 after it give the medians."""
    from deeplearning4j_tpu_torch.ops.generation import generate
    from deeplearning4j_tpu_torch.serving.generation import (
        GenerationConfig,
        GenerationEngine,
    )

    t0 = time.perf_counter()
    model = _flagship(torch)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] model: {n_params} params, compute {model.compute_dtype}, "
        f"built in {time.perf_counter() - t0:.1f}s")
    eng = GenerationEngine(model, GenerationConfig(**ENGINE)).start()
    try:
        _, _, cold = _serve_pass(torch, np, eng, seed=2)
        _log_pass("first pass (new shapes)", cold)
        kernels.reset_launches()
        prompts, outs, res = _serve_pass(torch, np, eng, seed=4)
        counts = kernels.launches()
        _log_pass("measured pass", res)
        more = [_serve_pass(torch, np, eng, seed=4)[2] for _ in range(PASSES - 1)]
        _log_medians("serve", [res] + more, res)
        if eng.kv.leak_check() is not None:
            raise AssertionError(eng.kv.leak_check())
    finally:
        eng.stop()
    log(f"[serve] launches in the measured pass: {counts}")
    for name in ("flash_fwd", "paged_attention_fwd"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on the main path: {counts}")
    # the long stream's first token against the dense reference (the same
    # prefill through the same kernels)
    dense_first = int(generate(model, prompts[0][None], 1)[0, -1])
    if dense_first != int(outs[0][len(prompts[0])]):
        raise AssertionError("first token of the 2000-token stream differs "
                             "from the dense reference")
    if not bool(torch.isfinite(model.output(prompts[1][None])).all()):
        raise AssertionError("non-finite hidden states")
    res["launches"] = counts
    res["first_pass"] = cold
    res["sample_ms"] = sample_cost(torch)
    del model
    torch.cuda.empty_cache()
    return res


def sample_cost(torch):
    """Host ms to sample one token from a (1, VOCAB) row of logits on the
    card (temperature 0.8, as the serve mix's sampled stream), top-k 50
    and top-k 0; each call ends in a sync, median of 5 rounds of 20.
    Beside the port's `_sample` (jax's noise for the finite candidates
    only, on the host), two yardsticks of the same rule that the port
    does not call: jax's noise over the whole vocabulary on the card, and
    noise from a `torch.Generator` on the card (a few launches, other
    bits than jax's)."""
    from deeplearning4j_tpu_torch.ops.generation import _sample
    from deeplearning4j_tpu_torch.runtime import rng

    def top_k_mask(scaled, top_k):
        if top_k <= 0:
            return scaled
        kth = torch.sort(scaled, dim=-1, descending=True).values[..., top_k - 1:top_k]
        return scaled.masked_fill(scaled < kth, float("-inf"))

    def jax_bits_on_card(logits, top_k, g):
        scaled = top_k_mask(logits.float() / 0.8, top_k)
        key = rng.fold_in(rng.key(11), g)
        return torch.argmax(scaled + rng.gumbel(key, scaled.shape, "cuda"), dim=-1)

    def torch_generator(logits, top_k, g):
        scaled = top_k_mask(logits.float() / 0.8, top_k)
        gen = torch.Generator(device="cuda").manual_seed(11 * 2**32 + g)
        e = torch.empty(scaled.shape, device="cuda").exponential_(generator=gen)
        return torch.argmax(scaled - torch.log(e), dim=-1)

    samplers = {
        "port": lambda x, k, g: _sample(x, temperature=0.8, top_k=k, seed=11, g=g),
        "jax_bits_on_card": jax_bits_on_card,
        "torch_generator": torch_generator,
    }
    logits = torch.randn((1, VOCAB), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(5))
    out = {}
    for top_k in (50, 0):
        want = [int(_sample(logits, temperature=0.8, top_k=top_k, seed=11, g=g)[0])
                for g in range(20)]
        if [int(jax_bits_on_card(logits, top_k, g)[0]) for g in range(20)] != want:
            raise AssertionError("the whole-vocabulary draw on the card gives "
                                 "other tokens than the port's sampler")
        for name, fn in samplers.items():
            rounds = []
            for _ in range(6):   # the first round warms up
                t0 = time.perf_counter()
                for g in range(20):
                    int(fn(logits, top_k, g)[0])
                rounds.append((time.perf_counter() - t0) / 20 * 1e3)
            out[f"{name}/top_k_{top_k}"] = statistics.median(rounds[1:])
    log(f"[serve] sampling a token from a (1, {VOCAB}) row, host ms (median of "
        "5 x 20, synced): " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))
    return out


def _agreement(np, prompts, outs, refs):
    agree = total = 0
    first_ok = True
    for p, o, r in zip(prompts, outs, refs):
        a, b = np.asarray(o)[len(p):], np.asarray(r)[len(p):]
        first_ok &= bool(a[0] == b[0])
        agree += int((a == b).sum())
        total += len(a)
    return agree / total, first_ok


def phase_parity(torch, np, kernels, kv_dtype="f32", gate=0.95, refs=None):
    from deeplearning4j_tpu_torch.ops.generation import generate
    from deeplearning4j_tpu_torch.serving.generation import (
        GenerationConfig,
        GenerationEngine,
    )

    model = _flagship(torch, bf16=False)
    prompts = _prompts(np, 3, PARITY_LENGTHS)
    max_new = 32
    if refs is None:
        refs = [generate(model, p[None], max_new)[0].cpu().numpy() for p in prompts]
    eng = GenerationEngine(model, GenerationConfig(**ENGINE, kv_dtype=kv_dtype)).start()
    try:
        _parity_streams(eng, prompts, max_new)             # meet every shape
        base = eng.stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        outs = _parity_streams(eng, prompts, max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        st = eng.stats()
        more = []
        for _ in range(PASSES - 1):
            b, t1 = eng.stats(), time.perf_counter()
            _parity_streams(eng, prompts, max_new)
            torch.cuda.synchronize()
            e = eng.stats()
            more.append({"tokens_per_s": len(prompts) * max_new / (time.perf_counter() - t1),
                         "decode_seconds": e["decode_seconds"] - b["decode_seconds"]})
    finally:
        eng.stop()
    _check_streams(np, prompts, outs, max_new)
    agree, first_ok = _agreement(np, prompts, outs, refs)
    timing = {"wall_s": wall, "tokens_per_s": len(prompts) * max_new / wall}
    for k in ("decode_steps", "decode_seconds", "prefills", "prefill_seconds"):
        timing[k] = st[k] - base[k]
    tag = "int8" if kv_dtype == "int8" else "parity"
    log(f"[{tag}] kv {kv_dtype}, f32 compute: "
        f"greedy agreement with dense generate {agree:.4f} (gate {gate}), "
        f"first tokens identical: {first_ok}, launches {counts}")
    log(f"[{tag}] {len(prompts)} streams x {max_new} tokens in {wall:.3f}s = "
        f"{timing['tokens_per_s']:.1f} tokens/s; {timing['decode_steps']} decode steps "
        f"{timing['decode_seconds']:.3f}s, {timing['prefills']} prefills "
        f"{timing['prefill_seconds']:.3f}s (second pass of the same streams)")
    _log_medians(tag, [timing] + more, timing)
    if agree < gate or not first_ok:
        raise AssertionError(f"engine ({kv_dtype} pages) disagrees with dense generate")
    del model
    torch.cuda.empty_cache()
    return {"agreement": agree, "first_token_identical": first_ok, "gate": gate,
            "launches": counts, **timing}, refs


PARITY_LENGTHS = [600, 150, 64, 17]


def _parity_streams(eng, prompts, max_new):
    reqs = [eng.submit(p, max_new) for p in prompts]
    return [r.result(timeout=600) for r in reqs]


# -- quant phase ------------------------------------------------------------------

def int8pack_case(torch, timer, x, q, scale, ref):
    """PyTorch's own int8-weight product, ``torch._weight_int8pack_mm``
    with f32 activations, where this build has it for CUDA tensors:
    (ms, relative error, note).  A second yardstick only; the port never
    calls it."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None, None, "this torch has no _weight_int8pack_mm"
    w_nk = q.t().contiguous()
    try:
        y = fn(x, w_nk, scale)
        torch.cuda.synchronize()
    except RuntimeError as e:          # not built for CUDA or for f32
        return None, None, str(e).splitlines()[0][:200]
    rel = (y - ref).abs().max().item() / ref.abs().max().item()
    # median of 3: it takes up to ~0.3 s a call at the head's shape
    return timer(lambda: fn(x, w_nk, scale), iters=3), rel, "f32 activations"


def dm_case(torch, timer, m, k, n, route=None):
    """Kernel B5 against `dequant_matmul_plain` at (M, K, N): random f32
    activations, int8 weights in [-127, 127] and positive scales.  With
    ``route`` None, through `dequant_matmul` (the route it picks by shape,
    the main path's), timed; else through that route alone, checked and
    not timed.  A second launch must give the same bits."""
    from deeplearning4j_tpu_torch.ops.dequant_matmul import (
        dequant_matmul,
        dequant_matmul_plain,
        kernel_route,
        launch_dequant_matmul,
    )

    g = torch.Generator(device="cuda").manual_seed(7 * m + 3 * k + n)
    x = torch.randn((m, k), generator=g, device="cuda")
    q = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                      dtype=torch.int8)
    scale = torch.rand((n,), generator=g, device="cuda") / 127 + 1e-4
    timed = route is None
    route = kernel_route(m, n, k, q) if route is None else route

    def fn():
        return dequant_matmul(x, q, scale) if timed else \
            launch_dequant_matmul(x, q, scale, route)

    y = fn()
    again = fn()
    ref = dequant_matmul_plain(x, q, scale)
    torch.cuda.synchronize()
    if not torch.equal(y, again):
        raise AssertionError(f"dequant_matmul {route} at {[m, k, n]}: a second "
                             "launch gave other bits")
    del again
    diff = (y - ref).abs().max().item()
    row = {
        "name": "dequant_matmul", "dtype": "int8", "shape": [m, k, n],
        "kernel": f"dequant_matmul_{route}", "route": route,
        "max_abs_err": diff, "rel_err": diff / ref.abs().max().item(),
        "tol": TOL["dequant_matmul/K1024" if k <= 1024 else "dequant_matmul/K4096"],
        "second_launch_identical": True,
    }
    if not timed:
        return row
    w = q.float() * scale                  # the library's dequantized weight
    n_bytes = m * k * 4 + k * n + n * 4 + m * n * 4
    # the function's multiply-adds on the bf16 peak, whatever the route
    b_ms, b_by = bound_ms(n_bytes, 2 * m * k * n, "bf16")
    row.update({
        "ms": timer(fn),
        "plain_ms": timer(lambda: dequant_matmul_plain(x, q, scale)),
        "library_ms": timer(lambda: torch.matmul(x, w)),
        "library": "cuBLAS f32 (torch.matmul) on the dequantized weight",
        "bound_ms": b_ms, "bound_by": b_by,
        # log only: the f32-FMA bound of the CUDA-core kernel the
        # tensor-core route replaced, and that route's own floor, two bf16
        # part products (x_hi q, x_lo q) for each multiply-add
        "f32_fma_bound_ms": bound_ms(n_bytes, 2 * m * k * n, "f32")[0],
    })
    if route == "wgmma":
        row["part_floor_ms"] = bound_ms(n_bytes, 2 * 2 * m * k * n, "bf16")[0]
    row["int8pack_ms"], row["int8pack_rel_err"], row["int8pack"] = int8pack_case(
        torch, timer, x, q, scale, ref)
    return row


def dm_rows(torch, timer):
    """B5 at every shape on the route the wrapper picks, timed; and the
    other route, where TMA can describe the weights (N a multiple of 16),
    checked against the plain version."""
    rows, other_rows = [], []
    for m, k, n in DM_SHAPES + [DM_RAGGED, DM_RAGGED_TMA]:
        rows.append(dm_case(torch, timer, m, k, n))
        other = "rows" if rows[-1]["route"] == "wgmma" else "wgmma"
        if other == "rows" or n % 16 == 0:
            other_rows.append(dm_case(torch, timer, m, k, n, route=other))
    return rows, other_rows


def _outputs(torch, model, ids, kernels=None):
    """``QUANT_WARMUP`` then ``QUANT_CALLS`` timed ``output()`` calls; with
    ``kernels``, the launch counters are zeroed just before the timed
    calls and read just after.  Returns (ms per call, counts, last out)."""
    for _ in range(QUANT_WARMUP):
        model.output(ids)
    torch.cuda.synchronize()
    if kernels is not None:
        kernels.reset_launches()
    ms = []
    for _ in range(QUANT_CALLS):
        t0 = time.perf_counter()
        out = model.output(ids)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launches() if kernels is not None else None
    return ms, counts, out


def _argmax_agreement(a, b) -> float:
    return (a.argmax(dim=-1) == b.argmax(dim=-1)).float().mean().item()


def phase_quant(torch, np, kernels, timer):
    """B5's kernel rows and B1's f32 row, then `quantize` of the
    full-width flagship with its softmax head and the measured quantized
    ``output()`` calls, held against the f32 model of the same weights."""
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel
    from deeplearning4j_tpu_torch.quant import (
        dequantize_tree,
        quantize,
        quantized_bytes,
    )
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

    rows, other_rows = dm_rows(torch, timer)
    rows.append(flash_case(torch, timer, QUANT_SEQ, torch.float32,
                           bh=QUANT_BATCH * HEADS))
    check_rows("quant", rows + other_rows)
    for r in rows:
        if "int8pack" in r:
            log(f"[quant] int8pack_mm at {r['shape']}: ms={r['int8pack_ms']} "
                f"rel_err={r['int8pack_rel_err']} ({r['int8pack']})")

    def zoo(bf16):
        # bench_longctx_quant's model (default RnnOutputLayer softmax head)
        # at the flagship widths
        return TransformerEncoder(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
                                  n_layers=LAYERS, causal=True, seed=123,
                                  bf16_compute=bf16)

    ids = np.random.default_rng(3).integers(
        0, VOCAB, (QUANT_BATCH, QUANT_SEQ)).astype(np.int64)
    tokens = QUANT_BATCH * QUANT_SEQ
    model = zoo(None).init_model(device="cuda")      # bf16 compute, as served today
    bf16_ms, _, _ = _outputs(torch, model, ids)
    t0 = time.perf_counter()
    qmodel = quantize(model)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    f32_bytes = quantized_bytes(model.params)["tree_bytes"]
    qb = quantized_bytes(qmodel.params)
    log(f"[quant] quantize: {quantize_s:.2f}s; tree {f32_bytes} -> "
        f"{qb['tree_bytes']} bytes ({qb['tree_bytes'] / f32_bytes:.4f}); "
        f"quantized weights {qb['quantized_bytes']} of {qb['f32_equiv_bytes']} "
        f"f32 bytes, ratio {qb['ratio']:.4f}; compute {qmodel.compute_dtype}")
    if not qb["tree_bytes"] < f32_bytes or qmodel.compute_dtype != torch.float32:
        raise AssertionError("the quantized model is not smaller, or not f32")

    q_ms, counts, p_q = _outputs(torch, qmodel, ids, kernels)
    want = {"dequant_matmul": (6 * LAYERS + 1) * QUANT_CALLS,
            "flash_fwd": LAYERS * QUANT_CALLS}
    log(f"[quant] int8 output(): {['%.2f' % t for t in q_ms]} ms a call, "
        f"{tokens / (statistics.median(q_ms) / 1e3):.1f} tokens/s; launches "
        f"{counts} (want {want})")
    log(f"[quant] unquantized bf16 output() (as the port serves it today, for "
        f"comparison): {['%.2f' % t for t in bf16_ms]} ms a call, "
        f"{tokens / (statistics.median(bf16_ms) / 1e3):.1f} tokens/s")
    if {k: counts.get(k, 0) for k in want} != want:
        raise AssertionError(f"quantized output() launches {counts}, want {want}")
    if tuple(p_q.shape) != (QUANT_BATCH, QUANT_SEQ, VOCAB) or \
            not bool(torch.isfinite(p_q).all()):
        raise AssertionError(f"quantized output {tuple(p_q.shape)} not finite")
    row_sum_err = (p_q.sum(-1) - 1).abs().max().item()
    if row_sum_err > 1e-3:
        raise AssertionError(f"probabilities sum to 1 +- {row_sum_err}")

    # the same int8 weights, dequantized into an f32 model: cuBLAS f32
    # products and the same f32 flash forward
    ref = SequentialModel(zoo(False).conf(), device="cuda").load_params(
        dequantize_tree(qmodel.params))
    p_ref = ref.output(ids)
    agree = _argmax_agreement(p_q, p_ref)
    dp = (p_q - p_ref).abs().max().item()
    p_max = p_ref.max().item()
    del ref, p_ref
    # the original f32 weights in f32: what int8 costs (information only)
    f32w = SequentialModel(zoo(False).conf(), device="cuda").load_params(model.params)
    agree_w = _argmax_agreement(p_q, f32w.output(ids))
    log(f"[quant] vs the f32 model of the dequantized weights: argmax "
        f"agreement {agree:.5f} (gate {QUANT_AGREEMENT}), max |dp| {dp:.3e} "
        f"of max p {p_max:.3e} (gate {QUANT_DP_REL:.0e} of max p); vs the "
        f"original f32 weights (information): agreement {agree_w:.5f}")
    if agree < QUANT_AGREEMENT or dp > QUANT_DP_REL * p_max:
        raise AssertionError("the quantized model disagrees with its dequantized "
                             "f32 twin")
    del model, qmodel, f32w, p_q
    torch.cuda.empty_cache()
    return {
        "kernel_rows": rows, "other_route_rows": other_rows,
        "batch": [QUANT_BATCH, QUANT_SEQ],
        "quantize_s": quantize_s, "f32_tree_bytes": f32_bytes,
        "quantized_bytes": qb, "output_ms": q_ms,
        "tokens_per_s": tokens / (statistics.median(q_ms) / 1e3),
        "bf16_unquantized_output_ms": bf16_ms, "launches": counts,
        "agreement_vs_dequantized_f32": agree, "max_abs_dp": dp, "max_p": p_max,
        "probability_row_sum_err": row_sum_err,
        "agreement_vs_f32_weights": agree_w,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list out of {PHASES + EXTRA_PHASES}")
    ap.add_argument("--package-root", default=None,
                    help="run the port found in this checkout (another commit "
                         "unpacked with git archive) instead of this one")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES + EXTRA_PHASES for p in phases):
        ap.error(f"unknown phase in {phases}")
    if args.package_root is not None:
        root = os.path.abspath(args.package_root)
        if not os.path.isdir(os.path.join(root, "deeplearning4j_tpu_torch")):
            ap.error(f"no deeplearning4j_tpu_torch package under {root}")
        sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "measures the GPU and has no CPU mode", file=sys.stderr)
        return 2
    import numpy as np

    from deeplearning4j_tpu_torch.runtime import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[identity] {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"capability {torch.cuda.get_device_capability(0)}; python {sys.version.split()[0]}")
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "package": os.path.dirname(os.path.dirname(os.path.abspath(kernels.__file__)))}
    log(f"[identity] port under test: {report['package']}")

    t0 = time.perf_counter()
    paths = kernels.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(paths)} libraries in {report['build_s']:.1f}s")
    serialized = []
    for stem, path in paths.items():
        logf = path.with_suffix(".log")
        if logf.exists():
            for line in logf.read_text(errors="replace").splitlines():
                if ("registers" in line or "spill" in line
                        or "warning" in line.lower() or "Performance Loss" in line):
                    log(f"[build] {stem}: {line.strip()}")
                if "wgmma.mma_async instructions are serialized" in line:
                    serialized.append(f"{stem}: {line.strip()}")
    if serialized:   # every product would wait for the one before it
        raise AssertionError("ptxas serialised the wgmma pipeline:\n" + "\n".join(serialized))
    if args.package_root is None:
        report["sass"] = check_sass(paths)
    else:   # another tree's kernels, compared, not held to this tree's SASS
        log("[build] SASS checks skipped: --package-root runs another tree's port")

    timer = Timer(torch)
    report["phase_s"] = phase_s = {}
    clock = [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now
        log(f"[time] {name}: {phase_s[name]:.1f}s")

    rows = []
    if "kernels" in phases:
        rows, report["flash_attention_layout"], report["timer_floor"] = phase_kernels(
            torch, timer)
        report["flash_fwd_fault"] = flash_fwd_fault_case(torch)
        done("kernels")
    elif "paged" in phases:
        rows, report["timer_floor"] = phase_paged(torch, timer)
        done("paged")
    if "stages" in phases:
        report["stages"] = stages_case(torch, timer)
        done("stages")
    report["kernel_phase"] = rows
    if "train" in phases:
        report["train"] = phase_train(torch, np, kernels)
        done("train")
    if "serve" in phases:
        report["serve"] = phase_serve(torch, np, kernels)
        done("serve")
    if "profile" in phases:
        report["profile"] = phase_profile(torch, np)
        done("profile")
    refs = None
    if "parity" in phases:
        report["parity"], refs = phase_parity(torch, np, kernels)
        done("parity")
    if "int8" in phases:
        report["int8"], _ = phase_parity(torch, np, kernels, kv_dtype="int8",
                                         gate=0.9, refs=refs)
        done("int8")
    if "quant" in phases:
        report["quant"] = phase_quant(torch, np, kernels, timer)
        rows = rows + report["quant"]["kernel_rows"]
        done("quant")

    entries = []
    def row(name, dtype="bf16", t=None, shape=None, causal=True, mix=None):
        return next((r for r in rows if r["name"] == name and r["dtype"] == dtype
                     and (t is None or r["shape"][1] == t)
                     and (shape is None or r["shape"] == shape)
                     and r.get("causal", True) == causal
                     and r.get("mix") == mix), None)

    dh = D_MODEL // HEADS
    train_bhtd = [TRAIN_BATCH * HEADS, TRAIN_SEQ, dh]
    # each main-path row with the path whose measured run counted its
    # launches (counters zeroed just before that run, read just after)
    main_rows = [
        (row("flash_fwd", shape=train_bhtd), "train"),
        (row("flash_fwd", shape=[HEADS, SERVE_LENGTHS[0], dh]), "serve"),  # the long prefill
        (row("flash_fwd", dtype="f32", shape=[QUANT_BATCH * HEADS, QUANT_SEQ, dh]), "quant"),
        (row("flash_bwd_dq", shape=train_bhtd), "train"),
        (row("flash_bwd_dkdv", shape=train_bhtd), "train"),
        (row("paged_attention_fwd", dtype="f32", mix="serve"), "serve"),
        (row("paged_attention_fwd_int8", dtype="int8", mix="serve"), "int8"),
        # the W1 product of the quantized flagship
        (row("dequant_matmul", dtype="int8",
             shape=[QUANT_BATCH * QUANT_SEQ, D_MODEL, 4 * D_MODEL]), "quant"),
    ]
    sources = {
        "flash_fwd": ("deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
                      "deeplearning4j_tpu/ops/flash_attention.py:35"),
        "flash_bwd_dq": ("deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
                         "deeplearning4j_tpu/ops/flash_attention.py:141"),
        "flash_bwd_dkdv": ("deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
                           "deeplearning4j_tpu/ops/flash_attention.py:189"),
        "paged_attention_fwd": ("deeplearning4j_tpu_torch/csrc/paged_attention.cu",
                                "deeplearning4j_tpu/ops/paged_attention.py:121"),
        "paged_attention_fwd_int8": ("deeplearning4j_tpu_torch/csrc/paged_attention.cu",
                                     "deeplearning4j_tpu/ops/paged_attention.py:121"),
        "dequant_matmul": ("deeplearning4j_tpu_torch/csrc/dequant_matmul.cu",
                           "deeplearning4j_tpu/ops/dequant_matmul.py:146"),
    }
    designs = {   # the kernels redesigned for Hopper
        "flash_fwd_wgmma": "warp-specialised: a TMA producer warpgroup keeps a 3-stage "
                           "K/V mbarrier ring full; 2 consumer warpgroups x 64 query "
                           "rows run S by wgmma m64n128k16 from shared memory and P V "
                           "with P in registers, taking turns on named barriers "
                           "(ping-pong)",
        "flash_fwd_split": "f32 at f32 accuracy on bf16 wgmma: a pre-pass splits "
                           "Q * scale, K, V into bf16 hi/lo parts; the bf16 "
                           "kernel's TMA producer, ping-pong consumers and 2-stage "
                           "ring of 64-key tiles; S and P V each as three part "
                           "products (hi hi, hi lo, lo hi), P split in registers",
        "dequant_matmul_wgmma": "x split into bf16 hi/lo parts by a pre-pass; TMA "
                                "4-stage ring of x parts and int8 q; 3 converter "
                                "warps widen q to bf16 in shared memory; 2 consumer "
                                "warpgroups run wgmma m64n128k16 a part, each K "
                                "slab's sum added to f32 registers",
        "flash_bwd_dq": "flash_bwd_dq_wgmma: wgmma bf16 -> f32, 2 warpgroups "
                        "x 64 query rows, cp.async ring of 2 K/V stages",
        "flash_bwd_dkdv": "flash_bwd_dkdv_wgmma: wgmma bf16 -> f32, 2 warpgroups "
                          "x 64 key rows, cp.async ring of 2 Q/g stages",
        "paged_attention_fwd": B4_DESIGN,
        "paged_attention_fwd_int8": B4_DESIGN,
    }
    for r, path in main_rows:
        if r is None:
            continue
        name = r["name"]
        src, replaces = sources[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": report.get(path, {}).get("launches", {}).get(name, 0),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "path": path, "dtype": r["dtype"], "shape": r["shape"],
        }
        design = designs.get(r.get("kernel", name))
        if design is not None:
            entry["kernel"] = r.get("kernel", name)
            entry["design"] = design
        entries.append(entry)
    if "int8" in report and report["int8"]["launches"].get("paged_attention_fwd_int8", 0) <= 0:
        raise AssertionError("the int8 engine never launched the int8 kernel")

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
