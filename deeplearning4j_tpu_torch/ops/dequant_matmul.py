"""Fused dequant-matmul — the counterpart of
`deeplearning4j_tpu/ops/dequant_matmul.py`.

``y = x @ (q * scale)`` for f32 activations ``x`` (..., K) against int8
weights ``q`` (K, N) with per-output-channel f32 scales ``scale`` (N,),
accumulated in f32 and returned as f32 (..., N).

Three implementations behind one dispatch, under the JAX package's
names:

- ``pallas`` — in the port, kernel B5, ``csrc/dequant_matmul.cu`` (the
  int8 weights cross HBM as int8 and are widened only on chip).  It
  runs on a CUDA tensor only: on a CPU tensor it raises.  The kernel has
  two routes, picked here by shape: more than `SMALL_M` rows whose
  weights TMA can describe go to the tensor cores (x split into two
  bf16 parts, f32 sums), the rest to f32 FMAs split over K
  (decode-sized products, and shapes TMA cannot describe).  Both take
  any M, K and N: they mask the ragged edge themselves, so the Pallas
  tiling rule (`pallas_eligible`) has no counterpart.
- ``blocked`` — `_blocked_dequant_dot`, a loop over K blocks that
  dequantizes one (block_k, N) slab at a time, with f32 sums; K must
  tile by a block candidate, else ``xla`` runs.
- ``xla`` — `dequant_matmul_plain`, the JAX package's
  dequantize-then-dot reference (`_xla_dequant_dot`).

Selection (`select_impl`).  On a CUDA tensor the quantized products
launch B5 or raise: the override ``DL4JTPU_QUANT_KERNEL`` may be unset,
``auto`` or ``pallas``, and ``blocked`` or ``xla`` there raises.  On a
CPU tensor the override (pallas / blocked / xla; auto or empty defers)
wins, else the JAX package's CPU rule: ``blocked`` from 2^22 weights and
2 rows up (K tiling), else ``xla``; ``pallas`` then raises.  Every
selection is counted on ``dl4jtpu_quant_dequant_matmul_total{impl}``
after the fallback is resolved, with the JAX package's labels.  The JAX
package counts when it traces a program: once per quantized site per
program signature.  The port counts once per site per input signature
of a model program (`SequentialModel.program_run` around each run of the
model's ``output()``, the generation engine's prefill and step, the
drafter and `ops.generation.generate`), and every call made outside a
program.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

from deeplearning4j_tpu_torch.runtime import kernels

ENV_KERNEL = "DL4JTPU_QUANT_KERNEL"
IMPLS = ("pallas", "blocked", "xla")

#: K block candidates of the blocked implementation, largest first
_BLOCK_CANDIDATES = (512, 256, 128)
#: the JAX package's CPU rule: ``blocked`` from this many weights and
#: this many activation rows up
_BLOCKED_MIN_WEIGHTS = 1 << 22
_BLOCKED_MIN_M = 2

_COUNTING = threading.local()


def _pick_block(dim: int) -> int:
    for b in _BLOCK_CANDIDATES:
        if dim % b == 0:
            return b
    return 0


def select_impl(m: int, k: int, n: int, device="cpu") -> str:
    """The selection rule.  Where `kernels.route` sends the device to the
    kernels (CUDA): ``pallas`` (B5), and an override of ``blocked`` or
    ``xla`` raises.  On the CPU: the env override, then the JAX package's
    rule (``blocked`` for large weights and at least two rows when K
    tiles, else ``xla``)."""
    env = os.environ.get(ENV_KERNEL, "").strip().lower()
    if kernels.route(torch.device(device)) == "kernel":
        if env in ("blocked", "xla"):
            raise RuntimeError(
                f"dequant_matmul: {ENV_KERNEL}={env!r} names a plain version; on "
                "a CUDA tensor the quantized products run kernel B5 (unset it, "
                "or set auto or pallas)")
        return "pallas"
    if env in IMPLS:
        return env
    if k * n >= _BLOCKED_MIN_WEIGHTS and m >= _BLOCKED_MIN_M and _pick_block(k):
        return "blocked"
    return "xla"


@contextlib.contextmanager
def counting_selections(on: bool):
    """Inside, a quantized site counts its selection only if ``on`` (and
    every enclosing scope is on): a model program counts on its first run
    at an input signature, as the JAX package counts when it traces."""
    prev = getattr(_COUNTING, "on", True)
    _COUNTING.on = prev and on
    try:
        yield
    finally:
        _COUNTING.on = prev


def _count_selection(impl: str) -> None:
    if not getattr(_COUNTING, "on", True):
        return
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().counter("dl4jtpu_quant_dequant_matmul_total").inc(impl=impl)
    except Exception:
        pass          # telemetry never fails a product (or a capture)


def dequant_matmul_plain(x, q, scale):
    """Dequantize-then-dot in f32: ``x.float() @ (q.float() * scale)``."""
    return x.float() @ (q.float() * scale.float())


def _blocked_dequant_dot(x, q, scale, *, block_k: int):
    """A loop over K blocks: one (block_k, N) int8 slab widened to f32 and
    dotted with the matching columns of x, summed in f32; the scale is
    applied once to the sum (it commutes with the contraction)."""
    k, n = q.shape
    x32 = x.float()
    acc = torch.zeros(x.shape[:-1] + (n,), dtype=torch.float32, device=x.device)
    for s in range(0, k, block_k):
        acc = acc + x32[..., s:s + block_k] @ q[s:s + block_k].float()
    return acc * scale.float()


def _check(x, q, scale) -> None:
    if q.dim() != 2 or q.dtype != torch.int8:
        raise TypeError(f"q must be (K, N) int8, got {tuple(q.shape)} {q.dtype}")
    k, n = q.shape
    if scale.shape != (n,) or scale.dtype != torch.float32:
        raise TypeError(f"scale must be ({n},) f32, got {tuple(scale.shape)} "
                        f"{scale.dtype}")
    if x.dim() < 1 or x.shape[-1] != k:
        raise ValueError(f"x must be (..., {k}) to meet q {tuple(q.shape)}; got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be f32, got {x.dtype}")
    if not (x.device == q.device == scale.device):
        raise ValueError("dequant_matmul: x, q, scale on different devices")


def dequant_matmul_work(m: int, k: int, n: int) -> list:
    """What kernel B5 computes for (M, K) f32 x and (K, N) int8 q:
    ``[(name, flops, bytes)]``, 2 M N K FLOPs; x, q and the scales read
    and y written once."""
    return [("dequant_matmul", 2 * m * k * n,
             m * k * 4 + k * n + n * 4 + m * n * 4)]


def dequant_matmul(x, q, scale):
    """(..., K) f32 @ dequant((K, N) int8, (N,) f32) -> (..., N) f32.  On a
    CUDA tensor B5 launches (or the call raises); on a CPU tensor a plain
    implementation runs (`select_impl`), and ``pallas`` raises."""
    _check(x, q, scale)
    *lead, k = x.shape
    n = q.shape[1]
    m = x.numel() // k if k else 0
    chosen = select_impl(m, k, n, x.device)
    if chosen == "blocked" and not _pick_block(k):
        chosen = "xla"                 # K does not tile: the baseline
    _count_selection(chosen)
    if chosen == "pallas" and kernels.route(x.device) != "kernel":
        raise RuntimeError("dequant_matmul: 'pallas' names kernel B5, which "
                           f"needs a CUDA tensor, not {x.device}")
    with kernels.kernel_call(lambda: dequant_matmul_work(m, k, n)):
        if chosen == "blocked":
            return _blocked_dequant_dot(x, q, scale, block_k=_pick_block(k))
        if chosen == "xla":
            return dequant_matmul_plain(x, q, scale)
        y = _dequant_matmul_kernel(x.reshape(-1, k), q, scale)
    return y.reshape(*lead, n)


#: the tensor-core route takes more rows than this
SMALL_M = 64
#: streaming multiprocessors of an H100 SXM: the rows route splits K until
#: its grid has about two blocks for each
_SMS = 132


def kernel_route(m: int, n: int, k: int, q) -> str:
    """``"wgmma"`` for more than `SMALL_M` rows when TMA can read q (N a
    multiple of 16, a 16-byte aligned start) and K > 0, else ``"rows"``."""
    if m > SMALL_M and n % 16 == 0 and k > 0 and q.data_ptr() % 16 == 0:
        return "wgmma"
    return "rows"


def row_splits(m: int, n: int, k: int) -> int:
    """How many K ranges the rows route sums separately: enough blocks to
    put every SM on the weight bytes, each range at least 16 rows deep,
    and the (splits, M, N) f32 partial sums no larger than the weights."""
    if k == 0:
        return 1
    rows = 1 if m == 1 else 2 if m == 2 else 4   # the rows a warp carries
    blocks = -(-n // 2048) * -(-m // rows)       # 4 strips of 512 columns a block
    want = -(-2 * _SMS // blocks)
    splits = max(1, min(want, k // (4 * m), k // 16))
    depth = -(-k // splits)
    return -(-k // depth)


def _dequant_matmul_kernel(x2, q, scale):
    if not (x2.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("dequant_matmul: inputs must be contiguous")
    m, k = x2.shape
    return launch_dequant_matmul(x2, q, scale, kernel_route(m, q.shape[1], k, q))


def launch_dequant_matmul(x2, q, scale, route: str):
    """Kernel B5 on one route (``"wgmma"`` or ``"rows"``) for contiguous
    (M, K) f32, (K, N) int8 and (N,) f32 CUDA tensors; allocates y and
    the route's scratch: the (2, M, K rounded up to 8) bf16 parts of x,
    or the (splits, M, N) f32 partial sums."""
    m, k = x2.shape
    n = q.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if m == 0 or n == 0:
        return y
    if route == "wgmma":
        if n % 16 or k == 0 or q.data_ptr() % 16:
            raise ValueError("dequant_matmul: TMA reads q only with N a multiple "
                             "of 16, K > 0 and a 16-byte aligned start")
        if -(-m // 128) > 65535:
            raise ValueError(f"dequant_matmul: {m} rows exceed the grid's 65535 tiles")
        parts = torch.empty((2, m, -(-k // 8) * 8), dtype=torch.bfloat16,
                            device=x2.device)
        scratch, partial, splits = parts.data_ptr(), None, 1
    elif route == "rows":
        if -(-m // 4) > 65535:
            raise ValueError(f"dequant_matmul: {m} rows exceed the grid's 65535 tiles")
        splits = row_splits(m, n, k)
        part = (torch.empty((splits, m, n), dtype=torch.float32, device=x2.device)
                if splits > 1 else None)
        scratch, partial = None, None if part is None else part.data_ptr()
    else:
        raise ValueError(f"dequant_matmul: no route {route!r}")
    rc = kernels.library("dequant_matmul").dl4j_dequant_matmul(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), scratch,
        partial, m, n, k, int(route == "wgmma"), splits,
        kernels.current_stream(x2.device))
    kernels.check_launch("dequant_matmul", rc)
    return y
