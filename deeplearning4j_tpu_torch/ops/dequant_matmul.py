"""Fused dequant-matmul — the counterpart of
`deeplearning4j_tpu/ops/dequant_matmul.py`.

``y = x @ (q * scale)`` for f32 activations ``x`` (..., K) against int8
weights ``q`` (K, N) with per-output-channel f32 scales ``scale`` (N,),
accumulated in f32 and returned as f32 (..., N).

`dequant_matmul` is the kernel wrapper: on a CUDA tensor it launches
``csrc/dequant_matmul.cu`` (the int8 weights cross HBM as int8 and are
widened only on chip) or raises; on a CPU tensor it runs
`dequant_matmul_plain`, the JAX package's dequantize-then-dot reference
(`_xla_dequant_dot`).  The kernel has two routes, picked here by shape:
more than `SMALL_M` rows whose weights TMA can describe go to the
tensor cores (x split into two bf16 parts, f32 sums), the rest to f32
FMAs split over K (decode-sized products, and shapes TMA cannot
describe).  Both take any M, K and N: they mask the ragged edge
themselves, so the Pallas tiling rule (`pallas_eligible`) has no
counterpart.  The JAX package's CPU ``blocked`` implementation, its
selection rule and its selection counter are not ported (ROADMAP A7).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.runtime import kernels


def dequant_matmul_plain(x, q, scale):
    """Dequantize-then-dot in f32: ``x.float() @ (q.float() * scale)``."""
    return x.float() @ (q.float() * scale.float())


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
    """(..., K) f32 @ dequant((K, N) int8, (N,) f32) -> (..., N) f32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check(x, q, scale)
    *lead, k = x.shape
    with kernels.kernel_call(
            lambda: dequant_matmul_work(x.numel() // k, k, q.shape[1])):
        if kernels.route(x.device) == "plain":
            return dequant_matmul_plain(x, q, scale)
        y = _dequant_matmul_kernel(x.reshape(-1, k), q, scale)
    return y.reshape(*lead, q.shape[1])


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
