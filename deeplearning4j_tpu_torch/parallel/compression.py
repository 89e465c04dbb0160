"""Quantized gradient all-reduce — `deeplearning4j_tpu/parallel/compression.py`.

Where gradient bytes are the bottleneck (data parallelism across hosts)
an int8 exchange moves a quarter of f32's.  The design is the JAX
package's:

  1. the ranks agree on one scale per tensor (the max over ranks of the
     local absmax, over 127), so the int8 values are summable;
  2. stochastic rounding (`runtime/rng.py`'s threefry bits, the JAX
     package's draws for the same key) keeps the quantizer unbiased;
  3. the int8 values are summed in int32 and the sum dequantized to the
     mean;
  4. error feedback: what quantization dropped is added to the next
     step's gradient.

`quantized_psum` exchanges one tensor (two collectives);
`quantized_allreduce_tree` exchanges a gradient list with per-leaf
scales in two collectives for the whole list: one max over the vector
of absmaxes and one int32 sum of the flat bucket of every leaf's
values.  Maxima and integer sums are exact, so the bucket computes the
per-leaf exchange's bits.  There is no Pallas kernel here in the JAX
package, so torch ops serve.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.runtime import rng
from deeplearning4j_tpu_torch.runtime.distributed import all_reduce_flat


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _quantize_stochastic(x: torch.Tensor, inv_scale, key) -> torch.Tensor:
    """x / scale stochastically rounded to the int8 lattice [-127, 127]."""
    scaled = x.float() * inv_scale
    low = torch.floor(scaled)
    frac = scaled - low
    up = rng.uniform(key, tuple(x.shape), device=x.device) < frac
    return torch.clamp(low + up.float(), -127, 127).to(torch.int8)


def _inv(scale: torch.Tensor) -> torch.Tensor:
    return torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))


def quantized_psum(x: torch.Tensor, *, key, n_shards: int | None = None):
    """The mean over the world's ranks of an f32 tensor, exchanged as
    int8.  Returns (mean, local_error): ``mean`` is equal on every rank;
    ``local_error = x - dequantized(this rank's contribution)``."""
    n = n_shards if n_shards is not None else _world()
    absmax = x.abs().max().float().reshape(1)
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX)
    scale = absmax[0] / 127.0
    q = _quantize_stochastic(x, _inv(scale), key)
    local = q.float() * scale
    total = q.to(torch.int32)
    dist.all_reduce(total)
    mean = total.float() * scale / n
    return mean.to(x.dtype), (x - local).to(x.dtype)


def quantized_allreduce_tree(grads: list, residual: list, *, key):
    """Error-feedback int8 mean over a gradient list (one scale a leaf,
    leaf i rounded with ``split(key, len(grads))[i]``, as the JAX
    package splits its key over the leaves).  Returns (synced grads,
    new residual): the first equal on every rank."""
    n = _world()
    if not grads:
        return [], []
    keys = rng.split(key, len(grads))
    comp = [g + r.to(g.dtype) for g, r in zip(grads, residual)]
    absmax = torch.stack([c.abs().max().float() for c in comp])
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX)
    scales = absmax / 127.0
    inv = _inv(scales)
    qs = [_quantize_stochastic(c, inv[i], keys[i]) for i, c in enumerate(comp)]
    totals = all_reduce_flat(qs, torch.int32)
    out, new_res = [], []
    for i, (c, q, t) in enumerate(zip(comp, qs, totals)):
        s = scales[i]
        out.append((t.float() * s / n).to(c.dtype))
        new_res.append((c - q.float() * s).to(c.dtype))
    return out, new_res


def zeros_residual(params: list) -> list:
    """The initial (all-zero) error-feedback state of a gradient list."""
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]
