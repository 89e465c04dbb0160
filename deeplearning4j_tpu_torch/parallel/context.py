"""What a layer or a loss needs to know of data parallelism while a
training step's forward runs: the counterpart of the JAX package's
global arrays under a ``P("data")`` batch sharding.

Under GSPMD every quantity of a data-parallel step is global: BatchNorm's
batch mean and variance are means over the global batch, dropout draws
``bernoulli(key, keep, x.shape)`` over the global shape, and the loss is
the mean over every rank's rows.  A port rank holds only its rows, so
the model's step enters `dp_scope` with a `DataParallelContext` and:

- `global_mean` (BatchNorm) all-reduces each rank's weighted partial
  mean through `AllReduceSum`, an autograd function whose backward
  all-reduces the gradient, so the backward is global too;
- `dropout_offset` is the flat index of the rank's first element in the
  global tensor (rank r's rows follow rank r - 1's), so the rank draws
  exactly its rows of the global mask (`runtime/rng.py` counts bits by
  flat index);
- `scale` (1 / n) turns the mean over a rank's rows into its share of
  the global mean, and a replicated term of the objective (the penalty,
  the auxiliary losses) into the rank's share of it (`replica_share`);
  `global_count` all-reduces a masked loss's count of kept entries, so
  a masked mean divides by the global count;
- the compressed step enters no scope: it keeps the JAX package's
  per-shard semantics (local statistics and masks, per-rank keys).

Every weight is an exact 1.0 in a world of one, so its step computes the
undistributed step's bits.  Outside a scope (inference, the cost
analysis re-running a step program) nothing here acts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataParallelContext:
    """A rank's place in the data axis while a step runs: ``rank`` of
    ``n``."""

    rank: int
    n: int

    @property
    def scale(self) -> float:
        return 1.0 / self.n


_local = threading.local()


def current() -> Optional[DataParallelContext]:
    """The active context, or None."""
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def dp_scope(ctx: Optional[DataParallelContext]):
    """Make ``ctx`` the active context of this thread (None: none)."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


class AllReduceSum(torch.autograd.Function):
    """Sum over the world, differentiable: the gradient of each rank's
    contribution is the sum of every rank's incoming gradient."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def global_mean(xf: torch.Tensor, dims) -> torch.Tensor:
    """The mean of ``xf`` over ``dims`` and every rank's rows (the active
    context's), or over the local rows outside one."""
    local = xf.mean(dim=dims)
    ctx = current()
    if ctx is None:
        return local
    return AllReduceSum.apply(local * ctx.scale)


def global_count(count: torch.Tensor) -> torch.Tensor:
    """A count of kept entries summed over the world (a constant of the
    step: no gradient)."""
    if current() is None:
        return count
    out = count.detach().clone()
    dist.all_reduce(out)
    return out


def loss_scale() -> Optional[float]:
    """The factor that makes a rank's mean its share of the global mean
    (1 / n), or None outside a context."""
    ctx = current()
    return None if ctx is None else ctx.scale


def replica_share(*terms):
    """Each replicated term of the objective (the l1 / l2 penalty, the
    layers' auxiliary losses) times 1 / n under a context, so the
    ranks' summed gradients count it once; as they are outside one."""
    scale = loss_scale()
    if scale is None:
        return terms
    return tuple(t * scale for t in terms)


def dropout_offset(x: torch.Tensor) -> int:
    """The flat index of ``x``'s first element in the global tensor whose
    rows the ranks hold in rank order (0 outside a context)."""
    ctx = current()
    return 0 if ctx is None else ctx.rank * x.numel()
