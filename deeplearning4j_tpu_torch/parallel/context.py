"""What a layer or a loss needs to know of data parallelism while a
training step's forward runs: the counterpart of the JAX package's
global arrays under a ``P("data")`` (or ``P("data", "seq")``) batch
sharding.

Under GSPMD every quantity of a data-parallel step is global: BatchNorm's
batch mean and variance are means over the global batch, dropout draws
``bernoulli(key, keep, x.shape)`` over the global shape, and the loss is
the mean over every rank's rows.  A port rank holds only its rows, so
the model's step enters `dp_scope` with a `DataParallelContext` and:

- `global_mean` (BatchNorm) all-reduces each rank's weighted partial
  mean (`collectives.all_reduce_sum`, whose backward all-reduces the
  gradient), so the backward is global too;
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
- under pipeline parallelism every rank of a pipe line runs the layers
  around the pipelined segment on the same rows, and the step sums the
  gradients over the pipe axis too (each stage's blocks have theirs on
  one rank): the replicated terms count on the last stage only
  (``pipe_last``), and the step keeps that stage's gradients of the
  layers outside the segment (`models/model.py` `_dp_grads`).

The rows of a global batch are split over the data axis and, under
sequence parallelism, its time steps over the seq axis: a rank holds a
(B / n, T / s) block.  Every reduction here runs over the rank's line
along both axes (the "rows" group of the active mesh), never over the
model or expert axes, whose ranks hold the same rows.  While a forward
runs on a time block (`time_sharded`), dropout draws the block's
elements of the global mask by their global flat indices.

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


ROWS = ("data", "seq")


@dataclasses.dataclass(frozen=True)
class DataParallelContext:
    """A rank's place in the data axis while a step runs: ``rank`` of
    ``n``, and ``seq_rank`` of ``seq`` on the seq axis."""

    rank: int
    n: int
    seq_rank: int = 0
    seq: int = 1
    # False on a pipe rank that is not the last stage: its share of the
    # replicated terms is 0 (the last stage's counts for the line)
    pipe_last: bool = True

    @property
    def scale(self) -> float:
        return 1.0 / (self.n * self.seq)


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


def global_mean(xf: torch.Tensor, dims) -> torch.Tensor:
    """The mean of ``xf`` over ``dims`` and every rank's rows (the active
    context's), or over the local rows outside one."""
    local = xf.mean(dim=dims)
    ctx = current()
    if ctx is None:
        return local
    from deeplearning4j_tpu_torch.parallel import collectives

    return collectives.all_reduce_sum(local * ctx.scale, ROWS)


def global_count(count: torch.Tensor) -> torch.Tensor:
    """A count of kept entries summed over the rows group (a constant of
    the step: no gradient)."""
    from deeplearning4j_tpu_torch.parallel import collectives

    if current() is None:
        return count
    return collectives.all_reduce_sum(count.detach(), ROWS)


def loss_scale() -> Optional[float]:
    """The factor that makes a rank's mean its share of the global mean
    (1 / n), or None outside a context."""
    ctx = current()
    return None if ctx is None else ctx.scale


def replica_share(*terms):
    """Each replicated term of the objective (the l1 / l2 penalty, the
    layers' auxiliary losses) times 1 / n under a context (0 off the
    last pipe stage), so the ranks' summed gradients count it once; as
    they are outside one."""
    ctx = current()
    if ctx is None:
        return terms
    scale = ctx.scale if ctx.pipe_last else 0.0
    return tuple(t * scale for t in terms)


@contextlib.contextmanager
def time_sharded(seq_rank: int, seq: int):
    """Mark the activations of the code inside as time block
    ``seq_rank`` of ``seq`` (dim 1) of the global sequence (``seq`` 1:
    whole in time)."""
    prev = getattr(_local, "time_block", None)
    _local.time_block = (seq_rank, seq) if seq > 1 else None
    try:
        yield
    finally:
        _local.time_block = prev


def time_offset(t: int) -> tuple[int, int]:
    """(global position of the first of ``t`` local time steps, global
    length): (r t, s t) on time block r of s, (0, t) when whole."""
    blk = getattr(_local, "time_block", None)
    return (0, t) if blk is None else (blk[0] * t, blk[1] * t)


def dropout_offset(x: torch.Tensor):
    """Where ``x``'s elements lie in the global tensor: the flat index of
    its first element when the ranks' rows follow each other in rank
    order (0 outside a context), or, for a time block, an int64 tensor
    of every element's global flat index."""
    ctx = current()
    if ctx is None:
        return 0
    blk = getattr(_local, "time_block", None)
    if blk is None:
        return ctx.rank * x.numel()
    b, t = x.shape[0], x.shape[1]
    rest = x[0, 0].numel()
    dev = x.device
    rows = torch.arange(b, device=dev) + ctx.rank * b
    steps = torch.arange(t, device=dev) + blk[0] * t
    base = (rows[:, None] * (t * blk[1]) + steps[None, :]) * rest
    idx = base[..., None] + torch.arange(rest, device=dev)
    return idx.reshape(x.shape)
