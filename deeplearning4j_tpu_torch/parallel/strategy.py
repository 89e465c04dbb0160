"""`ParallelConfig` and the ZeRO-1 shard rule —
`deeplearning4j_tpu/parallel/strategy.py`.

A JAX ``PartitionSpec`` says which dim of a leaf is split over which
mesh axis and lets GSPMD place the pieces; a port rank holds its piece
itself.  So the ZeRO-1 rule here answers "which slice of which dim does
this rank own": `zero1_spec_for_leaf` gives the dim (the largest one
that the data axis divides evenly, or None: the leaf stays replicated)
and `shard_zero1` cuts the rank's slice of it.  `replicate` makes every
rank's copy of a tree equal to rank 0's (one broadcast); `batch_sharding`
describes the rows a rank feeds.  The tensor-parallel rules
(``param_specs``, ``shard_params``) wait for tensor parallelism (ROADMAP
A11).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.models.model import tree_leaves
from deeplearning4j_tpu_torch.runtime.distributed import broadcast_flat
from deeplearning4j_tpu_torch.runtime.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    Mesh,
    MeshSpec,
    make_mesh,
)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Axis sizes (-1: fill with the remaining ranks, at most one) and
    the data-parallel options, the JAX package's fields.

    ``microbatches`` / ``schedule``: pipeline options (not ported yet).
    ``grad_compression``: "none" (the exact all-reduce) or "int8" (the
    error-feedback quantized exchange, `parallel/compression.py`).
    ``zero``: 0 replicated update, 1 sharded optimizer state and update,
    2 ZeRO-1 plus a sharded gradient accumulator, None reads
    ``DL4J_TPU_ZERO``.  ``grad_accum``: ZeRO-2 microbatches a step."""

    data: int = -1
    model: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1
    microbatches: int = 0
    schedule: str = "gpipe"
    grad_compression: str = "none"
    zero: int | None = None
    grad_accum: int = 1

    def mesh_spec(self) -> MeshSpec:
        # the data axis is always present; the others only when used
        axes = [(DATA_AXIS, self.data)]
        for name, size in ((MODEL_AXIS, self.model), (PIPE_AXIS, self.pipe),
                           (SEQ_AXIS, self.seq), (EXPERT_AXIS, self.expert)):
            if size != 1:
                axes.append((name, size))
        return MeshSpec(tuple(axes))

    def build_mesh(self, devices=None) -> Mesh:
        return make_mesh(self.mesh_spec(), devices)

    @staticmethod
    def data_parallel() -> "ParallelConfig":
        return ParallelConfig()


# -- ZeRO-1 weight-update sharding ------------------------------------------------

def zero1_spec_for_leaf(leaf, n: int) -> int | None:
    """The dim of ``leaf`` whose slices the n ranks own under ZeRO-1: the
    largest dim that n divides evenly (the first of equal ones), or None
    when no dim does (scalars and ragged leaves stay replicated)."""
    shape = tuple(getattr(leaf, "shape", ()))
    best = None
    for i, d in enumerate(shape):
        if d >= n and d % n == 0 and (best is None or d > shape[best]):
            best = i
    return best


def zero1_specs(tree, n: int):
    """`zero1_spec_for_leaf` of every leaf of a list or nested dict."""
    if isinstance(tree, dict):
        return {k: zero1_specs(v, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zero1_specs(v, n) for v in tree)
    return zero1_spec_for_leaf(tree, n)


def shard_of(t: torch.Tensor, dim: int | None, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along ``dim`` (a view; ``t`` itself
    when ``dim`` is None)."""
    if dim is None:
        return t
    c = t.shape[dim] // n
    return t.narrow(dim, rank * c, c)


def shard_zero1(tree, rank: int, n: int):
    """Each leaf's rank slice by the ZeRO-1 rule, as a contiguous copy
    (a replicated leaf is copied whole)."""
    if isinstance(tree, dict):
        return {k: shard_zero1(v, rank, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_zero1(v, rank, n) for v in tree)
    return shard_of(tree, zero1_spec_for_leaf(tree, n), rank, n).contiguous().clone()


@torch.no_grad()
def replicate(tree, src: int = 0):
    """Make every rank's tensors of ``tree`` equal to rank ``src``'s, in
    place, in one broadcast of a flat bucket a dtype.  Returns ``tree``."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree
    by_dtype: dict = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        broadcast_flat(ts, src)
    return tree


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The rows a rank feeds: rank ``rank``'s block of a global batch
    split evenly over the ``n`` ranks of the data axis (`runtime/
    distributed.py` `put_global` cuts it)."""

    rank: int
    n: int
    axis: str = DATA_AXIS


def batch_sharding(mesh: Mesh, data_axis: str = DATA_AXIS,
                   seq_axis: str | None = None) -> BatchSharding:
    """The batch dim over the data axis (``seq_axis`` is the sequence-
    parallel time split, not ported: it must be absent or of size 1)."""
    from deeplearning4j_tpu_torch.runtime import distributed

    if seq_axis and mesh.shape.get(seq_axis, 1) > 1:
        raise NotImplementedError(
            "sequence parallelism is not ported yet (ROADMAP A11)")
    return BatchSharding(distributed.process_index(), mesh.shape[data_axis],
                         data_axis)
