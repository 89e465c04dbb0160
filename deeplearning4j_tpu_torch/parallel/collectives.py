"""Differentiable collectives over one mesh axis — the port's ``lax.psum``,
``all_gather``, ``ppermute`` and ``all_to_all`` with their transposes.

A JAX program under a sharded mesh is one global function, and GSPMD or
``shard_map`` places the collectives and their transposes.  A port rank
runs its shard's code, so its layers call these: each is a
`torch.autograd.Function` over the process group of one axis of the
active mesh (`runtime/mesh.py` `axis_group`), and each is the identity
when that axis has size 1.

Two conventions meet here, and each collective says which it serves:

- **replicated gradients** (the model and expert axes): the code after
  a collective runs whole on every rank of the axis, so its gradient is
  complete and equal there.  `copy_to` (identity, all-reduce backward)
  completes the partial input gradient at the entry of a sharded
  region; `reduce_from` (all-reduce, identity backward) sums partial
  outputs; `gather` with ``grad="slice"`` gathers a sharded output and
  hands each rank its slice of the gradient back.
- **partial gradients** (the data and seq axes): each rank's objective
  is its share of the global one and the step sums the ranks'
  gradients.  `gather` with ``grad="sum"`` gathers a time-sharded
  sequence for a layer that needs all of it: its backward is the sum
  over the ranks of each one's gradient of the gathered tensor, sliced
  (an all-reduce, then the rank's block: gloo has no reduce-scatter).
  `ppermute` (ring attention's rotation, backward the inverse rotation,
  send and receive posted together) and `all_to_all` (Ulysses) are
  their own transposes' mirror images and serve both.

`exchange` posts one round of point-to-point transfers, the pipeline's
stage handoffs (`parallel/pipeline.py`), whose schedule places them.

Gloo carries CUDA tensors for all-reduce and all-gather; point-to-point
and all-to-all go through pinned host memory on a gloo world (and only
there), so a card shared by gloo ranks runs the same code as NCCL.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.runtime.mesh import active_mesh


def group_of(axis) -> object | None:
    """The process group of this rank's line along ``axis`` (a name or a
    tuple of names) of the active mesh, or None: no mesh, or the axes
    span one rank."""
    mesh = active_mesh()
    if mesh is None:
        return None
    return mesh.axes_group((axis,) if isinstance(axis, str) else tuple(axis))


def axis_size(axis) -> int:
    g = group_of(axis)
    return 1 if g is None else dist.get_world_size(g)


def axis_rank(axis) -> int:
    g = group_of(axis)
    return 0 if g is None else dist.get_rank(g)


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _block(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    c = t.shape[dim] // n
    return t.narrow(dim, dist.get_rank(group) * c, c).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, grad):
        ctx.dim, ctx.group, ctx.grad = dim, group, grad
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = _all_reduce(g, ctx.group)
        return _block(g, ctx.dim, ctx.group), None, None, None


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """Identity forward, all-reduce backward over ``axis``: the entry of
    a sharded region, whose ranks each return a partial input
    gradient."""
    g = group_of(axis)
    return x if g is None else _CopyTo.apply(x, g)


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """All-reduce forward, identity backward over ``axis``: partial
    outputs summed into the replicated whole."""
    g = group_of(axis)
    return x if g is None else _ReduceFrom.apply(x, g)


def all_reduce_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """All-reduce forward and backward over ``axis`` (``psum`` of a
    value every rank's objective shares: the partial-gradient axes)."""
    g = group_of(axis)
    return x if g is None else _AllReduceSum.apply(x, g)


def gather(x: torch.Tensor, dim: int, axis, grad: str = "slice") -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in the axis's rank
    order.  ``grad`` "slice": the rank's slice of the gradient (the
    replicated-gradient axes); "sum": the slice of the gradients summed
    over the axis (the partial-gradient axes)."""
    g = group_of(axis)
    return x if g is None else _Gather.apply(x, dim, g, grad)


def block(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (``x`` whole on every
    rank of ``axis``); differentiable as a slice."""
    g = group_of(axis)
    return x if g is None else _block(x, dim, g)


# -- point-to-point and all-to-all ------------------------------------------------

def _rotate(t: torch.Tensor, shift: int, group) -> torch.Tensor:
    """Rank i's ``t`` to rank (i + shift) mod n of ``group``; the send
    and the receive posted together."""
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    return exchange([(t, (i + shift) % n)],
                    [(t.shape, t.dtype, t.device, (i - shift) % n)], group)[0]


def exchange(sends, recvs, group) -> list:
    """One round of point-to-point transfers on ``group``, all posted
    together (one ``batch_isend_irecv``): ``sends`` a list of (tensor,
    destination rank of the group), ``recvs`` a list of (shape, dtype,
    device, source rank of the group).  Returns the received tensors in
    ``recvs`` order.  A pipeline's stage handoff (`parallel/pipeline.py`);
    a rank with nothing to send or receive in a round posts nothing."""
    if not sends and not recvs:
        return []
    devices = [t.device for t, _ in sends] + [torch.device(r[2]) for r in recvs]
    staged = _gloo(group) and any(d.type == "cuda" for d in devices)
    ops, out = [], []
    for t, dst in sends:
        t = t.detach().contiguous()
        if staged:
            t = t.to("cpu").pin_memory()
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, dst), group))
    for shape, dtype, device, src in recvs:
        buf = torch.empty(shape, dtype=dtype, device="cpu" if staged else device)
        if staged:
            buf = buf.pin_memory()
        out.append((buf, device))
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, src), group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return [buf.to(device, non_blocking=True) if staged else buf for buf, device in out]


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _rotate(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, -ctx.shift, ctx.group), None, None


def ppermute(x: torch.Tensor, axis, shift: int = 1) -> torch.Tensor:
    """Rank i's ``x`` lands on rank i + ``shift`` (mod the axis size):
    ``lax.ppermute`` with the ring permutation; its backward rotates the
    other way."""
    g = group_of(axis)
    return x if g is None else _Permute.apply(x, shift, g)


def _a2a(t: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """Tiled all-to-all: ``t`` split in n blocks along ``split_dim``,
    block j to rank j, the received blocks concatenated along
    ``concat_dim`` in rank order.  One ``all_to_all_single`` of the
    blocks laid out along dim 0 (gloo has no list all-to-all before
    torch 2.13)."""
    n = dist.get_world_size(group)
    staged = _gloo(group) and t.is_cuda
    src = t.detach().movedim(split_dim, 0)
    src = (src.to("cpu").pin_memory() if staged else src).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    out = out.to(t.device, non_blocking=True) if staged else out
    # dim 0 holds the n received blocks in rank order
    return torch.cat(out.movedim(0, split_dim).chunk(n, dim=split_dim), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _a2a(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _a2a(g, concat_dim, split_dim, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, axis, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``;
    its backward is the all-to-all back."""
    g = group_of(axis)
    return x if g is None else _AllToAll.apply(x, split_dim, concat_dim, g)
