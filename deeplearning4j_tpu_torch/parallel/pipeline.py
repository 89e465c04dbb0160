"""Pipeline parallelism — `deeplearning4j_tpu/parallel/pipeline.py`.

The JAX package runs every device of the ``pipe`` axis through one
``shard_map`` program: each holds one stage's parameters, a ``lax.scan``
of ticks applies the stage to whatever arrived and ``lax.ppermute``
hands the result on.  A port rank is already its shard's body, so here
each rank runs its own stage through the same static schedule and the
handoffs are point-to-point transfers on the pipe axis's process group
(`collectives.exchange`, one ``batch_isend_irecv`` a tick, to the next
stage only: the JAX ring's wrap-around transfer lands on stage 0, which
ignores it).  A rank knows its schedule, so it computes nothing on its
bubble ticks; the numbers are the JAX schedule's.

- `pipeline_apply` (GPipe): the forward schedule as an autograd
  function whose backward is the reverse schedule, each stage
  rematerialised from its stashed inputs (JAX's ``jax.checkpoint``
  stage): only the stage inputs of the step's microbatches live from
  the forward to the backward.  Its output is the last stage's, summed
  over the axis (JAX's masked ``psum``: `collectives.reduce_from`, so
  the caller's cotangent enters the last stage once) and its input
  enters through `collectives.copy_to` (the gradient of the
  microbatches, stage 0's, reaches every rank).
- `pipeline_train_1f1b`: forward and backward interleaved in one tick
  loop, the backward of microbatch m on stage s at tick m + 2(k-1) - s,
  a stash of 2k-1 stage inputs, loss and dx averaged over microbatches.
- `plan_sequential_pipeline` / `run_pipelined_segment`: which run of
  identical blocks of a `SequentialModel` pipelines, and its GPipe run.

Stage functions are shape-preserving, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from deeplearning4j_tpu_torch.models.model import _tree_map, tree_leaves, tree_unflatten
from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.runtime.mesh import PIPE_AXIS, active_mesh_scope


def _stage_vjp(stage_fn, params, leaves, h, g):
    """Recompute the stage on its stashed input ``h`` and pull ``g``
    back: (the leaves' gradients, zeros for an unused one; dh)."""
    with torch.enable_grad():
        lv = [t.detach().requires_grad_() for t in leaves]
        hh = h.detach().requires_grad_()
        y = stage_fn(tree_unflatten(params, lv), hh)
        grads = torch.autograd.grad(y, lv + [hh], g.to(y.dtype), allow_unused=True)
    dp = [torch.zeros_like(t) if d is None else d for t, d in zip(lv, grads[:-1])]
    dh = grads[-1] if grads[-1] is not None else torch.zeros_like(h)
    return dp, dh


class _GPipe(torch.autograd.Function):
    """This rank's stage through the GPipe schedule: (n_micro, B_micro,
    ...) microbatches in (stage 0 reads them), the stage's outputs out
    (the last stage's are the pipeline's; the others return zeros).
    Backward runs the reverse schedule: each microbatch's stage
    recomputed from its stashed input and pulled back, dh handed to the
    previous stage; stage 0's are the microbatches' gradient."""

    @staticmethod
    def forward(ctx, x_micro, stage_fn, params, group, *leaves):
        k, s = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
        n = x_micro.shape[0]
        shape, dt, dev = tuple(x_micro.shape[1:]), x_micro.dtype, x_micro.device
        p = tree_unflatten(params, list(leaves))
        stash, outs, h = [], [], None
        for t in range(n + k - 1):
            m = t - s
            y = None
            if 0 <= m < n:
                if s == 0:
                    h = x_micro[m]
                stash.append(h)
                y = stage_fn(p, h)
                if s == k - 1:
                    outs.append(y)
            sends = [(y, s + 1)] if y is not None and s < k - 1 else []
            recvs = ([(shape, dt, dev, s - 1)] if s > 0 and 0 <= t + 1 - s < n else [])
            got = collectives.exchange(sends, recvs, group)
            if got:
                h = got[0]
        ctx.stage_fn, ctx.params, ctx.group = stage_fn, params, group
        ctx.n = n
        ctx.save_for_backward(*stash, *leaves)
        ctx.meta = (shape, dt, dev)
        if s == k - 1:
            return torch.stack(outs).to(dt)
        return torch.zeros_like(x_micro)

    @staticmethod
    def backward(ctx, g_out):
        group, n = ctx.group, ctx.n
        k, s = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
        saved = ctx.saved_tensors
        stash, leaves = list(saved[:n]), list(saved[n:])
        shape, dt, dev = ctx.meta
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
        dx = torch.zeros((n,) + shape, dtype=dt, device=dev) if s == 0 else None
        g = None
        # the reverse schedule: stage s takes microbatch m at tick
        # (n - 1 - m) + (k - 1 - s), the last stage first
        for t in range(n + k - 1):
            m = n - 1 - (t - (k - 1 - s))
            dh = None
            if 0 <= m < n:
                if s == k - 1:
                    g = g_out[m]
                dp, dh = _stage_vjp(ctx.stage_fn, ctx.params, leaves, stash[m], g)
                for a, d in zip(acc, dp):
                    a.add_(d.float())
                if s == 0:
                    dx[m] = dh.to(dt)
            mn = n - 1 - (t - (k - 2 - s))    # m of tick t + 1
            sends = [(dh, s - 1)] if dh is not None and s > 0 else []
            recvs = ([(shape, dt, dev, s + 1)] if s < k - 1 and 0 <= mn < n else [])
            got = collectives.exchange(sends, recvs, group)
            if got:
                g = got[0]
        dx = dx if dx is not None else torch.zeros((n,) + shape, dtype=dt, device=dev)
        return (dx, None, None, None, *[a.to(t.dtype) for a, t in zip(acc, leaves)])


def _pipe_group(axis: str):
    group = collectives.group_of(axis)
    if group is None:
        raise ValueError(f"the {axis!r} axis of the active mesh spans one rank: "
                         "nothing to pipeline over")
    return group


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor, *,
                   axis: str):
    """GPipe over the pipe axis ``axis`` of the active mesh.

    ``stage_fn(params, x) -> y`` is applied by every rank to its own
    stage (``stage_params``, any tree of tensors); ``x_micro`` (n_micro,
    B_micro, ...) is on every rank and only stage 0 feeds it in.
    Returns the (n_micro, B_micro, ...) outputs of the last stage on
    every rank.  Differentiable in ``x_micro`` and ``stage_params``: the
    caller's cotangent (equal on every rank, which all run the same code
    after the pipeline) enters the last stage once; ``x_micro``'s
    gradient is stage 0's, on every rank; each rank's stage parameters
    get their own stage's gradient."""
    group = _pipe_group(axis)
    leaves = tree_leaves(stage_params)
    x_in = collectives.copy_to(x_micro, axis)
    y = _GPipe.apply(x_in, stage_fn, stage_params, group, *leaves)
    return collectives.reduce_from(y, axis)


def pipeline_train_1f1b(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                        loss_grad_fn: Callable, *, axis: str, extra=None):
    """One-forward-one-backward training schedule in one tick loop.

    Stage s, microbatch m, k stages: forward of m on s at tick m + s;
    loss and its gradient of m on the last stage at tick m + k - 1 (the
    forward, then the backward, in the same tick); backward of m on s at
    tick m + 2(k-1) - s.  n_micro + 2k - 2 ticks; a stage keeps a ring of
    2k - 1 stashed stage inputs (the stage is recomputed in its
    backward), so the microbatch count does not change its memory.

    ``loss_grad_fn(y, m) -> (loss_m, dL/dy[, extra_grads])`` runs on the
    last stage's output for microbatch m (close over the labels); the
    optional third element is a tree of further gradients (the
    post-segment head's), summed over the microbatches.  ``extra``:
    zeros of that tree's structure, which every rank needs for the final
    sum (the JAX package reads it from an abstract trace of
    ``loss_grad_fn``); None when it returns two elements.

    Returns (mean_loss, stage_grads, dx_micro[, extra_grads]): the loss
    averaged over microbatches (on every rank), this rank's stage
    gradients (summed over microbatches, then over n_micro), dL/dx of
    every microbatch on every rank (stage 0's, averaged), and the extra
    gradients averaged, on every rank."""
    group = _pipe_group(axis)
    dist = torch.distributed
    k, s = dist.get_world_size(group), dist.get_rank(group)
    n = x_micro.shape[0]
    total = n + 2 * k - 2
    stash_n = 2 * k - 1
    last = s == k - 1
    shape, dt, dev = tuple(x_micro.shape[1:]), x_micro.dtype, x_micro.device
    leaves = tree_leaves(stage_params)
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
    extra_acc = None if extra is None else [
        torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        for t in tree_leaves(extra)]
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    dx = torch.zeros((n,) + shape, dtype=dt, device=dev)
    stash: list = [None] * stash_n
    h_fwd = g_bwd = None
    with torch.no_grad():
        for t in range(total):
            m_f = t - s
            y = g_seed = None
            if 0 <= m_f < n:
                h_in = x_micro[m_f].detach() if s == 0 else h_fwd
                stash[m_f % stash_n] = h_in
                y = stage_fn(stage_params, h_in)
                if last:
                    with torch.enable_grad():
                        lg = loss_grad_fn(y, m_f)
                    loss = loss + lg[0].detach().float()
                    g_seed = lg[1]
                    if len(lg) == 3:
                        if extra_acc is None:
                            raise ValueError(
                                "loss_grad_fn returned extra gradients: pass their "
                                "zeros as extra= (every stage sums them)")
                        for a, d in zip(extra_acc, tree_leaves(lg[2])):
                            a.add_(d.float())
            m_b = t - 2 * (k - 1) + s
            dh = None
            if 0 <= m_b < n:
                g_in = g_seed if last else g_bwd
                dp, dh = _stage_vjp(stage_fn, stage_params, leaves,
                                    stash[m_b % stash_n], g_in)
                for a, d in zip(acc, dp):
                    a.add_(d.float())
                if s == 0:
                    dx[m_b] = dh.to(dt)
            sends, recvs = [], []
            if y is not None and s < k - 1:
                sends.append((y, s + 1))
            if dh is not None and s > 0:
                sends.append((dh.to(dt), s - 1))
            want_fwd = s > 0 and 0 <= t + 1 - s < n
            want_bwd = s < k - 1 and 0 <= t + 1 - 2 * (k - 1) + s < n
            if want_fwd:
                recvs.append((shape, dt, dev, s - 1))
            if want_bwd:
                recvs.append((shape, dt, dev, s + 1))
            got = collectives.exchange(sends, recvs, group)
            if want_fwd:
                h_fwd = got.pop(0)
            if want_bwd:
                g_bwd = got.pop(0)
        # the objective is the mean over microbatches: one bucket sums the
        # last stage's loss, stage 0's dx and the last stage's extras
        from deeplearning4j_tpu_torch.runtime.distributed import all_reduce_flat

        bucket = [loss if last else torch.zeros_like(loss), dx.float()]
        bucket += [a if last else torch.zeros_like(a) for a in extra_acc or []]
        summed = all_reduce_flat(bucket, group=group)
        mean_loss = summed[0] / n
        dx_micro = (summed[1] / n).to(dt)
        grads = tree_unflatten(stage_params, [(a / n).to(t.dtype)
                                               for a, t in zip(acc, leaves)])
        if extra is None:
            return mean_loss, grads, dx_micro
        ex = tree_unflatten(extra, [(a / n).to(t.dtype) for a, t in
                                     zip(summed[2:], tree_leaves(extra))])
        return mean_loss, grads, dx_micro, ex


def split_microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) -> (n_micro, B/n_micro, ...)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible into {n_micro} microbatches")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def merge_microbatches(y: torch.Tensor) -> torch.Tensor:
    return y.reshape((-1,) + tuple(y.shape[2:]))


# -- model integration: a SequentialModel's repeated-block segment -----------------

@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """How a sequential layer stack maps onto the pipe axis.

    The pipelined segment is a contiguous run of identically configured,
    shape-preserving, stateless blocks, n_blocks = k stages x m blocks
    each.  Layers before and after it run replicated on every pipe rank."""

    start: int                 # first layer index in the segment
    end: int                   # one past the last layer index
    block_names: tuple
    block_config: object       # the shared LayerConfig (names differ only)
    k: int                     # pipeline stages
    n_micro: int               # microbatches per batch


def _param_shapes(params, name):
    def walk(node):
        if isinstance(node, dict):
            return tuple((key, walk(node[key])) for key in sorted(node))
        return (tuple(node.shape), str(node.dtype))

    return walk(params.get(name, {}))


def plan_sequential_pipeline(layers, params, itypes, k: int, n_micro: int = 0,
                             net_state=None) -> PipelinePlan:
    """The pipelined segment of a sequential stack, or a ValueError with
    the reason.  Each block: the same configuration but its name, the
    same parameter tree (structure and shapes), the same input type, no
    dropout, no state, and no state or auxiliary output emitted in
    training (checked by one run of the first block on fake tensors,
    which computes nothing)."""

    def strip(cfg):
        return dataclasses.replace(cfg, name="")

    best = (0, 0)
    i = 0
    while i < len(layers):
        j = i
        while (j + 1 < len(layers)
               and type(layers[j + 1]) is type(layers[i])
               and strip(layers[j + 1]) == strip(layers[i])
               and _param_shapes(params, layers[j + 1].name)
               == _param_shapes(params, layers[i].name)
               and itypes[j + 1] == itypes[i]):
            j += 1
        # the run's output type (the next layer's input type) must be its
        # input type
        run_ok = j > i and ((j + 1 < len(itypes) and itypes[j + 1] == itypes[i])
                            or j + 1 == len(itypes))
        if run_ok and (j + 1 - i) > (best[1] - best[0]):
            best = (i, j + 1)
        i = j + 1
    start, end = best
    n_blocks = end - start
    if n_blocks < k:
        raise ValueError(
            f"pipeline parallelism over {k} stages needs a contiguous run of "
            f">= {k} identical shape-preserving layers; longest found is "
            f"{n_blocks}. Pipeline the repeated-block segment of a "
            "transformer-style stack, or drop the pipe axis.")
    if n_blocks % k:
        raise ValueError(
            f"pipelined segment has {n_blocks} blocks, not divisible into "
            f"{k} stages")
    seg = layers[start:end]
    for l in seg:
        if getattr(l, "dropout_rate", None):
            raise ValueError(
                f"layer {l.name!r}: dropout inside the pipelined segment is not "
                "supported (per-block rng is not threaded through the pipeline "
                "scan)")
        if net_state and net_state.get(l.name):
            raise ValueError(
                f"layer {l.name!r}: stateful layers (BatchNorm running stats "
                "etc.) cannot be pipelined — state updates cannot live inside "
                "the ppermute schedule")
    # blocks that emit state or aux in training though they hold none at
    # rest (MoELayer's load-balancing loss): the stage drops apply()'s state
    rep = seg[0]
    emitted = _emitted_state(rep, params.get(rep.name, {}), itypes[start])
    if emitted:
        raise ValueError(
            f"layer {rep.name!r} ({type(rep).__name__}) emits state/aux during "
            f"training ({sorted(emitted)}); the pipeline schedule cannot carry "
            "it — keep such layers outside the pipelined segment")
    return PipelinePlan(start=start, end=end, block_names=tuple(l.name for l in seg),
                        block_config=seg[0], k=k, n_micro=n_micro or 2 * k)


def _emitted_state(layer, lp, itype) -> dict:
    """The state ``layer.apply`` emits in training on a batch of 2 (a
    time axis of 4 where the type leaves it open), run on fake tensors:
    the JAX package's ``jax.eval_shape`` probe."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if itype.kind == "rnn":
        t = itype.shape[0] if itype.shape[0] > 0 else 4
        shape = (2, t, itype.shape[1])
    else:
        shape = (2,) + tuple(itype.shape)
    mode = FakeTensorMode()
    device = next(iter(tree_leaves(lp)), torch.zeros(())).device
    fake = _tree_map(mode.from_tensor, lp)
    # no mesh: the layer runs as on one rank
    with mode, active_mesh_scope(None):
        x = torch.zeros(shape, dtype=torch.float32, device=device)
        _, emitted = layer.apply(fake, {}, x, training=True, rng=None)
    return emitted


def _stage_fn(cfg, training: bool, dtype=None):
    """A stage: its m blocks (a list of parameter trees) in order.
    ``dtype``: the compute dtype the blocks see their master trees cast
    to inside (None: the trees are already cast)."""
    def stage_fn(sp, h):
        for p in sp:
            if dtype is not None:
                p = _tree_map(lambda t: t.to(dtype), p)
            h, _ = cfg.apply(p, {}, h, training=training, rng=None)
        return h

    return stage_fn


def stage_blocks(plan: PipelinePlan, params, stage: int) -> list:
    """The parameter trees of stage ``stage``'s blocks, in order."""
    m = len(plan.block_names) // plan.k
    return [params[n] for n in plan.block_names[stage * m:(stage + 1) * m]]


def run_pipelined_segment(plan: PipelinePlan, params, x, *, axis: str = PIPE_AXIS,
                          training: bool):
    """The planned segment on ``x`` (B, ...) through GPipe over ``axis``:
    this rank runs its stage's blocks on each microbatch, the merged
    activations come back on every rank.  The blocks' parameters stay
    whole on every rank (the JAX package keeps them replicated too);
    each rank's stage reads its own blocks' trees."""
    stage = collectives.axis_rank(axis)
    sp = stage_blocks(plan, params, stage)
    out = pipeline_apply(_stage_fn(plan.block_config, training), sp,
                         split_microbatches(x, plan.n_micro), axis=axis)
    return merge_microbatches(out)
