"""ZeRO-1/2 sharded weight update — `deeplearning4j_tpu/parallel/zero.py`.

Classic data parallelism keeps the whole optimizer state on every rank
and runs the whole update there after an all-reduce has made the summed
gradient equal everywhere.  ZeRO-1 (`Zero1Placement`) gives each rank
one slice of every leaf (`parallel/strategy.py`: the largest dim the
world divides; a leaf no dim divides stays replicated) and runs

    reduce-scatter grads -> the updater on the rank's slices -> all-gather params

so each rank holds ~1/n of the optimizer state and does ~1/n of the
update.  The port's reduce-scatter is the data-parallel step's one flat
all-reduce followed by the rank's slice, about 1.5x the bytes of plain
data parallelism with the all-gather.  No one reduce-scatter call runs
undeprecated on both torch 2.11 and 2.13: 2.11 has only
``reduce_scatter_tensor`` (NCCL takes it without a warning), and 2.13
deprecates it in favour of ``reduce_scatter_single`` (gloo warns).  The
JAX package's XLA lowers its reduce-scatter the same way on backends
without one.  The all-gather is one ``all_gather`` of a flat bucket of
the rank's updated slices.  A transform that is not elementwise sees the
whole gradient: `clip_by_global_norm` takes its norm as the sum over the
ranks' slices (`nn/updaters.py` ``global_sq_norm``).

**ZeRO-2** (`Zero2Placement`) adds a sharded gradient accumulator kept
beside the optimizer state (``opt_state = {"opt": <state>, "grad_accum":
<slices>}``, `wrap_opt_state`): each step adds its gradient slices into
it, updates from it and zeroes it.  With ``grad_accum=m > 1`` the step
splits each rank's rows into m microbatches and accumulates their
slices (`scan_accumulate`): microbatch i of the world is every rank's
i-th slice of its rows (the JAX package takes global rows i B/m ..
(i + 1) B/m; ROADMAP C).  Checkpoints hold the inner state, gathered
(`Zero1Placement.gather_state`); a restore gives each rank its slices.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.models.model import tree_leaves
from deeplearning4j_tpu_torch.parallel.strategy import shard_of, zero1_spec_for_leaf
from deeplearning4j_tpu_torch.runtime.distributed import all_gather_flat
from deeplearning4j_tpu_torch.runtime.mesh import DATA_AXIS, Mesh

log = logging.getLogger("deeplearning4j_tpu_torch")


@dataclasses.dataclass
class Zero1Placement:
    """The slices one ``distribute(zero=1)`` call derives for a model's
    trainable leaves (`Model._trainable_leaves` order): ``dims[i]`` the
    dim of leaf i that the ranks split (None: replicated), ``shapes[i]``
    its full shape."""

    mesh: Mesh
    n: int
    rank: int
    dims: list
    shapes: list

    @classmethod
    def build(cls, leaves, mesh: Mesh, rank: int, data_axis: str = DATA_AXIS,
              **kw) -> "Zero1Placement":
        n = mesh.shape[data_axis]
        return cls(mesh=mesh, n=n, rank=rank,
                   dims=[zero1_spec_for_leaf(t, n) for t in leaves],
                   shapes=[tuple(t.shape) for t in leaves], **kw)

    # -- slices ---------------------------------------------------------------
    def shard(self, i: int, t: torch.Tensor, rank: int | None = None) -> torch.Tensor:
        """Leaf i's slice of ``t`` owned by ``rank`` (this rank's by
        default): a view."""
        return shard_of(t, self.dims[i], self.rank if rank is None else rank, self.n)

    def _per_leaf(self, x, shapes) -> bool:
        """True for a per-leaf list of the updater's state (one tensor a
        trainable leaf, of ``shapes``)."""
        return (isinstance(x, list) and len(x) == len(shapes)
                and all(isinstance(t, torch.Tensor) and tuple(t.shape) == s
                        for t, s in zip(x, shapes)))

    def shard_shapes(self) -> list:
        return [tuple(self.shard(i, torch.empty(s, device="meta")).shape)
                for i, s in enumerate(self.shapes)]

    def shard_state(self, state):
        """The rank's slices of an updater state over the full leaves:
        every per-leaf list cut to slices (contiguous copies); counts and
        other leaves as they are."""
        def walk(s):
            if self._per_leaf(s, self.shapes):
                return [self.shard(i, t).contiguous().clone() for i, t in enumerate(s)]
            if isinstance(s, tuple):
                return tuple(walk(x) for x in s)
            if isinstance(s, list):
                return [walk(x) for x in s]
            return s

        return walk(state)

    def _gather(self, pairs) -> list:
        """Full tensors of the (leaf index, this rank's slice) pairs, in
        one all-gather of a flat bucket (slices of replicated leaves are
        already whole)."""
        out = [None] * len(pairs)
        todo = []
        for k, (i, t) in enumerate(pairs):
            if self.dims[i] is None:
                out[k] = t.clone()
            else:
                todo.append(k)
        if todo:
            parts = all_gather_flat([pairs[k][1] for k in todo])
            for k in todo:
                i, t = pairs[k]
                out[k] = torch.empty(self.shapes[i], dtype=t.dtype, device=t.device)
            for j, views in enumerate(parts):
                for k, v in zip(todo, views):
                    self.shard(pairs[k][0], out[k], j).copy_(v)
        return out

    def gather_state(self, state):
        """The full updater state from every rank's slices (a collective:
        every rank calls it); counts as they are."""
        sshapes = self.shard_shapes()
        pairs, lists = [], []

        def collect(s):
            if self._per_leaf(s, sshapes):
                lists.append(s)
                pairs.extend(enumerate(s))
            elif isinstance(s, (tuple, list)):
                for x in s:
                    collect(x)

        collect(state)
        full = iter(self._gather(pairs))
        done = {id(lst): [next(full) for _ in lst] for lst in lists}

        def rebuild(s):
            if id(s) in done:
                return done[id(s)]
            if isinstance(s, tuple):
                return tuple(rebuild(x) for x in s)
            if isinstance(s, list):
                return [rebuild(x) for x in s]
            return s

        return rebuild(state)

    @torch.no_grad()
    def load_state(self, live, full):
        """Copy this rank's slices of the full state ``full`` into the
        live sliced state ``live``, in place (a restore: no collective).
        Returns the live state with ``full``'s counts."""
        sshapes = self.shard_shapes()

        def walk(d, s):
            if self._per_leaf(d, sshapes):
                for i, (dt, st) in enumerate(zip(d, s)):
                    dt.copy_(self.shard(i, st.to(dt.device)).to(dt.dtype))
                return d
            if isinstance(d, tuple):
                return tuple(walk(x, y) for x, y in zip(d, s))
            if isinstance(d, list):
                return [walk(x, y) for x, y in zip(d, s)]
            return s if isinstance(s, int) else d

        return walk(live, full)

    # -- the update epilogue ----------------------------------------------------
    def sq_norm(self, grads) -> torch.Tensor:
        """The global sum of squares of a gradient given as this rank's
        slices: the sliced leaves' partial sums all-reduced, plus the
        replicated leaves' (equal on every rank) once."""
        zero = grads[0].new_zeros((), dtype=torch.float32) if grads else None
        part = [(g.float() * g.float()).sum() for i, g in enumerate(grads)
                if self.dims[i] is not None]
        rep = [(g.float() * g.float()).sum() for i, g in enumerate(grads)
               if self.dims[i] is None]
        total = sum(part, zero).reshape(1).clone()
        dist.all_reduce(total)
        return total[0] + sum(rep, zero)

    @torch.no_grad()
    def gather_params(self, plist) -> None:
        """Every rank's updated slices into each rank's full leaves, in
        place (one all-gather)."""
        todo = [i for i in range(len(plist)) if self.dims[i] is not None]
        if not todo:
            return
        parts = all_gather_flat([self.shard(i, plist[i]) for i in todo])
        for j, views in enumerate(parts):
            if j != self.rank:
                for i, v in zip(todo, views):
                    self.shard(i, plist[i], j).copy_(v)

    def _update(self, tx, plist, inner, g, vals):
        from deeplearning4j_tpu_torch.nn.updaters import global_norm_scope

        p = [self.shard(i, t) for i, t in enumerate(plist)]
        with global_norm_scope(self.sq_norm):
            updates, inner = tx.update(g, inner, p, vals)
        with torch.no_grad():
            for pi, u in zip(p, updates):
                pi.add_(u.to(pi.dtype))
        self.gather_params(plist)
        return inner

    def apply(self, tx, plist, opt_state, grads, vals=None, accumulated=False):
        """The sharded epilogue: this rank's slices of the (summed)
        ``grads``, the updater on its slices of ``opt_state`` and of the
        parameters, the parameters gathered back in place.  Returns the
        new state."""
        g = [self.shard(i, t) for i, t in enumerate(grads)]
        return self._update(tx, plist, opt_state, g, vals)


# -- ZeRO-2: persistently sharded gradients ----------------------------------------

_WRAP_KEYS = frozenset({"opt", "grad_accum"})


def is_wrapped(opt_state) -> bool:
    """True for the ZeRO-2 wrapper: the inner state beside the sharded
    gradient accumulator."""
    return isinstance(opt_state, dict) and set(opt_state) == _WRAP_KEYS


def wrap_opt_state(leaves, opt_state):
    """The ZeRO-2 wrapper over ``opt_state`` with a zero accumulator of
    ``leaves``' shapes (their slices, when the leaves are slices).
    Idempotent."""
    if is_wrapped(opt_state):
        return opt_state
    return {"opt": opt_state,
            "grad_accum": [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                           for t in leaves]}


def unwrap_opt_state(opt_state):
    """(inner state, accumulator or None): the inner state is what a
    checkpoint holds and the updater reads."""
    if is_wrapped(opt_state):
        return opt_state["opt"], opt_state["grad_accum"]
    return opt_state, None


def wrap_like(ref_opt_state, opt_state, leaves):
    """``opt_state`` wrapped as ``ref_opt_state`` is (a checkpoint holds
    the inner state; a ZeRO-2 model holds the wrapper)."""
    if is_wrapped(ref_opt_state) and not is_wrapped(opt_state):
        return wrap_opt_state(leaves, opt_state)
    if not is_wrapped(ref_opt_state) and is_wrapped(opt_state):
        return opt_state["opt"]
    return opt_state


@dataclasses.dataclass
class Zero2Placement(Zero1Placement):
    """ZeRO-1 plus the sharded accumulator: `apply` adds the step's
    gradient slices into it (unless `scan_accumulate` already did),
    updates from it and zeroes it.  ``accum`` > 1 splits each step's
    rows into that many microbatches."""

    accum: int = 1

    def apply(self, tx, plist, opt_state, grads, vals=None, accumulated=False):
        inner, acc = opt_state["opt"], opt_state["grad_accum"]
        if not accumulated:
            with torch.no_grad():
                for i, (a, g) in enumerate(zip(acc, grads)):
                    a.add_(self.shard(i, g).to(a.dtype))
        inner = self._update(tx, plist, inner, acc, vals)
        with torch.no_grad():
            for a in acc:
                a.zero_()
        return {"opt": inner, "grad_accum": acc}

    def scan_accumulate(self, loss_grad_fn, state0, micro_arrays, acc):
        """The microbatches of one step with the sharded accumulator
        ``acc`` as the carry: ``loss_grad_fn(state, arrays, i)`` ->
        (loss, new state, summed grads) runs microbatch i (its own
        dropout keys); each microbatch's slices are added into ``acc``,
        which ends as their mean.  Returns (mean loss, final state)."""
        state, losses = state0, []
        for i, arrays in enumerate(micro_arrays):
            loss, state, grads = loss_grad_fn(state, arrays, i)
            with torch.no_grad():
                for j, (a, g) in enumerate(zip(acc, grads)):
                    a.add_(self.shard(j, g).to(a.dtype))
            losses.append(loss)
        with torch.no_grad():
            for a in acc:
                a.div_(self.accum)
        return torch.stack(losses).mean(), state


def split_accum_microbatches(arrays, m: int) -> list:
    """Each batch-leading array (B, ...) cut into m microbatches of B / m
    rows (None stays None); a batch m does not divide raises."""
    for a in arrays:
        if a is not None and a.shape[0] % m:
            raise ValueError(
                f"zero=2 grad_accum={m} needs the batch size to split evenly "
                f"into microbatches; got batch {a.shape[0]} — pick a batch "
                f"divisible by {m} or drop grad_accum")
    return [tuple(None if a is None else a[i * (a.shape[0] // m):
                                            (i + 1) * (a.shape[0] // m)]
                  for a in arrays) for i in range(m)]


# -- accounting ---------------------------------------------------------------------

def leaf_bytes_per_replica(leaf) -> int:
    """Bytes one rank holds for ``leaf`` (a slice is its own tensor; a
    count is an int32)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    if isinstance(leaf, int):
        return 4
    return 0


def opt_state_bytes_per_replica(opt_state) -> int:
    """This rank's bytes of the optimizer state (a ZeRO-2 wrapper's inner
    state only; the accumulator is gradient state)."""
    inner, _ = unwrap_opt_state(opt_state)
    return sum(leaf_bytes_per_replica(x) for x in tree_leaves(inner))


def grad_state_bytes_per_replica(model) -> int:
    """This rank's bytes of gradient state: the accumulator's slices
    under ZeRO-2, else the full gradient every rank materialises during
    a step (the trainable leaves' size)."""
    _, acc = unwrap_opt_state(model.opt_state)
    tree = acc if acc is not None else model._trainable_leaves(model.params)
    return sum(leaf_bytes_per_replica(x) for x in tree_leaves(tree))


def gauge_opt_state_bytes(model, mode: str) -> int:
    """Refresh ``dl4jtpu_opt_state_bytes`` and ``dl4jtpu_grad_state_bytes``
    for the model's placement (``mode``: "replicated", "sharded" or
    "zero2").  Returns the optimizer-state bytes."""
    total = opt_state_bytes_per_replica(model.opt_state)
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        g = registry().gauge("dl4jtpu_opt_state_bytes")
        g.clear()       # one live series: the model's current placement
        g.set(total, mode=mode)
        gg = registry().gauge("dl4jtpu_grad_state_bytes")
        gg.clear()
        gg.set(grad_state_bytes_per_replica(model), mode=mode)
    except Exception as e:      # telemetry never fails placement
        log.debug("opt-state bytes gauge failed: %s", e)
    return total


def measure_update_seconds(model, iters: int = 5) -> float:
    """Wall seconds of one update epilogue (`Model._apply_grads`: the
    updater, and under ZeRO the slices and the gather) under the model's
    placement, on copies of its trees and zero gradients (the epilogue's
    cost is not data dependent), after one untimed run.  Every rank must
    call it.  Adds the seconds to ``dl4jtpu_update_seconds_total``
    (labelled by mode) and returns one run's."""
    from deeplearning4j_tpu_torch.models.model import _clone_state

    leaves = [t.detach().clone() for t in model._trainable_leaves(model.params)]
    grads = [torch.zeros_like(t) for t in leaves]

    def once():
        model._apply_grads(leaves, _clone_state(model.opt_state), grads, None)
        if leaves and leaves[0].is_cuda:
            torch.cuda.synchronize(leaves[0].device)

    once()
    t0 = time.perf_counter()
    for _ in range(iters):
        once()
    secs = (time.perf_counter() - t0) / iters
    mode = "sharded" if getattr(model, "_zero_placement", None) is not None else "replicated"
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().counter("dl4jtpu_update_seconds_total").inc(secs * iters, mode=mode)
    except Exception as e:
        log.debug("update-seconds counter failed: %s", e)
    return secs
