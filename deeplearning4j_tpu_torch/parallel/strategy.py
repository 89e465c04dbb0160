"""`ParallelConfig`, the tensor-parallel partition rules and the ZeRO-1
shard rule — `deeplearning4j_tpu/parallel/strategy.py`.

A JAX ``PartitionSpec`` says which dim of a leaf is split over which
mesh axis and lets GSPMD place the pieces; a port rank holds its piece
itself.  The specs here are the JAX package's, as tuples of axis names
(``()`` replicated, ``(None, "model")`` the last dim of a matrix on the
model axis, ``("expert",)`` the leading dim on the expert axis):

- `param_specs` applies the JAX rules to a model's tree: ``W`` / ``Wx``
  / ``Wh`` / ``pointW`` split their last dim and ``b`` its only dim on
  the model axis; output layers, norms and the nested trees of blocks
  stay whole; MoE ``Wi`` / ``Wo`` split their experts on the expert
  axis.  `_warn_unsharded_params` names a sizable leaf no rule matched;
- `shard_params` cuts the rank's slice of each leaf, and
  `ShardPlacement` keeps which dim of which leaf lies on which axis, to
  cut the updater's state the same way and to gather trees back whole
  (a checkpoint);
- the ZeRO-1 rule answers "which slice of which dim does this rank own"
  on the data axis: `zero1_spec_for_leaf` gives the dim (the largest one
  the data axis divides evenly, or None) and `shard_zero1` cuts it.

`replicate` makes every rank's copy of a tree equal to rank 0's (one
broadcast); `batch_sharding` describes the rows and the time block a
rank feeds.
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
    the data-parallel options, the JAX package's fields: ``data``,
    ``model`` (tensor-sharded parameters), ``seq`` (ring or Ulysses
    attention over time blocks), ``expert`` (MoE experts) and ``pipe``
    (stages of a run of identical blocks, `parallel/pipeline.py`).

    ``microbatches`` / ``schedule``: the pipeline's microbatches a batch
    (0: twice the stages) and its schedule, "gpipe" or "1f1b".
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


# -- tensor-parallel partition rules -------------------------------------------

def _spec_for_param(layer_type: str, pname: str, ndim: int,
                    model_axis: str | None,
                    expert_axis: str | None = None) -> tuple:
    """The output-feature dim of weight matrices on the model axis,
    biases on it too, norms whole; MoE expert tensors' leading dim on
    the expert axis (the JAX package's rule)."""
    if layer_type == "MoELayer":
        if pname in ("Wi", "Wo") and expert_axis:
            return (expert_axis,)
        return ()
    if layer_type in ("BatchNorm", "LayerNorm"):
        return ()
    if model_axis is None:
        return ()
    if pname in ("W", "Wx", "Wh", "pointW"):
        return (None,) * (ndim - 1) + (model_axis,)
    if pname == "depthW":
        return ()
    if pname == "b":
        return (model_axis,)
    return ()


def layer_types(conf) -> dict:
    """{parameter-tree key: layer type name} of a sequential or graph
    configuration (a graph's shared layers key on their ``pkey``)."""
    out: dict = {}
    if hasattr(conf, "layers"):
        for l in conf.layers:
            out[l.name] = type(l).__name__
    else:
        for n in conf.nodes:
            if n.layer is not None:
                out.setdefault(getattr(n, "pkey", n.name), type(n.layer).__name__)
    return out


def param_specs(params, conf, model_axis: str | None = MODEL_AXIS,
                expert_axis: str | None = None, warn_unsharded: bool = False):
    """The spec tree of a model's parameters (``conf`` tells each layer's
    type).  Output-layer weights stay whole; ``model_axis`` None: no
    tensor parallelism (``expert_axis`` may still split MoE experts)."""
    types = layer_types(conf)
    specs = {}
    for lname, lp in params.items():
        ltype = types.get(lname, "")
        if ltype in ("OutputLayer", "RnnOutputLayer"):
            specs[lname] = _whole(lp)
            continue
        specs[lname] = {
            pname: _whole(leaf) if isinstance(leaf, dict)
            else _spec_for_param(ltype, pname, leaf.dim(), model_axis, expert_axis)
            for pname, leaf in lp.items()}
    if warn_unsharded and model_axis is not None:
        _warn_unsharded_params(params, specs, types)
    return specs


def _whole(tree):
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return ()


# layer types whose parameters stay whole under the model axis by the
# JAX package's policy (norms, heads and small slopes by design;
# attention and MoE because their sharding rides the seq and expert axes)
_TP_REPLICATE_OK = {
    "BatchNorm", "LayerNorm", "OutputLayer", "RnnOutputLayer", "Embedding",
    "PReLU", "MoELayer", "SeparableConv2D",
    "SelfAttentionLayer", "LearnedSelfAttentionLayer",
    "TransformerEncoderBlock", "AttentionVertex",
}


def _warn_unsharded_params(params, specs, types) -> None:
    """Warn of sizable leaves (2-D or more, 4096 elements or more) that no
    rule matched, nested trees included: tensor parallelism would keep
    them whole on every rank."""
    import warnings

    suspicious = []
    for lname, lp in params.items():
        if types.get(lname, "") in _TP_REPLICATE_OK:
            continue
        for pname, leaf in lp.items():
            if isinstance(leaf, dict):
                for sub in tree_leaves(leaf):
                    if sub.dim() >= 2 and sub.numel() >= 4096:
                        suspicious.append(f"{lname}/{pname}/...{tuple(sub.shape)}")
                        break
                continue
            if specs[lname][pname] == () and leaf.dim() >= 2 and leaf.numel() >= 4096:
                suspicious.append(f"{lname}/{pname}{tuple(leaf.shape)}")
    if suspicious:
        warnings.warn(
            "tensor parallelism is active but these sizable parameters "
            f"matched no partition rule and will be REPLICATED: "
            f"{suspicious}. If they belong to a custom layer, name the "
            "weights like the built-ins (W/Wx/Wh/pointW/b) or extend "
            "parallel/strategy.py's rules.", stacklevel=3)


def spec_dim(spec: tuple):
    """(axis, dim) of the one split dim of ``spec``, or None (whole)."""
    for d, a in enumerate(spec):
        if a is not None:
            return a, d
    return None


def shard_params(params, mesh: Mesh, specs):
    """Each leaf's slice on this rank (contiguous copies; whole leaves
    as they are).  A split dim the axis does not divide raises."""
    from deeplearning4j_tpu_torch.models.model import tree_unflatten

    placement = ShardPlacement.build(params, specs, mesh)
    return tree_unflatten(params, [placement.cut(i, t)
                                   for i, t in enumerate(tree_leaves(params))])


@dataclasses.dataclass
class ShardPlacement:
    """Which dim of each leaf (in `tree_leaves` order of the parameter
    tree) lies on which mesh axis: ``splits[i]`` is (axis, dim) or
    None.  Cuts the updater's per-leaf state as the leaves are cut and
    gathers trees back whole."""

    mesh: Mesh
    splits: list
    shapes: list                      # the full leaves' shapes

    @classmethod
    def build(cls, params, specs, mesh: Mesh) -> "ShardPlacement":
        """The placement of ``params``' leaves by the spec tree ``specs``."""
        return cls(mesh, [spec_dim(s) for s in spec_leaves(specs)],
                   [tuple(t.shape) for t in tree_leaves(params)])

    def cut(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of leaf i's full tensor ``t`` (a contiguous
        copy; ``t`` itself when whole)."""
        sd = self.splits[i]
        if sd is None:
            return t
        axis, dim = sd
        n = self.mesh.shape[axis]
        if t.shape[dim] % n:
            raise ValueError(
                f"a leaf of shape {tuple(t.shape)} splits dim {dim} over the "
                f"{axis} axis of size {n}, which does not divide it")
        return shard_of(t, dim, self.mesh.axis_index(axis), n).contiguous().clone()

    def shard_state(self, state, index: list):
        """The rank's slices of an updater state over the full leaves
        whose positions in the parameter tree are ``index`` (the
        trainable ones): every per-leaf list cut; counts as they are."""
        return self._map_state(state, index, [self.shapes[i] for i in index], self.cut)

    def gather_leaf(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf i whole from every rank's slice along its axis (a
        collective of that axis's ranks)."""
        sd = self.splits[i]
        if sd is None:
            return t
        axis, dim = sd
        group = self.mesh.axis_group(axis)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    def gather_tree(self, tree):
        """A parameter-shaped tree whole (every rank calls it)."""
        from deeplearning4j_tpu_torch.models.model import tree_unflatten

        leaves = tree_leaves(tree)
        return tree_unflatten(tree, [self.gather_leaf(i, t) for i, t in enumerate(leaves)])

    def gather_state(self, state, index: list):
        """The full updater state from this rank's slices (a collective)."""
        return self._map_state(state, index, [tuple(self._shard_shape(i)) for i in index],
                               self.gather_leaf)

    @staticmethod
    def _map_state(state, index: list, shapes: list, fn):
        """``state`` with ``fn(i, t)`` in place of each tensor of every
        per-leaf list (leaf i of the parameter tree, of shape in
        ``shapes``); the rest as it is."""
        def walk(s):
            if _per_leaf(s, shapes):
                return [fn(i, t) for i, t in zip(index, s)]
            if isinstance(s, tuple):
                return tuple(walk(x) for x in s)
            if isinstance(s, list):
                return [walk(x) for x in s]
            return s

        return walk(state)

    def _shard_shape(self, i: int):
        shape = list(self.shapes[i])
        sd = self.splits[i]
        if sd is not None:
            shape[sd[1]] //= self.mesh.shape[sd[0]]
        return shape


def spec_leaves(specs) -> list:
    """The specs of a spec tree's leaves in `tree_leaves` order of the
    parameter tree (dict keys sorted)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    return [specs]


def _per_leaf(x, shapes) -> bool:
    return (isinstance(x, list) and len(x) == len(shapes)
            and all(isinstance(t, torch.Tensor) and tuple(t.shape) == tuple(s)
                    for t, s in zip(x, shapes)))


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
    """The rows a rank feeds: block ``rank`` of a global batch split
    evenly over the ``n`` ranks of the data axis (`runtime/
    distributed.py` `put_global` cuts it with ``block=(rank, n)``).
    Under sequence parallelism (``seq`` > 1) the rank feeds those rows
    whole in time, and the model's step runs on time block
    ``seq_rank`` of ``seq`` (JAX ``P("data", "seq")``)."""

    rank: int
    n: int
    axis: str = DATA_AXIS
    seq_rank: int = 0
    seq: int = 1


def batch_sharding(mesh: Mesh, data_axis: str = DATA_AXIS,
                   seq_axis: str | None = None) -> BatchSharding:
    """The batch dim over the data axis, and time over ``seq_axis`` when
    it is given."""
    sr, s = 0, 1
    if seq_axis and mesh.shape.get(seq_axis, 1) > 1:
        sr, s = mesh.axis_index(seq_axis), mesh.shape[seq_axis]
    return BatchSharding(mesh.axis_index(data_axis), mesh.shape[data_axis],
                         data_axis, sr, s)
