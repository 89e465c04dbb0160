"""The mesh — `deeplearning4j_tpu/runtime/mesh.py` over the port's world.

The JAX package lays its devices out as a `jax.sharding.Mesh` with named
axes ("data", "model", "pipe", "seq", "expert") and shards over them.
A port mesh is the same named layout over the ranks of the
`torch.distributed` world (`runtime/distributed.py`, one process a
device): `make_mesh` resolves a `MeshSpec` against the world size and lays
the ranks out row-major over the axes, as JAX reshapes its device list:
rank r's coordinate on each axis is its digit in that mixed radix
(`axis_index`).  Every line of ranks along an axis larger than 1 gets a
`torch.distributed` process group (`axis_group`), and so does every
line along several axes at once (`axes_group`: the data and seq axes of
a gradient sum); every rank creates every group, in one order, as
``new_group`` requires.  A mesh on a world of one has every axis of
size 1 and no group.  ``shard_map`` is JAX mechanics and has no
counterpart: a rank's code is already its shard's body.
"""

from __future__ import annotations

import dataclasses
import math

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named axis layout; a size of -1 fills the remaining ranks (at most
    one axis).  Axes of size 1 are kept."""

    axes: tuple[tuple[str, int], ...] = ((DATA_AXIS, -1),)

    @staticmethod
    def data_parallel() -> "MeshSpec":
        return MeshSpec(((DATA_AXIS, -1),))

    @staticmethod
    def of(**axis_sizes: int) -> "MeshSpec":
        return MeshSpec(tuple(axis_sizes.items()))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    def resolve(self, n_devices: int) -> tuple[tuple[str, int], ...]:
        sizes = [s for _, s in self.axes]
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {self.axes}")
        fixed = math.prod(s for s in sizes if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh axes {self.axes} need {fixed} devices, have {n_devices}")
        return tuple((name, size) for (name, _), size in zip(self.axes, sizes))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over world ranks: ``shape[name]`` the axis size,
    ``devices`` the ranks in row-major order of the axes."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, rank: int) -> dict:
        """World rank ``rank``'s coordinate on each axis."""
        i = self.devices.index(rank)
        out = {}
        for name, size in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = i % size
            i //= size
        return {name: out[name] for name in self.axis_names}

    def axis_index(self, name: str) -> int:
        """This process's coordinate on axis ``name`` (0 on an absent
        axis), JAX ``lax.axis_index``."""
        from deeplearning4j_tpu_torch.runtime import distributed

        if name not in self.axis_names:
            return 0
        return self.coords(distributed.process_index())[name]

    def line(self, rank: int, names) -> tuple[int, ...]:
        """The ranks that share ``rank``'s coordinates on every axis but
        ``names``, in row-major order of those axes."""
        c = self.coords(rank)
        return tuple(r for r in self.devices
                     if all(v == c[a] for a, v in self.coords(r).items()
                            if a not in names))

    def axis_group(self, name: str):
        """The process group of this rank's line along axis ``name``
        (None: the axis has size 1, a collective over it is the
        identity)."""
        return self.axes_group((name,))

    def axes_group(self, names):
        """The process group of this rank's line along the axes ``names``
        together (None when they span one rank)."""
        from deeplearning4j_tpu_torch.runtime import distributed

        names = tuple(n for n in self.axis_names
                      if n in names and self.shape[n] > 1)
        if not names:
            return None
        return _GROUPS[(self, names)][self.line(distributed.process_index(), names)]


# (mesh, axes) -> {line of ranks: process group}
_GROUPS: dict = {}


def _make_groups(mesh: Mesh, names: tuple) -> None:
    """Every line's process group along ``names``, created on every rank
    in one order (``new_group`` is a collective of the whole world)."""
    import torch.distributed as dist

    key = (mesh, names)
    if key in _GROUPS:
        return
    lines: dict = {}
    for r in mesh.devices:
        line = mesh.line(r, names)
        if line not in lines:
            lines[line] = (dist.group.WORLD if len(line) == dist.get_world_size()
                           else dist.new_group(list(line)))
    _GROUPS[key] = lines


def make_mesh(spec: MeshSpec | None = None, devices=None) -> Mesh:
    """A mesh of ``spec`` over ``devices`` (world ranks; default: every
    rank of the world, or one rank when no world is formed), with the
    process groups of its axes: every rank of the world must call it
    with the same arguments, in the same order."""
    from deeplearning4j_tpu_torch.runtime import distributed

    spec = spec or MeshSpec.data_parallel()
    ranks = (tuple(int(d) for d in devices) if devices is not None
             else tuple(range(distributed.process_count())))
    resolved = spec.resolve(len(ranks))
    mesh = Mesh(tuple(n for n, _ in resolved), tuple(s for _, s in resolved), ranks)
    if distributed.is_initialized() and mesh.size > 1:
        import itertools

        wide = tuple(n for n, s in resolved if s > 1)
        for k in range(1, len(wide) + 1):
            for names in itertools.combinations(wide, k):
                _make_groups(mesh, names)
    return mesh


def axis_size(name: str, mesh: Mesh | None = None) -> int:
    """The size of axis ``name`` of ``mesh`` (the active mesh by
    default; 1 without one)."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return 1
    return mesh.shape.get(name, 1)


def single_device_mesh(axis: str = DATA_AXIS) -> Mesh:
    """A one-rank mesh (this process's rank), so sharded code paths run
    unchanged on one device."""
    from deeplearning4j_tpu_torch.runtime import distributed

    return Mesh((axis,), (1,), (distributed.process_index(),))


# -- the active mesh ----------------------------------------------------------------

_ACTIVE_MESH: Mesh | None = None
_ACTIVE_SPLITS: dict = {}


class active_mesh_scope:
    """Install ``mesh`` as the active mesh (reentrant; None is a valid,
    no-mesh value) with ``splits``: {id of a parameter leaf: the mesh
    axis that splits it}, what `parallel/strategy.py` decided for the
    trees the scope's layers run on (`leaf_axis`).  Within the same mesh
    they add to the enclosing scope's."""

    def __init__(self, mesh: Mesh | None, splits: dict | None = None):
        self._mesh = mesh
        self._splits = splits or {}
        self._prev = None

    def __enter__(self):
        global _ACTIVE_MESH, _ACTIVE_SPLITS
        self._prev = (_ACTIVE_MESH, _ACTIVE_SPLITS)
        outer = _ACTIVE_SPLITS if self._mesh is not None and self._mesh is _ACTIVE_MESH else {}
        _ACTIVE_MESH = self._mesh
        _ACTIVE_SPLITS = {**outer, **self._splits} if self._splits else outer
        return self._mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH, _ACTIVE_SPLITS
        _ACTIVE_MESH, _ACTIVE_SPLITS = self._prev
        return False


def active_mesh() -> Mesh | None:
    return _ACTIVE_MESH


def leaf_axis(t) -> str | None:
    """The axis of the active mesh that splits parameter leaf ``t`` (the
    layer holds this rank's slice of it), or None: ``t`` is whole."""
    return _ACTIVE_SPLITS.get(id(t))
