"""The mesh — `deeplearning4j_tpu/runtime/mesh.py` over the port's world.

The JAX package lays its devices out as a `jax.sharding.Mesh` with named
axes ("data", "model", "pipe", "seq", "expert") and shards over them.
A port mesh is the same named layout over the ranks of the
`torch.distributed` world (`runtime/distributed.py`, one process a
device): `make_mesh` resolves a `MeshSpec` against the world size and
records which ranks lie along each axis.  Only the data axis may be
larger than 1 here; tensor, pipeline, sequence and expert axes raise
(ROADMAP A11).  ``shard_map`` is JAX mechanics and has no counterpart:
a rank's code is already its shard's body.
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


def make_mesh(spec: MeshSpec | None = None, devices=None) -> Mesh:
    """A mesh of ``spec`` over ``devices`` (world ranks; default: every
    rank of the world, or one rank when no world is formed).  Only the
    data axis may be larger than 1 in this port."""
    from deeplearning4j_tpu_torch.runtime import distributed

    spec = spec or MeshSpec.data_parallel()
    ranks = (tuple(int(d) for d in devices) if devices is not None
             else tuple(range(distributed.process_count())))
    resolved = spec.resolve(len(ranks))
    wide = [name for name, size in resolved if name != DATA_AXIS and size > 1]
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} larger than 1: tensor, pipeline, sequence and "
            "expert parallelism are not ported yet (ROADMAP A11); the port's "
            "mesh spreads the data axis only")
    return Mesh(tuple(n for n, _ in resolved), tuple(s for _, s in resolved), ranks)


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


class active_mesh_scope:
    """Install ``mesh`` as the active mesh (reentrant; None is a valid,
    no-mesh value)."""

    def __init__(self, mesh: Mesh | None):
        self._mesh = mesh
        self._prev: Mesh | None = None

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev = _ACTIVE_MESH
        _ACTIVE_MESH = self._mesh
        return self._mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev
        return False


def active_mesh() -> Mesh | None:
    return _ACTIVE_MESH
