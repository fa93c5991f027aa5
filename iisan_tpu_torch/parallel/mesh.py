"""A mesh of ``torch.distributed`` ranks on named axes.

Port of ``iisan_tpu/parallel/mesh.py``.  ``make_mesh("data:4,model:2")``
lays the ranks of the process group out row-major on the named axes (the
JAX package reshapes its device list the same way): rank r sits at
``np.unravel_index(r, sizes)``, and along each axis the ranks that share
every other coordinate form one ``torch.distributed`` group.  The empty
spec is every rank on one ``data`` axis.  Without a process group the mesh
is this one process, its axes of size 1 with no group, and nothing in
``parallel`` communicates.

What the JAX shardings do becomes explicit here:

- ``data`` (the JAX package's batch sharding, ``data_sharding`` /
  ``shard_batch``): each rank takes ``Axis.rows(n)`` of a batch of n rows,
  the whole batch when n does not divide the axis (replicated, as the JAX
  uncached trainer falls back);
- ``model``: the cached trainer keeps ``Axis.columns(d)`` of its tap
  tables' feature dim;
- ``replicate``: every rank builds the same parameters from the same seed;
  ``distributed.broadcast_`` makes sure of it;
- an axis of another name holds replicas, which compute the same thing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this rank sees it: its name and size, this
    rank's coordinate on it (``index``), the global ranks along it through
    this rank (``ranks``) and their process group (None without a process
    group)."""
    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Optional[object] = None

    def splits(self, n: int) -> bool:
        """Whether a batch of n rows is split over the axis (it is
        replicated when n does not divide it, or without a group)."""
        return self.group is not None and n % self.size == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of n: contiguous ``n / size`` rows
        in axis order, or all of them when the batch is replicated."""
        if not self.splits(n):
            return slice(0, n)
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)

    def columns(self, d: int) -> slice:
        """This rank's feature columns of a width-d table (``model``);
        d must divide."""
        if d % self.size:
            raise ValueError(f"feature width {d} does not divide the "
                             f"{self.name!r} axis of {self.size} ranks")
        per = d // self.size
        return slice(self.index * per, (self.index + 1) * per)


@dataclass(frozen=True)
class Mesh:
    """The axes of ``make_mesh``; ``shape`` maps names to sizes, as a JAX
    mesh's does."""
    axes: Tuple[Axis, ...]
    rank: int
    world: int

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return {a.name: a.size for a in self.axes}

    def axis(self, name: str) -> Axis:
        """The named axis; an axis the mesh lacks has size 1 and no group."""
        for a in self.axes:
            if a.name == name:
                return a
        return Axis(name, 1, 0, (self.rank,))


def parse_mesh_spec(spec: str, world: int) -> Tuple[List[str], List[int]]:
    """("name:size,...") -> (names, sizes); the empty spec is
    (["data"], [world]).  Raises ValueError on a malformed spec, a repeated
    name or a size below 1."""
    if not spec:
        return ["data"], [world]
    names, sizes = [], []
    for part in spec.split(","):
        name, sep, size = part.partition(":")
        if not sep or not name or not size.strip().isdigit():
            raise ValueError(f"mesh_shape {spec!r}: each axis is 'name:size'")
        if name in names:
            raise ValueError(f"mesh_shape {spec!r}: axis {name!r} repeats")
        if int(size) < 1:
            raise ValueError(f"mesh_shape {spec!r}: axis {name!r} has size "
                             f"{size}")
        names.append(name)
        sizes.append(int(size))
    return names, sizes


def world_rank() -> Tuple[int, int]:
    """(world size, rank) of the process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def mesh_layout(spec: str, world: int, rank: int):
    """(names, sizes, this rank's coordinates, [for each axis the global
    ranks along it through this rank]) of ``spec`` over ``world`` ranks,
    row-major.  Raises ValueError where the sizes do not multiply to the
    world."""
    names, sizes = parse_mesh_spec(spec, world)
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh_shape {spec!r} holds {int(np.prod(sizes))} "
                         f"ranks but the world has {world}")
    grid = np.arange(world).reshape(sizes)
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
    lines = []
    for i in range(len(sizes)):
        at = list(coords)
        at[i] = slice(None)
        lines.append(tuple(int(r) for r in grid[tuple(at)]))
    return names, sizes, coords, lines


def make_mesh(spec: str = "") -> Mesh:
    """The mesh of ``spec`` over the ranks of the process group.  Its sizes
    must multiply to the world size.  Every rank must call it, in the same
    order as its other collectives: each axis group is made by
    ``new_group`` (an axis that spans the world uses the default group)."""
    world, rank = world_rank()
    names, sizes, coords, lines = mesh_layout(spec, world, rank)
    grid = np.arange(world).reshape(sizes)
    axes = []
    for i, (name, size) in enumerate(zip(names, sizes)):
        group = None
        if dist.is_available() and dist.is_initialized():
            if size == world:
                group = dist.group.WORLD
            else:  # every line of this axis, made on every rank in order
                for line in np.moveaxis(grid, i, -1).reshape(-1, size):
                    g = dist.new_group([int(r) for r in line])
                    if rank in line:
                        group = g
        axes.append(Axis(name, size, coords[i], lines[i], group))
    return Mesh(tuple(axes), rank, world)


def pad_to_multiple(n: int, m: int) -> int:
    """n rounded up to a multiple of m."""
    return ((n + m - 1) // m) * m
