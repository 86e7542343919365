"""The rank mesh and its sharding helpers (counterpart of
deflatedmlmc_schwinger_tpu/parallel/mesh.py).

The primary axis is 'samples' (probe data-parallelism): every rank takes its
rows of a probe batch, and the only communication between sample rows is
the any-reduce of the solver's loop predicates and the gather of the
estimates. The secondary axis is 'x' (lattice domain decomposition): level-0
fields (..., 2, X, T) are cut along X and the stencil exchanges one boundary
row per neighbour (parallel/halo.py).

A ``Mesh`` is this rank's view: the shape by axis name, its own coordinates,
one communicator per axis (the ranks that differ from it in that coordinate
only) and the world. Ranks are laid out row-major over the shape, as
``np.arange(n).reshape(shape)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import (
    Group,
    broadcast_object,
    rank_device,
    shard_global_batch,
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    coords: Dict[str, int]
    groups: Dict[str, Group]
    world: Group
    device: torch.device

    @property
    def rank(self) -> int:
        return self.world.index

    @property
    def size(self) -> int:
        return self.world.size


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("samples",),
    device="cuda",
) -> Mesh:
    """This rank's view of a mesh over the ranks of the process group;
    defaults to all ranks on one 'samples' axis. Every rank of the mesh must
    call it with the same arguments, and a rank the mesh leaves out must call
    it too (it takes part in making the communicators and gets None)."""
    axis_names = tuple(axis_names)
    live = dist.is_available() and dist.is_initialized()
    nranks = dist.get_world_size() if live else 1
    me = dist.get_rank() if live else 0
    if shape is None:
        shape = (nranks,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if n > nranks:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, have {nranks}")
    grid = np.arange(n).reshape(shape)
    mine = None if me >= n else tuple(int(c) for c in np.argwhere(grid == me)[0])

    def group_of(ranks) -> Optional[Group]:
        ranks = tuple(int(r) for r in ranks)
        # every rank creates every communicator, in the same order
        pg = dist.new_group(list(ranks)) if live and len(ranks) > 1 else None
        return Group(pg, ranks, ranks.index(me)) if me in ranks else None

    world = group_of(grid.ravel())
    groups: Dict[str, Group] = {}
    for ax, name in enumerate(axis_names):
        lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            g = group_of(line)
            if g is not None:
                groups[name] = g
    if mine is None:
        return None
    return Mesh(shape=dict(zip(axis_names, shape)), axis_names=axis_names,
                coords=dict(zip(axis_names, mine)), groups=groups, world=world,
                device=rank_device(device))


def spans_processes(mesh: Optional[Mesh]) -> bool:
    """True when the mesh has more than one rank."""
    return mesh is not None and mesh.size > 1


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: str = "samples") -> torch.Tensor:
    """This rank's rows of a (B, ...) batch that every rank holds whole
    (probes are counter-keyed, so every rank makes the identical batch)."""
    return shard_global_batch(x, mesh, axis)


def replicate(tree, mesh: Mesh):
    """Rank 0's ``tree`` (a hierarchy, a deflation basis; anything
    ``torch.save`` takes) on every rank of the mesh, on the rank's device.
    The other ranks' argument is ignored, so they may pass None: setup
    artifacts are built once and every rank holds bit-identical copies."""
    return broadcast_object(tree, mesh.world, mesh.device)
