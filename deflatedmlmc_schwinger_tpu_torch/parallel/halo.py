"""Halo-exchange stencil matvec over the lattice-sharded mesh axis
(counterpart of deflatedmlmc_schwinger_tpu/parallel/halo.py).

Each rank of the 'x' axis holds X/k rows of the lattice: the (2, 2, 5, X/k, T)
coefficients and (B, 2, X/k, T) blocks of the vectors. An application of D
sends exactly one boundary row per direction to the ring neighbours and
receives theirs; taps reach +-1 in x, and t stays whole on every rank.

Before a call a rank holds its block of v; after it, its block of D v.

On a CUDA device the local apply is kernel K1 on the block padded with the
two received rows, (B, 2, X/k + 2, T), against coefficients padded once with
two rows of zeros: K1's periodic wrap in x then only touches the two pad
rows of the output, which are dropped. The same padding gives b - D x
through kernel K2. On the CPU the plain version below runs, the JAX
package's ``_halo_kernel`` tap for tap. One shard wraps locally.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels
from deflatedmlmc_schwinger_tpu_torch.ops.stencil_kernels import TAPS
from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import (
    Group,
    all_gather_cat,
    ring_exchange,
)


@dataclasses.dataclass(frozen=True)
class ShardedStencil:
    """This rank's X-range of a stencil operator."""

    coeffs: torch.Tensor            # (2, 2, 5, X/k, T)
    padded: Optional[torch.Tensor]  # (2, 2, 5, X/k + 2, T) on a CUDA device
    nx: int                         # the whole lattice's X
    nt: int
    group: Optional[Group]          # the ring of x shards (None: one shard)

    @property
    def nshards(self) -> int:
        return 1 if self.group is None else self.group.size

    @property
    def nx_local(self) -> int:
        return self.nx // self.nshards

    @property
    def x0(self) -> int:
        return 0 if self.group is None else self.group.index * self.nx_local


def shard_coeffs(op, mesh, x_axis: str = "x") -> ShardedStencil:
    """This rank's X-range of the (2, 2, 5, X, T) coefficients of the stencil
    operator ``op``, which every rank holds whole."""
    group = mesh.groups.get(x_axis) if x_axis in mesh.axis_names else None
    nshards = 1 if group is None else group.size
    if op.nx % nshards:
        raise ValueError(f"nx={op.nx} not divisible by {nshards} x-shards")
    xl = op.nx // nshards
    x0 = 0 if group is None else group.index * xl
    local = op.coeffs[:, :, :, x0:x0 + xl].contiguous()
    padded = None
    if local.is_cuda:
        padded = torch.nn.functional.pad(local, (0, 0, 1, 1)).contiguous()
    return ShardedStencil(local, padded, op.nx, op.nt,
                          group if nshards > 1 else None)


def halo_rows(sh: ShardedStencil, v: torch.Tensor):
    """(the previous shard's last row, the next shard's first row) for this
    rank's block v (B, 2, X/k, T): one ring exchange."""
    first, last = v[:, :, :1], v[:, :, -1:]
    if sh.group is None:
        return last, first
    nxt, prv = ring_exchange(first, last, sh.group)
    return prv, nxt


def _halo_kernel(coeffs: torch.Tensor, v: torch.Tensor, prv: torch.Tensor,
                 nxt: torch.Tensor) -> torch.Tensor:
    """The plain local apply: v (B, 2, X/k, T) with the neighbours' boundary
    rows prv and nxt (B, 2, 1, T)."""
    up = torch.cat([v[:, :, 1:], nxt], dim=2)        # v[x+1]
    down = torch.cat([prv, v[:, :, :-1]], dim=2)     # v[x-1]
    out = torch.zeros_like(v)
    for k, (dx, dt) in enumerate(TAPS):
        s = up if dx == 1 else down if dx == -1 else v
        if dt:
            s = torch.roll(s, shifts=-dt, dims=-1)
        for a in range(2):
            for b in range(2):
                if a != b and k == 0:
                    continue  # the cross-spin on-site term is structurally zero
                out[:, a] += coeffs[a, b, k] * s[:, b]
    return out


def _padded(v: torch.Tensor, prv: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    return torch.cat([prv, v, nxt], dim=2).reshape(v.shape[0], -1)


def halo_apply(sh: ShardedStencil, v: torch.Tensor) -> torch.Tensor:
    """This rank's block of D v from its block of v (B, 2, X/k, T)."""
    prv, nxt = halo_rows(sh, v)
    if not v.is_cuda:
        return _halo_kernel(sh.coeffs, v, prv, nxt)
    xp = sh.nx_local + 2
    y = stencil_kernels.stencil_matvec(sh.padded, _padded(v, prv, nxt), xp, sh.nt)
    return y.reshape(v.shape[0], 2, xp, sh.nt)[:, :, 1:-1]


def halo_residual(sh: ShardedStencil, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of b - D x; kernel K2 on a CUDA device."""
    prv, nxt = halo_rows(sh, x)
    if not x.is_cuda:
        return b - _halo_kernel(sh.coeffs, x, prv, nxt)
    xp = sh.nx_local + 2
    bp = torch.nn.functional.pad(b, (0, 0, 1, 1)).reshape(b.shape[0], -1)
    r = stencil_kernels.stencil_residual(sh.padded, bp, _padded(x, prv, nxt), xp, sh.nt)
    return r.reshape(b.shape[0], 2, xp, sh.nt)[:, :, 1:-1]


def local_block(v: torch.Tensor, mesh, nx: int, nt: int, *, x_axis: str = "x",
                sample_axis: str = "samples") -> torch.Tensor:
    """This rank's (B/s, 2, X/k, T) block of a (B, 2*X*T) batch that every
    rank holds whole: its sample rows and its X-range."""
    B = v.shape[0]
    g = v.reshape(B, 2, nx, nt)
    for axis, dim in ((sample_axis, 0), (x_axis, 2)):
        if axis in mesh.axis_names:
            n = mesh.shape[axis]
            if g.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(g.shape)} not divisible by the "
                                 f"{n} shards of mesh axis '{axis}'")
            w = g.shape[dim] // n
            g = g.narrow(dim, mesh.coords[axis] * w, w)
    return g


def gather_blocks(y: torch.Tensor, mesh, *, x_axis: str = "x",
                  sample_axis: str = "samples") -> torch.Tensor:
    """The whole (B, 2*X*T) batch on every rank from the ranks' blocks."""
    if x_axis in mesh.axis_names:
        y = all_gather_cat(y, mesh.groups[x_axis], dim=2)
    if sample_axis in mesh.axis_names:
        y = all_gather_cat(y, mesh.groups[sample_axis], dim=0)
    return y.reshape(y.shape[0], -1)


def halo_matvec(sh: ShardedStencil, mesh, *, x_axis: str = "x",
                sample_axis: str = "samples") -> Callable[[torch.Tensor], torch.Tensor]:
    """The matvec over blocks (B/s, 2, X/k, T) of a batch with B split over
    ``sample_axis`` and X over ``x_axis``: f(this rank's block of v) -> its
    block of D v. ``sh`` comes from ``shard_coeffs`` on the same mesh. Each
    apply exchanges two boundary rows per rank over the ring."""
    nshards = mesh.shape[x_axis] if x_axis in mesh.axis_names else 1
    if nshards != sh.nshards:
        raise ValueError(f"coefficients cut for {sh.nshards} x-shards, mesh has {nshards}")

    def matvec(v: torch.Tensor) -> torch.Tensor:
        return halo_apply(sh, v)

    return matvec
