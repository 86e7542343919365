"""Containers for the multigrid hierarchy (counterpart of
deflatedmlmc_schwinger_tpu/mg/hierarchy.py), as nn.Modules with buffers so
that ``hier.to(device)`` moves every level.

  * level 0: the 9-point StencilOperator (ops/dirac.py, kernel K1);
  * intermediate levels: BlockStencilOperator (cyclic block stencil, with
    the grouped-band packing of ``pack_grouped``);
  * the coarsest level: DenseOperator plus its precomputed dense inverse.

Prolongators are per-aggregate dense blocks (n_aggr, L, 2k), so P and
R = P^H are one batched einsum each. The coarse matvecs are plain
einsum/matmul calls; the JAX package leaves them to XLA too.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


class DenseOperator(nn.Module):
    """Dense coarse-level operator; matvec on row vectors: y = v @ A^T."""

    def __init__(self, mat: torch.Tensor):
        super().__init__()
        self.register_buffer("mat", mat)

    @property
    def n(self) -> int:
        return self.mat.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.mat.dtype

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return v @ self.mat.T

    def complex_matrix(self) -> np.ndarray:
        return self.mat.detach().cpu().numpy()


class BlockStencilOperator(nn.Module):
    """Coarse operator as a cyclic block stencil: blocks[j, k] is the
    (dc, dc) coupling of block-row j to block-column (j + offsets[k]) mod nac.

    ``gmat``/``gwin``: optional grouped-band packing (see pack_grouped)."""

    def __init__(self, blocks: torch.Tensor, offsets: Sequence[int],
                 gmat: Optional[torch.Tensor] = None,
                 gwin: Optional[torch.Tensor] = None, G: int = 0):
        super().__init__()
        self.register_buffer("blocks", blocks)
        self.register_buffer("gmat", gmat)
        self.register_buffer("gwin", gwin)
        nac = blocks.shape[0]
        idx = (torch.arange(nac)[None, :]
               + torch.as_tensor(list(offsets), dtype=torch.long)[:, None]) % nac
        self.register_buffer("gidx", idx.to(blocks.device))
        self.offsets = tuple(int(o) for o in offsets)
        self.G = int(G)

    @property
    def n(self) -> int:
        return self.blocks.shape[0] * self.blocks.shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        nac, K, dc, _ = self.blocks.shape
        batch = v.shape[:-1]
        xa = v.reshape(batch + (nac, dc))
        if self.gmat is not None:
            ngroups, nwin = self.gwin.shape
            xw = xa[..., self.gwin, :].reshape(batch + (ngroups, nwin * dc))
            out = torch.einsum("...gk,gkn->...gn", xw, self.gmat)
            return out.reshape(batch + (nac * dc,))
        xg = xa[..., self.gidx, :]                    # (..., K, nac, dc)
        out = torch.einsum("akij,...kaj->...ai", self.blocks, xg)
        return out.reshape(batch + (nac * dc,))

    def complex_matrix(self) -> np.ndarray:
        b = self.blocks.detach().cpu().numpy()
        nac, K, dc, _ = b.shape
        C = np.zeros((nac * dc, nac * dc), dtype=b.dtype)
        for j in range(nac):
            for k, off in enumerate(self.offsets):
                j2 = (j + off) % nac
                C[j * dc:(j + 1) * dc, j2 * dc:(j2 + 1) * dc] = b[j, k]
        return C


def pack_grouped(op: BlockStencilOperator, group: int = 8,
                 max_fill: float = 4.0,
                 host_blocks: Optional[np.ndarray] = None) -> BlockStencilOperator:
    """Pack a cyclic block stencil into grouped-band matrices: block rows
    are grouped ``group`` at a time, offsets are clustered on the cyclic
    index circle, and each group's band becomes one dense (nwin*dc, G*dc)
    matrix, so the matvec is one batched matmul. Returns ``op`` unchanged
    when packing does not pay (same rules as the JAX package)."""
    nac, K, dc, _ = op.blocks.shape
    G = int(group)
    if op.gmat is not None or nac % G or nac < 2 * G:
        return op
    offs = sorted(int(o) % nac for o in op.offsets)
    gaps = [(offs[(i + 1) % len(offs)] - offs[i]) % nac for i in range(len(offs))]
    splits = [i for i, g in enumerate(gaps) if g > G]
    if not splits:
        return op
    clusters = []
    start = (splits[-1] + 1) % len(offs)
    ordered = offs[start:] + offs[:start]
    cur = [ordered[0]]
    for o in ordered[1:]:
        if (o - cur[-1]) % nac > G:
            clusters.append(cur)
            cur = [o]
        else:
            cur.append(o)
    clusters.append(cur)
    rel = []
    for c in clusters:
        c0 = c[0]
        span = (c[-1] - c0) % nac + 1
        rel.extend(((c0 + j) % nac) for j in range(span + G - 1))
    nwin = len(rel)
    if nwin * dc > max_fill * K * dc or nwin >= nac:
        return op
    ngroups = nac // G
    rel_arr = np.asarray(rel)
    gwin = (np.arange(ngroups)[:, None] * G + rel_arr[None, :]) % nac
    wpos = {int(r): w for w, r in enumerate(rel_arr)}
    B = (np.asarray(host_blocks) if host_blocks is not None
         else op.blocks.detach().cpu().numpy())
    gmat = np.zeros((ngroups, nwin * dc, G * dc), dtype=B.dtype)
    for r in range(G):
        for k, off in enumerate(op.offsets):
            w = wpos[int((off + r) % nac)]
            blk = B[np.arange(ngroups) * G + r, k]          # (ngroups, dc, dc)
            gmat[:, w * dc:(w + 1) * dc, r * dc:(r + 1) * dc] = blk.transpose(0, 2, 1)
    return BlockStencilOperator(
        blocks=op.blocks,
        offsets=op.offsets,
        gmat=torch.from_numpy(gmat).to(device=op.blocks.device, dtype=op.blocks.dtype),
        gwin=torch.as_tensor(gwin, dtype=torch.long, device=op.blocks.device),
        G=G,
    )


def block_stencil_from_dense(C: np.ndarray, dc: int, dtype: torch.dtype,
                             max_offsets: int = 48,
                             device=None) -> Optional[BlockStencilOperator]:
    """The cyclic block stencil of a dense (n, n) coarse matrix with
    (dc, dc) blocks, packed by ``pack_grouped``, on ``device`` in ``dtype``;
    None when n is no multiple of dc or more than ``max_offsets`` cyclic
    block offsets couple (the matrix then stays a DenseOperator)."""
    n = C.shape[0]
    if n % dc:
        return None
    nac = n // dc
    Cb = C.reshape(nac, dc, nac, dc).transpose(0, 2, 1, 3)   # (nac, nac, dc, dc)
    norms = np.abs(Cb).reshape(nac, nac, -1).max(axis=-1)
    j1, j2 = np.nonzero(norms)
    offsets = sorted({int((b - a) % nac) for a, b in zip(j1, j2)})
    if len(offsets) > max_offsets:
        return None
    blocks = np.zeros((nac, len(offsets), dc, dc), dtype=C.dtype)
    rows = np.arange(nac)
    for k, off in enumerate(offsets):
        blocks[:, k] = Cb[rows, (rows + off) % nac]
    return pack_grouped(BlockStencilOperator(
        blocks=torch.from_numpy(blocks).to(device=device, dtype=dtype),
        offsets=offsets), host_blocks=blocks)


class BlockProlongator(nn.Module):
    """Aggregation prolongator as dense per-aggregate blocks (na, L, 2k);
    the coarse index layout is aggregate-major, j*(2k) + c."""

    def __init__(self, blocks: torch.Tensor):
        super().__init__()
        self.register_buffer("blocks", blocks)

    @property
    def n_fine(self) -> int:
        return self.blocks.shape[0] * self.blocks.shape[1]

    @property
    def n_coarse(self) -> int:
        return self.blocks.shape[0] * self.blocks.shape[2]

    def apply(self, y: torch.Tensor) -> torch.Tensor:
        """P @ y for flat coarse vectors y of shape (..., n_coarse)."""
        na, L, dc = self.blocks.shape
        ya = y.reshape(y.shape[:-1] + (na, dc))
        out = torch.einsum("alk,...ak->...al", self.blocks, ya)
        return out.reshape(y.shape[:-1] + (na * L,))

    def apply_adjoint(self, x: torch.Tensor) -> torch.Tensor:
        """R @ x = P^H @ x for flat fine vectors x of shape (..., n_fine)."""
        na, L, dc = self.blocks.shape
        xa = x.reshape(x.shape[:-1] + (na, L))
        out = torch.einsum("alk,...al->...ak", self.blocks.conj(), xa)
        return out.reshape(x.shape[:-1] + (na * dc,))

    def to_dense(self) -> np.ndarray:
        """P as a host complex (n_fine, n_coarse) matrix."""
        b = self.blocks.detach().cpu().numpy()
        na, L, dc = b.shape
        P = np.zeros((na * L, na * dc), dtype=b.dtype)
        for j in range(na):
            P[j * L:(j + 1) * L, j * dc:(j + 1) * dc] = b[j]
        return P


class MGLevel(nn.Module):
    """One level: its operator, the prolongator to the next coarser level
    (None on the coarsest) and the displacement shift of the permuted
    observable."""

    def __init__(self, op: nn.Module, P: Optional[BlockProlongator],
                 perm_shift: int = 0):
        super().__init__()
        self.op = op
        self.P = P
        self.perm_shift = int(perm_shift)

    @property
    def n(self) -> int:
        return self.op.n


class Hierarchy(nn.Module):
    """The level list, the dense coarsest inverse, and the precomputed
    GMRES-polynomial smoother roots per non-coarsest level (``poly_roots``
    for the sampling depth, ``poly_roots_extra`` for a second depth)."""

    def __init__(self, levels: Sequence[MGLevel], coarsest_inv: torch.Tensor,
                 poly_roots: Optional[Tuple[Tuple[complex, ...], ...]] = None,
                 poly_roots_extra: Optional[Tuple[Tuple[complex, ...], ...]] = None):
        super().__init__()
        self.levels = nn.ModuleList(levels)
        self.register_buffer("coarsest_inv", coarsest_inv)
        self.poly_roots = poly_roots
        self.poly_roots_extra = poly_roots_extra

    @property
    def nr_levels(self) -> int:
        return len(self.levels)

    def sizes(self) -> Tuple[int, ...]:
        return tuple(lev.n for lev in self.levels)
