"""Aggregation multigrid setup: prolongator blocks, the backend dispatch,
the device backend and the quality checks (counterpart of
deflatedmlmc_schwinger_tpu/mg/setup.py).

``setup_backend='host'`` builds the hierarchy in numpy/scipy
(mg/host_setup.py). ``setup_backend='device'`` runs the heavy phases on the
operator's device: the test vectors of every level come from the
device-resident CheFSI (solvers/eigs.py), and each Galerkin coarse operator
C = P^H A P is computed there as a stack of column stripes, its cyclic
block-stencil pattern detected from the (na, na) map of block norms, so only
that map and the nonzero blocks reach the host. The per-aggregate QR, the
m x m Ritz problems and the coarsest inverse stay on the host. The device
backend stores no smoother roots: MGSolver computes them at first use
(mg/cycle.py gmres_poly_roots).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deflatedmlmc_schwinger_tpu_torch.config import TraceConfig
from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import (
    BlockProlongator,
    BlockStencilOperator,
    DenseOperator,
    Hierarchy,
    MGLevel,
    pack_grouped,
)
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import gamma3
from deflatedmlmc_schwinger_tpu_torch.solvers.eigs import (
    _apply_cols,
    chebyshev_filtered_smallest,
    smallest_eigpairs_nonhermitian,
)


def p_blocks_host(tv: np.ndarray, L: int, phase_period: int) -> np.ndarray:
    """Host (na, L, 2k) complex prolongator blocks from test vectors tv
    (n, k): per-aggregate spin-phase column split + batched QR."""
    n, k = tv.shape
    if n % L:
        raise ValueError(f"lattice size {n} not divisible by aggregate size {L}")
    na = n // L
    T = tv.reshape(na, L, k)
    pos = np.arange(L)
    g0 = np.where((pos % phase_period) < (phase_period // 2))[0]
    g1 = np.where((pos % phase_period) >= (phase_period // 2))[0]
    blocks = np.zeros((na, L, 2 * k), dtype=np.complex128)
    for idx, off in ((g0, 0), (g1, k)):
        Q, R = np.linalg.qr(T[:, idx, :])
        d = np.diagonal(R, axis1=-2, axis2=-1)
        phase = np.where(np.abs(d) > 0, d / np.maximum(np.abs(d), 1e-300), 1.0)
        Q = Q * np.conj(phase)[:, None, :]
        blocks[:, idx[:, None], off + np.arange(k)[None, :]] = Q
    return blocks


def build_P_blocks(tv: np.ndarray, L: int, phase_period: int, dtype: torch.dtype,
                   device) -> BlockProlongator:
    """The block prolongator on ``device`` from host test vectors tv (n, k)."""
    blocks = p_blocks_host(tv, L, phase_period)
    return BlockProlongator(
        blocks=torch.from_numpy(blocks).to(device=device, dtype=dtype))


def _galerkin_stripe(op, P: BlockProlongator, c: int) -> torch.Tensor:
    """One within-aggregate column group of C = P^H A P: the basis vectors
    {P e_(j,c)}_j have disjoint supports, so one (na, n) batch matvec gives a
    whole column stripe. Returns RY (na, nc) with
    RY[j_col, j_row*dc + c_row] = C[j_row*dc + c_row, j_col*dc + c]."""
    na, L, dc = P.blocks.shape
    X = torch.zeros((na, na, L), dtype=P.blocks.dtype, device=P.blocks.device)
    ar = torch.arange(na, device=P.blocks.device)
    X[ar, ar] = P.blocks[:, :, c]           # row j: column c of aggregate j
    return P.apply_adjoint(op.matvec(X.reshape(na, na * L)))


def _galerkin_stack(op, P: BlockProlongator) -> torch.Tensor:
    """The stack S (dc, na, nc) of all column stripes of C = P^H A P, one
    stripe batch at a time (a stripe batch is (na, n): 1 GB at 256^2 with
    64-site aggregates in complex64)."""
    dc = P.blocks.shape[2]
    return torch.stack([_galerkin_stripe(op, P, c) for c in range(dc)])


def _block_norms(S: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of each (dc, dc) block of C from the stripe stack:
    norms[j_row, j_col]."""
    dc, na, _ = S.shape
    T = S.reshape(dc, na, na, dc)            # [c_col, j_col, j_row, c_row]
    return torch.sqrt((T.real ** 2 + T.imag ** 2).sum(dim=(0, 3))).T


def _gather_blocks(S: torch.Tensor, offsets) -> torch.Tensor:
    """blocks[j, k] = the block (j, (j + offsets[k]) % na) of C from the
    stripe stack: (na, K, dc, dc), the payload of a BlockStencilOperator."""
    dc, na, _ = S.shape
    Tp = S.reshape(dc, na, na, dc).permute(1, 2, 3, 0)   # [j_col, j_row, c_row, c_col]
    rows = torch.arange(na, device=S.device)
    return torch.stack([Tp[(rows + off) % na, rows] for off in offsets], dim=1)


def _dense_from_stack(S: torch.Tensor) -> np.ndarray:
    """Host complex (nc, nc) coarse matrix from the stripe stack."""
    dc, na, nc = S.shape
    T = S.cpu().numpy().reshape(dc, na, na, dc)          # [c_col, j_col, j_row, c_row]
    return T.transpose(2, 3, 1, 0).reshape(nc, nc)


def galerkin_coarse(op, P: BlockProlongator) -> np.ndarray:
    """Host complex coarse operator C = P^H A P, pulled densely (the
    coarsest level, and any level whose coupling is not small-cyclic)."""
    return _dense_from_stack(_galerkin_stack(op, P))


def galerkin_block_stencil(op, P: BlockProlongator,
                           max_offsets: int = 48) -> Optional[BlockStencilOperator]:
    """C = P^H A P directly as a cyclic block stencil, computed and its
    sparsity detected on the device: blocks below 1e-12 of the largest block
    norm count as zero, and only the (na, na) norm map and the K nonzero
    block diagonals are read. None when more than ``max_offsets`` cyclic
    offsets couple."""
    S = _galerkin_stack(op, P)
    norms = _block_norms(S).cpu().numpy()
    na = norms.shape[0]
    j1, j2 = np.nonzero(norms > 1e-12 * max(float(norms.max()), 1e-30))
    offsets = tuple(sorted({int((b - a) % na) for a, b in zip(j1, j2)}))
    if len(offsets) > max_offsets:
        return None
    return pack_grouped(BlockStencilOperator(blocks=_gather_blocks(S, offsets),
                                             offsets=offsets))


def _test_vectors(op, k: int, cfg: TraceConfig, seed: int, tol: float, device,
                  V0: Optional[np.ndarray] = None) -> np.ndarray:
    """Near-kernel test vectors of a level operator on the device (modes
    'EVs' | 'LSVs' | 'RSVs'), as a host (n, k) array. ``V0`` warm-starts the
    subspace: the restricted test vectors of the finer level approximate the
    near-kernel of its Galerkin coarse operator, and fewer rounds
    (``subspace_iters_coarse``) are run from them."""
    mode = cfg.test_vectors_type

    def mvQ(v: torch.Tensor) -> torch.Tensor:
        return gamma3(op.matvec(v))

    rounds = cfg.subspace_iters
    if V0 is not None:
        rounds = (cfg.subspace_iters_coarse if cfg.subspace_iters_coarse is not None
                  else max(2, cfg.subspace_iters // 2))
    if mode in ("RSVs", "LSVs"):
        V = chebyshev_filtered_smallest(
            mvQ, op.n, k, dtype=op.dtype, device=device, seed=seed,
            degree=cfg.chebyshev_degree, rounds=rounds, tol=tol, V0=V0).vectors
        if mode == "LSVs":
            half = V.shape[0] // 2
            V = np.concatenate([V[:half], -V[half:]], axis=0)
        return V
    if mode == "EVs":
        _, V = smallest_eigpairs_nonhermitian(
            op.matvec, mvQ, op.n, k, dtype=op.dtype, device=device, seed=seed,
            degree=cfg.chebyshev_degree, rounds=rounds, V0=V0)
        return V
    raise ValueError(f"unknown test_vectors_type {mode!r}")


def _setup_hierarchy_device(op0, cfg: TraceConfig) -> Hierarchy:
    """The device backend: level by level, test vectors on the device, the
    per-aggregate QR on the host, the Galerkin product on the device."""
    device, dtype = op0.device, op0.dtype
    dof = list(cfg.dof)
    aggrs = list(cfg.aggrs)
    max_levels = int(cfg.max_nr_levels)
    if dof[0] != 2:
        raise ValueError("dof[0] must be 2 (spin components)")
    if cfg.accuracy_mg_eigvs not in ("low", "high"):
        raise ValueError(
            f"accuracy_mg_eigvs must be 'low' or 'high', got {cfg.accuracy_mg_eigvs!r}")
    eig_tol = 1.0e-3 if cfg.accuracy_mg_eigvs == "low" else 1.0e-9

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    levels: List[MGLevel] = []
    cur_op = op0
    perm_shift = 2 * cfg.nt * cfg.x_displacement if cfg.use_permuted else 0
    tv_warm: Optional[np.ndarray] = None
    coarsest_dense = None
    for i in range(max_levels - 1):
        L = aggrs[i] * dof[i]
        phase_period = dof[i] if i == 0 else dof[i] // 2
        k = dof[i + 1] // 2
        tv = _test_vectors(cur_op, k, cfg, cfg.seed + 977 * i, eig_tol, device,
                           V0=tv_warm)
        P = build_P_blocks(tv, L, phase_period, dtype, device)
        levels.append(MGLevel(op=cur_op, P=P, perm_shift=perm_shift))
        # tv lies in range(P), so R tv approximates the coarse near-kernel
        tv_warm = _apply_cols(P.apply_adjoint, tv, dtype, device)
        perm_shift = (perm_shift // L) * dof[i + 1] if cfg.use_permuted else 0
        is_coarsest = i + 1 == max_levels - 1
        prev_op, cur_op = cur_op, None
        if not is_coarsest and cfg.coarse_format == "auto":
            cur_op = galerkin_block_stencil(prev_op, P)
        if cur_op is None:
            coarsest_dense = galerkin_coarse(prev_op, P)
            cur_op = DenseOperator(mat=up(coarsest_dense))
    levels.append(MGLevel(op=cur_op, P=None, perm_shift=perm_shift))
    return Hierarchy(levels=levels, coarsest_inv=up(np.linalg.inv(coarsest_dense)))


def setup_hierarchy(op0, cfg: TraceConfig) -> Hierarchy:
    """Build the multigrid hierarchy for the fine StencilOperator ``op0``;
    its tensors land on op0's device in op0's dtype. ``cfg.setup_backend``
    chooses the host or the device backend; both run the quality checks
    when ``cfg.check_quality_MG`` asks for them."""
    if cfg.setup_backend == "host":
        from deflatedmlmc_schwinger_tpu_torch.mg.host_setup import setup_hierarchy_host

        hier = setup_hierarchy_host(op0, cfg)
    elif cfg.setup_backend == "device":
        hier = _setup_hierarchy_device(op0, cfg)
    else:
        raise ValueError(
            f"setup_backend must be 'host' or 'device', got {cfg.setup_backend!r}")
    if cfg.check_quality_MG:
        for name, val in check_quality(hier).items():
            print(f"\t{name} = {val:.3e}")
    return hier


def g3_compatibility(P: np.ndarray, na: int) -> float:
    """||gamma3 P - P gamma3_c||_F for a dense (n_f, n_c) prolongator of
    ``na`` aggregates: gamma3 is +1 on the first spin half of the fine
    indices and -1 on the second, gamma3_c the sign of each aggregate
    (+1 for the first na/2 in the aggregate-major coarse layout) repeated
    over its n_c/na columns. 0 when no aggregate straddles the spin halves
    and every aggregate keeps its position."""
    nf, nc = P.shape
    s_f = np.where(np.arange(nf) < nf // 2, 1.0, -1.0)
    s_c = np.repeat(np.where(np.arange(na) < na // 2, 1.0, -1.0), nc // na)
    return float(np.linalg.norm(s_f[:, None] * P - P * s_c[None, :]))


def check_quality(hier: Hierarchy) -> Dict[str, float]:
    """The reference's invariant checks: orthonormality ||RP - I||_F,
    gamma3-compatibility of P (``g3_compatibility``; the JAX package's
    check subtracts the sign from itself and always reads 0), Hermiticity
    of A_{l+1} and gamma3 A_{l+1}."""
    out: Dict[str, float] = {}
    for i, lev in enumerate(list(hier.levels)[:-1]):
        b = lev.P.blocks.detach().cpu().numpy()
        na, L, dc = b.shape
        gram = np.einsum("alk,alm->akm", np.conj(b), b)
        out[f"orthonormality of P at level {i}"] = float(
            np.sqrt(np.sum(np.abs(gram - np.eye(dc)[None]) ** 2)))
        out[f"g3-compatibility at level {i}"] = g3_compatibility(lev.P.to_dense(), na)
        Ac = hier.levels[i + 1].op.complex_matrix()
        out[f"hermiticity of A at level {i+1}"] = float(np.linalg.norm(Ac - Ac.conj().T))
        half = Ac.shape[0] // 2
        g3Ac = np.concatenate([Ac[:half], -Ac[half:]], axis=0)
        out[f"hermiticity of g3*A at level {i+1}"] = float(
            np.linalg.norm(g3Ac - g3Ac.conj().T))
    return out
