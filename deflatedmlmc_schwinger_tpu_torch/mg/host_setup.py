"""Host-side (numpy/scipy) MG hierarchy setup (counterpart of
deflatedmlmc_schwinger_tpu/mg/host_setup.py).

CheFSI + harmonic Ritz near-kernel test vectors, spin-split per-aggregate QR
block prolongators, sparse Galerkin coarse operators with cyclic
block-stencil detection, a dense coarsest inverse, per-level displacement
shifts and the GMRES-polynomial smoother roots. All host math is complex128;
the finished tensors are uploaded once, in the fine operator's dtype, to its
device. For n >= 2^17 with RSV/LSV test vectors the fine-level eigensolve
runs the device-resident CheFSI (solvers/eigs.py) through kernel K1.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from deflatedmlmc_schwinger_tpu_torch.config import TraceConfig
from deflatedmlmc_schwinger_tpu_torch.io.stencil import csr_from_stencil
from deflatedmlmc_schwinger_tpu_torch.mg.cycle import arnoldi_leja_roots
from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import (
    BlockProlongator,
    BlockStencilOperator,
    DenseOperator,
    Hierarchy,
    MGLevel,
    pack_grouped,
)
from deflatedmlmc_schwinger_tpu_torch.mg.setup import _test_vectors, p_blocks_host
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import StencilOperator
from deflatedmlmc_schwinger_tpu_torch.solvers.eigs import _harmonic_small_solve, _orth


def _gamma3_rows(W: np.ndarray) -> np.ndarray:
    """gamma3 @ W: negate the lower spin half of the rows."""
    half = W.shape[0] // 2
    out = W.copy()
    out[half:] = -out[half:]
    return out


def _power_bound_host(qmul: Callable, n: int, seed: int, iters: int = 25) -> float:
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 1))
    lam = 0.0
    for _ in range(iters):
        w = qmul(v)
        lam = float(np.linalg.norm(w))
        v = w / max(lam, 1e-300)
    return lam * 1.05


def chefsi_host(
    qmul: Callable,
    n: int,
    k: int,
    *,
    seed: int,
    degree: int,
    rounds: int,
    tol: float = 0.0,
    V0: Optional[np.ndarray] = None,
    buffer: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Smallest-|lambda| eigenpairs of a Hermitian operator (column matvec
    ``qmul``: (n, m) -> (n, m)) via CheFSI on H^2 + harmonic Ritz.
    Returns (values[k], vectors (n, k), resnorms[k])."""
    m = buffer if buffer is not None else max(k + 2, int(round(1.5 * k)))
    m = min(m, n)
    lam_max = _power_bound_host(qmul, n, seed + 17)
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    if V0 is not None:
        m0 = min(V0.shape[1], m)
        V[:, :m0] = V0[:, :m0]
    V = _orth(V)
    eps = 1e3 * np.finfo(np.float64).eps
    b = lam_max * lam_max
    cut = lam_max * 1.0e-2
    theta = res = None
    for _ in range(rounds):
        a = max(cut * cut, b * 1.0e-12)
        c0 = (a + b) / (b - a)
        c1 = 2.0 / (b - a)

        def y(X):
            return c1 * qmul(qmul(X)) - c0 * X

        T0, T1 = V, y(V)
        for _ in range(degree - 1):
            Tp = 2.0 * y(T1) - T0
            s = 1.0 / np.maximum(np.linalg.norm(Tp, axis=0, keepdims=True), 1e-300)
            T0, T1 = T1 * s, Tp * s
        V = T1 / np.maximum(np.linalg.norm(T1, axis=0, keepdims=True), 1e-300)
        W = _orth(V)
        U = qmul(W)
        Y = _harmonic_small_solve(U.conj().T @ W, U.conj().T @ U, eps)
        X = W @ Y
        HX = U @ Y
        nrm = np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-300)
        X, HX = X / nrm, HX / nrm
        theta = np.real(np.sum(np.conj(X) * HX, axis=0))
        res = np.linalg.norm(HX - X * theta[None, :], axis=0)
        V = X
        theta_abs = np.sort(np.abs(theta))
        new_cut = float(theta_abs[min(k, m - 1)])
        if new_cut > 0:
            cut = min(max(new_cut, 1e-8 * lam_max), 0.5 * lam_max)
        if tol > 0 and float(np.max(res[:k])) < tol:
            break
    return theta[:k], V[:, :k], res[:k]


def _test_vectors_host(A: sp.csr_matrix, k: int, cfg: TraceConfig, seed: int,
                       tol: float, rounds: int,
                       V0: Optional[np.ndarray] = None) -> np.ndarray:
    """Near-kernel test vectors (modes 'EVs' | 'LSVs' | 'RSVs') from the host
    CSR level operator."""
    mode = cfg.test_vectors_type
    n = A.shape[0]
    qmul = lambda W: _gamma3_rows(A @ W)  # noqa: E731
    if mode in ("RSVs", "LSVs"):
        _, V, _ = chefsi_host(qmul, n, k, seed=seed, degree=cfg.chebyshev_degree,
                              rounds=rounds, tol=tol, V0=V0)
        return _gamma3_rows(V) if mode == "LSVs" else V
    if mode == "EVs":
        m = max(k + 2, 2 * k)
        _, Vs, _ = chefsi_host(qmul, n, m, seed=seed, degree=cfg.chebyshev_degree,
                               rounds=rounds, V0=V0,
                               buffer=max(m + 2, int(round(1.25 * m))))
        W = _orth(Vs)
        theta, Y = np.linalg.eig(W.conj().T @ (A @ W))
        order = np.argsort(np.abs(theta))[:k]
        return W @ Y[:, order]
    raise ValueError(f"unknown test_vectors_type {mode!r}")


def _bsr_from_blocks(blocks: np.ndarray) -> sp.csr_matrix:
    """Block-diagonal prolongator CSR from (na, L, dc) aggregate blocks."""
    na, L, dc = blocks.shape
    return sp.bsr_matrix(
        (blocks, np.arange(na), np.arange(na + 1)), shape=(na * L, na * dc)
    ).tocsr()


def _block_stencil_host(C: sp.csr_matrix, dc: int, up: Callable,
                        max_offsets: int = 48) -> Optional[BlockStencilOperator]:
    """Detect the cyclic block-offset coupling of a Galerkin coarse matrix
    and pack it as a BlockStencilOperator (None if the pattern is not
    small-cyclic)."""
    n = C.shape[0]
    if n % dc:
        return None
    nac = n // dc
    coo = C.tocoo()
    mags = np.abs(coo.data)
    scale = float(mags.max()) if mags.size else 0.0
    keep = mags > 1e-12 * max(scale, 1e-30)
    row, col, dat = coo.row[keep], coo.col[keep], coo.data[keep]
    j1, j2 = row // dc, col // dc
    offs = (j2 - j1) % nac
    offsets = np.unique(offs)
    if len(offsets) > max_offsets:
        return None
    kidx = np.searchsorted(offsets, offs)
    blocks = np.zeros((nac, len(offsets), dc, dc), dtype=np.complex128)
    blocks[j1, kidx, row % dc, col % dc] = dat
    return pack_grouped(
        BlockStencilOperator(blocks=up(blocks), offsets=tuple(int(o) for o in offsets)),
        host_blocks=blocks,
    )


def _poly_roots_host(A: sp.csr_matrix, m: int, seed: int = 29) -> Tuple[complex, ...]:
    """Leja-ordered roots of the m-step GMRES residual polynomial of the
    host level operator (mg/cycle.py arnoldi_leja_roots)."""
    return tuple(complex(t) for t in
                 arnoldi_leja_roots(lambda v: A @ v, A.shape[0], m, seed))


def setup_hierarchy_host(op0: StencilOperator, cfg: TraceConfig) -> Hierarchy:
    """Build the multigrid hierarchy on the host and upload it once; level 0
    is ``op0`` itself."""
    if not isinstance(op0, StencilOperator):
        raise TypeError(f"unsupported fine operator {type(op0)!r}")
    coeffs = op0.host_coeffs().astype(np.complex128)

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=op0.device,
                                                            dtype=op0.dtype)

    dof = list(cfg.dof)
    aggrs = list(cfg.aggrs)
    max_levels = int(cfg.max_nr_levels)
    if dof[0] != 2:
        raise ValueError("dof[0] must be 2 (spin components)")
    if cfg.accuracy_mg_eigvs not in ("low", "high"):
        raise ValueError(
            f"accuracy_mg_eigvs must be 'low' or 'high', got {cfg.accuracy_mg_eigvs!r}")
    if cfg.setup_fine_eigs not in ("auto", "host", "device"):
        raise ValueError(f"setup_fine_eigs must be 'auto'|'host'|'device', got "
                         f"{cfg.setup_fine_eigs!r}")
    eig_tol = 1.0e-3 if cfg.accuracy_mg_eigvs == "low" else 1.0e-9
    rounds_coarse = (cfg.subspace_iters_coarse
                     if cfg.subspace_iters_coarse is not None
                     else max(2, cfg.subspace_iters // 2))

    A = csr_from_stencil(coeffs)
    levels: List[MGLevel] = []
    roots: List[Tuple[complex, ...]] = []
    roots_extra: List[Tuple[complex, ...]] = []
    extra_depth = (cfg.defl_solver.smooth_iters
                   if (cfg.defl_solver is not None
                       and cfg.defl_solver.smooth_iters != cfg.solver.smooth_iters)
                   else None)
    perm_shift = 2 * cfg.nt * cfg.x_displacement if cfg.use_permuted else 0
    tv_warm: Optional[np.ndarray] = None
    dev_op = op0
    coarsest_dense = None
    # the device CheFSI pays off from n = 2^17 on (the JAX package's rule)
    fine_dev = cfg.setup_fine_eigs == "device" or (
        cfg.setup_fine_eigs == "auto"
        and op0.n >= 2 ** 17
        and cfg.test_vectors_type in ("RSVs", "LSVs")
    )

    for i in range(max_levels - 1):
        L = aggrs[i] * dof[i]
        phase_period = dof[i] if i == 0 else dof[i] // 2
        k = dof[i + 1] // 2
        if i == 0 and fine_dev:
            # the device backend's eigensolve (mg/setup.py): the (m, n)
            # subspace and the Chebyshev recurrence stay on op0's device
            # (kernel K1); only m x m projections and the final (n, k) block
            # come back
            if cfg.test_vectors_type not in ("RSVs", "LSVs"):
                raise ValueError("device fine eigensolve supports RSVs/LSVs, got "
                                 f"{cfg.test_vectors_type!r}")
            tv = _test_vectors(op0, k, cfg, cfg.seed + 977 * i, eig_tol, op0.device)
        else:
            tv = _test_vectors_host(
                A, k, cfg, cfg.seed + 977 * i, eig_tol,
                rounds=cfg.subspace_iters if tv_warm is None else rounds_coarse,
                V0=tv_warm,
            )
        blocks = p_blocks_host(tv, L, phase_period)
        P = BlockProlongator(blocks=up(blocks))
        roots.append(_poly_roots_host(A, cfg.solver.smooth_iters))
        if extra_depth is not None:
            roots_extra.append(_poly_roots_host(A, extra_depth))
        levels.append(MGLevel(op=dev_op, P=P, perm_shift=perm_shift))
        Pcsr = _bsr_from_blocks(blocks)
        tv_warm = np.asarray(Pcsr.conj().T @ tv)
        perm_shift = (perm_shift // L) * dof[i + 1] if cfg.use_permuted else 0
        A = (Pcsr.conj().T.tocsr() @ (A @ Pcsr)).tocsr()
        is_coarsest = i + 1 == max_levels - 1
        dev_op = None
        if not is_coarsest and cfg.coarse_format == "auto":
            dev_op = _block_stencil_host(A, dof[i + 1] * 2, up)
        if dev_op is None:
            coarsest_dense = A.toarray()
            dev_op = DenseOperator(mat=up(coarsest_dense))

    if coarsest_dense is None or coarsest_dense.shape[0] != A.shape[0]:
        coarsest_dense = A.toarray()
    levels.append(MGLevel(op=dev_op, P=None, perm_shift=perm_shift))
    return Hierarchy(
        levels=levels,
        coarsest_inv=up(np.linalg.inv(coarsest_dense)),
        poly_roots=tuple(roots),
        poly_roots_extra=tuple(roots_extra) if roots_extra else None,
    )
