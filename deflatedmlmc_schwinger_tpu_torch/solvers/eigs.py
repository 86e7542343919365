"""Eigensolvers for the setup phase (subset of
deflatedmlmc_schwinger_tpu/solvers/eigs.py).

Smallest-|lambda| eigenpairs of the Hermitian Q = gamma3 D come from
Chebyshev-filtered subspace iteration (CheFSI) on Q^2 with harmonic Ritz
extraction. The (m, n) subspace, the filter, the Gram and projection
products and the recombination run as tensors on the operator's device;
only the m x m solves run on the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import scipy.linalg as sla
import torch

from deflatedmlmc_schwinger_tpu_torch.config import real_dtype


class EigResult(NamedTuple):
    values: np.ndarray    # (k,) real
    vectors: np.ndarray   # (n, k) complex (host)
    resnorms: np.ndarray  # (k,) ||H v - theta v||_2


def _orth(V: np.ndarray) -> np.ndarray:
    Q, R = np.linalg.qr(V)
    d = np.diagonal(R)
    phase = np.where(np.abs(d) > 0, d / np.maximum(np.abs(d), 1e-300), 1.0)
    return Q * np.conj(phase)[None, :]


def _harmonic_small_solve(A: np.ndarray, B: np.ndarray, eps: float):
    """Host m x m harmonic-Ritz solve: eigenpairs of the pencil
    (A = U^H W, B = U^H U) ordered by |mu| ascending (theta ~ 1/mu nearest
    0). Returns the (m, m) recombination matrix Y, ordered."""
    m = A.shape[0]
    A = 0.5 * (A + A.conj().T)
    B = 0.5 * (B + B.conj().T)
    scale = float(np.real(np.trace(B))) / m
    L = np.linalg.cholesky(B + (eps * scale) * np.eye(m))
    M = sla.solve_triangular(L, A, lower=True)
    M = sla.solve_triangular(L, M.conj().T, lower=True).conj().T
    M = 0.5 * (M + M.conj().T)
    mu, Z = np.linalg.eigh(M)
    Y = sla.solve_triangular(L.conj().T, Z, lower=False)
    with np.errstate(divide="ignore"):
        order = np.argsort(np.where(np.abs(mu) > 0, 1.0 / np.abs(mu), np.inf))
    return Y[:, order]


def _row_norms(X: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((X.real ** 2 + X.imag ** 2).sum(-1))


def power_bound(matvec: Callable, n: int, dtype: torch.dtype, device,
                seed: int = 17, iters: int = 25) -> float:
    """Upper estimate of the largest |eigenvalue| of a Hermitian operator
    acting on (..., n) complex tensors."""
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.standard_normal(n)).to(device=device, dtype=dtype)
    lam = torch.zeros((), dtype=real_dtype(dtype), device=device)
    for _ in range(iters):
        w = matvec(p)
        lam = _row_norms(w)
        p = w * (1.0 / torch.clamp(lam, min=1e-30))
    return float(lam) * 1.05


def chebyshev_filtered_smallest(
    matvec: Callable,
    n: int,
    k: int,
    *,
    dtype: torch.dtype,
    device,
    seed: int = 3,
    degree: int = 100,
    rounds: int = 8,
    tol: float = 0.0,
) -> EigResult:
    """Smallest-|lambda| eigenpairs of a Hermitian operator (``matvec`` on
    (m, n) row batches) via CheFSI on H^2 + harmonic Ritz, the subspace
    resident on ``device``; stops early once the k residuals are below
    ``tol`` (0: run every round)."""
    m = min(max(k + 2, int(round(1.5 * k))), n)
    lam_max = power_bound(matvec, n, dtype, device, seed=seed + 17)
    rng = np.random.default_rng(seed)
    V = _orth(rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m)))

    def up(M: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(M)).to(device=device, dtype=dtype)

    def down(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy().astype(np.complex128)

    rdt = np.finfo(np.float64 if dtype == torch.complex128 else np.float32)
    eps = 1e3 * rdt.eps
    b = lam_max * lam_max
    cut = lam_max * 1.0e-2
    Vd = up(V.T)                                     # device (m, n) rows
    theta = res = None
    for _ in range(rounds):
        a = max(cut * cut, b * 1.0e-12)
        Vd = _chebyshev_filter(matvec, Vd, a, b, int(degree))
        G = down(Vd.conj() @ Vd.T)                   # <v_i, v_j>, m x m down
        Gs = 0.5 * (G + G.conj().T)
        scale = float(np.real(np.trace(Gs))) / m
        L = np.linalg.cholesky(Gs + (eps * scale) * np.eye(m))
        T = sla.solve_triangular(L.conj().T, np.eye(m), lower=False)  # L^{-H}
        W = up(T).T @ Vd                             # rows of V_cols @ T
        U = matvec(W)
        Y = _harmonic_small_solve(down(U.conj() @ W.T), down(U.conj() @ U.T), eps)
        Yd = up(Y).T
        X = Yd @ W
        HX = Yd @ U
        inv_nrm = 1.0 / torch.clamp(_row_norms(X), min=1e-30)
        X = X * inv_nrm[:, None]
        HX = HX * inv_nrm[:, None]
        theta_d = (X.conj() * HX).sum(-1).real
        res_d = _row_norms(HX - theta_d[:, None] * X)
        Vd = X
        theta = theta_d.double().cpu().numpy()
        res = res_d.double().cpu().numpy()
        theta_abs = np.sort(np.abs(theta))
        new_cut = float(theta_abs[min(k, m - 1)])
        if new_cut > 0:
            cut = min(max(new_cut, 1e-8 * lam_max), 0.5 * lam_max)
        if tol > 0 and float(np.max(res[:k])) < tol:
            break
    X = down(Vd).T
    return EigResult(theta[:k], X[:, :k], res[:k])


def _chebyshev_filter(matvec: Callable, V: torch.Tensor, a: float, b: float,
                      deg: int) -> torch.Tensor:
    """Degree-``deg`` Chebyshev filter in t = lambda^2 mapped to [a, b],
    with a per-row rescale of both carries each step (the recurrence is
    linear and row-independent; unscaled it overflows float32)."""
    c0 = (a + b) / (b - a)
    c1 = 2.0 / (b - a)

    def y(X: torch.Tensor) -> torch.Tensor:
        return c1 * matvec(matvec(X)) - c0 * X

    T0, T1 = V, y(V)
    for _ in range(deg - 1):
        Tp = 2.0 * y(T1) - T0
        s = (1.0 / torch.clamp(_row_norms(Tp), min=1e-30))[:, None]
        T0, T1 = T1 * s, Tp * s
    return T1 * (1.0 / torch.clamp(_row_norms(T1), min=1e-30))[:, None]
