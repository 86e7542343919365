"""Eigensolvers for the setup phases (counterpart of
deflatedmlmc_schwinger_tpu/solvers/eigs.py).

  * Smallest-|lambda| eigenpairs of the Hermitian Q = gamma3 D for MG test
    vectors: Chebyshev-filtered subspace iteration (CheFSI) on Q^2 with
    harmonic Ritz extraction; the (m, n) subspace stays on the operator's
    device and only the m x m solves run on the host.
  * The deflation basis of deflated Hutchinson:
    ``inverse_iteration_smallest_device``, inverse subspace iteration
    V <- Q^{-1} V through MG solves, with a harmonic-Ritz round after each
    solve, a final plain Rayleigh--Ritz on a whitened basis and ghost
    rejection. Here the m x m Cholesky, triangular solves and eigh run in
    ``torch.linalg`` on the operator's device, in the working dtype (as the
    JAX package's jitted round does): a round then reads one stacked
    (theta, res) pair on the host, and the (m, n) basis never leaves the
    device. The final whitening runs in complex128 (the JAX package does it
    in float64 numpy).
  * The MLMC difference-operator deflation: block power iteration with
    plain Rayleigh--Ritz (``subspace_iteration_largest``), on the host in
    numpy with the operator applied to column blocks on the device, as in
    the JAX package.
  * ``smallest_eigpairs_nonhermitian``: approximate smallest eigenpairs of
    the non-Hermitian D itself (the 'EVs' test vectors of the device setup
    backend): a CheFSI subspace of Q^2 = D^H D, then an oblique Ritz step.
  * ``harmonic_ritz_smallest`` and ``inverse_iteration_smallest``: the host
    forms of the harmonic-Ritz extraction and of inverse subspace iteration
    (the (n, m) basis crosses to the host every round).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

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


def _apply_cols(matvec: Callable, W: np.ndarray, dtype: torch.dtype,
                device) -> np.ndarray:
    """Apply an operator on (m, n) row batches to the columns of a host
    complex (n, m) matrix."""
    rows = torch.from_numpy(np.ascontiguousarray(W.T)).to(device=device, dtype=dtype)
    return matvec(rows).cpu().numpy().T


def harmonic_ritz_smallest(matvec: Callable, V: np.ndarray, k: int,
                           dtype: torch.dtype, device) -> EigResult:
    """Harmonic Rayleigh--Ritz on the host for the eigenvalues nearest 0 of
    a Hermitian operator, from the span of the columns of V (n, m)."""
    W = _orth(V)
    U = _apply_cols(matvec, W, dtype, device)
    eps = 1e3 * float(torch.finfo(real_dtype(dtype)).eps)
    # _harmonic_small_solve orders by |mu| ascending, i.e. theta ~ 1/mu
    # nearest 0 first
    X = W @ _harmonic_small_solve(U.conj().T @ W, U.conj().T @ U, eps)
    X = X / np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-300)
    HX = _apply_cols(matvec, X, dtype, device)
    theta = np.real(np.sum(np.conj(X) * HX, axis=0))[:k]
    X = X[:, :k]
    R = HX[:, :k] - X * theta[None, :]
    return EigResult(values=theta, vectors=X, resnorms=np.linalg.norm(R, axis=0))


def inverse_iteration_smallest(matvec: Callable, apply_inv: Callable, n: int,
                               k: int, *, dtype: torch.dtype, device,
                               seed: int = 5, rounds: int = 6,
                               buffer: Optional[int] = None, tol: float = 0.0,
                               V0: Optional[np.ndarray] = None) -> EigResult:
    """Smallest-|lambda| eigenpairs of a Hermitian H by inverse subspace
    iteration V <- H^{-1} V with the basis on the host (``apply_inv`` and
    ``matvec`` act on (m, n) rows on ``device``); harmonic Ritz after every
    round."""
    m = buffer if buffer is not None else max(k + 2, int(round(1.25 * k)))
    m = min(m, n)
    if V0 is not None:
        V = V0
        m = V.shape[1]
    else:
        rng = np.random.default_rng(seed)
        V = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    result = None
    for _ in range(rounds):
        V = _apply_cols(apply_inv, _orth(V), dtype, device)
        result = harmonic_ritz_smallest(matvec, V, m, dtype, device)
        V = result.vectors
        if tol > 0 and float(np.max(result.resnorms[:k])) < tol:
            break
    return EigResult(result.values[:k], result.vectors[:, :k], result.resnorms[:k])


def rayleigh_ritz_hermitian(matvec: Callable, V: np.ndarray, k: int,
                            dtype: torch.dtype, device,
                            which: str = "largest_abs") -> EigResult:
    """Plain Rayleigh--Ritz on the host (extremal eigenvalues, where it is
    ghost-free)."""
    W = _orth(V)
    HW = _apply_cols(matvec, W, dtype, device)
    M = W.conj().T @ HW
    M = 0.5 * (M + M.conj().T)
    theta, Y = np.linalg.eigh(M)
    if which == "largest_abs":
        order = np.argsort(-np.abs(theta))[:k]
    elif which == "smallest_abs":
        order = np.argsort(np.abs(theta))[:k]
    else:
        raise ValueError(which)
    theta = theta[order]
    X = W @ Y[:, order]
    R = _apply_cols(matvec, X, dtype, device) - X * theta[None, :]
    return EigResult(values=theta, vectors=X, resnorms=np.linalg.norm(R, axis=0))


def subspace_iteration_largest(matvec: Callable, n: int, k: int, *,
                               dtype: torch.dtype, device, seed: int = 11,
                               rounds: int = 10, buffer: Optional[int] = None,
                               tol: float = 0.0) -> EigResult:
    """Largest-|lambda| eigenpairs by block power iteration + Rayleigh--Ritz
    (the MLMC difference-operator deflation, which needs loose accuracy)."""
    m = buffer if buffer is not None else max(k + 2, int(round(1.25 * k)))
    m = min(m, n)
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    result = None
    for _ in range(rounds):
        V = _apply_cols(matvec, _orth(V), dtype, device)
        result = rayleigh_ritz_hermitian(matvec, V, m, dtype, device, "largest_abs")
        V = result.vectors
        if tol > 0 and float(np.max(result.resnorms[:k])) < tol:
            break
    return EigResult(result.values[:k], result.vectors[:, :k], result.resnorms[:k])


# ---- device-resident Ritz blocks: (m, n) row tensors -------------------------

def _gram(V: torch.Tensor) -> torch.Tensor:
    """G[i, j] = <v_i, v_j> of the rows of V."""
    return V.conj() @ V.T


def _project(matvec: Callable, V: torch.Tensor, T: torch.Tensor):
    """Basis change W_cols = V_cols @ T (rows: W = T^T V), U = H W, and the
    projections A = U^H W, B = U^H U."""
    W = T.T @ V
    U = matvec(W)
    return W, U, U.conj() @ W.T, U.conj() @ U.T


def _recombine(W: torch.Tensor, U: torch.Tensor, Y: torch.Tensor):
    """X_cols = W_cols @ Y and H X_cols = U_cols @ Y (no matvec), rows
    normalized; returns (X, HX, Rayleigh quotients, residual norms)."""
    X = Y.T @ W
    HX = Y.T @ U
    inv_nrm = (1.0 / torch.clamp(_row_norms(X), min=1e-30))[:, None]
    X = X * inv_nrm
    HX = HX * inv_nrm
    theta = (X.conj() * HX).sum(-1).real
    res = _row_norms(HX - theta[:, None] * X)
    return X, HX, theta, res


def _whitening(G: torch.Tensor, eps: float) -> torch.Tensor:
    """T = chol(G)^{-H} for the Gram matrix G = V V^H (regularized by eps
    times its mean diagonal): the rows of T^T V are orthonormal."""
    m = G.shape[0]
    eye = torch.eye(m, dtype=G.dtype, device=G.device)
    Gs = 0.5 * (G + G.mH)
    scale = Gs.diagonal().real.sum() / m
    L = torch.linalg.cholesky(Gs + (eps * scale) * eye)
    return torch.linalg.solve_triangular(L.mH, eye, upper=True)


def _harmonic_round(matvec: Callable, Vd: torch.Tensor):
    """One harmonic-Ritz round on the device: whiten, project, solve the
    m x m pencil (A = U^H W, B = U^H U) for the values nearest 0, recombine.
    Returns the new (m, n) rows and the stacked (2, m) (theta, res)."""
    m = Vd.shape[0]
    eps = 1e3 * torch.finfo(real_dtype(Vd.dtype)).eps
    eye = torch.eye(m, dtype=Vd.dtype, device=Vd.device)
    W, U, A, B = _project(matvec, Vd, _whitening(_gram(Vd), eps))
    A = 0.5 * (A + A.mH)
    B = 0.5 * (B + B.mH)
    scb = B.diagonal().real.sum() / m
    Lb = torch.linalg.cholesky(B + (eps * scb) * eye)
    M = torch.linalg.solve_triangular(Lb, A, upper=False)
    M = torch.linalg.solve_triangular(Lb, M.mH, upper=False).mH
    M = 0.5 * (M + M.mH)
    mu, Z = torch.linalg.eigh(M)
    Y = torch.linalg.solve_triangular(Lb.mH, Z, upper=True)
    amu = mu.abs()
    order = torch.argsort(torch.where(amu > 0, 1.0 / amu, torch.full_like(amu, np.inf)),
                          stable=True)
    X, _, theta, res = _recombine(W, U, Y[:, order])
    return X, torch.stack([theta, res])


class DeviceEigResult(NamedTuple):
    values: np.ndarray      # (k,) real (host)
    vectors: torch.Tensor   # (k, n) rows on the operator's device
    resnorms: np.ndarray    # (k,) (host)


def inverse_iteration_smallest_device(
    matvec: Callable,
    apply_inv: Callable,
    n: int,
    k: int,
    *,
    dtype: torch.dtype,
    device,
    seed: int = 5,
    rounds: int = 6,
    buffer: Optional[int] = None,
    tol: float = 0.0,
    V0: Optional[np.ndarray] = None,
    warm_filter_degree: int = 0,
) -> DeviceEigResult:
    """Smallest-|lambda| eigenpairs of a Hermitian H by inverse subspace
    iteration V <- H^{-1} V (``apply_inv`` on (m, n) rows), the subspace
    resident on ``device``.

    The start block is ``V0`` (host (n, m) complex, orthonormalized) when
    given, otherwise an i.i.d. Gaussian (m, n) block from a generator on
    ``device`` seeded with ``seed``; ``warm_filter_degree`` > 0 runs one
    Chebyshev filter pass in t = lambda^2 over that random block first.
    Each round is one batched apply_inv and one harmonic-Ritz round. With
    ``tol`` > 0 it stops once the k smallest residuals are below tol AND the
    k smallest |theta| moved by less than sqrt(tol) relative since the
    previous round (small residuals alone do not prove that no interior
    mode is still missing from the subspace). The result comes from a
    plain Rayleigh--Ritz on the whitened basis (the harmonic recombination
    is not unitary), and pairs with res > 0.5 |theta| -- ghosts of plain RR
    on an indefinite operator -- are passed over while enough genuine ones
    remain."""
    m = buffer if buffer is not None else max(k + 2, int(round(1.25 * k)))
    m = min(m, n)
    if V0 is not None:
        m = V0.shape[1]
        Vd = torch.from_numpy(np.ascontiguousarray(_orth(V0).T)).to(
            device=device, dtype=dtype)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        rdt = real_dtype(dtype)
        re = torch.randn((m, n), generator=gen, dtype=rdt, device=device)
        im = torch.randn((m, n), generator=gen, dtype=rdt, device=device)
        Vd = torch.complex(re, im)
        if warm_filter_degree:
            lam = power_bound(matvec, n, dtype, device, seed=seed + 17)
            b = lam * lam
            # cut at ~1% of lam_max: the near-critical modes sit orders of
            # magnitude below the bulk edge
            a = max((1.0e-2 * lam) ** 2, b * 1.0e-12)
            Vd = _chebyshev_filter(matvec, Vd, a, b, int(warm_filter_degree))
    prev_theta = None
    for _ in range(rounds):
        Vd, diag_d = _harmonic_round(matvec, apply_inv(Vd))
        diag = diag_d.double().cpu().numpy()          # one read per round
        theta_r = np.abs(diag[0])[:k]
        if tol > 0 and float(np.max(diag[1][:k])) < tol:
            if prev_theta is not None and float(np.max(
                np.abs(np.sort(theta_r) - np.sort(prev_theta))
                / np.maximum(np.sort(prev_theta), 1e-300)
            )) < np.sqrt(max(tol, 1e-12)):
                break
        prev_theta = theta_r
    # final plain Rayleigh--Ritz: Z is unitary, so the rows X = Z^T W are
    # orthonormal to working precision
    eps = 1e3 * torch.finfo(real_dtype(dtype)).eps
    T = _whitening(_gram(Vd).to(torch.complex128), eps).to(dtype)
    W, U, M, _ = _project(matvec, Vd, T)
    M = 0.5 * (M + M.mH)
    mu, Z = torch.linalg.eigh(M)
    order = torch.argsort(mu.abs(), stable=True)
    Vd, _, theta_d, res_d = _recombine(W, U, Z[:, order])
    diag = torch.stack([theta_d, res_d]).double().cpu().numpy()
    theta, res = diag[0], diag[1]
    ok = res <= 0.5 * np.abs(theta)
    sel = [i for i in range(len(theta)) if ok[i]][:k]
    if len(sel) < k:
        sel += [i for i in range(len(theta)) if not ok[i]][: k - len(sel)]
        sel = sorted(sel)
    idx = np.asarray(sel, dtype=np.int64)
    return DeviceEigResult(theta[idx], Vd[torch.from_numpy(idx).to(Vd.device)], res[idx])


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
    buffer: Optional[int] = None,
    tol: float = 0.0,
    V0: Optional[np.ndarray] = None,
) -> EigResult:
    """Smallest-|lambda| eigenpairs of a Hermitian operator (``matvec`` on
    (m, n) row batches) via CheFSI on H^2 + harmonic Ritz, the subspace of
    ``buffer`` (default 1.5 k) vectors resident on ``device``; stops early
    once the k residuals are below ``tol`` (0: run every round). ``V0``
    (host (n, m0) complex) replaces the first columns of the random start
    block: MG setup seeds a coarse level with the restricted test vectors of
    the finer one."""
    m = buffer if buffer is not None else max(k + 2, int(round(1.5 * k)))
    m = min(m, n)
    lam_max = power_bound(matvec, n, dtype, device, seed=seed + 17)
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    if V0 is not None:
        m0 = min(V0.shape[1], m)
        V[:, :m0] = V0[:, :m0]
    V = _orth(V)

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


def smallest_eigpairs_nonhermitian(
    matvec_A: Callable,
    matvec_Q: Callable,
    n: int,
    k: int,
    *,
    dtype: torch.dtype,
    device,
    seed: int = 23,
    degree: int = 100,
    rounds: int = 8,
    buffer: Optional[int] = None,
    V0: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Approximate smallest-|lambda| eigenpairs (values (k,), vectors
    (n, k), host) of the non-Hermitian A: a CheFSI subspace of
    Q^2 = A^H A (Q = gamma3 A Hermitian), then the oblique Ritz problem
    G = W^H A W on the host. The hierarchy's quality depends on these
    vectors, an estimator's bias never does."""
    m = buffer if buffer is not None else max(k + 2, 2 * k)
    sub = chebyshev_filtered_smallest(
        matvec_Q, n, m, dtype=dtype, device=device, seed=seed, degree=degree,
        rounds=rounds, buffer=max(m + 2, int(round(1.25 * m))), V0=V0)
    W = _orth(sub.vectors)
    theta, Y = np.linalg.eig(W.conj().T @ _apply_cols(matvec_A, W, dtype, device))
    order = np.argsort(np.abs(theta))[:k]
    return theta[order], W @ Y[:, order]


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
