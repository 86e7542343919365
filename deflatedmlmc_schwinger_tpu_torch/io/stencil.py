"""Host-side conversion between CSR matrices and stencil coefficient fields
(counterpart of deflatedmlmc_schwinger_tpu/io/stencil.py)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from deflatedmlmc_schwinger_tpu_torch.ops.stencil_kernels import TAPS


def _flat_index(s, x, t, nx, nt):
    return s * (nx * nt) + x * nt + t


def stencil_from_csr(A: sp.spmatrix, nt: int, nx: int) -> np.ndarray:
    """Extract (2, 2, 5, nx, nt) coefficients from a spin-major CSR matrix
    (flat index = spin*(N/2) + x*nt + t). Raises if A has nonzeros outside
    the 9-point periodic stencil pattern."""
    A = sp.csr_matrix(A)
    N = A.shape[0]
    if N != 2 * nx * nt:
        raise ValueError(f"matrix size {N} != 2*{nx}*{nt}")
    X, T = np.meshgrid(np.arange(nx), np.arange(nt), indexing="ij")
    C = np.zeros((2, 2, len(TAPS), nx, nt), dtype=A.dtype)
    covered = 0
    for s_out in (0, 1):
        rows = _flat_index(s_out, X, T, nx, nt).ravel()
        for s_in in (0, 1):
            for k, (dx, dt) in enumerate(TAPS):
                if s_in != s_out and k == 0:
                    continue
                cols = _flat_index(s_in, (X + dx) % nx, (T + dt) % nt, nx, nt).ravel()
                vals = np.asarray(A[rows, cols]).ravel()
                C[s_out, s_in, k] = vals.reshape(nx, nt)
                covered += np.count_nonzero(vals)
    if covered != A.nnz:
        raise ValueError(
            f"matrix has {A.nnz} nonzeros but only {covered} lie on the "
            "9-point periodic stencil pattern"
        )
    return C


def csr_from_stencil(C: np.ndarray) -> sp.csr_matrix:
    """Inverse of stencil_from_csr."""
    _, _, _, nx, nt = C.shape
    N = 2 * nx * nt
    X, T = np.meshgrid(np.arange(nx), np.arange(nt), indexing="ij")
    rows_l, cols_l, vals_l = [], [], []
    for s_out in (0, 1):
        rows = _flat_index(s_out, X, T, nx, nt).ravel()
        for s_in in (0, 1):
            for k, (dx, dt) in enumerate(TAPS):
                vals = C[s_out, s_in, k].ravel()
                if not np.any(vals):
                    continue
                cols = _flat_index(s_in, (X + dx) % nx, (T + dt) % nt, nx, nt).ravel()
                rows_l.append(rows)
                cols_l.append(cols)
                vals_l.append(vals)
    return sp.csr_matrix(
        (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=(N, N),
    )
