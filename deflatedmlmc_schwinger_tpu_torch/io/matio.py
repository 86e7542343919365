"""Matrix ingestion: a .mat file or a 'generated:' spec -> StencilOperator
(counterpart of deflatedmlmc_schwinger_tpu/io/matio.py).

A .mat file gives key 'S', for schwinger16.mat first multiplied by gamma_3
(lower half of the rows negated), then D = S + m I. It is read by the native
C++ MAT5 reader (io/native.py) when that library is built, else by scipy.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from deflatedmlmc_schwinger_tpu_torch.io.stencil import stencil_from_csr
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import StencilOperator


def load_matrix(path: str, mass: float) -> sp.csr_matrix:
    """Load D = (gamma3-fixed) S + m*I as a host CSR matrix. The native
    reader is preferred (bit-exact against scipy.io); DMLMC_NATIVE_IO=0, an
    unbuilt library or a file it cannot read leave the reading to scipy."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    A = None
    if os.environ.get("DMLMC_NATIVE_IO", "1") != "0":
        from deflatedmlmc_schwinger_tpu_torch.io import native

        if native.available():
            try:
                A = sp.csr_matrix(native.load_mat_sparse(path, "S"))
            except RuntimeError:
                A = None
    if A is None:
        import scipy.io as sio

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            A = sp.csr_matrix(sio.loadmat(path)["S"])
    if os.path.basename(path) == "schwinger16.mat":
        half = A.shape[0] // 2
        A = sp.vstack([A[:half, :], -A[half:, :]]).tocsr()
    return (A + mass * sp.identity(A.shape[0], dtype=A.dtype)).tocsr()


def infer_latt_dims(n: int) -> Tuple[int, int]:
    """Square-lattice dims from the matrix size (n = 2*L*L)."""
    L = int(round((n / 2) ** 0.5))
    if 2 * L * L != n:
        raise ValueError(f"cannot infer square lattice dims from n={n}")
    return (L, L)


def parse_generated_name(matrix_name: str):
    """Parse 'generated:<nx>x<nt>[:beta=<b>][:seed=<s>]'; None otherwise."""
    if not matrix_name.startswith("generated:"):
        return None
    parts = matrix_name.split(":")
    nx, nt = (int(v) for v in parts[1].split("x"))
    beta, seed = 5.0, 0
    for p in parts[2:]:
        k, v = p.split("=")
        if k == "beta":
            beta = float(v)
        elif k == "seed":
            seed = int(v)
        else:
            raise ValueError(f"unknown generated-matrix option {k!r}")
    return nx, nt, beta, seed


def load_operator(
    matrix_name: str,
    mass: float,
    latt_dims: Optional[Tuple[int, int]] = None,
    dtype: Optional[torch.dtype] = None,
    *,
    device=None,
) -> Tuple[StencilOperator, Optional[sp.csr_matrix]]:
    """The Dirac operator as a StencilOperator on ``device`` plus the CSR
    oracle (None for generated operators)."""
    gen = parse_generated_name(matrix_name)
    if gen is not None:
        from deflatedmlmc_schwinger_tpu_torch.io.gauge import generate_operator

        nx, nt, beta, seed = gen
        return generate_operator(nx, nt, mass, beta=beta, seed=seed,
                                 dtype=dtype, device=device), None
    A = load_matrix(matrix_name, mass)
    if latt_dims is None:
        latt_dims = infer_latt_dims(A.shape[0])
    nt, nx = int(latt_dims[0]), int(latt_dims[1])
    C = stencil_from_csr(A, nt=nt, nx=nx).astype(np.complex128)
    return StencilOperator.from_numpy(C, device=device, dtype=dtype), A
