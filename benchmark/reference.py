"""The plain reference that decides ``correct``, and the lower-precision
control that has to fail it. NumPy, SciPy and plain PyTorch only; nothing
of the program is imported.

The reference builds the Wilson--Dirac operator from the same coefficient
field that the program was given (benchmark/gauge.py), as a complex128
sparse matrix, and draws the window's probes again by the counter-keyed
rule (probe s of seed q: a generator seeded by SeedSequence([q, s]), one
``torch.randint`` draw of n signs on the device). What it reads of the
program's set-up is the state the window's estimates are defined by: the
probe projector basis U, its exact term tr1 and, for an MLMC level, the
prolongator blocks of the coarse correction. The deflated Hutchinson and
MLMC estimators are unbiased for any U with a matching tr1, so U is judged
through tr1 (worked out again here with exact solves) and through the
systems it defines; the coarse operator is worked out again as the Galerkin
product of the prolongator and the reference's own operator.

Numbers (``judge``), each over the rows of the checked batches:
  relres_max     max ||b - D x|| / ||b|| over every checked row, those
                 the program flagged as stalled too, b the reference's
                 right-hand side;
  est_gap        max |e - e^| / (||z|| (||x|| + ||P y||)): each estimate
                 against e^ = z^H x - z^H P y, built in complex128 from the
                 program's own (judged) solution x and, for an MLMC level,
                 the reference's coarse correction y = Ac^{-1} P^H b with the
                 dense inverse of the Galerkin coarse operator Ac;
  tr1_err        |tr1 - tr1*| / |tr1*|, tr1* from exact solves (a sparse LU
                 of D) and the same coarse correction.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spl
import torch

from gauge import TAPS


def csr_operator(C: np.ndarray) -> sp.csr_matrix:
    """D as a complex128 CSR matrix in the spin-major flat layout
    (index = spin * X * T + x * T + t), from C[s_out, s_in, tap, x, t]."""
    _, _, _, nx, nt = C.shape
    X, T = np.meshgrid(np.arange(nx), np.arange(nt), indexing="ij")
    rows, cols, vals = [], [], []
    for so in (0, 1):
        r = (so * nx * nt + X * nt + T).ravel()
        for si in (0, 1):
            for k, (dx, dt) in enumerate(TAPS):
                v = np.asarray(C[so, si, k], dtype=np.complex128).ravel()
                if not np.any(v):
                    continue
                rows.append(r)
                cols.append((si * nx * nt + ((X + dx) % nx) * nt + (T + dt) % nt).ravel())
                vals.append(v)
    n = 2 * nx * nt
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))


def probe_rows(seed: int, samples: np.ndarray, n: int, device) -> np.ndarray:
    """Rademacher probes of the given sample indices, complex128 (rows)."""
    gen = torch.Generator(device=device)
    out = np.empty((len(samples), n), dtype=np.complex128)
    for i, s in enumerate(samples):
        key = np.random.SeedSequence([int(seed), int(s)]).generate_state(1)
        gen.manual_seed(int(key[0]))
        r = torch.randint(0, 2, (n,), generator=gen, device=device, dtype=torch.int8)
        out[i] = (r.to(torch.float64) * 2 - 1).cpu().numpy()
    return out


def prolongator(blocks: np.ndarray) -> sp.csr_matrix:
    """An aggregation prolongator from its (n_aggr, L, dc) blocks: aggregate
    a maps fine indices [a L, (a + 1) L) to coarse ones [a dc, (a + 1) dc)."""
    return sp.block_diag(list(np.asarray(blocks, dtype=np.complex128)), format="csr")


class Reference:
    """The operator, the right-hand sides and the exact estimates of one
    configuration and program state."""

    def __init__(self, C: np.ndarray, state: dict):
        self.A = csr_operator(C)
        self.n = self.A.shape[0]
        self.state = state
        self.U = state["U"]
        self.shift = int(state["shift"])
        self.P = None
        if state.get("coarse_P"):
            P = prolongator(state["coarse_P"][0])
            for b in state["coarse_P"][1:]:
                P = (P @ prolongator(b)).tocsr()
            self.P = P
        self._lu = None
        self._coarse_inv = None

    def rhs(self, Z: np.ndarray, matmul=None) -> np.ndarray:
        """The systems' right-hand sides: Pi^T (z - U U^H z) per row."""
        mm = matmul or np.matmul
        B = Z
        if self.U is not None:
            B = Z - mm(mm(Z, self.U.conj()), self.U.T)
        return np.roll(B, self.shift, axis=-1) if self.shift else B

    def lu(self):
        if self._lu is None:
            self._lu = spl.splu(self.A.tocsc(), permc_spec="MMD_AT_PLUS_A")
        return self._lu

    def solve(self, B: np.ndarray) -> np.ndarray:
        return self.lu().solve(np.ascontiguousarray(B.T)).T

    def coarse_inv(self) -> np.ndarray:
        """The dense inverse of the Galerkin coarse operator P^H D P."""
        if self._coarse_inv is None:
            Ac = (self.P.conj().T @ (self.A @ self.P)).toarray()
            self._coarse_inv = np.linalg.inv(Ac)
        return self._coarse_inv

    def coarse_term(self, Z: np.ndarray, B: np.ndarray):
        """(z^H P Ac^{-1} P^H b per row, P y per row) of the coarse
        correction; zeros without one."""
        if self.P is None:
            return np.zeros(len(Z), dtype=np.complex128), np.zeros_like(B)
        Py = (self.P @ (self.coarse_inv() @ (self.P.conj().T @ B.T))).T
        return np.sum(Z.conj() * Py, axis=1), Py

    def exact_tr1(self) -> Optional[complex]:
        """sum_i U_i^H (D^{-1} - P Ac^{-1} P^H) Pi^T U_i."""
        if self.U is None:
            return None
        R = self.U.T                                         # (k, n) rows
        B = np.roll(R, self.shift, axis=-1) if self.shift else R
        c, _ = self.coarse_term(R, B)
        return complex(np.sum(R.conj() * self.solve(B)) - np.sum(c))


def judge(ref: Reference, outputs: dict, names: List[str]) -> Dict[str, float]:
    """The numbers ``names`` for the program's outputs: ``Z`` the checked
    probe rows, ``X`` their solutions, ``e`` their estimates and ``tr1``."""
    Z, X, e = outputs["Z"], outputs["X"], np.asarray(outputs["e"])
    got: Dict[str, float] = {}
    if "relres_max" in names:
        B = ref.rhs(Z)
        rel = (np.linalg.norm(B - (ref.A @ X.T).T, axis=1)
               / np.linalg.norm(B, axis=1))
        got["relres_max"] = float(rel.max())
    if "est_gap" in names:
        c, Py = ref.coarse_term(Z, ref.rhs(Z))
        ehat = np.sum(Z.conj() * X, axis=1) - c
        scale = np.linalg.norm(Z, axis=1) * (np.linalg.norm(X, axis=1)
                                             + np.linalg.norm(Py, axis=1))
        with np.errstate(divide="ignore", invalid="ignore"):   # a missing solution
            got["est_gap"] = float(np.max(np.abs(e - ehat) / scale))
    if "tr1_err" in names:
        t = ref.exact_tr1()
        got["tr1_err"] = 0.0 if t is None else abs(outputs["tr1"] - t) / abs(t)
    return got


# ---- the control: the reference in the program's place, one precision down --

def _round_bf16(a: np.ndarray) -> np.ndarray:
    """Round the real and imaginary parts to bfloat16 (nearest even)."""
    def r(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
            torch.bfloat16).to(torch.float64).numpy()
    a = np.asarray(a)
    return r(a.real) + 1j * r(a.imag) if np.iscomplexobj(a) else r(a)


def _round_tf32(a: np.ndarray) -> np.ndarray:
    """Round the real and imaginary parts to TF32 (10 mantissa bits)."""
    def r(x):
        f = np.ascontiguousarray(x, dtype=np.float32).copy()
        i = f.view(np.uint32)
        i += np.uint32(0x1000)
        i &= np.uint32(0xFFFFE000)
        return f.astype(np.float64)
    a = np.asarray(a)
    return r(a.real) + 1j * r(a.imag) if np.iscomplexobj(a) else r(a)


def _tf32_matmul(a, b):
    """A matrix product in TF32: inputs rounded to TF32, the result to
    float32 (the sums of a tensor-core product accumulate in float32)."""
    if sp.issparse(a):
        a = a.toarray()
    if sp.issparse(b):
        b = b.toarray()
    return (_round_tf32(a) @ _round_tf32(b)).astype(np.complex64).astype(np.complex128)


class Control(Reference):
    """The reference computed one precision below what the configuration
    states (complex64, TF32 off): matrix products in TF32, every other
    float32 quantity in bfloat16. The solve is the exact solve of the
    rounded system (bfloat16 operator and right-hand side), its solution
    rounded to bfloat16; each estimate and tr1 term is rounded to
    bfloat16."""

    def __init__(self, C: np.ndarray, state: dict):
        super().__init__(_round_bf16(C), state)

    def outputs(self, Z: np.ndarray) -> dict:
        B = _round_bf16(self.rhs(Z, matmul=_tf32_matmul))
        X = _round_bf16(self.solve(B))
        c = np.zeros(len(Z), dtype=np.complex128)
        if self.P is not None:
            y = _tf32_matmul(self.coarse_inv(), _tf32_matmul(self.P.conj().T, B.T))
            Py = _tf32_matmul(self.P, y).T
            c = _round_bf16(np.sum(Z.conj() * Py, axis=1))
        e = _round_bf16(_round_bf16(np.sum(Z.conj() * X, axis=1)) - c)
        tr1 = 0.0 + 0.0j
        if self.U is not None:
            R = self.U.T
            Bu = _round_bf16(np.roll(R, self.shift, axis=-1) if self.shift else R)
            cu = np.zeros(len(R), dtype=np.complex128)
            if self.P is not None:
                yu = _tf32_matmul(self.coarse_inv(), _tf32_matmul(self.P.conj().T, Bu.T))
                cu = _round_bf16(np.sum(R.conj() * _tf32_matmul(self.P, yu).T, axis=1))
            terms = _round_bf16(np.sum(R.conj() * _round_bf16(self.solve(Bu)), axis=1)) - cu
            tr1 = complex(_round_bf16(np.sum(_round_bf16(terms))).ravel()[0])
        return dict(Z=Z, X=X, e=e, tr1=tr1)
