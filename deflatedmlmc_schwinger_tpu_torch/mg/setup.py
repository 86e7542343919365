"""Aggregation multigrid setup: prolongator blocks, the backend dispatch and
the quality checks (subset of deflatedmlmc_schwinger_tpu/mg/setup.py).

Only ``setup_backend='host'`` is ported (mg/host_setup.py); the device
Galerkin/CheFSI backend waits for the G302 slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from deflatedmlmc_schwinger_tpu_torch.config import TraceConfig
from deflatedmlmc_schwinger_tpu_torch.mg.hierarchy import Hierarchy


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


def setup_hierarchy(op0, cfg: TraceConfig) -> Hierarchy:
    """Build the multigrid hierarchy for the fine StencilOperator ``op0``;
    its tensors land on op0's device in op0's dtype."""
    if cfg.setup_backend == "host":
        from deflatedmlmc_schwinger_tpu_torch.mg.host_setup import setup_hierarchy_host

        hier = setup_hierarchy_host(op0, cfg)
        if cfg.check_quality_MG:
            for name, val in check_quality(hier).items():
                print(f"\t{name} = {val:.3e}")
        return hier
    if cfg.setup_backend == "device":
        raise NotImplementedError(
            "setup_backend='device' waits for the G302 slice (ROADMAP.md, "
            "'Modules to port': device setup backend)")
    raise ValueError(
        f"setup_backend must be 'host' or 'device', got {cfg.setup_backend!r}")


def check_quality(hier: Hierarchy) -> Dict[str, float]:
    """The reference's invariant checks: orthonormality ||RP - I||_F,
    gamma3-compatibility of P, Hermiticity of A_{l+1} and gamma3 A_{l+1}."""
    out: Dict[str, float] = {}
    for i, lev in enumerate(list(hier.levels)[:-1]):
        b = lev.P.blocks.detach().cpu().numpy()
        na, L, dc = b.shape
        gram = np.einsum("alk,alm->akm", np.conj(b), b)
        out[f"orthonormality of P at level {i}"] = float(
            np.sqrt(np.sum(np.abs(gram - np.eye(dc)[None]) ** 2)))
        # aggregates never straddle the spin half and the coarse layout is
        # aggregate-major, so fine and coarse per-strip signs agree
        sign = np.where(np.arange(na) < na // 2, 1.0, -1.0)
        mism = (sign - sign)[:, None, None] * b
        out[f"g3-compatibility at level {i}"] = float(np.sqrt(np.sum(np.abs(mism) ** 2)))
        Ac = hier.levels[i + 1].op.complex_matrix()
        out[f"hermiticity of A at level {i+1}"] = float(np.linalg.norm(Ac - Ac.conj().T))
        half = Ac.shape[0] // 2
        g3Ac = np.concatenate([Ac[:half], -Ac[half:]], axis=0)
        out[f"hermiticity of g3*A at level {i+1}"] = float(
            np.linalg.norm(g3Ac - g3Ac.conj().T))
    return out
