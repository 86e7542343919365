"""Quenched 2D U(1) gauge-configuration generator -> Wilson--Dirac operators
(counterpart of deflatedmlmc_schwinger_tpu/io/gauge.py, the same numpy code
so a seed gives bit-identical coefficients in both packages).

    D = (m + 4) I
        + u_t(x,t)         (1 - sigma1) delta_{t+1}
        + conj(u_t(x,t-1)) (1 + sigma1) delta_{t-1}
        + u_x(x,t)         (1 - sigma2) delta_{x+1}
        + conj(u_x(x-1,t)) (1 + sigma2) delta_{x-1}

Plaquette angles are i.i.d. von Mises(beta) (the exact 2D quenched
ensemble), links in temporal gauge with a random Polyakov line per column.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from deflatedmlmc_schwinger_tpu_torch.ops.dirac import StencilOperator

SIGMA1 = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
SIGMA2 = np.array([[0.0, -1.0j], [1.0j, 0.0]], dtype=complex)
I2 = np.eye(2, dtype=complex)


def sample_links(nx: int, nt: int, beta: float,
                 seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sample (theta_t, theta_x) link angles, each (nx, nt)."""
    rng = np.random.default_rng(seed)
    plaq = rng.vonmises(0.0, beta, size=(nx, nt))
    th_x0 = rng.uniform(-np.pi, np.pi, size=(nx, 1))
    csum = np.concatenate(
        [np.zeros((nx, 1)), np.cumsum(plaq, axis=1)[:, :-1]], axis=1
    )
    theta_x = th_x0 - csum
    theta_t = np.zeros((nx, nt))
    return theta_t, theta_x


def stencil_from_links(theta_t: np.ndarray, theta_x: np.ndarray,
                       mass: float) -> np.ndarray:
    """(2, 2, 5, nx, nt) Wilson--Dirac stencil coefficients from link angles."""
    nx, nt = theta_t.shape
    u = np.exp(1j * theta_t)
    v = np.exp(1j * theta_x)
    C = np.zeros((2, 2, 5, nx, nt), dtype=complex)
    C[:, :, 0] = (mass + 4.0) * I2[:, :, None, None]
    C[:, :, 1] = (I2 - SIGMA1)[:, :, None, None] * u
    C[:, :, 2] = (I2 + SIGMA1)[:, :, None, None] * np.conj(np.roll(u, 1, axis=1))
    C[:, :, 3] = (I2 - SIGMA2)[:, :, None, None] * v
    C[:, :, 4] = (I2 + SIGMA2)[:, :, None, None] * np.conj(np.roll(v, 1, axis=0))
    return C


def generate_operator(nx: int, nt: int, mass: float, *, beta: float = 5.0,
                      seed: int = 0, dtype: Optional[torch.dtype] = None,
                      device=None) -> StencilOperator:
    """Generate a quenched 2D Schwinger Wilson--Dirac StencilOperator on
    ``device`` (complex128 unless ``dtype`` says otherwise)."""
    theta_t, theta_x = sample_links(nx, nt, beta, seed)
    C = stencil_from_links(theta_t, theta_x, mass)
    return StencilOperator.from_numpy(C, device=device, dtype=dtype)
