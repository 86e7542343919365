"""The benchmark's inputs: the quenched 2D U(1) gauge field of a
configuration and its Wilson--Dirac stencil coefficients, made from the
configuration's own field seed.

A frozen copy of the port's generator (deflatedmlmc_schwinger_tpu_torch/
io/gauge.py, the same numpy calls), so that a field seed gives the same
coefficients here as the configuration's ``generated:`` name gives the
program, and a later change to the program's generator cannot move the
benchmark's inputs. Both sides get these coefficients: the program as a
StencilOperator, the plain reference as a sparse matrix.

    D = (m + 4) I
        + u_t(x,t)         (1 - sigma1) delta_{t+1}
        + conj(u_t(x,t-1)) (1 + sigma1) delta_{t-1}
        + u_x(x,t)         (1 - sigma2) delta_{x+1}
        + conj(u_x(x-1,t)) (1 + sigma2) delta_{x-1}
"""

from __future__ import annotations

import numpy as np

SIGMA1 = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
SIGMA2 = np.array([[0.0, -1.0j], [1.0j, 0.0]], dtype=complex)
I2 = np.eye(2, dtype=complex)

# (dx, dt) of the five taps of the coefficient field C[s_out, s_in, tap, x, t]
TAPS = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))


def sample_links(nx: int, nt: int, beta: float, seed: int):
    """(theta_t, theta_x) link angles, each (nx, nt): i.i.d. von Mises(beta)
    plaquettes in temporal gauge with a random Polyakov line per column."""
    rng = np.random.default_rng(seed)
    plaq = rng.vonmises(0.0, beta, size=(nx, nt))
    th_x0 = rng.uniform(-np.pi, np.pi, size=(nx, 1))
    csum = np.concatenate([np.zeros((nx, 1)), np.cumsum(plaq, axis=1)[:, :-1]], axis=1)
    return np.zeros((nx, nt)), th_x0 - csum


def stencil_from_links(theta_t: np.ndarray, theta_x: np.ndarray,
                       mass: float) -> np.ndarray:
    """(2, 2, 5, nx, nt) complex128 Wilson--Dirac coefficients."""
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


def coefficients(operator: dict) -> np.ndarray:
    """The coefficients of a configuration's ``operator`` entry:
    {"nx", "nt", "beta", "field_seed", "mass"}."""
    tt, tx = sample_links(int(operator["nx"]), int(operator["nt"]),
                          float(operator["beta"]), int(operator["field_seed"]))
    return stencil_from_links(tt, tx, float(operator["mass"]))
