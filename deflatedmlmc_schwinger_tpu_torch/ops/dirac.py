"""The Wilson--Dirac 9-point stencil operator as dense coefficient fields
(counterpart of deflatedmlmc_schwinger_tpu/ops/dirac.py).

    C[s_out, s_in, tap, x, t]     shape (2, 2, 5, X, T)

with taps (dx, dt) = (0,0), (0,1), (0,-1), (1,0), (-1,0) and periodic wrap;
the cross-spin on-site tap is structurally zero. Flat vectors of length
N = 2*X*T use the reference's spin-major layout (index = spin*X*T + x*T + t).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels
from deflatedmlmc_schwinger_tpu_torch.ops.stencil_kernels import TAPS

__all__ = [
    "TAPS", "StencilOperator", "gamma3", "shift_rows_up", "shift_rows_down",
    "stencil_matvec_host",
]


class StencilOperator(nn.Module):
    """9-point gauged stencil on the (spin=2, X, T) lattice; the matvec is
    kernel K1 on a CUDA device and its plain version on the CPU."""

    def __init__(self, coeffs: torch.Tensor, nx: int, nt: int):
        super().__init__()
        if tuple(coeffs.shape) != (2, 2, 5, nx, nt):
            raise ValueError(f"coefficients must be (2, 2, 5, {nx}, {nt}), "
                             f"got {tuple(coeffs.shape)}")
        self.register_buffer("coeffs", coeffs.contiguous())
        self.nx = int(nx)
        self.nt = int(nt)

    @classmethod
    def from_numpy(cls, coeffs: np.ndarray, *, device=None,
                   dtype: Optional[torch.dtype] = None) -> "StencilOperator":
        """From the complex (2, 2, 5, X, T) numpy array."""
        _, _, _, nx, nt = coeffs.shape
        t = torch.from_numpy(np.ascontiguousarray(coeffs))
        return cls(t.to(device=device, dtype=dtype or t.dtype), nx, nt)

    @property
    def n(self) -> int:
        return 2 * self.nx * self.nt

    @property
    def dtype(self) -> torch.dtype:
        return self.coeffs.dtype

    @property
    def device(self) -> torch.device:
        return self.coeffs.device

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """Apply to flat vectors v of shape (..., N)."""
        return stencil_kernels.stencil_matvec(self.coeffs, v.contiguous(),
                                              self.nx, self.nt)

    def host_coeffs(self) -> np.ndarray:
        return self.coeffs.detach().cpu().numpy()


def stencil_matvec_host(coeffs: np.ndarray, v: np.ndarray, nx: int,
                        nt: int) -> np.ndarray:
    """Host numpy twin of the stencil matvec (caller-chosen precision)."""
    g = v.reshape(v.shape[:-1] + (2, nx, nt))
    out = np.zeros_like(g)
    for k, (dx, dt) in enumerate(TAPS):
        shifted = g
        if dx:
            shifted = np.roll(shifted, -dx, axis=-2)
        if dt:
            shifted = np.roll(shifted, -dt, axis=-1)
        out = out + np.einsum("abxt,...bxt->...axt", coeffs[:, :, k], shifted)
    return out.reshape(v.shape)


def gamma3(v: torch.Tensor) -> torch.Tensor:
    """gamma_3 = diag(+I, -I) on the two spin halves of flat vectors (valid
    at every level: aggregates never straddle the spin boundary)."""
    half = v.shape[-1] // 2
    return torch.cat([v[..., :half], -v[..., half:]], dim=-1)


def shift_rows_up(v: torch.Tensor, d: int) -> torch.Tensor:
    """(Pi v)[i] = v[(i+d) % N], the displacement operator."""
    return torch.roll(v, shifts=-d, dims=-1)


def shift_rows_down(v: torch.Tensor, d: int) -> torch.Tensor:
    """(Pi^T v)[i] = v[(i-d) % N]."""
    return torch.roll(v, shifts=d, dims=-1)
