"""Typed configuration for the trace estimators and the multigrid solver
(counterpart of deflatedmlmc_schwinger_tpu/config.py; the field meanings and
the measurements behind the defaults are documented there).

Both dataclasses are frozen: MGSolver and the estimators read them, and a
config is changed only through ``replace``. The complex dtype is an explicit
field (complex128 unless a configuration asks for complex64).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def pin_full_precision_matmuls() -> None:
    """Keep float32 matmuls in full float32. The coarse-level einsums, the
    prolongator applications and the dense coarsest inverse are complex64
    matmuls; TF32 would keep about three of their decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def real_dtype(cdtype: torch.dtype) -> torch.dtype:
    return torch.float64 if cdtype == torch.complex128 else torch.float32


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Knobs for the multigrid-preconditioned FGMRES solver."""

    restart: int = 20
    max_restarts: int = 10
    smooth_iters: int = 4
    smoother: str = "gmres"         # 'gmres' | 'poly'
    stall_ratio: Optional[float] = 0.9
    stall_cycles: int = 2
    tol_floor_c64: float = 3.0e-7
    tol_floor_c128: float = 1.0e-13

    def tol_floor(self, dtype: torch.dtype) -> float:
        return self.tol_floor_c128 if dtype == torch.complex128 else self.tol_floor_c64

    def effective_tol(self, tol: float, dtype: torch.dtype) -> float:
        return max(float(tol), self.tol_floor(dtype))


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Full configuration of one trace-estimation experiment."""

    # ---- problem / matrix ----
    matrix: str = "schwinger128.mat"
    problem_name: str = "schwinger"
    mass: float = -0.1320
    latt_dims: Tuple[int, int] = (128, 128)  # (nt, nx)

    # ---- trace estimation ----
    trace_tol: float = 1.0e-2
    function_tol: float = 1.0e-12
    max_nr_ests: int = 100000
    min_nr_ests: int = 6
    nr_rough_iters: int = 5
    rough_batch_full: bool = False
    rough_seed: int = 123456
    seed: int = 51234
    stop_safety: float = 1.0
    stop_confirm: bool = False

    # ---- multigrid hierarchy ----
    max_nr_levels: int = 4
    aggrs: Tuple[int, ...] = (4 * 4, 2 * 2, 2 * 2)
    dof: Tuple[int, ...] = (2, 8, 8, 8)
    accuracy_mg_eigvs: str = "high"
    test_vectors_type: str = "EVs"
    check_quality_MG: bool = False
    coarsest_level_directly: bool = True

    # ---- deflation ----
    nr_deflat_vctrs: int = 8
    mlmc_deflat_vctrs: Tuple[int, ...] = (0, 0, 0)
    defl_type: str = "exact"
    defl_eigvs_tol_Hutch: float = 1.0e-9
    defl_eigvs_tol_MLMC: float = 1.0e-1
    diff_lev_op_tol: float = 1.0e-3
    defl_subspace_rounds: int = 6
    defl_warm_filter_degree: int = 0
    defl_buffer: Optional[int] = None
    rough_deflat_vctrs: Optional[int] = None
    rough_defl_rounds: Optional[int] = None
    defl_refine_steps: int = 0

    # ---- MLMC ----
    mlmc_levels_to_skip: Tuple[int, ...] = (1,)
    mlmc_schedule: str = "sequential"
    mlmc_exact_dense_max_n: int = 0
    mlmc_fine_deflation: bool = False

    # ---- displaced trace tr(D^-1 Pi) ----
    use_permuted: bool = True
    x_displacement: int = 2

    # ---- solver and device knobs ----
    probe_batch: int = 8
    dtype: torch.dtype = torch.complex128
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    defl_solver: Optional[SolverConfig] = None
    coarse_format: str = "auto"
    setup_backend: str = "host"
    setup_fine_eigs: str = "auto"
    chebyshev_degree: int = 100
    subspace_iters: int = 8
    subspace_iters_coarse: Optional[int] = None
    max_stalled_frac: float = 0.05
    sample_axis: str = "samples"
    lattice_axis: str = "x"

    def complex_dtype(self) -> torch.dtype:
        return self.dtype

    @property
    def nt(self) -> int:
        return int(self.latt_dims[0])

    @property
    def nx(self) -> int:
        return int(self.latt_dims[1])

    def replace(self, **kw) -> "TraceConfig":
        return dataclasses.replace(self, **kw)
