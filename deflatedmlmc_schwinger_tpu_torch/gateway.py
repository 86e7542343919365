"""Experiment gateway: the named configurations and the G-entry functions
(counterpart of deflatedmlmc_schwinger_tpu/gateway.py).

``set_params`` holds all five configurations as data, field for field the
JAX package's (the reasons behind each tuned knob are documented there).
All six entries run here on one device: G101/G201 (the 16^2 profile, GMRES
smoother, complex128), G102/G202 (the tuned 128^2 profile), G301 (generated
256^2) and G302 (generated 512^2; the profile keeps the host setup backend,
with the fine-level test vectors from the device CheFSI). G302 over several
devices, with probe batches or the lattice sharded, waits for the parallel
slice (ROADMAP.md queue).
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from deflatedmlmc_schwinger_tpu_torch.config import SolverConfig, TraceConfig
from deflatedmlmc_schwinger_tpu_torch.examples import EXAMPLE_001, EXAMPLE_002

_SCHWINGER128_COMMON = dict(
    matrix="schwinger128.mat",
    problem_name="schwinger",
    mass=-0.1320,
    latt_dims=(128, 128),
    trace_tol=1.0e-2,
    aggrs=(4 * 4, 2 * 2, 2 * 2),
    dof=(2, 8, 8, 8),
    max_nr_levels=4,
    coarsest_level_directly=True,
    check_quality_MG=False,
    mlmc_levels_to_skip=(1,),
    mlmc_deflat_vctrs=(0, 0, 0),
    defl_type="exact",
    defl_eigvs_tol_MLMC=1.0e-1,
    diff_lev_op_tol=1.0e-3,
    use_permuted=True,
    x_displacement=2,
    seed=51234,
    probe_batch=128,
)

# scale-out configs: generated quenched lattices, k=0 deflation, light CheFSI
_GENERATED_COMMON = dict(
    problem_name="schwinger",
    mass=-0.10,
    trace_tol=1.0e-2,
    coarsest_level_directly=True,
    accuracy_mg_eigvs="low",
    test_vectors_type="RSVs",
    mlmc_levels_to_skip=(),
    nr_deflat_vctrs=0,
    defl_eigvs_tol_Hutch=1.0e-2,
    defl_type="exact",
    defl_eigvs_tol_MLMC=1.0e-1,
    diff_lev_op_tol=1.0e-3,
    rough_batch_full=True,
    stop_safety=0.7,
    stop_confirm=True,
    use_permuted=False,
    x_displacement=0,
    check_quality_MG=False,
    seed=51234,
    chebyshev_degree=30,
    subspace_iters=3,
    dtype=torch.complex64,
    solver=SolverConfig(restart=40, smoother="poly"),
    function_tol=5.0e-4,
)

_CONFIGS: Dict[str, dict] = {
    # the reference's 16^2 set, repaired (dof (2,4,4): the shipped (2,2,2)
    # coarsest operator is singular)
    "schwinger16": dict(
        matrix="schwinger16.mat",
        problem_name="schwinger",
        mass=-1.00690114 * 0.99,
        latt_dims=(16, 16),
        trace_tol=1.0e-2,
        max_nr_levels=3,
        coarsest_level_directly=True,
        accuracy_mg_eigvs="low",
        nr_deflat_vctrs=64,
        mlmc_deflat_vctrs=(16, 16),
        mlmc_levels_to_skip=(1,),
        aggrs=(2 * 2, 2 * 2),
        dof=(2, 4, 4),
        defl_type="exact",
        defl_eigvs_tol_Hutch=1.0e-9,
        defl_eigvs_tol_MLMC=1.0e-1,
        diff_lev_op_tol=1.0e-3,
        use_permuted=False,
        x_displacement=0,
        check_quality_MG=False,
        test_vectors_type="EVs",
        seed=51234,
    ),
    # the tuned 128^2 profile
    "schwinger128": dict(
        _SCHWINGER128_COMMON,
        accuracy_mg_eigvs="low",
        test_vectors_type="RSVs",
        nr_deflat_vctrs=128,
        defl_eigvs_tol_Hutch=1.0e-2,
        defl_subspace_rounds=3,
        defl_buffer=128,
        mlmc_exact_dense_max_n=4096,
        mlmc_fine_deflation=True,
        rough_batch_full=True,
        stop_safety=0.7,
        stop_confirm=True,
        chebyshev_degree=60,
        subspace_iters=8,
        dtype=torch.complex64,
        solver=SolverConfig(restart=40, smoother="poly", smooth_iters=16),
        defl_solver=SolverConfig(restart=40, smoother="poly"),
        function_tol=5.0e-4,
    ),
    # reference-fidelity 128^2 variant for matched-seed validation
    "schwinger128-parity": dict(
        _SCHWINGER128_COMMON,
        accuracy_mg_eigvs="high",
        test_vectors_type="EVs",
        nr_deflat_vctrs=8,
        defl_eigvs_tol_Hutch=1.0e-9,
        function_tol=1.0e-12,
        solver=SolverConfig(restart=40, smoother="poly"),
    ),
    "schwinger256": dict(
        _GENERATED_COMMON,
        matrix="generated:256x256:beta=5.0:seed=8",
        latt_dims=(256, 256),
        aggrs=(8 * 8, 4 * 4),
        dof=(2, 8, 8),
        max_nr_levels=3,
        mlmc_deflat_vctrs=(0, 0),
        probe_batch=64,
    ),
    "schwinger512": dict(
        _GENERATED_COMMON,
        matrix="generated:512x512:beta=5.0:seed=9",
        latt_dims=(512, 512),
        aggrs=(8 * 8, 4 * 4, 2 * 2),
        dof=(2, 8, 8, 8),
        max_nr_levels=4,
        mlmc_deflat_vctrs=(0, 0, 0),
        probe_batch=16,
    ),
}


def set_params(example_name: str) -> TraceConfig:
    if example_name not in _CONFIGS:
        raise ValueError(f"unknown experiment name {example_name!r}")
    return TraceConfig(**_CONFIGS[example_name])


def G101(*, device="cuda"):
    """Deflated Hutchinson, Schwinger 16^2 (needs schwinger16.mat)."""
    return EXAMPLE_001(set_params("schwinger16").replace(function_tol=1e-12),
                       device=device)


def G201(*, device="cuda"):
    """Deflated MG-MLMC, Schwinger 16^2 (needs schwinger16.mat)."""
    return EXAMPLE_002(set_params("schwinger16").replace(function_tol=1e-12),
                       device=device)


def G102(*, device="cuda"):
    """Deflated Hutchinson, Schwinger 128^2, the tuned profile (needs
    schwinger128.mat)."""
    return EXAMPLE_001(set_params("schwinger128"), device=device)


def G202(*, device="cuda"):
    """Deflated MG-MLMC, Schwinger 128^2, the tuned profile (needs
    schwinger128.mat)."""
    return EXAMPLE_002(set_params("schwinger128"), device=device)


def G301(*, device="cuda"):
    """Deflated Hutchinson on a generated 256^2 quenched configuration."""
    return EXAMPLE_001(set_params("schwinger256"), device=device)


def G302(*, device="cuda", devices: int = 1):
    """Deflated Hutchinson on a generated 512^2 quenched configuration, on
    one device. ``devices`` > 1 (probe batches sharded over several devices)
    and DMLMC_X_SHARDS > 1 (the lattice decomposed over devices) are the
    JAX package's multi-chip forms of this entry and are not ported yet."""
    if int(devices) != 1 or int(os.environ.get("DMLMC_X_SHARDS", "1")) > 1:
        raise NotImplementedError(
            "G302 over more than one device waits for the parallel slice "
            "(ROADMAP.md queue: parallel); run it with devices=1")
    return EXAMPLE_001(set_params("schwinger512"), device=device)


ENTRIES = {"G101": G101, "G102": G102, "G201": G201, "G202": G202,
           "G301": G301, "G302": G302}
