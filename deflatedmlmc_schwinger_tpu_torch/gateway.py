"""Experiment gateway: the named configurations and the G-entry functions
(counterpart of deflatedmlmc_schwinger_tpu/gateway.py).

``set_params`` holds all five configurations as data, field for field the
JAX package's (the reasons behind each tuned knob are documented there).
All six entries run here: G101/G201 (the 16^2 profile, GMRES smoother,
complex128), G102/G202 (the tuned 128^2 profile), G301 (generated 256^2)
and G302 (generated 512^2; the profile keeps the host setup backend, with
the fine-level test vectors from the device CheFSI). G302 also runs over
several ranks of ``torch.distributed``, one per device, with the probe
batches split over them and, with DMLMC_X_SHARDS=k, the lattice cut over k
of them (parallel/).
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from deflatedmlmc_schwinger_tpu_torch.config import (
    SolverConfig,
    TraceConfig,
    pin_full_precision_matmuls,
)
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
    """Deflated Hutchinson on a generated 512^2 quenched configuration, with
    the probe batches split over all ranks of the process group.

    Several ranks: run one process per device under ``torchrun`` (or with
    RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set), or pass
    ``devices`` > 1 and the entry starts that many ranks on this host itself
    (parallel/worker.py) and returns rank 0's result as host numbers. Every
    rank gets the same result; rank 0 prints the report. DMLMC_X_SHARDS=k
    also cuts the 512^2 lattice over k ranks per probe group
    (parallel/sharded_solve.py). Ranks that outnumber the cards share them
    over the gloo backend."""
    import torch.distributed as dist

    from deflatedmlmc_schwinger_tpu_torch.io import load_operator
    from deflatedmlmc_schwinger_tpu_torch.parallel import initialize, make_mesh
    from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import rank_device
    from deflatedmlmc_schwinger_tpu_torch.reporting import print_post_results, result_to_json
    from deflatedmlmc_schwinger_tpu_torch.trace import hutchinson

    in_group = dist.is_available() and dist.is_initialized()
    if int(devices) > 1 and not in_group and "WORLD_SIZE" not in os.environ:
        from deflatedmlmc_schwinger_tpu_torch.parallel.worker import launch

        return launch("deflatedmlmc_schwinger_tpu_torch.parallel.worker:run_entry",
                      int(devices), args=("G302", str(device)), device=str(device))[0]
    rank = initialize(device=device)
    nranks = dist.get_world_size() if dist.is_initialized() else 1
    if nranks == 1:
        # one device: no mesh machinery at all
        return EXAMPLE_001(set_params("schwinger512"), device=device)
    cfg = set_params("schwinger512")
    xs = int(os.environ.get("DMLMC_X_SHARDS", "1"))
    if xs > 1 and nranks % xs == 0:
        mesh = make_mesh((nranks // xs, xs), (cfg.sample_axis, cfg.lattice_axis),
                         device=device)
    else:
        mesh = make_mesh(device=device)  # all ranks on the 'samples' axis
    nshards = mesh.shape[cfg.sample_axis]
    if cfg.probe_batch % nshards:
        cfg = cfg.replace(probe_batch=nshards * max(1, cfg.probe_batch // nshards))
    pin_full_precision_matmuls()
    op, _ = load_operator(cfg.matrix, cfg.mass, latt_dims=cfg.latt_dims,
                          dtype=cfg.complex_dtype(), device=rank_device(device))
    result = hutchinson(op, cfg, mesh=mesh)
    if rank == 0:
        print_post_results(cfg, result, "hutchinson")
        print(result_to_json(cfg, result, "hutchinson"))
    return result


ENTRIES = {"G101": G101, "G102": G102, "G201": G201, "G202": G202,
           "G301": G301, "G302": G302}
