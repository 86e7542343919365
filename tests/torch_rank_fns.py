"""Functions that the ranks of the port's multi-process tests run
(tests/test_torch_parallel.py, test_torch_halo.py, test_torch_sharded_solve.py,
test_torch_multiprocess.py) through parallel/worker.py ``launch``. They import
torch and the port only, take their inputs as .npz files written by the
test, and return plain numpy values."""

import dataclasses

import numpy as np
import torch

from deflatedmlmc_schwinger_tpu_torch.config import SolverConfig, TraceConfig
from deflatedmlmc_schwinger_tpu_torch.mg import MGSolver
from deflatedmlmc_schwinger_tpu_torch.ops.dirac import StencilOperator
from deflatedmlmc_schwinger_tpu_torch.parallel import (
    ShardedMGSolver,
    allgather_moments,
    halo_matvec,
    make_mesh,
    psum_moments,
    shard_coeffs,
)
from deflatedmlmc_schwinger_tpu_torch.parallel.halo import gather_blocks, local_block
from deflatedmlmc_schwinger_tpu_torch.trace import hutchinson, mlmc
from deflatedmlmc_schwinger_tpu_torch.trace.stats import RunningMoments
from deflatedmlmc_schwinger_tpu_torch.utils.checkpoint import load_hierarchy


def _operator(path: str) -> StencilOperator:
    return StencilOperator.from_numpy(np.load(path)["coeffs"], device="cpu")


def _mesh(shape, axis_names):
    return make_mesh(tuple(shape), tuple(axis_names), device="cpu")


def mesh_layout(shape, axis_names):
    """This rank's coordinates and the global ranks of each of its groups."""
    mesh = _mesh(shape, axis_names)
    if mesh is None:
        return None
    return dict(rank=mesh.rank, coords=dict(mesh.coords), shape=dict(mesh.shape),
                groups={k: (g.ranks, g.index) for k, g in mesh.groups.items()},
                world=mesh.world.ranks)


def batches_and_replicas(shape, axis_names):
    """shard_batch then global_values of a seeded batch; replicate of a tree
    that differs by rank; a ring exchange; an any-reduce."""
    from deflatedmlmc_schwinger_tpu_torch.parallel import replicate, shard_batch
    from deflatedmlmc_schwinger_tpu_torch.parallel.distributed import (
        all_any,
        global_values,
        ring_exchange,
    )

    mesh = _mesh(shape, axis_names)
    rng = np.random.default_rng(5)
    full = torch.from_numpy(rng.standard_normal((8, 6)) + 1j * rng.standard_normal((8, 6)))
    mine = shard_batch(full, mesh, "samples")
    tree = {"a": torch.full((3,), float(mesh.rank)), "b": [np.arange(2) + mesh.rank, "r%d" % mesh.rank]}
    got = replicate(tree, mesh)
    me = torch.tensor([float(mesh.rank)])
    from_next, from_prev = ring_exchange(me, me + 0.5, mesh.world)
    return dict(rows=mine.shape[0], first_row=mine[0].numpy(),
                gathered=global_values(mine, mesh, "samples"),
                replica=(got["a"].numpy(), got["b"][0], got["b"][1]),
                ring=(float(from_next), float(from_prev)),
                any_on_last=all_any(mesh.rank == mesh.size - 1, mesh.world),
                any_on_none=all_any(False, mesh.world))


def fail_on_rank(bad: int):
    import torch.distributed as dist

    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    dist.barrier()     # the others wait here until the launcher ends them
    return "unreachable"


def sleep_for(seconds: float):
    import time

    time.sleep(seconds)
    return "awake"


def halo_cases(cases, data_path: str):
    """For each (shape, axis_names, applications): the halo matvec applied
    that many times to the batch in the file, gathered whole (None on a rank
    the mesh leaves out)."""
    data = np.load(data_path)
    op = _operator(data_path)
    out = []
    for shape, axis_names, applications in cases:
        mesh = _mesh(shape, axis_names)
        if mesh is None:
            out.append(None)
            continue
        mv = halo_matvec(shard_coeffs(op, mesh, "x"), mesh)
        g = local_block(torch.from_numpy(data["v"]), mesh, op.nx, op.nt)
        for _ in range(applications):
            g = mv(g)
        out.append(gather_blocks(g, mesh).numpy())
    return out


def moments(shape, axis_names, es: np.ndarray):
    """psum_moments over the samples axis of this rank's share of ``es``,
    and allgather_moments of per-rank RunningMoments over all ranks."""
    mesh = _mesh(shape, axis_names)
    n = mesh.shape["samples"]
    mine = np.asarray(es).reshape(n, -1)[mesh.coords["samples"]]
    cnt, mre, mim, m2 = psum_moments(torch.from_numpy(mine), mesh.groups["samples"])
    local = RunningMoments()
    local.update_batch(np.arange(4, dtype=float) + (mesh.rank + 1) * 1j)
    merged = allgather_moments(local)
    return dict(psum=(float(cnt), float(mre), float(mim), float(m2)),
                merged=(merged.count, merged.mean, merged.m2))


def _solve_result(r) -> dict:
    return dict(x=r.x.numpy(), iters=r.iters.numpy(), resnorm=r.resnorm.numpy(),
                bnorm=r.bnorm.numpy(), stalled=r.stalled.numpy(), cycles=r.cycles)


def solve_cases(cases, hier_path: str, data_path: str, tol: float):
    """For each (shape, axis_names, smoother): ShardedMGSolver.solve of the
    batch in the file; under "replicated", MGSolver.solve per smoother."""
    hier = load_hierarchy(hier_path, "cpu", torch.complex128)
    b = torch.from_numpy(np.load(data_path)["b"])
    out = {"replicated": {}}
    for shape, axis_names, smoother in cases:
        scfg = SolverConfig(smoother=smoother)
        mesh = _mesh(shape, axis_names)
        out[(tuple(shape), smoother)] = _solve_result(
            ShardedMGSolver(hier, mesh, scfg).solve(b, tol))
        if smoother not in out["replicated"]:
            out["replicated"][smoother] = _solve_result(MGSolver(hier, scfg).solve(b, tol))
    return out


def _summary(r: dict) -> dict:
    out = dict(trace=complex(r["trace"]), std_dev=float(r["std_dev"]),
               rough_trace=complex(r["rough_trace"]), stalled_rows=int(r["stalled_rows"]))
    if "results" in r:
        out["nr_ests"] = [lev["nr_ests"] for lev in r["results"]]
        out["function_iters"] = [lev["function_iters"] for lev in r["results"]]
    else:
        out["nr_ests"] = r["nr_ests"]
        out["function_iters"] = r["function_iters"]
    return out


def estimator_cases(cases, hier_path: str, data_path: str):
    """For each (which, shape, axis_names, cfg_fields, probe_source):
    hutchinson or mlmc over the mesh (``shape`` None: no mesh) on the
    hierarchy in the file."""
    op = _operator(data_path)
    out = []
    for which, shape, axis_names, fields, probe_source in cases:
        hier = load_hierarchy(hier_path, "cpu", torch.complex128)
        mesh = None if shape is None else _mesh(shape, axis_names)
        fn = hutchinson if which == "hutchinson" else mlmc
        out.append(_summary(fn(op, TraceConfig(**fields), hier=hier, mesh=mesh,
                               verbose=False, probe_source=probe_source)))
    return out


def deflation_basis(shape, axis_names, cfg_fields: dict, hier_path: str, data_path: str):
    """hutchinson_deflation through the replicated solver and through the
    lattice-sharded one."""
    from deflatedmlmc_schwinger_tpu_torch.trace.deflation import hutchinson_deflation

    cfg = TraceConfig(**cfg_fields)
    op = _operator(data_path)
    hier = load_hierarchy(hier_path, "cpu", torch.complex128)
    solver = MGSolver(hier, cfg.solver)
    mesh = _mesh(shape, axis_names)
    fine = ShardedMGSolver(hier, mesh, cfg.solver)
    rep = hutchinson_deflation(op, solver, cfg)
    sh = hutchinson_deflation(op, solver, cfg, fine_solver=fine)
    return {name: dict(values=np.asarray(d.values), tr1=complex(d.tr1),
                       shape=tuple(d.U.shape))
            for name, d in (("replicated", rep), ("sharded", sh))}


def gateway_g302(cfg_fields: dict, x_shards: int):
    """What a rank started by gateway.G302(devices=N) runs
    (parallel/worker.py run_entry), on the CPU and with a small profile in
    the place of 'schwinger512'; with the rank's own allgather_moments check."""
    import os

    from deflatedmlmc_schwinger_tpu_torch import gateway
    from deflatedmlmc_schwinger_tpu_torch.parallel.worker import run_entry

    os.environ["DMLMC_X_SHARDS"] = str(x_shards)
    gateway._CONFIGS["schwinger512"] = dict(cfg_fields)
    out = run_entry("G302", "cpu")
    import torch.distributed as dist

    half = RunningMoments()
    half.update_batch(np.arange(4, dtype=float) + (dist.get_rank() + 1) * 1j)
    merged = allgather_moments(half)
    out["merged"] = (merged.count, merged.mean, merged.m2)
    return out


def cfg_fields(cfg: TraceConfig) -> dict:
    """A TraceConfig as the plain dict that travels to the ranks."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
