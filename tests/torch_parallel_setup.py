"""Shared set-up of the port's parallel tests: one generated operator in
both packages, the JAX package's hierarchy carried to the port through a
checkpoint file, and the files the ranks read. The pytest process holds the
JAX side (8 virtual CPU devices, tests/conftest.py); the port's ranks are
gloo processes started through parallel/worker.py that import no jax."""

import os
import sys

import numpy as np

import jax.numpy as jnp

from deflatedmlmc_schwinger_tpu.config import TraceConfig as JaxTraceConfig
from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge
from deflatedmlmc_schwinger_tpu.mg import setup_hierarchy as jax_setup
from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator
from deflatedmlmc_schwinger_tpu.utils.checkpoint import save_hierarchy as jax_save_hierarchy
from deflatedmlmc_schwinger_tpu_torch.config import TraceConfig
from deflatedmlmc_schwinger_tpu_torch.parallel.worker import launch

import torch

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
MASS, BETA = -0.29, 5.0
SQUARE = dict(nx=16, nt=16, seed=1)        # generated:16x16:beta=5.0:seed=1
OBLONG = dict(nx=24, nt=16, seed=3)        # a non-square lattice, X = 24
LAUNCH_TIMEOUT_S = 400.0


def base_fields(nx: int, nt: int, seed: int, **kw) -> dict:
    """The fields both packages' TraceConfig share for the 3-level test
    hierarchy with aggrs = (4, 4) (t-strips of 4 sites)."""
    base = dict(
        matrix=f"generated:{nx}x{nt}:beta={BETA}:seed={seed}", mass=MASS,
        latt_dims=(nt, nx), max_nr_levels=3, aggrs=(4, 4), dof=(2, 4, 4),
        accuracy_mg_eigvs="low", test_vectors_type="RSVs", use_permuted=False,
        trace_tol=1e-2, nr_deflat_vctrs=16, mlmc_deflat_vctrs=(0, 0),
        chebyshev_degree=30, subspace_iters=3, probe_batch=8, mlmc_levels_to_skip=(),
    )
    base.update(kw)
    return base


def configs(lattice: dict, **kw):
    """(port TraceConfig, JAX TraceConfig), complex128 both."""
    fields = base_fields(**lattice, **kw)
    return (TraceConfig(dtype=torch.complex128, **fields),
            JaxTraceConfig(dtype=jnp.complex128, **fields))


def build(tmp_dir, lattice: dict, batch: int = 8, seed: int = 3) -> dict:
    """The operator in both packages, the JAX hierarchy saved for the port,
    and a seeded (batch, n) complex batch; returns a dict with the JAX
    objects and the two file paths the ranks read."""
    nx, nt, gseed = lattice["nx"], lattice["nt"], lattice["seed"]
    cfg, jcfg = configs(lattice)
    jop = jax_gauge.generate_operator(nx, nt, MASS, beta=BETA, seed=gseed)
    pop = pair_operator(jop)
    jh = jax_setup(pop, jcfg)
    hier_path = str(tmp_dir / f"hierarchy_{nx}x{nt}.npz")
    jax_save_hierarchy(jh, hier_path)
    rng = np.random.default_rng(seed)
    n = 2 * nx * nt
    v = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    coeffs = np.asarray(jop.coeffs).astype(np.complex128)
    data_path = str(tmp_dir / f"data_{nx}x{nt}.npz")
    np.savez(data_path, coeffs=coeffs, v=v, b=v)
    return dict(cfg=cfg, jcfg=jcfg, jop=jop, pop=pop, jh=jh, v=v, coeffs=coeffs,
                hier_path=hier_path, data_path=data_path, nx=nx, nt=nt, n=n)


def run_ranks(fn: str, nprocs: int, *args):
    """``torch_rank_fns.fn(*args)`` on ``nprocs`` gloo ranks on the CPU, one
    thread each; returns the ranks' values in rank order."""
    if TESTS_DIR not in sys.path:      # the ranks inherit sys.path
        sys.path.insert(0, TESTS_DIR)
    return launch(f"torch_rank_fns:{fn}", nprocs, args=args, device="cpu",
                  timeout_s=LAUNCH_TIMEOUT_S)
