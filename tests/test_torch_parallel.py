"""The port's mesh, transport and moment reductions (parallel/mesh.py,
parallel/distributed.py, parallel/worker.py) on gloo ranks, against the JAX
package's mesh layout and ``psum_moments`` and the host Chan merge; and the
solvers' reduction hooks left off (``group=None``): no collective, and the
JAX package's iteration counts.

Tolerances: moments 1e-12 relative (float64 sums of 16 numbers, added in
another order); fgmres x 1e-9 absolute at a solve tolerance of 1e-10.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deflatedmlmc_schwinger_tpu.io import gauge as jax_gauge  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops import cplx  # noqa: E402
from deflatedmlmc_schwinger_tpu.ops.dirac import pair_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from deflatedmlmc_schwinger_tpu.parallel import psum_moments as jax_psum_moments  # noqa: E402
from deflatedmlmc_schwinger_tpu.solvers.fgmres import fgmres as jax_fgmres  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch import parallel  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.io import generate_operator  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.mg.cycle import gmres_smoother  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.parallel import distributed, make_mesh, worker  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.solvers.fgmres import fgmres  # noqa: E402
from deflatedmlmc_schwinger_tpu_torch.trace.stats import RunningMoments  # noqa: E402

import torch_parallel_setup as tps  # noqa: E402

SHAPES = [((4,), ("samples",)), ((2, 2), ("samples", "x")), ((1, 4), ("samples", "x")),
          ((2,), ("samples",))]


def test_exports_match_the_jax_package():
    import deflatedmlmc_schwinger_tpu.parallel as jax_parallel

    names = {n for n in dir(jax_parallel) if not n.startswith("_")
             and callable(getattr(jax_parallel, n))}
    assert names <= set(dir(parallel))


def test_one_process_mesh_needs_no_group():
    mesh = make_mesh((1, 1), ("samples", "x"), device="cpu")
    assert mesh.shape == {"samples": 1, "x": 1} and mesh.coords == {"samples": 0, "x": 0}
    assert mesh.rank == 0 and mesh.size == 1 and not parallel.mesh.spans_processes(mesh)
    assert make_mesh(device="cpu").axis_names == ("samples",)
    with pytest.raises(ValueError, match="needs 4 ranks, have 1"):
        make_mesh((2, 2), ("samples", "x"), device="cpu")
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(parallel.shard_batch(x, mesh), x)
    assert parallel.replicate({"a": x}, mesh)["a"] is x
    assert distributed.initialize(device="cpu") == 0      # WORLD_SIZE unset: no-op
    m = RunningMoments()
    m.update_batch(np.array([1 + 1j, 2 - 1j, 0.5j]))
    assert parallel.allgather_moments(m) is m


@pytest.fixture(scope="module")
def layouts():
    return {shape: tps.run_ranks("mesh_layout", 4, shape, names) for shape, names in SHAPES}


@pytest.mark.parametrize("shape,names", SHAPES, ids=[str(s) for s, _ in SHAPES])
def test_rank_layout_is_row_major_like_the_jax_mesh(layouts, shape, names):
    """Rank r sits where device r sits in the JAX package's mesh
    (np.array(devices[:n]).reshape(shape)), and each axis group holds the
    ranks that differ from it in that coordinate only."""
    jmesh = jax_make_mesh(shape, names)
    ids = np.vectorize(lambda d: d.id)(np.asarray(jmesh.devices))
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    assert np.array_equal(ids, grid)     # the JAX mesh is row-major over device ids
    for rank, got in enumerate(layouts[shape]):
        if rank >= grid.size:
            assert got is None
            continue
        where = tuple(int(c) for c in np.argwhere(grid == rank)[0])
        assert got["coords"] == dict(zip(names, where))
        assert got["shape"] == dict(jmesh.shape)
        assert got["world"] == tuple(range(grid.size))
        for ax, name in enumerate(names):
            line = tuple(int(r) for r in np.moveaxis(grid, ax, -1)[where[:ax] + where[ax + 1:]])
            assert got["groups"][name] == (line, where[ax])


def test_batches_replicas_ring_and_any():
    ranks = tps.run_ranks("batches_and_replicas", 4, (4,), ("samples",))
    rng = np.random.default_rng(5)
    full = rng.standard_normal((8, 6)) + 1j * rng.standard_normal((8, 6))
    for r, got in enumerate(ranks):
        assert got["rows"] == 2 and np.array_equal(got["first_row"], full[2 * r])
        assert np.array_equal(got["gathered"], full)      # global sample order
        a, b0, b1 = got["replica"]                        # rank 0's tree everywhere
        assert np.array_equal(a, np.zeros(3)) and np.array_equal(b0, [0, 1]) and b1 == "r0"
        assert got["ring"] == ((r + 1) % 4, (r - 1) % 4 + 0.5)
        assert got["any_on_last"] is True and got["any_on_none"] is False


def test_moments_match_jax_psum_and_host_merge():
    rng = np.random.default_rng(11)
    es = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    ranks = tps.run_ranks("moments", 4, (4,), ("samples",), es)
    mesh = jax_make_mesh((4,), ("samples",))
    spec = jax.sharding.PartitionSpec("samples", None)
    f = jax.jit(jax.shard_map(lambda a, b: jax_psum_moments(a, b, "samples"), mesh=mesh,
                              in_specs=(spec,) * 2, out_specs=jax.sharding.PartitionSpec()))
    jcnt, jre, jim, jm2 = (float(v) for v in f(jnp.asarray(es.real).reshape(4, 4),
                                               jnp.asarray(es.imag).reshape(4, 4)))
    ref = RunningMoments()
    ref.update_batch(es)
    want = RunningMoments()
    for r in range(4):
        part = RunningMoments()
        part.update_batch(np.arange(4, dtype=float) + (r + 1) * 1j)
        want = want.merge(part)
    for got in ranks:
        cnt, mre, mim, m2 = got["psum"]
        assert cnt == jcnt == 16
        np.testing.assert_allclose([mre, mim, m2], [jre, jim, jm2], rtol=1e-12)
        np.testing.assert_allclose(complex(mre, mim), ref.mean, rtol=1e-12)
        np.testing.assert_allclose(m2, ref.m2, rtol=1e-12)
        n, mean, mm2 = got["merged"]
        assert n == want.count == 16
        assert abs(mean - want.mean) < 1e-12 and abs(mm2 - want.m2) < 1e-12 * want.m2


def test_psum_moments_clamps_cancelled_m2():
    """The raw-sum form cancels when |mean| >> std; m2 never goes negative."""
    es = torch.full((8,), 1.0e4 + 0j, dtype=torch.complex64) + 1e-4
    cnt, mre, mim, m2 = distributed.psum_moments(es, None)
    assert float(cnt) == 8 and float(m2) >= 0.0


def test_a_failing_rank_ends_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        tps.run_ranks("fail_on_rank", 2, 1)


def test_a_hanging_launch_is_cut_at_its_timeout(monkeypatch):
    assert tps.run_ranks("sleep_for", 2, 0.0) == ["awake", "awake"]
    monkeypatch.setattr(tps, "LAUNCH_TIMEOUT_S", 8.0)
    with pytest.raises(RuntimeError, match="did not end within 8 s"):
        tps.run_ranks("sleep_for", 2, 600.0)


def test_hooks_off_make_no_collective_and_match_jax(monkeypatch):
    """fgmres(group=None, pred_group=None) and gmres_smoother(group=None)
    never reach the transport helper, and fgmres takes the JAX package's
    iteration counts on the same operator and right-hand sides."""
    def refuse(*a, **k):
        raise AssertionError("a collective was made with the hooks off")

    for name in ("all_sum", "all_any", "all_gather_cat", "ring_exchange"):
        monkeypatch.setattr(distributed, name, refuse)
    nx, nt, seed = 16, 16, 1
    op = generate_operator(nx, nt, tps.MASS, beta=tps.BETA, seed=seed, device="cpu")
    pop = pair_operator(jax_gauge.generate_operator(nx, nt, tps.MASS, beta=tps.BETA, seed=seed))
    rng = np.random.default_rng(7)
    b = rng.standard_normal((4, op.n)) + 1j * rng.standard_normal((4, op.n))
    kw = dict(tol=1e-10, restart=40, max_restarts=20)
    got = fgmres(op.matvec, torch.from_numpy(b), **kw)
    ref = jax_fgmres(pop.matvec, cplx.from_complex(b), **kw)
    assert np.array_equal(got.iters.numpy(), np.asarray(ref.iters))
    assert got.cycles == int(ref.cycles)
    assert np.abs(got.x.numpy() - cplx.to_complex(ref.x)).max() < 1e-9
    x = gmres_smoother(op.matvec, torch.from_numpy(b), 4)
    assert torch.isfinite(x).all()


def test_initialize_reads_the_standard_environment(monkeypatch):
    """initialize() takes rank and world size from torch's standard
    variables and picks gloo for CPU ranks; the call itself is mocked."""
    import torch.distributed as dist

    seen = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for k, v in dict(RANK="1", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="29123").items():
        monkeypatch.setenv(k, v)
    assert distributed.initialize(device="cpu") == 1
    assert seen["backend"] == "gloo" and seen["world_size"] == 2 and seen["rank"] == 1
    assert seen["init_method"] == "tcp://127.0.0.1:29123"
    assert seen["timeout"].total_seconds() > 0
    assert worker.free_port() > 0
