"""Fine-level stencil kernels K1-K3 (CUDA C++, ``csrc/stencil.cu``), their
plain PyTorch versions, launch counters, and the build-and-load code.

Counterpart of ``deflatedmlmc_schwinger_tpu/ops/pallas_stencil.py``:

  * K1 ``stencil_matvec``      y = D v
  * K2 ``stencil_residual``    r = b - D x, one pass
    Both launch the row kernel: a block stages whole lattice rows of a
    chunk of probes in shared memory and keeps its sites' coefficients in
    registers over the chunk, with the tiling, chunking and copy path that
    ``launch_plan`` picks per shape. ``stencil_rows_plain`` replays that
    algorithm in plain PyTorch for the CPU tests.
    ``stencil_matvec_per_site`` and ``stencil_residual_per_site`` are the
    first kernels, one thread per site, kept as the yardsticks the row
    kernel is timed against; neither is on any path.
  * K3 ``stencil_poly_smooth`` x = p(D) r through the residual recurrence
    step_k = cur_k / theta_k, x += step_k, cur_{k+1} = cur_k - D step_k.
    On the card this is the tiled kernel: a launch takes up to
    ``FUSE_DEPTH`` roots on a window with a halo, each thread a strip of
    ``STRIP`` sites whose coefficients stay in its registers and only the
    window's cur in shared memory, so a call with m roots is
    ceil(m / FUSE_DEPTH) launches.
    ``stencil_poly_smooth_per_root`` is the earlier kernel, one launch per
    root, kept as the yardstick the tiled one is timed against;
    ``stencil_poly_smooth_tiled_plain`` replays the tiled kernel's
    algorithm in plain PyTorch for the CPU tests. Neither is on any path.

The public functions take complex tensors: coefficients of shape
(2, 2, 5, X, T) and vectors of shape (..., 2*X*T). A CUDA tensor launches
the kernel (or raises); a CPU tensor takes the plain version. There is no
fallback from one to the other.

Build: the first launch compiles ``csrc/*.cu`` with ``nvcc`` for sm_90a into
a shared library with a plain C interface, under ``_build/<source hash>/``
beside this package's sources, and loads it with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from types import MappingProxyType
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

# (dx, dt) offsets; tap 0 is the on-site term (ops/dirac.py TAPS).
TAPS: Tuple[Tuple[int, int], ...] = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))

_PKG_DIR = Path(__file__).resolve().parent.parent
_CSRC = _PKG_DIR / "csrc"
_BUILD_ROOT = _PKG_DIR / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}

# The tiled K3 (csrc/stencil.cu poly_tiled_kernel), by dtype, fixed in the
# source: the window of lattice sites one thread block holds, the strip of
# adjacent t-sites each thread owns (their coefficients live in its
# registers, so the registers bound the window), the probes a block runs
# through the roots together, and the most roots one launch is given.
# bench_torch/k3_sweep.py and PERF.md give the measurements behind them.
MAX_FUSE = 4                     # kMaxFuse in csrc/stencil.cu
WINDOW = MappingProxyType({torch.complex64: (24, 40), torch.complex128: (16, 32)})
STRIP = MappingProxyType({torch.complex64: 1, torch.complex128: 1})
PROBES_PER_PASS = MappingProxyType({torch.complex64: 1, torch.complex128: 1})
FUSE_DEPTH = MappingProxyType({torch.complex64: 4, torch.complex128: 4})

# The row kernel of K1/K2 (csrc/stencil.cu stencil_rows_kernel): limits
# fixed in the source, and what launch_plan aims at (bench_torch/k12_sweep.py
# and PERF.md give the measurements behind these choices).
ROWS_MAX_THREADS = 512           # kRowsMaxThreads
ROWS_MAX_STAGES = 8              # kRowsMaxStages
ROWS_BAR_BYTES = 64              # kRowsBarBytes: the stages' mbarriers
MAX_SMEM = 232448                # kMaxSmem: dynamic shared memory of a block
SM_SMEM = 233472                 # shared memory of one SM
SM_REGS = 65536                  # registers of one SM
SM_MAX_BLOCKS = 32               # resident blocks of one SM
ROWS_REGS = 128                  # registers per thread (ptxas: 111-128)
ROWS_THREADS = 128               # threads a tile aims at
ROWS_STAGES = 3                  # probes staged ahead, where shared memory allows

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: dict = {}                  # (wrapper name, dtype suffix) -> ctypes function


# ---- plain PyTorch versions --------------------------------------------------

def stencil_matvec_plain(coeffs: torch.Tensor, v: torch.Tensor, nx: int,
                         nt: int) -> torch.Tensor:
    """y[s,x,t] = sum_{s',k} C[s,s',k,x,t] v[s',(x+dx_k)%X,(t+dt_k)%T] with
    torch.roll (out[i] = v[(i+d) % n])."""
    g = v.reshape(v.shape[:-1] + (2, nx, nt))
    out = torch.zeros_like(g)
    for k, (dx, dt) in enumerate(TAPS):
        s = g
        if dx:
            s = torch.roll(s, shifts=-dx, dims=-2)
        if dt:
            s = torch.roll(s, shifts=-dt, dims=-1)
        for a in range(2):
            if k == 0:
                out[..., a, :, :] += coeffs[a, a, 0] * s[..., a, :, :]
            else:
                out[..., a, :, :] += (coeffs[a, 0, k] * s[..., 0, :, :]
                                      + coeffs[a, 1, k] * s[..., 1, :, :])
    return out.reshape(v.shape)


def stencil_residual_plain(coeffs: torch.Tensor, b: torch.Tensor,
                           x: torch.Tensor, nx: int, nt: int) -> torch.Tensor:
    return b - stencil_matvec_plain(coeffs, x, nx, nt)


def stencil_poly_smooth_plain(coeffs: torch.Tensor, r: torch.Tensor,
                              roots: Sequence[complex], nx: int, nt: int,
                              with_residual: bool = False):
    """The recurrence of mg/cycle.py poly_smoother on the plain matvec:
    D is applied m times with ``with_residual`` (returns (x, r - D x)),
    m - 1 times otherwise (returns (x, None))."""
    x = None
    cur = r
    for k, th in enumerate(roots):
        step = cur * (1.0 / complex(th))
        x = step if x is None else x + step
        if k == len(roots) - 1 and not with_residual:
            break
        cur = cur - stencil_matvec_plain(coeffs, step, nx, nt)
    return x, (cur if with_residual else None)


class RowsPlan(NamedTuple):
    """How the row kernel runs K1/K2 at one shape (``launch_plan``)."""
    rows: int            # R: lattice rows of a tile
    cols: int            # W: columns of a tile (T: whole rows)
    probes_per_block: int
    stages: int          # probes staged ahead in shared memory
    bulk: bool           # whole rows by cp.async.bulk; else cp.async per element
    smem: int            # dynamic shared-memory bytes of a block
    threads: int
    tiles: int
    chunks: int

    def c_array(self, B: int, nx: int, nt: int, dev: int) -> ctypes.Array:
        """The launch as the C entry takes it: B, X, T, the plan, device."""
        return (ctypes.c_int * 10)(B, nx, nt, self.rows, self.cols, self.probes_per_block,
                                   self.stages, int(self.bulk), self.smem, dev)


def launch_plan(B: int, nx: int, nt: int, itemsize: int, sms: int, *,
                residual: bool, aligned: bool = True, rows: Optional[int] = None,
                probes_per_block: Optional[int] = None,
                stages: Optional[int] = None) -> RowsPlan:
    """The row kernel's plan for B probes on an nx x nt lattice with
    ``itemsize``-byte complex elements on a card with ``sms`` SMs.
    ``aligned``: the vectors' addresses are 16-byte aligned. ``rows``,
    ``probes_per_block`` and ``stages`` override the choice (k12_sweep).

    A thread owns two adjacent sites in complex64 and one in complex128.
    A tile is R whole rows, R chosen for about ROWS_THREADS threads, and
    smaller where that leaves fewer blocks than SMs even with one probe
    each; a row too wide for ROWS_MAX_THREADS threads is cut into column
    tiles. Rows are copied whole (bulk) when they are whole, their byte
    length is a multiple of 16 and the vectors are aligned. ``occupancy``,
    the blocks an SM holds by their registers, sets the rest: the probes
    are cut into chunks so that the grid is about one such wave (fewer
    chunks reload the coefficients less often, more fill the card), and up
    to ROWS_STAGES probes of a chunk are staged ahead, as many as leave an
    SM's shared memory to that many blocks."""
    if min(B, nx, nt) < 1:
        raise ValueError(f"no launch plan for B={B} on {nx} x {nt}")
    spt = 2 if itemsize == 8 else 1
    cols = min(nt, ROWS_MAX_THREADS * spt)
    bulk = aligned and cols == nt and (nt * itemsize) % 16 == 0
    tiles_t = -(-nt // cols)
    if rows is None:
        rows = max(1, min(nx, ROWS_THREADS * spt // cols))
        while rows > 1 and -(-nx // rows) * tiles_t * B < sms:
            rows //= 2
    threads = -(-rows * cols // spt)
    occupancy = max(1, min(SM_MAX_BLOCKS, SM_REGS // (threads * ROWS_REGS)))
    align = 16 // itemsize
    pitch = nt if bulk else -(-(cols + 2) // align) * align
    stage_bytes = (2 * (rows + 2) + (2 * rows if residual else 0)) * pitch * itemsize
    tiles = -(-nx // rows) * tiles_t
    if probes_per_block is None:
        chunks = min(B, max(1, round(occupancy * sms / tiles)))
        probes_per_block = -(-B // chunks)
    chunks = -(-B // probes_per_block)
    if stages is None:
        budget = min(MAX_SMEM, SM_SMEM // occupancy - 1024) - ROWS_BAR_BYTES
        stages = max(1, min(ROWS_STAGES, probes_per_block, budget // stage_bytes))
    smem = ROWS_BAR_BYTES + stages * stage_bytes
    if (threads > ROWS_MAX_THREADS or smem > MAX_SMEM or rows > nx
            or not 1 <= stages <= ROWS_MAX_STAGES or chunks > 65535):
        raise ValueError(f"the row kernel cannot run R={rows}, W={cols}, "
                         f"{stages} stages ({smem} B) for B={B} on {nx} x {nt}")
    return RowsPlan(rows, cols, probes_per_block, stages, bulk, smem, threads,
                    tiles, chunks)


def stencil_rows_plain(coeffs: torch.Tensor, v: torch.Tensor, nx: int, nt: int,
                       b: Optional[torch.Tensor] = None, *,
                       plan: RowsPlan) -> torch.Tensor:
    """The row kernel's algorithm in plain PyTorch (used by the tests
    only): D v, or b - D v when ``b`` is given, block by block of ``plan``.
    A block stages the rows x0-1 .. x0+R of its chunk of probes (wrapped;
    a lattice of fewer rows repeats in them), with whole rows wrapping t+-1
    inside the row on the bulk path and a tile's columns plus the two
    neighbouring columns otherwise, then sums the taps in the kernel's
    order. Every site must be written by exactly one block."""
    g = v.reshape(-1, 2, nx, nt)
    gb = None if b is None else b.reshape(-1, 2, nx, nt)
    B = g.shape[0]
    out = torch.full_like(g, complex(float("nan"), float("nan")))
    hits = torch.zeros((nx, nt), dtype=torch.int64)
    R, W = plan.rows, plan.cols
    for p0 in range(0, B, plan.probes_per_block):
        pr = slice(p0, min(B, p0 + plan.probes_per_block))
        for x0 in range(0, nx, R):
            rows = min(R, nx - x0)
            slot_rows = [(x0 - 1 + j) % nx for j in range(rows + 2)]
            for t0 in range(0, nt, W):
                cols = min(W, nt - t0)
                c = torch.arange(cols)
                if plan.bulk:
                    colidx = torch.arange(nt)
                    left, right = (c - 1) % nt, (c + 1) % nt
                else:
                    colidx = torch.cat([t0 + c, torch.tensor([(t0 - 1) % nt,
                                                              (t0 + cols) % nt])])
                    left = torch.where(c > 0, c - 1, cols)
                    right = torch.where(c < cols - 1, c + 1, cols + 1)
                st = g[pr][:, :, slot_rows][:, :, :, colidx]
                mid = st[:, :, 1:rows + 1]
                taps = (mid[..., :cols], mid[..., right], mid[..., left],
                        st[:, :, 2:rows + 2, :cols], st[:, :, 0:rows, :cols])
                cw = coeffs[:, :, :, x0:x0 + rows, t0:t0 + cols]
                for a in range(2):
                    acc = torch.zeros_like(taps[0][:, 0])
                    for k in range(5):
                        for bb in range(2):
                            if a != bb and k == 0:
                                continue
                            acc = acc + cw[a, bb, k] * taps[k][:, bb]
                    if gb is not None:
                        acc = gb[pr, a, x0:x0 + rows, t0:t0 + cols] - acc
                    out[pr, a, x0:x0 + rows, t0:t0 + cols] = acc
                if p0 == 0:
                    hits[x0:x0 + rows, t0:t0 + cols] += 1
    if not bool((hits == 1).all()):
        raise AssertionError("the plan's tiles do not cover every site once")
    return out.reshape(v.shape)


def fused_passes(m: int, depth: int):
    """How m roots are spread over ceil(m / depth) launches of the tiled K3:
    (first root, number of roots) per launch, as evenly as they go (a launch
    with fewer roots needs a shallower halo, so 16 roots at depth 3 are
    3+3+3+3+2+2 and not five threes and a one)."""
    if m < 1 or depth < 1:
        raise ValueError("the polynomial smoother needs at least one root")
    n_pass = -(-m // depth)
    base, extra = divmod(m, n_pass)
    out, k = [], 0
    for i in range(n_pass):
        n = base + (1 if i < extra else 0)
        out.append((k, n))
        k += n
    return out


def poly_launches(m: int, depth: int, with_residual: bool):
    """The launches of a tiled K3 call of m roots, at most ``depth`` each:
    [(first root, roots, whether its last root applies D)], and the halo
    that every launch's tiles leave, the most applications of D in one
    launch (so a call's launches share one tiling)."""
    out = [(first, n, first + n < m or with_residual)
           for first, n in fused_passes(m, depth)]
    return out, max(n if apply_last else n - 1 for _, n, apply_last in out)


def stencil_poly_smooth_tiled_plain(coeffs: torch.Tensor, r: torch.Tensor,
                                    roots: Sequence[complex], nx: int, nt: int,
                                    with_residual: bool = False, *,
                                    window: Tuple[int, int] = (32, 32),
                                    depth: int = 4, strip: int = 1, probes: int = 1):
    """The tiled K3's algorithm in plain PyTorch, tile by tile (used by the
    tests only). The lattice is cut into tiles of ``window`` less the halo
    of ``poly_launches`` on each side. A launch that applies D h times loads
    each tile's window from the lattice's periodic extension, h sites before
    the tile (a lattice smaller than the window repeats in it), for the
    probes in passes of ``probes`` (the last pass padded with zero probes,
    computed and dropped), and runs its roots on it. Root j applies D on the
    rows j + 1 .. H - j, H the last row that the tile's owned rows need
    (fewer in a ragged tile), and on every column, a column's t +- 1
    neighbours wrapping within the window's row. ``strip`` (the t-sites a
    thread owns) must divide the window's width; a strip takes t +- 1 inside
    it from its own values, which are the window's. Rows outside j + 1 ..
    H - j and columns outside j + 1 .. WT - 2 - j are then filled with NaN
    (the kernel leaves old values there, or values no valid site reads), so
    a read of one would show. x and cur are written on the tile only,
    ragged tiles cut at the lattice's edge."""
    roots = tuple(complex(t) for t in roots)
    WX, WT = window
    if WT % strip:
        raise ValueError(f"a strip of {strip} sites does not divide a window row of {WT}")
    launches, halo = poly_launches(len(roots), depth, with_residual)
    tx, tt = WX - 2 * halo, WT - 2 * halo
    if tx < 1 or tt < 1:
        raise ValueError(f"a halo of depth {halo} leaves no tile in a {WX} x {WT} window")
    shape = r.shape
    cur = r.reshape((-1, 2, nx, nt))
    B = cur.shape[0]
    cur = torch.cat([cur, cur.new_zeros((-B % probes, 2, nx, nt))])
    x = torch.zeros_like(cur)
    nan = complex(float("nan"), float("nan"))
    cols = torch.arange(WT)
    t_up, t_dn = (cols + 1) % WT, (cols - 1) % WT
    for first, n, apply_last in launches:
        h = n if apply_last else n - 1
        new_cur = torch.full_like(cur, nan)
        for x0 in range(0, nx, tx):
            ox = min(tx, nx - x0)
            H = min(WX - 2, ox + 2 * h - 2)
            for t0 in range(0, nt, tt):
                ot = min(tt, nt - t0)
                ix = (x0 - h + torch.arange(WX)) % nx
                it = (t0 - h + cols) % nt
                win = cur[:, :, ix][:, :, :, it]
                cw = coeffs[:, :, :, ix][:, :, :, :, it]
                xacc = torch.zeros_like(win)
                for j in range(n):
                    step = win * (1.0 / roots[first + j])
                    xacc = xacc + step
                    if j >= h:
                        break
                    taps = (step, step[..., t_up], step[..., t_dn],
                            torch.roll(step, -1, dims=-2), torch.roll(step, 1, dims=-2))
                    d_step = torch.zeros_like(step)
                    for k, s in enumerate(taps):
                        for a in range(2):
                            if k == 0:
                                d_step[:, a] += cw[a, a, 0] * s[:, a]
                            else:
                                d_step[:, a] += cw[a, 0, k] * s[:, 0] + cw[a, 1, k] * s[:, 1]
                    rows, cs = slice(j + 1, H - j + 1), slice(j + 1, WT - 1 - j)
                    nxt = torch.full_like(win, nan)
                    nxt[:, :, rows, cs] = win[:, :, rows, cs] - d_step[:, :, rows, cs]
                    win = nxt
                x[:, :, x0:x0 + ox, t0:t0 + ot] += xacc[:, :, h:h + ox, h:h + ot]
                new_cur[:, :, x0:x0 + ox, t0:t0 + ot] = win[:, :, h:h + ox, h:h + ot]
        if apply_last:
            cur = new_cur
    x, cur = x[:B], cur[:B]
    return x.reshape(shape), (cur.reshape(shape) if with_residual else None)


# ---- build and load ----------------------------------------------------------

def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the stencil kernels are built from "
                       f"{_CSRC} at first use and need the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources lives (keyed by a hash of
    the sources and the compiler flags)."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libdmlmc_stencil.so"


def _build() -> Path:
    """Compile csrc/*.cu into the shared library unless it already exists.
    Writes to a temporary name and renames, so concurrent builds never
    load a half-written file. What ptxas reports for each kernel
    (registers, shared memory, spills) goes to build.log beside it."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [nvcc, *_NVCC_FLAGS, "-o", tmp, *cu]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        out.with_name("build.log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            for sfx in _SUFFIX.values():
                fns = {   # the row kernel: pointers, RowsPlan.c_array, stream
                    "stencil_matvec": ("matvec", [P, P, P, P, P]),
                    "stencil_residual": ("residual", [P, P, P, P, P, P]),
                    "stencil_matvec_per_site": ("matvec_per_site", [P, P, P, I, I, I, I, P]),
                    "stencil_residual_per_site":
                        ("residual_per_site", [P, P, P, P, I, I, I, I, P]),
                    "stencil_poly_step": ("poly_step", [P, P, P, P, D, D, I, I, I, I, I, P]),
                    "stencil_poly_tiled": ("poly_tiled", [P, P, P, P, P] + [I] * 7 + [P]),
                    # K4 (ops/block_kernels.py): seven pointers, 1/theta, cfg, stream
                    "coarse_bsr": ("coarse_bsr", [P] * 7 + [D, D, P, P]),
                }
                for key, (entry, argtypes) in fns.items():
                    fn = getattr(lib, f"dmlmc_stencil_{entry}_{sfx}")
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    _fns[(key, sfx)] = fn
            _lib = lib
        return _lib


def _fn(name: str, sfx: str):
    """The library's entry for wrapper ``name`` and dtype suffix ``sfx``."""
    if not _fns:
        load_library()
    return _fns[(name, sfx)]


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _raw_stream(dev: int) -> int:
    """The current stream of device ``dev`` (the capture stream under CUDA
    graph capture) as an integer, by PyTorch's own cheapest query."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(dev)
    return torch.cuda.current_stream(dev).cuda_stream


# Coefficient tensors already validated: id -> (what the validation saw, the
# result). A new tensor at a reused id or address differs in some field of
# the key and is validated anew.
_coeff_cache: dict = {}
_COEFF_CACHE_MAX = 256


def _coeff_entry(coeffs: torch.Tensor, nx: int, nt: int):
    """Validate a coefficient tensor (once per tensor and lattice); returns
    ((dtype suffix, itemsize), its device)."""
    device = coeffs.device
    key = (coeffs.data_ptr(), coeffs.shape, coeffs.stride(), coeffs.dtype, device, nx, nt)
    hit = _coeff_cache.get(id(coeffs))
    if hit is not None and hit[0] == key:
        return hit[1], device
    if coeffs.dtype not in _SUFFIX:
        raise TypeError(f"stencil kernels take complex64/complex128, got {coeffs.dtype}")
    if tuple(coeffs.shape) != (2, 2, 5, nx, nt):
        raise ValueError(f"coefficients must be (2, 2, 5, {nx}, {nt}), "
                         f"got {tuple(coeffs.shape)}")
    if not coeffs.is_contiguous():
        raise ValueError("stencil operands must be contiguous")
    entry = (_SUFFIX[coeffs.dtype], coeffs.element_size())
    if len(_coeff_cache) >= _COEFF_CACHE_MAX:
        _coeff_cache.clear()
    _coeff_cache[id(coeffs)] = (key, entry)
    return entry, device


def _check_operands(coeffs: torch.Tensor, nx: int, nt: int,
                    *vecs: torch.Tensor) -> Tuple[str, int, int]:
    """Validate the operands of a launch (any device: the tests call it on
    CPU and meta tensors); returns (dtype suffix, itemsize, batch size B)."""
    (sfx, itemsize), device = _coeff_entry(coeffs, nx, nt)
    v0 = vecs[0]
    for t in vecs:
        if t.device != device:
            raise ValueError("stencil operands must share one CUDA device")
        if t.dtype != coeffs.dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs {coeffs.dtype}")
        if not t.is_contiguous():
            raise ValueError("stencil operands must be contiguous")
        if t.shape != v0.shape:
            raise ValueError(f"shape mismatch: {tuple(t.shape)} vs {tuple(v0.shape)}")
    n = 2 * nx * nt
    if v0.dim() == 0 or v0.shape[-1] != n:
        raise ValueError(f"vectors must be (..., {n}), got {tuple(v0.shape)}")
    return sfx, itemsize, v0.numel() // n


def _dispatch(t: torch.Tensor) -> bool:
    """True -> launch the CUDA kernel; False -> plain version (CPU only)."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no stencil kernel for device {t.device}")


# (residual, B, X, T, itemsize, aligned, device) -> the plan's C array
_plans: dict = {}
_sms: dict = {}                  # device index -> SM count


def _plan_for(residual: bool, B: int, nx: int, nt: int, itemsize: int,
              aligned: bool, dev: int) -> ctypes.Array:
    key = (residual, B, nx, nt, itemsize, aligned, dev)
    arr = _plans.get(key)
    if arr is None:
        sms = _sms.get(dev)
        if sms is None:
            sms = _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = launch_plan(B, nx, nt, itemsize, sms, residual=residual, aligned=aligned)
        arr = _plans[key] = plan.c_array(B, nx, nt, dev)
    return arr


def _launch_rows(name: str, sfx: str, itemsize: int, coeffs: torch.Tensor,
                 b: Optional[torch.Tensor], v: torch.Tensor, out: torch.Tensor,
                 B: int, nx: int, nt: int, plan: Optional[RowsPlan] = None) -> None:
    """One launch of the row kernel (K1 with ``b`` None, else K2) on
    validated CUDA operands, with ``plan`` or the cached plan of the shape."""
    dev = v.device.index
    ptrs = (coeffs.data_ptr(), v.data_ptr(), out.data_ptr()) if b is None else (
        coeffs.data_ptr(), b.data_ptr(), v.data_ptr(), out.data_ptr())
    if plan is None:
        aligned = not (ptrs[1] | ptrs[2] | ptrs[-1]) & 15
        arr = _plan_for(b is not None, B, nx, nt, itemsize, aligned, dev)
    else:
        arr = plan.c_array(B, nx, nt, dev)
    _check(_fn(name, sfx)(*ptrs, arr, _raw_stream(dev)), name)


# ---- public wrappers ---------------------------------------------------------

def stencil_matvec(coeffs: torch.Tensor, v: torch.Tensor, nx: int,
                   nt: int) -> torch.Tensor:
    """K1: y = D v for complex v of shape (..., 2*nx*nt), by the row kernel."""
    if not _dispatch(v):
        return stencil_matvec_plain(coeffs, v, nx, nt)
    sfx, itemsize, B = _check_operands(coeffs, nx, nt, v)
    y = torch.empty_like(v)
    if B:
        _launch_rows("stencil_matvec", sfx, itemsize, coeffs, None, v, y, B, nx, nt)
        stencil_matvec.launches += 1
    return y


def stencil_residual(coeffs: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                     nx: int, nt: int) -> torch.Tensor:
    """K2: r = b - D x in one pass, by the row kernel."""
    if not _dispatch(b):
        return stencil_residual_plain(coeffs, b, x, nx, nt)
    sfx, itemsize, B = _check_operands(coeffs, nx, nt, b, x)
    r = torch.empty_like(b)
    if B:
        _launch_rows("stencil_residual", sfx, itemsize, coeffs, b, x, r, B, nx, nt)
        stencil_residual.launches += 1
    return r


def stencil_matvec_per_site(coeffs: torch.Tensor, v: torch.Tensor, nx: int,
                            nt: int) -> torch.Tensor:
    """The first K1, one thread per site: the same function as
    ``stencil_matvec``. On no path; kept to be timed beside the row kernel."""
    if not _dispatch(v):
        return stencil_matvec_plain(coeffs, v, nx, nt)
    sfx, _, B = _check_operands(coeffs, nx, nt, v)
    y = torch.empty_like(v)
    dev = v.device.index
    _check(_fn("stencil_matvec_per_site", sfx)(
        coeffs.data_ptr(), v.data_ptr(), y.data_ptr(), B, nx, nt, dev, _raw_stream(dev)),
        "stencil_matvec_per_site")
    stencil_matvec_per_site.launches += 1
    return y


def stencil_residual_per_site(coeffs: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                              nx: int, nt: int) -> torch.Tensor:
    """The first K2, one thread per site (the yardstick, on no path)."""
    if not _dispatch(b):
        return stencil_residual_plain(coeffs, b, x, nx, nt)
    sfx, _, B = _check_operands(coeffs, nx, nt, b, x)
    r = torch.empty_like(b)
    dev = b.device.index
    _check(_fn("stencil_residual_per_site", sfx)(
        coeffs.data_ptr(), b.data_ptr(), x.data_ptr(), r.data_ptr(), B, nx, nt, dev,
        _raw_stream(dev)), "stencil_residual_per_site")
    stencil_residual_per_site.launches += 1
    return r


def _poly_operands(coeffs, r, roots, nx, nt):
    """Shared by the K3 wrappers: the roots as complex numbers (at least
    one) and, for a CUDA tensor, the batch size; None for a CPU tensor."""
    roots = tuple(complex(t) for t in roots)
    if not roots:
        raise ValueError("the polynomial smoother needs at least one root")
    if not _dispatch(r):
        return roots, None
    return roots, _check_operands(coeffs, nx, nt, r)[2]


def stencil_poly_smooth(coeffs: torch.Tensor, r: torch.Tensor,
                        roots: Sequence[complex], nx: int, nt: int, *,
                        with_residual: bool = False):
    """K3: x = p(D) r by the tiled kernel, up to ``FUSE_DEPTH`` roots per
    launch (the roots are spread by ``fused_passes``). Returns (x, r - D x)
    with ``with_residual`` (m applications of D), else (x, None) (m - 1).
    complex64 and complex128 take the same kernel template with their own
    ``WINDOW``, ``STRIP``, ``PROBES_PER_PASS`` and ``FUSE_DEPTH``.
    ``.launches`` counts kernel launches, so a call adds ceil(m / FUSE_DEPTH)
    to it, not m; ``.plans`` counts them by plan (``_plan_key``)."""
    roots, B = _poly_operands(coeffs, r, roots, nx, nt)
    if B is None:
        return stencil_poly_smooth_plain(coeffs, r, roots, nx, nt, with_residual)
    return _poly_tiled(coeffs, r, roots, nx, nt, with_residual, B, FUSE_DEPTH[r.dtype])


# launches of the tiled K3 by plan; the same dict as stencil_poly_smooth.plans,
# updated here because a tracer may stand in for that name (benchmark/devtrace.py)
_k3_plans: dict = {}


def _plan_key(dtype: torch.dtype, B: int, nx: int, nt: int, halo: int) -> str:
    """What a launch of the tiled K3 ran: the shape and the dtype's plan."""
    (wx, wt), S, pb = WINDOW[dtype], STRIP[dtype], PROBES_PER_PASS[dtype]
    return (f"{_SUFFIX[dtype]} B={B} {nx}x{nt}: window {wx}x{wt}, strip {S}, "
            f"{pb} probes a pass, halo {halo}")


def _poly_tiled(coeffs, r, roots, nx, nt, with_residual, B, depth, fn=None):
    """The launches of ``stencil_poly_smooth`` on validated CUDA operands,
    at most ``depth`` <= MAX_FUSE roots each. ``fn``: the entry of another
    build with the same C signature (bench_torch/k3_sweep.py's variants),
    whose launches count nowhere."""
    launches, halo = poly_launches(len(roots), depth, with_residual)
    x = torch.empty_like(r)
    bufs = [None, None]  # ping-pong for cur between launches
    cur = r
    counted = fn is None
    if counted:
        fn = _fn("stencil_poly_tiled", _SUFFIX[r.dtype])
        key = _plan_key(r.dtype, B, nx, nt, halo)
    with torch.cuda.device(r.device):
        stream = _raw_stream(r.device.index)
        for i, (first, n, apply_last) in enumerate(launches):
            out = None
            if apply_last:
                if bufs[i % 2] is None:
                    bufs[i % 2] = torch.empty_like(r)
                out = bufs[i % 2]
            inv = (ctypes.c_double * (2 * n))()
            for j in range(n):
                z = 1.0 / roots[first + j]
                inv[2 * j], inv[2 * j + 1] = z.real, z.imag
            _check(fn(coeffs.data_ptr(), cur.data_ptr(), x.data_ptr(),
                      out.data_ptr() if apply_last else None, inv, n, halo,
                      int(first == 0), int(apply_last), B, nx, nt,
                      stream), "stencil_poly_smooth")
            if counted:
                stencil_poly_smooth.launches += 1
                _k3_plans[key] = _k3_plans.get(key, 0) + 1
            if apply_last:
                cur = out
    return x, (cur if with_residual else None)


def stencil_poly_smooth_per_root(coeffs: torch.Tensor, r: torch.Tensor,
                                 roots: Sequence[complex], nx: int, nt: int, *,
                                 with_residual: bool = False):
    """The earlier K3: the same function as ``stencil_poly_smooth`` with one
    launch per root, every root's cur and x passing through device memory.
    On no path; kept to be timed beside the tiled kernel."""
    roots, B = _poly_operands(coeffs, r, roots, nx, nt)
    if B is None:
        return stencil_poly_smooth_plain(coeffs, r, roots, nx, nt, with_residual)
    fn = _fn("stencil_poly_step", _SUFFIX[r.dtype])
    x = torch.empty_like(r)
    bufs = (torch.empty_like(r), torch.empty_like(r))  # ping-pong for cur
    cur = r
    with torch.cuda.device(r.device):
        stream = _raw_stream(r.device.index)
        for k, th in enumerate(roots):
            inv = 1.0 / th
            apply = k < len(roots) - 1 or with_residual
            out = bufs[k % 2]
            _check(fn(coeffs.data_ptr(), cur.data_ptr(), x.data_ptr(),
                      out.data_ptr(), inv.real, inv.imag, int(k == 0), int(apply),
                      B, nx, nt, stream), "stencil_poly_smooth_per_root")
            stencil_poly_smooth_per_root.launches += 1
            if apply:
                cur = out
    return x, (cur if with_residual else None)


# The kernels of the main path, whose launches ``launch_counts`` reports. K3
# counts launches of the tiled kernel (several roots each). The yardsticks
# (per-root K3, per-site K1 and K2) keep counts of their own, which stay 0
# on every path (``yardstick_counts``).
KERNELS = (stencil_matvec, stencil_residual, stencil_poly_smooth)
YARDSTICKS = (stencil_poly_smooth_per_root, stencil_matvec_per_site,
              stencil_residual_per_site)


def reset_launch_counts() -> None:
    for fn in KERNELS + YARDSTICKS:
        fn.launches = 0
    _k3_plans.clear()


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def yardstick_counts() -> dict:
    return {fn.__name__: fn.launches for fn in YARDSTICKS}


stencil_poly_smooth.plans = _k3_plans
reset_launch_counts()
