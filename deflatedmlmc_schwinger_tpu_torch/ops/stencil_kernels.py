"""Fine-level stencil kernels K1-K3 (CUDA C++, ``csrc/stencil.cu``), their
plain PyTorch versions, launch counters, and the build-and-load code.

Counterpart of ``deflatedmlmc_schwinger_tpu/ops/pallas_stencil.py``:

  * K1 ``stencil_matvec``      y = D v
  * K2 ``stencil_residual``    r = b - D x, one pass
  * K3 ``stencil_poly_smooth`` x = p(D) r through the residual recurrence
    step_k = cur_k / theta_k, x += step_k, cur_{k+1} = cur_k - D step_k.
    On the card this is the tiled kernel: a launch takes up to
    ``FUSE_DEPTH`` roots on a shared-memory window with a halo, so a call
    with m roots is ceil(m / FUSE_DEPTH) launches.
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
from typing import Optional, Sequence, Tuple

import torch

# (dx, dt) offsets; tap 0 is the on-site term (ops/dirac.py TAPS).
TAPS: Tuple[Tuple[int, int], ...] = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))

_PKG_DIR = Path(__file__).resolve().parent.parent
_CSRC = _PKG_DIR / "csrc"
_BUILD_ROOT = _PKG_DIR / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}

# The tiled K3 (csrc/stencil.cu poly_tiled_kernel), by dtype: the window of
# lattice sites one thread block holds in shared memory (fixed in the
# source) and the most roots one launch is given. complex128 has twice the
# bytes per site, so half the window, and a shallower halo on it. Four roots
# were the best or within 5% of it at every shape measured (PERF.md).
MAX_FUSE = 4                     # kMaxFuse in csrc/stencil.cu
WINDOW = MappingProxyType({torch.complex64: (32, 32), torch.complex128: (16, 32)})
FUSE_DEPTH = MappingProxyType({torch.complex64: 4, torch.complex128: 2})

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


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


def stencil_poly_smooth_tiled_plain(coeffs: torch.Tensor, r: torch.Tensor,
                                    roots: Sequence[complex], nx: int, nt: int,
                                    with_residual: bool = False, *,
                                    window: Tuple[int, int] = (32, 32),
                                    depth: int = 4):
    """The tiled K3's algorithm in plain PyTorch, window by window (used by
    the tests only). Each pass of ``fused_passes`` that applies D h times
    cuts the lattice into tiles of ``window`` - 2h sites, loads each tile's
    window from the lattice's periodic extension (a lattice smaller than the
    window simply repeats in it), runs its roots on the window, whose valid
    region shrinks by one site per application (the rest is filled with NaN
    here, so a read of an invalid site would show), and writes x and cur on
    the tile only, ragged tiles cut at the lattice's edge."""
    roots = tuple(complex(t) for t in roots)
    WX, WT = window
    shape = r.shape
    cur = r.reshape((-1, 2, nx, nt))
    x = torch.zeros_like(cur)
    nan = complex(float("nan"), float("nan"))
    passes = fused_passes(len(roots), depth)
    for first, n in passes:
        apply_last = first + n < len(roots) or with_residual
        h = n if apply_last else n - 1
        tx, tt = WX - 2 * h, WT - 2 * h
        if tx < 1 or tt < 1:
            raise ValueError(f"a halo of depth {h} leaves no tile in a {WX} x {WT} window")
        new_cur = torch.empty_like(cur)
        for x0 in range(0, nx, tx):
            for t0 in range(0, nt, tt):
                ix = (x0 - h + torch.arange(WX)) % nx
                it = (t0 - h + torch.arange(WT)) % nt
                win = cur[:, :, ix][:, :, :, it]
                cw = coeffs[:, :, :, ix][:, :, :, :, it]
                xacc = torch.zeros_like(win)
                for j in range(n):
                    step = win * (1.0 / roots[first + j])
                    xacc = xacc + step
                    if j >= h:
                        break
                    lo, hx, ht = j + 1, WX - j - 1, WT - j - 1
                    d_step = torch.zeros_like(win[:, :, lo:hx, lo:ht])
                    for k, (dx, dt) in enumerate(TAPS):
                        s = step[:, :, lo + dx:hx + dx, lo + dt:ht + dt]
                        c = cw[:, :, k, lo:hx, lo:ht]
                        for a in range(2):
                            if k == 0:
                                d_step[:, a] += c[a, a] * s[:, a]
                            else:
                                d_step[:, a] += c[a, 0] * s[:, 0] + c[a, 1] * s[:, 1]
                    nxt = torch.full_like(win, nan)
                    nxt[:, :, lo:hx, lo:ht] = win[:, :, lo:hx, lo:ht] - d_step
                    win = nxt
                ox, ot = min(tx, nx - x0), min(tt, nt - t0)
                x[:, :, x0:x0 + ox, t0:t0 + ot] += xacc[:, :, h:h + ox, h:h + ot]
                if apply_last:
                    new_cur[:, :, x0:x0 + ox, t0:t0 + ot] = win[:, :, h:h + ox, h:h + ot]
        if apply_last:
            cur = new_cur
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
                fns = {
                    f"dmlmc_stencil_matvec_{sfx}": [P, P, P, I, I, I, P],
                    f"dmlmc_stencil_residual_{sfx}": [P, P, P, P, I, I, I, P],
                    f"dmlmc_stencil_poly_step_{sfx}":
                        [P, P, P, P, D, D, I, I, I, I, I, P],
                    f"dmlmc_stencil_poly_tiled_{sfx}":
                        [P, P, P, P, P, I, I, I, I, I, I, P],
                }
                for name, argtypes in fns.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_operands(coeffs: torch.Tensor, nx: int, nt: int,
                    *vecs: torch.Tensor) -> int:
    """Validate the operands of a CUDA launch; returns the batch size B."""
    if coeffs.dtype not in _SUFFIX:
        raise TypeError(f"stencil kernels take complex64/complex128, got {coeffs.dtype}")
    if tuple(coeffs.shape) != (2, 2, 5, nx, nt):
        raise ValueError(f"coefficients must be (2, 2, 5, {nx}, {nt}), "
                         f"got {tuple(coeffs.shape)}")
    n = 2 * nx * nt
    for t in (coeffs,) + vecs:
        if t.device != coeffs.device:
            raise ValueError("stencil operands must share one CUDA device")
        if t.dtype != coeffs.dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs {coeffs.dtype}")
        if not t.is_contiguous():
            raise ValueError("stencil operands must be contiguous")
    shape = vecs[0].shape
    for t in vecs:
        if t.shape != shape:
            raise ValueError(f"shape mismatch: {tuple(t.shape)} vs {tuple(shape)}")
    if not shape or shape[-1] != n:
        raise ValueError(f"vectors must be (..., {n}), got {tuple(shape)}")
    B = 1
    for s in shape[:-1]:
        B *= int(s)
    return B


def _dispatch(t: torch.Tensor) -> bool:
    """True -> launch the CUDA kernel; False -> plain version (CPU only)."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no stencil kernel for device {t.device}")


# ---- public wrappers ---------------------------------------------------------

def stencil_matvec(coeffs: torch.Tensor, v: torch.Tensor, nx: int,
                   nt: int) -> torch.Tensor:
    """K1: y = D v for complex v of shape (..., 2*nx*nt)."""
    if not _dispatch(v):
        return stencil_matvec_plain(coeffs, v, nx, nt)
    B = _check_operands(coeffs, nx, nt, v)
    lib = load_library()
    y = torch.empty_like(v)
    fn = getattr(lib, f"dmlmc_stencil_matvec_{_SUFFIX[v.dtype]}")
    with torch.cuda.device(v.device):
        _check(fn(coeffs.data_ptr(), v.data_ptr(), y.data_ptr(), B, nx, nt,
                  _stream(v.device)), "stencil_matvec")
    stencil_matvec.launches += 1
    return y


def stencil_residual(coeffs: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                     nx: int, nt: int) -> torch.Tensor:
    """K2: r = b - D x in one pass."""
    if not _dispatch(b):
        return stencil_residual_plain(coeffs, b, x, nx, nt)
    B = _check_operands(coeffs, nx, nt, b, x)
    lib = load_library()
    r = torch.empty_like(b)
    fn = getattr(lib, f"dmlmc_stencil_residual_{_SUFFIX[b.dtype]}")
    with torch.cuda.device(b.device):
        _check(fn(coeffs.data_ptr(), b.data_ptr(), x.data_ptr(), r.data_ptr(), B,
                  nx, nt, _stream(b.device)), "stencil_residual")
    stencil_residual.launches += 1
    return r


def _poly_operands(coeffs, r, roots, nx, nt):
    """Shared by the K3 wrappers: the roots as complex numbers (at least
    one) and, for a CUDA tensor, the batch size; None for a CPU tensor."""
    roots = tuple(complex(t) for t in roots)
    if not roots:
        raise ValueError("the polynomial smoother needs at least one root")
    if not _dispatch(r):
        return roots, None
    return roots, _check_operands(coeffs, nx, nt, r)


def stencil_poly_smooth(coeffs: torch.Tensor, r: torch.Tensor,
                        roots: Sequence[complex], nx: int, nt: int, *,
                        with_residual: bool = False):
    """K3: x = p(D) r by the tiled kernel, up to ``FUSE_DEPTH`` roots per
    launch (the roots are spread by ``fused_passes``). Returns (x, r - D x)
    with ``with_residual`` (m applications of D), else (x, None) (m - 1).
    complex64 and complex128 take the same kernel template; they differ in
    ``WINDOW``, ``FUSE_DEPTH`` and the probes a block takes per pass (2 and
    1). ``.launches`` counts kernel launches, so a call adds
    ceil(m / FUSE_DEPTH) to it, not m."""
    roots, B = _poly_operands(coeffs, r, roots, nx, nt)
    if B is None:
        return stencil_poly_smooth_plain(coeffs, r, roots, nx, nt, with_residual)
    return _poly_tiled(coeffs, r, roots, nx, nt, with_residual, B, FUSE_DEPTH[r.dtype])


def _poly_tiled(coeffs, r, roots, nx, nt, with_residual, B, depth):
    """The launches of ``stencil_poly_smooth`` on validated CUDA operands,
    at most ``depth`` <= MAX_FUSE roots each."""
    lib = load_library()
    fn = getattr(lib, f"dmlmc_stencil_poly_tiled_{_SUFFIX[r.dtype]}")
    x = torch.empty_like(r)
    bufs = [None, None]  # ping-pong for cur between launches
    cur = r
    with torch.cuda.device(r.device):
        stream = _stream(r.device)
        for i, (first, n) in enumerate(fused_passes(len(roots), depth)):
            apply_last = first + n < len(roots) or with_residual
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
                      out.data_ptr() if apply_last else None, inv, n,
                      int(first == 0), int(apply_last), B, nx, nt,
                      stream), "stencil_poly_smooth")
            stencil_poly_smooth.launches += 1
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
    lib = load_library()
    fn = getattr(lib, f"dmlmc_stencil_poly_step_{_SUFFIX[r.dtype]}")
    x = torch.empty_like(r)
    bufs = (torch.empty_like(r), torch.empty_like(r))  # ping-pong for cur
    cur = r
    with torch.cuda.device(r.device):
        stream = _stream(r.device)
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
# counts launches of the tiled kernel (several roots each). The per-root
# kernel keeps a count of its own, which stays 0 on every path.
KERNELS = (stencil_matvec, stencil_residual, stencil_poly_smooth)


def reset_launch_counts() -> None:
    for fn in KERNELS + (stencil_poly_smooth_per_root,):
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
