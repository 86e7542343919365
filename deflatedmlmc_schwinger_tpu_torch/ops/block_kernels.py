"""Kernel K4 (CUDA C++, ``csrc/stencil.cu coarse_bsr_kernel``): the coarse
levels' block stencils as block-sparse rows, with its plain PyTorch twin,
launch counters and the layout it reads.

A coarse operator (mg/hierarchy.py BlockStencilOperator) is a cyclic block
stencil of (dc, dc) blocks, and most of their entries are exact zeros that
the aggregation leaves (at 128^2, 79% of level 1's stored entries). The
layout keeps only the 2 x 2 sub-blocks that hold a nonzero entry, as
block-sparse rows (BSR): per row of sub-blocks, the column indices and the
values (``block_layout``). K4 has three forms, one launch each:

  * ``block_matvec``       y = A v
  * ``block_residual``     r = b - A x
  * ``block_poly_smooth``  x = p(A) r through the recurrence of
    mg/cycle.py poly_smoother, one launch per root: step = cur / theta,
    x = step (first root) or x + step, cur' = cur - A step (computed as
    cur - (A cur) / theta), cur ping-ponging between two buffers; with
    ``with_residual`` it returns (x, r - A x), else (x, None).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version, which follows the kernel's arithmetic (the tests hold it to the
einsum matvec of BlockStencilOperator). The kernel is built into the same
library as K1-K3 (``stencil_kernels.load_library``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from deflatedmlmc_schwinger_tpu_torch.ops import stencil_kernels as sk

# the sub-block size: on the H100, 2 beat 1, 4 and 8 at both coarse levels of
# the 128^2 hierarchy (PERF.md): it keeps the fewest zeros of the sizes above
# 1, and a thread's loads of 16 bytes
SIZE = 2
_MODES = {"matvec": 0, "residual": 1, "root": 2, "last": 3}


class BlockLayout(NamedTuple):
    """Block-sparse rows of an (n, n) operator with SIZE x SIZE sub-blocks:
    the sub-blocks of row i are ``vals[rowptr[i]:rowptr[i + 1]]`` (nnzb, s,
    s), at the sub-block columns ``cols[rowptr[i]:rowptr[i + 1]]``, in
    ascending order."""
    rowptr: torch.Tensor         # (n / s + 1,) int32
    cols: torch.Tensor           # (nnzb,) int32
    vals: torch.Tensor           # (nnzb, s, s), the operator's dtype

    @property
    def size(self) -> int:
        return self.vals.shape[-1]

    @property
    def rows(self) -> int:
        return self.rowptr.shape[0] - 1


def _subblocks(blocks: torch.Tensor, s: int) -> torch.Tensor:
    """(nac, K, dc, dc) blocks as (nac, K, dc/s, dc/s, s, s) sub-blocks."""
    nac, K, dc, _ = blocks.shape
    q = dc // s
    return blocks.reshape(nac, K, q, s, q, s).permute(0, 1, 2, 4, 3, 5)


def block_layout(blocks: torch.Tensor, offsets: Sequence[int]) -> BlockLayout:
    """The BSR layout of the cyclic block stencil ``blocks`` (nac, K, dc,
    dc) with block offsets ``offsets`` (blocks[j, k] couples block row j to
    block column (j + offsets[k]) mod nac), on the blocks' device: every
    SIZE x SIZE sub-block with a nonzero entry, its values copied as they
    are. Sub-blocks that land on one place (offsets equal mod nac) are
    summed, as the einsum matvec sums them. dc must be even (coarse blocks
    are (2k, 2k))."""
    nac, K, dc, _ = blocks.shape
    s = SIZE
    if dc % s:
        raise ValueError(f"no block layout with {s} x {s} sub-blocks of {dc} x {dc} blocks")
    q = dc // s
    sub = _subblocks(blocks, s)
    j, k, ra, cb = (sub != 0).flatten(-2).any(-1).nonzero(as_tuple=True)
    offs = torch.as_tensor([int(o) for o in offsets], dtype=torch.long, device=blocks.device)
    nbr = nac * q
    key = (j * q + ra) * nbr + ((j + offs[k]) % nac) * q + cb
    key, order = torch.sort(key, stable=True)
    vals = sub[j, k, ra, cb][order]
    uniq, inverse = torch.unique_consecutive(key, return_inverse=True)
    if uniq.numel() != key.numel():
        vals = torch.zeros((uniq.numel(), s, s), dtype=vals.dtype,
                           device=vals.device).index_add_(0, inverse, vals)
    rowptr = torch.zeros(nbr + 1, dtype=torch.long, device=blocks.device)
    rowptr[1:] = torch.cumsum(torch.bincount(uniq // nbr, minlength=nbr), 0)
    return BlockLayout(rowptr.to(torch.int32), (uniq % nbr).to(torch.int32),
                       vals.contiguous())


# ---- plain PyTorch versions --------------------------------------------------

def block_matvec_plain(layout: BlockLayout, v: torch.Tensor) -> torch.Tensor:
    """y = A v over the layout's sub-blocks: each sub-block times its probe
    segments, summed into its row."""
    s, nbr = layout.size, layout.rows
    vb = v.reshape(-1, nbr, s)
    rows = torch.repeat_interleave(torch.arange(nbr, device=v.device),
                                   layout.rowptr.diff().long())
    prod = torch.einsum("kab,pkb->pka", layout.vals, vb[:, layout.cols.long()])
    return torch.zeros_like(vb).index_add_(1, rows, prod).reshape(v.shape)


def block_residual_plain(layout: BlockLayout, b: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    return b - block_matvec_plain(layout, x)


def block_poly_smooth_plain(layout: BlockLayout, r: torch.Tensor,
                            roots: Sequence[complex], with_residual: bool = False):
    """The kernel's recurrence: per root, x = cur / theta (first) or
    x + cur / theta, and (except on the last root without the residual)
    cur' = cur - (A cur) / theta. Returns (x, cur) with ``with_residual``,
    else (x, None)."""
    x = None
    cur = r
    for k, th in enumerate(roots):
        inv = 1.0 / complex(th)
        step = cur * inv
        x = step if x is None else x + step
        if k == len(roots) - 1 and not with_residual:
            break
        cur = cur - block_matvec_plain(layout, cur) * inv
    return x, (cur if with_residual else None)


# ---- launches ------------------------------------------------------------------

_plans: dict = {}                # (sub-block rows, B, device) -> launch_plan


def launch_plan(n: int, B: int, sms: int) -> int:
    """Probes per thread for an operator of n rows and B probes. A thread
    owns one row for a chunk of probes, a warp 32 rows, and the 8 warps of
    a block successive probe chunks of the same rows. The kernel is built
    for 4 and 8 probes a thread: 8 where that leaves 16 warps per SM, else 4
    (at 128^2: 8 on level 1, 4 on level 2, the fastest in
    bench_torch/k4_sweep.py)."""
    return 8 if -(-n // 32) * -(-B // 8) >= 16 * sms else 4


def _operands(layout: BlockLayout, *vecs: torch.Tensor):
    """The vectors as the kernel takes them (contiguous, 16-byte aligned,
    on the layout's device and in its dtype) and the batch size."""
    vals = layout.vals
    n = layout.rows * layout.size
    out = []
    for t in vecs:
        if t.device != vals.device:
            raise ValueError(f"K4 operands must share one device: {t.device} vs {vals.device}")
        if t.dtype != vals.dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs {vals.dtype}")
        if t.dim() == 0 or t.shape[-1] != n or t.shape != vecs[0].shape:
            raise ValueError(f"vectors must be (..., {n}) of one shape, got {tuple(t.shape)}")
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out, vecs[0].numel() // n


def _launch(name: str, layout: BlockLayout, mode: str, B: int, inp: torch.Tensor,
            b: Optional[torch.Tensor] = None, x: Optional[torch.Tensor] = None,
            out: Optional[torch.Tensor] = None, inv: complex = 0j, first: bool = False,
            probes: Optional[int] = None) -> None:
    """One launch of K4's form ``mode`` on validated CUDA operands, with
    ``probes`` a thread or the cached ``launch_plan`` of the shape."""
    dev = inp.device.index
    if probes is None:
        key = (layout.rows, B, dev)
        probes = _plans.get(key)
        if probes is None:
            probes = _plans[key] = launch_plan(
                layout.rows * SIZE, B,
                torch.cuda.get_device_properties(dev).multi_processor_count)
    cfg = (ctypes.c_int * 6)(_MODES[mode], int(first), B, layout.rows, probes, dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    sk._check(sk._fn("coarse_bsr", sk._SUFFIX[inp.dtype])(
        layout.rowptr.data_ptr(), layout.cols.data_ptr(), layout.vals.data_ptr(),
        inp.data_ptr(), ptr(b), ptr(x), ptr(out), inv.real, inv.imag, cfg,
        sk._raw_stream(dev)), name)


def block_matvec(layout: BlockLayout, v: torch.Tensor) -> torch.Tensor:
    """K4: y = A v for v of shape (..., n)."""
    if not sk._dispatch(v):
        return block_matvec_plain(layout, v)
    (v,), B = _operands(layout, v)
    y = torch.empty_like(v)
    if B:
        _launch("block_matvec", layout, "matvec", B, v, out=y)
        block_matvec.launches += 1
    return y


def block_residual(layout: BlockLayout, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K4: r = b - A x in one pass."""
    if not sk._dispatch(b):
        return block_residual_plain(layout, b, x)
    (b, x), B = _operands(layout, b, x)
    r = torch.empty_like(b)
    if B:
        _launch("block_residual", layout, "residual", B, x, b=b, out=r)
        block_residual.launches += 1
    return r


def block_poly_smooth(layout: BlockLayout, r: torch.Tensor, roots: Sequence[complex],
                      with_residual: bool = False
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K4: x = p(A) r, one launch per root (the last one, without
    ``with_residual``, updates x alone). Returns (x, r - A x) with
    ``with_residual``, else (x, None). ``.launches`` counts launches, so a
    call adds len(roots)."""
    roots = tuple(complex(t) for t in roots)
    if not roots:
        raise ValueError("the polynomial smoother needs at least one root")
    if not sk._dispatch(r):
        return block_poly_smooth_plain(layout, r, roots, with_residual)
    (r,), B = _operands(layout, r)
    x = torch.empty_like(r)
    if not B:
        return x, (torch.empty_like(r) if with_residual else None)
    bufs = [None, None]          # ping-pong for cur between launches
    cur = r
    for k, th in enumerate(roots):
        last = k == len(roots) - 1 and not with_residual
        out = None
        if not last:
            if bufs[k % 2] is None:
                bufs[k % 2] = torch.empty_like(r)
            out = bufs[k % 2]
        _launch("block_poly_smooth", layout, "last" if last else "root", B, cur,
                x=x, out=out, inv=1.0 / th, first=k == 0)
        block_poly_smooth.launches += 1
        if not last:
            cur = out
    return x, (cur if with_residual else None)


KERNELS = (block_matvec, block_residual, block_poly_smooth)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
