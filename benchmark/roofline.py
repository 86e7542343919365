"""The least time of a stencil kernel call, from the work its algorithm
needs at the call's shape, at the card's data-sheet peaks. Frozen from
chip_smoke.py (``_bound`` and its constants) so that a later change to the
program cannot move the yardstick.

Work is counted by the algorithm, not by the implementation: each input
probe block (B, 2, X, T) is read once, each output block written once, and
the 18 used coefficient fields are read once per call; K3 is charged the
operator applications that p(D) r needs, whatever number of launches or
halo sites a kernel takes for them.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: device memory bandwidth, and float32 / float64
# outside the tensor cores (the stencil's coefficients differ per site, so
# it is no matrix product). They assume the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FP64_FLOPS_PER_S = 34e12
COEFF_FIELDS = 18

# Real flops per site and probe: 18 complex multiply-adds for D; K2 adds two
# complex subtractions; a K3 root scales two values (12), adds them to x (4)
# and, where it applies D, subtracts D step from cur (144 + 4).
FLOPS_D = 144
FLOPS_K2 = FLOPS_D + 4
FLOPS_K3_ROOT = 12 + 4 + FLOPS_D + 4
FLOPS_K3_LAST_NO_D = 12 + 4


def call_work(kind: str, B: int, nx: int, nt: int, itemsize: int, roots: int = 0,
              with_residual: bool = False):
    """(bytes, flops) of one call: ``kind`` is 'matvec' (K1, y = D v),
    'residual' (K2, r = b - D x) or 'poly' (K3, x = p(D) r with ``roots``
    roots, and r - D x with ``with_residual``)."""
    sites = nx * nt
    if kind == "matvec":
        blocks, flops = 2, FLOPS_D
    elif kind == "residual":
        blocks, flops = 3, FLOPS_K2
    elif kind == "poly":
        if with_residual:
            blocks, flops = 3, roots * FLOPS_K3_ROOT
        else:
            blocks, flops = 2, (roots - 1) * FLOPS_K3_ROOT + FLOPS_K3_LAST_NO_D
    else:
        raise ValueError(kind)
    nbytes = (blocks * B * 2 + COEFF_FIELDS) * sites * itemsize
    return nbytes, flops * sites * B


def bound_s(nbytes: float, flops: float, itemsize: int) -> float:
    """The least seconds: the larger of bytes over the memory bandwidth and
    flops over the float32 (complex64) or float64 (complex128) rate."""
    peak = FP32_FLOPS_PER_S if itemsize == 8 else FP64_FLOPS_PER_S
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def share_pct(trace: dict, kinds, group: str):
    """100 * (the least seconds of the traced stretch's calls of ``kinds``)
    / (the device seconds of the kernels of ``group``, devtrace.GROUPS);
    None when the stretch ran no such call or no such kernel."""
    from devtrace import group_seconds

    if not trace:
        return None
    least = sum(bound_s(*call_work(kind, B, nx, nt, itemsize, roots, with_res), itemsize)
                for kind, B, nx, nt, itemsize, roots, with_res in trace["calls"]
                if kind in kinds)
    spent = group_seconds(trace["by_name"]).get(group, 0.0)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent
