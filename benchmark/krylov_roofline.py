"""The least time of FGMRES's Arnoldi step tails (the tail kernel,
``krylov_tail_reduce_kernel``), from the bytes the algorithm moves: step
j's tail reads the basis vectors V[0..j] and w once and writes V[j+1] once,
j + 3 blocks of B n itemsize bytes, at the card's data-sheet bandwidth
(PERF.md's kernel table, PR 18's step-tail row).

The program counts its step tails per solve shape (B, n, itemsize) in
utils/timer.py ``krylov_counts``: solves, restart cycles, step tails and
the sum of their step indices j, since the process started. A program
without those counters gives None here.
"""

from __future__ import annotations

from roofline import HBM_BYTES_PER_S

TAIL_KERNEL = "krylov_tail_reduce_kernel"


def tail_bytes(j: int, B: int, n: int, itemsize: int) -> int:
    """Bytes of step j's tail: V[0..j] and w read, V[j+1] written."""
    return (j + 3) * B * n * itemsize


def tails_bound_s(tails: float, j_sum: float, B: int, n: int, itemsize: int) -> float:
    """The least seconds of ``tails`` step tails whose indices sum to
    ``j_sum``."""
    return (j_sum + 3 * tails) * B * n * itemsize / HBM_BYTES_PER_S


def program_counts():
    """The program's counters, or None where the program has none."""
    from deflatedmlmc_schwinger_tpu_torch.utils import timer

    return getattr(timer, "krylov_counts", None)


def sampling_counts(window: dict, counts=None):
    """((B, n, itemsize), its counters) of the window's solves: the shape
    whose B is the window's probes a batch, the one with the most step
    tails; None without counters or such a shape."""
    counts = program_counts() if counts is None else counts
    if not counts or not window.get("batch_s"):
        return None
    B = window["samples"] // len(window["batch_s"])
    keys = [k for k, c in counts.items() if k[0] == B and c["tails"]]
    if not keys:
        return None
    key = max(keys, key=lambda k: counts[k]["tails"])
    return key, counts[key]


def share_pct(ctx: dict, counts=None):
    """100 * (the least seconds of the traced stretch's step tails) / (the
    device seconds of the tail kernel in it): the stretch's outer
    iterations, one step tail each, at the counters' mean bytes a tail."""
    t = ctx.get("trace")
    found = sampling_counts(ctx["window"], counts)
    if not t or found is None:
        return None
    (B, n, itemsize), c = found
    least = tails_bound_s(t["outer_iters"], t["outer_iters"] * c["j_sum"] / c["tails"],
                          B, n, itemsize)
    spent = sum(s for name, s in t["by_name"].items() if TAIL_KERNEL in name)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent
