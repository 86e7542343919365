"""krylov_tail_roofline: FGMRES's Arnoldi step tails (the tail kernel)
against their byte bound: the traced stretch's outer iterations at the
program's mean bytes a tail for the window's solve shape
(benchmark/krylov_roofline.py), over the device time of
``krylov_tail_reduce_kernel`` in the stretch."""

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "samples_per_s"


def read(ctx):
    from krylov_roofline import share_pct

    return share_pct(ctx)
