"""fgmres.iters_per_solve: Outer FGMRES iterations per probe solve over the
window (the per-row ``iters`` summed, over the samples)."""

LAYER = "krylov"
UNIT = "iters"
SOURCE = "program_counter"
MOVES = "samples_per_s"


def read(ctx):
    w = ctx["window"]
    return w["iters_total"] / w["samples"] if w["samples"] else None
