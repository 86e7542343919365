"""host.syncs_per_iter: Host reads that block on the device (the program's
utils/timer.py ``host_reads``: the FGMRES loop predicates and the sampling
loop's flags and end) in the untraced window, over the window's outer FGMRES
iterations (the sum over its batches of the slowest row's iterations)."""

LAYER = "host"
UNIT = "reads"
SOURCE = "program_counter"
MOVES = "samples_per_s"


def read(ctx):
    w = ctx["window"]
    reads, iters = w.get("host_reads"), sum(w["batch_iters"])
    return reads["reads"] / iters if reads and iters else None
