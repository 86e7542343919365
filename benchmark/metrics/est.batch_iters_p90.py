"""est.batch_iters_p90: The 90th percentile over the window's batches of the
batch's slowest-row outer iteration count (per-row ``iters`` that the step
returns): a batch lasts until its slowest row converges."""

LAYER = "estimators"
UNIT = "iters"
SOURCE = "program_counter"
MOVES = "samples_per_s"


def read(ctx):
    from stats import percentile

    return percentile(ctx["window"]["batch_iters"], 90)
