"""batch_ms_p90: the 90th percentile over all the window's batches of the
batch's time on the device stream, from the CUDA events that the step
wrapper records between batches. A batch lasts until its slowest row
converges, so stragglers and the host's slow stretches land here."""

LAYER = "estimators"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "samples_per_s"


def read(ctx):
    from stats import percentile

    batch_s = ctx["window"]["batch_s"]
    if not batch_s:
        return None
    return percentile([1e3 * s for s in batch_s], 90)
