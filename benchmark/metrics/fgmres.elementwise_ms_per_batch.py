"""fgmres.elementwise_ms_per_batch: Device milliseconds per batch of
elementwise and reduction kernels (the Arnoldi step's Gram-Schmidt, norms
and updates, and the smaller passes around them) in the traced stretch."""

LAYER = "krylov"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "samples_per_s"


def read(ctx):
    from devtrace import group_seconds

    t = ctx["trace"]
    if not t:
        return None
    s = group_seconds(t["by_name"]).get("elementwise and reductions")
    return 1e3 * s / t["batches"] if s else None
