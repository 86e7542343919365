"""vcycle.gemm_ms_per_batch: Device milliseconds per batch of matrix-product
kernels (coarse-level block stencils, prolongation and restriction, the
dense coarse inverses, the deflation projection) in the traced stretch."""

LAYER = "v-cycle and coarse levels"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "samples_per_s"


def read(ctx):
    from devtrace import group_seconds

    t = ctx["trace"]
    if not t:
        return None
    s = group_seconds(t["by_name"]).get("GEMM")
    return 1e3 * s / t["batches"] if s else None
