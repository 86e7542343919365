"""vcycle.coarse_ms_per_batch: Device milliseconds per batch of the span pass
(benchmark/spantrace.py) launched under a vcycle.l{>=1}.* span or
vcycle.coarsest: the coarse levels' block stencils, smoothers, transfers and
the dense coarsest solve."""

LAYER = "v-cycle and coarse levels"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "samples_per_s"


def read(ctx):
    from spantrace import group_ms_per_batch

    return group_ms_per_batch(ctx, "vcycle.coarse")
