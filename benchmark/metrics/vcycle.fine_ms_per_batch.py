"""vcycle.fine_ms_per_batch: Device milliseconds per batch of the span pass
(benchmark/spantrace.py) launched under a vcycle.l0.* span: the fine level's
smoothing (K3), residual (K2), restriction and prolongation."""

LAYER = "v-cycle and coarse levels"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "samples_per_s"


def read(ctx):
    from spantrace import group_ms_per_batch

    return group_ms_per_batch(ctx, "vcycle.fine")
