"""est.own_ms_per_batch: Device milliseconds per batch of the span pass
(benchmark/spantrace.py) launched under an est.* span and under no fgmres.*
span: the deflation projection and row shift, the estimates, and MLMC's
restriction, dense coarse correction and add-back."""

LAYER = "estimators"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "samples_per_s"


def read(ctx):
    from spantrace import group_ms_per_batch

    return group_ms_per_batch(ctx, "est.own")
