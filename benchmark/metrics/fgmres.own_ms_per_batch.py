"""fgmres.own_ms_per_batch: Device milliseconds per batch of the span pass
(benchmark/spantrace.py) launched under an fgmres.* span and under no vcycle*
span: the Arnoldi steps' Gram-Schmidt, norms and Givens updates, the restart
cycles' residuals, back substitution and update of x."""

LAYER = "krylov"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "samples_per_s"


def read(ctx):
    from spantrace import group_ms_per_batch

    return group_ms_per_batch(ctx, "fgmres.own")
