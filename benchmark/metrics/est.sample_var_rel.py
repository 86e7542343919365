"""est.sample_var_rel: sigma^2 / |tr|^2 over the window: sigma^2 the per-sample
variance of the window's estimates, tr the window's own trace estimate."""

LAYER = "estimators"
UNIT = "ratio"
SOURCE = "program_counter"
MOVES = "sampling_s_to_1pct"


def read(ctx):
    w = ctx["window"]
    return w["variance"] / w["trace_abs"] ** 2 if w["trace_abs"] else None
