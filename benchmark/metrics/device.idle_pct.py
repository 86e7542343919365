"""device.idle_pct: share of the traced stretch in which no kernel, copy
or fill ran on the card: 1 - busy_s / window_s of the result line, the
busy time being the union of the stretch's device intervals. The
profiler's own cost per launch lengthens the host's gaps in the stretch,
so this reads above the idle share of an untraced stretch of the same
batches."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "samples_per_s"


def read(ctx):
    t = ctx["trace"]
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
