"""device.launches_per_iter: Device operations (kernels, copies, fills) per
outer FGMRES iteration in the traced stretch, an iteration counted once per
batch (the batch's slowest row)."""

LAYER = "device"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "samples_per_s"


def read(ctx):
    t = ctx["trace"]
    if not t or not t["outer_iters"]:
        return None
    return t["device_ops"] / t["outer_iters"]
