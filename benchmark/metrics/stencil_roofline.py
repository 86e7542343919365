"""stencil_roofline: the fine-level D v and b - D x (K1, K2) against their
roofline. The least time of the calls in the traced stretch, from the
algorithm's work at each call's shape (benchmark/roofline.py), over the
device time of the kernels that ran them."""

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "samples_per_s"


def read(ctx):
    from roofline import share_pct

    return share_pct(ctx["trace"], ("matvec", "residual"), "K1 + K2")
