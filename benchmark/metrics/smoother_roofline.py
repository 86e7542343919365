"""smoother_roofline: the fine-level polynomial smoother p(D) r (K3) against
its roofline. The least time of the calls in the traced stretch, each
charged the operator applications that p(D) needs (benchmark/roofline.py),
over the device time of the kernels that ran them."""

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "samples_per_s"


def read(ctx):
    from roofline import share_pct

    return share_pct(ctx["trace"], ("poly",), "K3")
