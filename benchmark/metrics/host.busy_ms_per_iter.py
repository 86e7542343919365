"""host.busy_ms_per_iter: The host's own time per outer FGMRES iteration in
the untraced window: the window's seconds less the seconds the program spent
blocked in host reads of device values (utils/timer.py ``host_reads``), over
the window's outer iterations. Against the device's busy time per iteration
it says whether the host enqueues slower than the card runs."""

LAYER = "host"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "samples_per_s"


def read(ctx):
    w = ctx["window"]
    reads, iters = w.get("host_reads"), sum(w["batch_iters"])
    return 1e3 * (w["seconds"] - reads["seconds"]) / iters if reads and iters else None
