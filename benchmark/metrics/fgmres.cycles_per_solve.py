"""fgmres.cycles_per_solve: FGMRES restart cycles per solve of the window's
solve shape (utils/timer.py ``krylov_counts``, since the process started;
None where the program has no such counters). 1 where every solve ends in
its first cycle of ``restart`` steps."""

LAYER = "krylov"
UNIT = "cycles"
SOURCE = "program_counter"
MOVES = "samples_per_s"


def read(ctx):
    from krylov_roofline import sampling_counts

    found = sampling_counts(ctx["window"])
    if found is None or not found[1]["solves"]:
        return None
    return found[1]["cycles"] / found[1]["solves"]
