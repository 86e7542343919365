"""setup.mg_s: Seconds of the multigrid hierarchy set-up (PhaseTimer phase
mg_setup)."""

LAYER = "setup"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(ctx):
    return ctx["phases"].get("mg_setup")
