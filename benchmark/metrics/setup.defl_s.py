"""setup.defl_s: Seconds of the deflation set-up (PhaseTimer phase defl_setup):
the gamma3 basis and its exact correction."""

LAYER = "setup"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(ctx):
    return ctx["phases"].get("defl_setup")
