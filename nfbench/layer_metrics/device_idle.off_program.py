"""device_idle.off_program: the share of the traced slice's wall in which no
kernel ran and no program span was open on the host (the caller's own
work between its calls into the program)."""
from nfbench.harness import program_spans


def read(ctx):
    split = program_spans.idle_split(ctx)
    return None if split is None else split["off_program"]
