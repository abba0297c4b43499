"""replays_per_step: the program's `replay` spans in the traced slice (each
a call of a captured program) over the optimization steps run in it."""
from nfbench.harness import program_spans


def read(ctx):
    return program_spans.per_step(ctx, "replay")
