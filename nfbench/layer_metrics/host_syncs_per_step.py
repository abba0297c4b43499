"""host_syncs_per_step: the program's `sync` spans in the traced slice (each
a host decision that waits for the card) over the optimization steps run in
it."""
from nfbench.harness import program_spans


def read(ctx):
    return program_spans.per_step(ctx, "sync")
