"""device_idle.run_loop: the share of the traced slice's wall in which no
kernel ran and the host was inside the program's run loop (a `run` span or
one of its children: `sync`, `program`, `replay`, `run.outputs`)."""
from nfbench.harness import program_spans


def read(ctx):
    split = program_spans.idle_split(ctx)
    return None if split is None else split["run_loop"]
