"""device_idle.solve: the share of the traced slice of a solving cell in
which no kernel ran on the card (1 - busy / wall of the same slice)."""
from nfbench.harness import idle


def read(ctx):
    return idle.share(ctx)
