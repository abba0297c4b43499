"""device_idle.replan: the share of the traced slice of a replanning cell
(whole cycles) in which no kernel ran on the card."""
from nfbench.harness import idle


def read(ctx):
    return idle.share(ctx)
