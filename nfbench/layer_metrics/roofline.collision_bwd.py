"""roofline.collision_bwd: the f32 collision-terms backward kernel's share
of its roofline (forward and input gradient on the step's (N-1) S
collision poses), from the traced slice's device time per launch."""
import pathlib

from nfbench.harness import roofline


def read(ctx):
    return roofline.share(ctx, pathlib.Path(__file__).with_suffix(".kernels.json"))
