"""roofline.field_grad: the f32 field-gradient kernel's share of its
roofline (forward and parameter gradient of the mean BCE on the step's
N-1 + K + R points), from the traced slice's device time per launch."""
import pathlib

from nfbench.harness import roofline


def read(ctx):
    return roofline.share(ctx, pathlib.Path(__file__).with_suffix(".kernels.json"))
