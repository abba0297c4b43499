"""Comparison baselines (the reference's run_gpmp2.py role; port of
`nfopp_tpu/baselines/`)."""

from .gpmp2 import GPMP2Config, SDF, build_sdf, gpmp2_plan, stack_sdfs  # noqa: F401
