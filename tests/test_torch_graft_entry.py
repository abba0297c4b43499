"""The port's entry points (nfopp_tpu_torch/graft_entry.py) on the
CPU, as tests/test_graft_entry.py holds the root's `__graft_entry__.py`:
one batched step from `entry()`, and `dryrun_multichip` on 2 ranks and on
4 (sub-fleets spanning two of them) over gloo against the 1-rank control,
every stage passing."""
import numpy as np
import torch

from nfopp_tpu_torch import graft_entry
from torch_threads import one_thread  # noqa: F401


def test_entry_runs_one_step_on_the_cpu():
    fn, args = graft_entry.entry(device="cpu")
    trajectories, losses = fn(*args)
    assert trajectories.shape == (8, 32, 3)
    assert losses.shape == (8,)
    assert torch.isfinite(losses).all()
    assert np.isfinite(trajectories.numpy()).all()


def test_dryrun_multichip_on_two_ranks():
    verdict = graft_entry.dryrun_multichip(2, device="cpu")
    assert {stage for stage, how in verdict.items() if how == "bits"} >= set(
        graft_entry.BITS_HOLD) | {"subfleets"}
    assert verdict["shared"] == verdict["fleet"] == "tolerance"


def test_dryrun_multichip_on_four_ranks():
    # four ranks: the sub-fleets' shared fields span two ranks each
    verdict = graft_entry.dryrun_multichip(4, device="cpu")
    assert set(verdict) == {"init", "smoke", "mean", "shared", "pipeline_init", "pipeline",
                            "fleet", "subfleets", "polygon"}
