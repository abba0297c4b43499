"""The frozen work counts reproduce the kernel bounds of PERF.md's kernel
table (B=256; M=209 for the field gradient, 99 for the collision terms,
199 for the candidates' forward; H100 SXM peaks)."""
import pytest

from nfbench.counts import field_work
from nfbench.harness import core

SOLVER = core.load_json("configs", "car-se2")["solver"]
ONF = SOLVER["onf"]
SXM = field_work.card_peaks("NVIDIA H100 80GB HBM3")


def test_param_count_matches_the_configuration():
    assert field_work.param_count(ONF) == ONF["parameters"] == 33141


@pytest.mark.parametrize("function,m,bound_ms", [
    ("field_grad", 209, 0.1565), ("collision", 99, 0.0495), ("forward", 199, 0.0498)])
def test_bounds_of_the_kernel_table(function, m, bound_ms):
    seconds = field_work.bound_s(function, ONF, 256, m, SXM, "f32")
    assert round(seconds * 1e3, 4) == bound_ms


def test_step_points_and_flops():
    assert field_work.step_points(SOLVER) == {"forward": 199, "field_grad": 209, "collision": 99}
    assert field_work.step_flops(SOLVER, 256) == 17151815680.0


def test_peaks_by_card_name():
    assert field_work.card_peaks("NVIDIA H100 PCIe")["f32"] == 51.2e12
    assert field_work.card_peaks("NVIDIA H100 NVL")["bytes_per_s"] == 3.9e12
    assert SXM["f32"] == 67.0e12
