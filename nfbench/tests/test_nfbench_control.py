"""The control, the reference in the nearest precision below the
configuration's (TF32 for f32 with TF32 off) put in the program's place,
must come out as not correct: on the CPU at a small size, and on the card
at each cell's own size over three seeds; so must each fault the cell's
traffic lists, planted under the timed path at the cell's own size."""
import json
import subprocess
import sys

import pytest
import torch

from nfbench import readings
from nfbench.harness import core


def refused(cell, numbers: dict) -> bool:
    return any(numbers[name] > limit for name, limit in cell.limits.items())


@pytest.mark.parametrize("name", core.workloads())
def test_control_refused_at_a_small_size(name):
    cell = core.Cell.load(name)
    for seed, candidate, numbers in readings.readings(cell, [3, 2 ** 33 + 1],
                                                      cell.small["seconds"], torch.device("cpu"),
                                                      cell.small["traffic"]):
        assert refused(cell, numbers) == (candidate == "control"), (seed, candidate, numbers)


@pytest.mark.card
@pytest.mark.parametrize("name", core.workloads())
def test_control_refused_at_the_cell_size(card, name):
    cell = core.Cell.load(name)
    for seed, candidate, numbers in readings.readings(cell, [101, 2 ** 31 + 5, 2 ** 40 + 9],
                                                      cell.small["card_seconds"], card):
        assert refused(cell, numbers) == (candidate == "control"), (seed, candidate, numbers)


@pytest.mark.card
@pytest.mark.parametrize("name,fault", [(name, fault) for name in core.workloads()
                                        for fault in core.Cell.load(name).small["faults"]])
def test_faults_refused_at_the_cell_size(card, name, fault):
    """Each fault the cell's traffic lists, planted at the cell's own size,
    comes out as not correct on three seeds. Each fault runs in a process
    of its own: a captured program outlives a patch planted after it was
    captured, so a fault planted in this process after another test had
    captured the cell's programs would not reach the card."""
    cell = core.Cell.load(name)
    seeds = [103, 2 ** 31 + 7, 2 ** 40 + 11]
    out = subprocess.run([sys.executable, str(core.BENCH / "readings.py"), "--workload", name,
                          "--seeds", ",".join(map(str, seeds)),
                          "--seconds", str(cell.small["card_seconds"]), "--fault", fault],
                         capture_output=True, text=True, timeout=900, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert [line["seed"] for line in lines] == seeds
    for numbers in lines:
        assert refused(cell, numbers), (fault, numbers)
