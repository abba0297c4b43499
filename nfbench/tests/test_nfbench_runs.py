"""Tiny runs of every cell on the CPU: one contract line each; the look for
a card; and the check catching a timed path broken underneath it."""
import importlib.util
import itertools
import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from nfbench import faults
from nfbench.harness import core

spec = importlib.util.spec_from_file_location("nfbench_run", core.BENCH / "run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345


def small_run(name: str, seed: int = SEED):
    cell = core.Cell.load(name)
    return run.run_cell(cell, seed, cell.small["seconds"], False, CPU, cell.small["traffic"])


@pytest.mark.parametrize("name", core.workloads())
def test_one_contract_line(name):
    result, checks = small_run(name)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    cell = core.Cell.load(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for k, v in line["metrics"].items() if k != "feasible_frac")
    assert line["attempted"] > 0 and set(line["checks"]) == set(cell.limits)


def test_the_command_needs_a_card(tmp_path):
    """Without a card the command exits with another code than 0 and
    prints no result, also from a directory that holds only the benchmark."""
    alone = tmp_path / "alone"
    shutil.copytree(core.BENCH, alone / "nfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(core.ROOT / "BENCHMARK.json", alone / "BENCHMARK.json")
    for cwd in (core.ROOT, alone):
        out = subprocess.run([sys.executable, "nfbench/run.py", "--workload", "car-batch-256",
                              "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                             capture_output=True, text=True, timeout=300, cwd=cwd,
                             env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0 and out.stdout.strip() == ""


def test_seeds_give_the_same_work():
    """Two seeds solve the same number of problems with the same calls."""
    a, _ = small_run("car-batch-256", 1)
    b, _ = small_run("car-batch-256", 2 ** 32 + 7)
    assert a["attempted"] % 8 == 0 and b["attempted"] % 8 == 0


# ---------------------------------------------------- the counted batches

PROBLEMS = core.Cell.load("car-batch-256").small["traffic"]["problems"]


def ticking_window(monkeypatch) -> list:
    """Give the batch driver a clock that reads one second more at each
    reading, and collect the drivers made. The window reads it at its start
    and twice a batch (before starting it and when it completes), so a
    window of 2n seconds holds n batches."""
    made, real = [], core.driver_module

    def driver_module(name):
        module = real(name)
        ticks = itertools.count()
        module.time = types.SimpleNamespace(perf_counter=lambda: float(next(ticks)))

        class Driver(module.Driver):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)

        module.Driver = Driver
        return module

    monkeypatch.setattr(core, "driver_module", driver_module)
    return made


def batches_run(monkeypatch, batches: int, traffic: dict | None = None):
    cell = core.Cell.load("car-batch-256")
    made = ticking_window(monkeypatch)
    result, _ = run.run_cell(cell, SEED, 2 * batches, False, CPU,
                             {**cell.small["traffic"], **(traffic or {})})
    driver = made[-1]
    assert len(driver.batches) == batches
    return result, driver


def test_the_count_is_the_same_however_many_batches_the_window_holds(monkeypatch):
    """One seed's runs whose windows hold 1 and 3 batches count the same
    problems: the same attempted and failed, and the same collisions."""
    one, short = batches_run(monkeypatch, 1)
    three, long = batches_run(monkeypatch, 3)
    assert one["attempted"] == three["attempted"] == PROBLEMS
    assert one["failed"] == three["failed"]
    assert torch.equal(short.counted_collides(), long.counted_collides())
    assert torch.equal(short.batches[0][1], long.batches[0][1])
    assert one["correct"] and three["correct"]


def test_solves_per_s_counts_every_batch_of_the_window(monkeypatch):
    result, driver = batches_run(monkeypatch, 3)
    assert result["attempted"] == PROBLEMS
    assert result["metrics"]["solves_per_s"]["value"] == 3 * PROBLEMS / driver.elapsed
    attempted, failed = result["attempted"], result["failed"]
    assert result["metrics"]["feasible_frac"]["value"] == 100.0 * (attempted - failed) / attempted


def test_a_short_window_counts_the_batches_it_completed(monkeypatch):
    result, _ = batches_run(monkeypatch, 2, {"counted_batches": 3})
    assert result["attempted"] == 2 * PROBLEMS


# ------------------------------------------------------------- the faults

FAULTS = [(name, fault) for name in core.workloads()
          for fault in core.Cell.load(name).small["faults"]]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_the_check_refuses_a_broken_timed_path(monkeypatch, name, fault):
    """Each fault the cell's traffic lists (a step that returns its state
    unchanged; half or a quarter of the batch left out; an answer altered;
    the fleet's group mean over half of each group) comes out as not
    correct."""
    result, _ = small_run(name)
    assert result["correct"] is True
    faults.plant(core.Cell.load(name).small["faults"][fault], monkeypatch.setattr)
    result, checks = small_run(name)
    assert result["correct"] is False, checks
