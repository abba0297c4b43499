"""The port's multi-process script (scripts/run_multihost_torch.py) on the
CPU, as tests/test_multihost.py holds the JAX one: two ranks over gloo (a
file rendezvous under the test's temporary directory) against one process
of the same global batch of the car scene at full width, 20 steps.

The metrics reduced over the mesh agree across ranks and with the single
process; every rank cuts its rows from the random blocks drawn for the
global batch, so the per-problem decisions (feasible or not) are the single
process's. A field shared by the whole batch spans both ranks: its
replicas stay bit-identical, gathered.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

from torch_threads import one_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "run_multihost_torch.py"

STEPS = 20
BATCH_PER_HOST = 4  # global batch 8 in the 2-process run
TIMEOUT = 300  # seconds for each process, and for each collective


def _launch(tmp: pathlib.Path, name: str, num_processes: int, process_id: int,
            batch_per_host: int, extra=()):
    cmd = [sys.executable, str(SCRIPT), "--cpu", "--num-processes", str(num_processes),
           "--process-id", str(process_id), "--batch-per-host", str(batch_per_host),
           "--steps", str(STEPS), "--json-out", str(tmp / f"{name}.json"),
           "--timeout", str(TIMEOUT), *extra]
    if num_processes > 1:
        cmd += ["--init-file", str(tmp / f"rendezvous-{name.split('-')[0]}")]
    # stdout goes to a file: the ranks wait on each other, so a full pipe on
    # one would stall both
    log = (tmp / f"{name}.log").open("w")
    return subprocess.Popen(cmd, cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT)


def _results(tmp, procs: dict) -> dict:
    try:
        for p in procs.values():
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        log = (tmp / f"{name}.log").read_text()
        assert p.returncode == 0, f"{name} (rc {p.returncode}):\n" + "\n".join(
            log.splitlines()[-25:])
    return {name: json.loads((tmp / f"{name}.json").read_text()) for name in procs}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every process at once: the 2-rank run, the single process, and the
    2-rank run with one field shared by all 8 problems."""
    tmp = tmp_path_factory.mktemp("multihost")
    procs = {f"pair-{i}": _launch(tmp, f"pair-{i}", 2, i, BATCH_PER_HOST) for i in range(2)}
    procs.update({f"grouped-{i}": _launch(tmp, f"grouped-{i}", 2, i, BATCH_PER_HOST,
                                          ("--group-size", str(2 * BATCH_PER_HOST)))
                  for i in range(2)})
    procs["single"] = _launch(tmp, "single", 1, 0, 2 * BATCH_PER_HOST)
    return _results(tmp, procs)


def test_two_process_distributed_matches_single_process(runs):
    pair = [runs["pair-0"], runs["pair-1"]]
    single = runs["single"]
    for i, r in enumerate(pair):
        assert r["process_id"] == i and r["num_processes"] == 2, r
        assert r["total_batch"] == 2 * BATCH_PER_HOST and r["backend"] == "gloo", r
    assert single["num_processes"] == 1 and single["backend"] is None
    # the all_reduced global metric agrees across ranks
    assert pair[0]["mean_loss"] == pytest.approx(pair[1]["mean_loss"], rel=1e-6)
    assert pair[0]["mean_loss"] == pytest.approx(single["mean_loss"], rel=1e-4)
    assert pair[0]["mean_final_xy"] == pytest.approx(single["mean_final_xy"], rel=1e-4)
    # decisions: every problem's feasibility as the single process decides it
    assert pair[0]["feasible"] == pair[1]["feasible"] == single["feasible"]
    assert len(single["feasible"]) == 2 * BATCH_PER_HOST
    # one all_reduce per run call (the schedule), none per step without a shared field
    assert pair[0]["collectives"] == 1 and single["collectives"] == 0


def test_a_field_shared_by_both_ranks_keeps_its_replicas_bit_identical(runs):
    grouped = [runs["grouped-0"], runs["grouped-1"]]
    for r in grouped:
        assert r["group_size"] == 2 * BATCH_PER_HOST and r["replicas_equal"] is True, r
        # one all_reduce per field step (run_grouped's schedule is static)
        assert r["collectives"] == STEPS, r
    assert grouped[0]["mean_loss"] == pytest.approx(grouped[1]["mean_loss"], rel=1e-6)
    assert grouped[0]["feasible"] == grouped[1]["feasible"]
