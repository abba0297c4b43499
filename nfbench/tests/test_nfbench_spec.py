"""BENCHMARK.json against the benchmark's contract, and every file its
names point at."""
import json
import math
import re

import pytest

from nfbench.harness import core

SPEC = core.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "nfbench/run.py"]
    assert SPEC["paths"] == ["nfbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_every_name_and_unit():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for metric in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])


def test_metrics_and_their_cells():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads", "bound"} == METRIC_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= set(cells)
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) == METRIC_KEYS | {"layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].startswith("roofline.") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for name in cells:
        own = [m for m in SPEC["end_to_end"] if name in m.get("workloads", cells)]
        assert len(own) >= 2 and "setup_s" in [m["name"] for m in own]
        assert any(name in m["workloads"] for m in SPEC["per_layer"])


def test_cells_resolve_their_files():
    used = set()
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        cell = core.Cell.load(w["name"], SPEC)
        used.add(w["config"])
        assert (core.BENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        assert (core.BENCH / "reference" / f"{cell.config['reference']}.py").is_file()
        for m in cell.per_layer:
            assert hasattr(core.metric_reader(m["name"]), "read")
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, math.floor(0.25 * len(SPEC["workloads"])))
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"] == f"nfbench/configs/{c['name']}.json"
        assert json.loads((core.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_a_batch_solves_as_the_configuration_states(workload):
    cell = core.Cell.load(workload, SPEC)
    if cell.traffic["driver"] == "batch_solve":
        assert sum(cell.traffic["calls"]) == cell.config["solver"]["iterations"]
        assert set(cell.traffic["followed_calls"]) <= set(range(len(cell.traffic["calls"])))


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_limits_name_every_number_checked(workload):
    limits = core.load_json("limits", workload)
    assert limits and all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())
