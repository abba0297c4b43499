"""Nothing the card runs loads JAX or the JAX package, and the reference
loads nothing of the program: top-level module names compared whole."""
import ast
import json
import subprocess
import sys

import pytest

from nfbench.harness import core

FORBIDDEN = {"jax", "jaxlib", "flax", "nfopp_tpu"}
SOURCES = sorted(p for p in core.BENCH.rglob("*.py") if "tests" not in p.parts)


def imported(path) -> set:
    """Top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(core.BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN
    if "reference" in path.parts:
        assert not imported(path) & {"nfopp_tpu_torch", "nfbench"}


def test_whole_names_are_compared():
    assert "nfopp_tpu_torch" not in FORBIDDEN and "nfopp_tpu" in FORBIDDEN
    fake = {"nfopp_tpu_torch": 1, "nfopp_tpu_torch.solver": 1, "jaxtyping": 1}
    assert not {n.split(".")[0] for n in fake} & FORBIDDEN


def test_a_run_loads_neither(tmp_path):
    """A tiny run of every cell on the CPU, then sys.modules."""
    code = f"""
import json, sys, torch
sys.path.insert(0, {str(core.ROOT)!r})
torch.set_num_threads(2)
from nfbench.harness import core
import importlib.util
spec = importlib.util.spec_from_file_location("nfrun", {str(core.BENCH / "run.py")!r})
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
for name in core.workloads():
    cell = core.Cell.load(name)
    run.run_cell(cell, 7, cell.small["seconds"], False, torch.device("cpu"), cell.small["traffic"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "nfopp_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_the_reference_alone_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {str(core.ROOT)!r})
from nfbench.harness import core
core.reference_module("planner_se2"); core.reference_module("postprocess")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"nfopp_tpu_torch"})
