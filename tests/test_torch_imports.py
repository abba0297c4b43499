"""Import hygiene of the port: nfopp_tpu_torch and chip_smoke.py use neither
JAX nor anything of the JAX package (the card's machine has no JAX).

The parametrised cases each import one module or script alone, in a child
forked from one clean interpreter (`-I`) that has already imported torch,
numpy and scipy.interpolate. Every module of the port imports torch, which
takes seconds to load, and the package's host math imports scipy.interpolate,
so a fresh interpreter per case spent most of the file's time loading them
again. None of the three imports anything the cases look for, so
pre-importing them hides nothing. The interpreter inherits OMP_NUM_THREADS=1
from torch_threads.one_thread, so it forks holding no thread but its own.
test_importing_the_port_loads_no_jax keeps an interpreter of its own with
nothing pre-imported."""
import json
import pathlib
import re
import subprocess
import sys

import pytest

from torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ("run_benchmark_torch", "replan_latency_torch", "dynamic_replan_demo_torch",
           "anytime_server_torch")
COMPARISON_SCRIPTS = ("run_gpmp2_torch", "analyze_results_torch", "run_planner_torch")
SUITE_SCRIPTS = ("compare_suites_torch", "shortcut_gains_torch", "run_sweep_torch",
                 "two_walls_reliability_torch", "compare_with_reference_torch",
                 "compare_holonomic_torch")
MESH_SCRIPTS = ("run_multihost_torch",)
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|optax|flax|nfopp_tpu)(\.|\s|$)", re.M)
MODULES = (
    "nfopp_tpu_torch.experimental",
    "nfopp_tpu_torch.experimental.solver",
    "nfopp_tpu_torch.experimental.merged_step",
    "nfopp_tpu_torch.tools.profile_step",
    "nfopp_tpu_torch.kernels.onf_multi",
    "nfopp_tpu_torch.kernels.field_grad_multi",
    "nfopp_tpu_torch.solver.tracking",
    "nfopp_tpu_torch.solver.holonomic",
    "nfopp_tpu_torch.solver.api",
    "nfopp_tpu_torch.solver.checkpoint",
    "nfopp_tpu_torch.utils.config",
    "nfopp_tpu_torch.worlds.oracle",
    "nfopp_tpu_torch.worlds.scenarios",
    "nfopp_tpu_torch.astar",
    "nfopp_tpu_torch.parallel",
    "nfopp_tpu_torch.bench",
    "nfopp_tpu_torch.bench.runner",
    "nfopp_tpu_torch.service",
    "nfopp_tpu_torch.service.postprocessor",
    "nfopp_tpu_torch.service.world_state",
    "nfopp_tpu_torch.service.replanner",
    "nfopp_tpu_torch.service.session",
    "nfopp_tpu_torch.service.fleet",
    "nfopp_tpu_torch.baselines",
    "nfopp_tpu_torch.baselines.gpmp2",
    "nfopp_tpu_torch.bench.adapter",
    "nfopp_tpu_torch.bench.analysis",
    "nfopp_tpu_torch.plotting",
    "nfopp_tpu_torch.utils",
    "nfopp_tpu_torch.utils.position2",
    "nfopp_tpu_torch.utils.factory",
    "nfopp_tpu_torch.utils.timer",
    "nfopp_tpu_torch.utils.profiling",
    "nfopp_tpu_torch.parallel.mesh",
    "nfopp_tpu_torch.graft_entry",
)
NO_JAX = ("import sys\n"
          "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'jaxlib', 'optax', 'flax', 'nfopp_tpu'))\n"
          "assert not bad, bad\n")
SUITE_NO_JAX = ("import sys\n"
                "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'optax', 'flax', 'nfopp_tpu', 'compare_suites', "
                "'run_benchmark', 'shortcut_gains'))\n"
                "assert not bad, bad\n")


def load_script(name: str) -> str:
    """Code that loads scripts/<name>.py as a module, as chip_smoke.py loads it."""
    return ("import importlib.util, sys\n"
            f"path = {str(ROOT / 'scripts')!r} + '/{name}.py'\n"
            f"spec = importlib.util.spec_from_file_location({name!r}, path)\n"
            "module = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(module)\n")


CASES = {
    **{f"module:{module}": ("import importlib, sys\n"
                            f"sys.path.insert(0, {str(ROOT)!r})\n"
                            f"importlib.import_module({module!r})\n" + NO_JAX)
       for module in MODULES},
    **{f"service:{name}": (load_script(name) + "import nfopp_tpu_torch.service\n"
                           "assert callable(module.main)\n" + NO_JAX)
       for name in SCRIPTS[1:]},
    **{f"comparison:{name}": (
        load_script(name)
        + "import nfopp_tpu_torch.baselines, nfopp_tpu_torch.bench, nfopp_tpu_torch.plotting\n"
        "assert callable(module.main)\n" + NO_JAX + "assert 'matplotlib' not in sys.modules\n")
       for name in COMPARISON_SCRIPTS},
    **{f"suite:{name}": (load_script(name)
                         + f"sys.path.insert(0, {str(ROOT / 'scripts')!r})\n"
                         "import compare_suites_torch, run_benchmark_torch\n"
                         "import nfopp_tpu_torch.bench.runner, nfopp_tpu_torch.parallel\n"
                         "assert callable(module.main)\n" + SUITE_NO_JAX)
       for name in SUITE_SCRIPTS},
    **{f"mesh:{name}": (load_script(name)
                        + "import nfopp_tpu_torch.parallel.mesh, nfopp_tpu_torch.graft_entry\n"
                        "assert callable(module.main) and callable(module.run)\n" + NO_JAX)
       for name in MESH_SCRIPTS},
}

# Runs in the clean interpreter: reads {key: code} from stdin, runs each code
# in a child forked after torch, numpy and scipy are loaded, and prints {key: error},
# where an empty error means the child ran its code through.
RUNNER = """
import json, os, sys, traceback
import numpy, scipy.interpolate, torch

cases = json.load(sys.stdin)
errors = {}
for key, code in cases.items():
    read, write = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(read)
        try:
            exec(compile(code, key, "exec"), {"__name__": "__case__"})
            error = ""
        except BaseException:
            error = traceback.format_exc()
        os.write(write, error.encode())
        os._exit(0)
    os.close(write)
    with os.fdopen(read, "rb") as pipe:
        error = pipe.read().decode()
    _, status = os.waitpid(pid, 0)
    if status and not error:
        error = f"the child ended with wait status {status}"
    errors[key] = error
print(json.dumps(errors))
"""


@pytest.fixture(scope="module")
def import_errors():
    """Every case's error, from one interpreter that forks a child per case."""
    # -I: ignore PYTHONPATH and user site, so nothing but the port is imported
    result = subprocess.run([sys.executable, "-I", "-c", RUNNER], input=json.dumps(CASES),
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    return json.loads(result.stdout.splitlines()[-1])


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import nfopp_tpu_torch\n"
        "for mod in pkgutil.walk_packages(nfopp_tpu_torch.__path__, 'nfopp_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'flax', 'nfopp_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('nfopp_tpu_torch')]))\n"
    )
    # -I: ignore PYTHONPATH and user site, so nothing but the port is imported
    result = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                            timeout=120)
    assert result.returncode == 0, result.stderr
    assert int(result.stdout.strip()) > 20


def test_no_jax_import_statements():
    files = sorted((ROOT / "nfopp_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / "scripts" / f"{name}.py"
        for name in SCRIPTS + COMPARISON_SCRIPTS + SUITE_SCRIPTS + MESH_SCRIPTS]
    assert len(files) > 20
    for path in files:
        match = FORBIDDEN.search(path.read_text())
        assert match is None, f"{path.relative_to(ROOT)}: {match.group(0).strip()}"


@pytest.mark.parametrize("module", MODULES)
def test_the_batch_path_modules_load_no_jax(module, import_errors):
    """The bf16 batch path's modules, the tracked, grouped, holonomic and
    API modules, the benchmark suite's subpackages, the replanning
    services, and the comparison path's (the GPMP2 baseline, the adapter,
    the analysis, plotting, the host utilities), each imported alone (the
    suite's runner also pulls in the shortcut and the host math)."""
    assert not import_errors[f"module:{module}"], import_errors[f"module:{module}"]


@pytest.mark.parametrize("name", SCRIPTS[1:])
def test_the_service_scripts_load_no_jax(name, import_errors):
    """Each replanning-service script, loaded as a module as chip_smoke.py
    loads it, with the service package it drives."""
    assert not import_errors[f"service:{name}"], import_errors[f"service:{name}"]


@pytest.mark.parametrize("name", COMPARISON_SCRIPTS)
def test_the_comparison_scripts_load_no_jax(name, import_errors):
    """Each script of the comparison path (GPMP2, the analysis CLI, the
    demo), loaded as a module as chip_smoke.py loads it, with the modules it
    drives; matplotlib is not among them."""
    assert not import_errors[f"comparison:{name}"], import_errors[f"comparison:{name}"]


@pytest.mark.parametrize("name", SUITE_SCRIPTS)
def test_the_suite_scripts_load_no_jax(name, import_errors):
    """Each suite and parity script, loaded as a module as chip_smoke.py
    loads it, with what its functions import (shortcut_gains_torch.py
    imports compare_suites_torch.py and run_benchmark_torch.py, never the
    JAX scripts)."""
    assert not import_errors[f"suite:{name}"], import_errors[f"suite:{name}"]


@pytest.mark.parametrize("name", MESH_SCRIPTS)
def test_the_mesh_script_loads_no_jax(name, import_errors):
    """The multi-process script, loaded as a module as chip_smoke.py loads
    it, with the mesh it drives."""
    assert not import_errors[f"mesh:{name}"], import_errors[f"mesh:{name}"]
