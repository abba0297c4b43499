"""Import hygiene of the port: nfopp_tpu_torch and chip_smoke.py use neither
JAX nor anything of the JAX package (the card's machine has no JAX)."""
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|optax|flax|nfopp_tpu)(\.|\s|$)", re.M)


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
    files = sorted((ROOT / "nfopp_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        match = FORBIDDEN.search(path.read_text())
        assert match is None, f"{path.relative_to(ROOT)}: {match.group(0).strip()}"


@pytest.mark.parametrize("module", [
    "nfopp_tpu_torch.experimental",
    "nfopp_tpu_torch.experimental.solver",
    "nfopp_tpu_torch.kernels.onf_multi",
    "nfopp_tpu_torch.kernels.field_grad_multi",
    "nfopp_tpu_torch.solver.tracking",
    "nfopp_tpu_torch.solver.holonomic",
    "nfopp_tpu_torch.solver.api",
    "nfopp_tpu_torch.solver.checkpoint",
    "nfopp_tpu_torch.utils.config",
    "nfopp_tpu_torch.worlds.oracle",
])
def test_the_batch_path_modules_load_no_jax(module):
    """The bf16 batch path's modules and the tracked, grouped, holonomic and
    API modules, each imported alone."""
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'flax', 'nfopp_tpu'))\n"
        "assert not bad, bad\n"
    )
    result = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                            timeout=120)
    assert result.returncode == 0, result.stderr
