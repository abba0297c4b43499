"""scripts/profile_step_torch.py, the counterpart of scripts/profile_step.py,
on the CPU: its five variants are the JAX script's (labels in order, each
config field for field against `run_planner_config()._replace(...)` with the
JAX script's own arguments, read from its source), and a tiny run (B=2, 10
steps) prints its JSON with every variant, the two whose reparametrization
freq does not divide the steps marked as the dynamic schedule. The card's
run is chip_smoke.py phase 16c."""
import ast
import importlib.util
import json
import pathlib
import subprocess
import sys

from nfopp_tpu.solver import run_planner_config as jax_run_planner_config

ROOT = pathlib.Path(__file__).resolve().parent.parent


def load_script():
    path = ROOT / "scripts" / "profile_step_torch.py"
    spec = importlib.util.spec_from_file_location("profile_step_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_variants() -> list:
    """[(label, {field: value})] of scripts/profile_step.py: the labels of its
    `measure` calls and the arguments of its `base_cfg._replace` calls, in
    source order (each kind sits at one depth of `main`, which ast.walk
    visits breadth first); the full step replaces nothing."""
    tree = ast.parse((ROOT / "scripts" / "profile_step.py").read_text())
    labels, replaced = [], [{}]
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Name) and func.id == "measure":
            labels.append(node.args[0].value)
        if (isinstance(func, ast.Attribute) and func.attr == "_replace"
                and isinstance(func.value, ast.Name) and func.value.id == "base_cfg"):
            replaced.append({kw.arg: ast.literal_eval(kw.value) for kw in node.keywords})
    return list(zip(labels, replaced))


def test_the_five_variants_are_the_jax_script_s_field_for_field():
    script = load_script()
    want = jax_variants()
    assert [(label, fields) for label, fields in script.VARIANTS] == want
    base = jax_run_planner_config()
    for (label, config), (_, fields) in zip(script.variant_configs(), want):
        jax_config = base._replace(**fields)
        assert {**config._asdict(), "onf": config.onf._asdict()} == {
            **jax_config._asdict(), "onf": jax_config.onf._asdict()}, label


def test_a_tiny_run_prints_every_variant():
    result = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "profile_step_torch.py"), "--device", "cpu",
         "--batch", "2", "--steps", "10", "--aot"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"},
    )
    assert result.returncode == 0, result.stderr[-2000:]
    out = json.loads(result.stdout.strip().splitlines()[-1])
    assert out["metric"] == "step_ablation_us_per_step_per_problem" and out["device"] == "cpu"
    assert (out["batch"], out["steps"], out["aot"]) == (2, 10, True)
    assert list(out["variants"]) == [label for label, _ in jax_variants()]
    dynamic = {"no reparametrization", "trajectory update only"}
    for label, v in out["variants"].items():
        assert v["schedule"] == ("dynamic" if label in dynamic else "static")
        assert v["captured"] is False and v["us_per_step_per_problem"] > 0
    assert result.stderr.count("eager (dynamic schedule)") == 2
