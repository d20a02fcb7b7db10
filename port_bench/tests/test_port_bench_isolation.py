"""The benchmark loads no JAX and no JAX package, the reference nothing of
the port, and without a card a run fails and prints no result."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import catalog

ROOT = catalog.ROOT
CHECKOUT = ROOT.parent


def test_run_workloads_and_reference_load_no_jax():
    code = f"""
import importlib.util, sys
sys.path.insert(0, {str(CHECKOUT)!r})
spec = importlib.util.spec_from_file_location("run_under_test", {str(ROOT / "run.py")!r})
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
from port_bench import catalog, harness, program, traffic, trace
from port_bench.reference import train, graph, precision, TGAT, DyGFormer
for name in catalog.names()["workloads"]:
    catalog.cell(name)
catalog.metrics(); catalog.work()
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300, check=True).stdout
    top = set(out.strip().split(","))
    assert not top & {"jax", "jaxlib", "flax", "dyglib_tpu"}, top & {"jax", "jaxlib", "flax"}
    assert "dyglib_tpu_torch" in top  # compared whole: the port's name is not the JAX package's


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_port():
    for path in sorted((ROOT / "reference").glob("*.py")):
        assert not _imports(path) & {"dyglib_tpu_torch", "dyglib_tpu", "jax", "jaxlib", "flax",
                                     "port_bench"}, path.name


def test_only_program_imports_the_port():
    paths = [p for p in ROOT.rglob("*.py") if "tests" not in p.parts]
    users = {p.name for p in paths if "dyglib_tpu_torch" in _imports(p)}
    assert users == {"program.py"}
    for p in paths:
        assert not _imports(p) & {"jax", "jaxlib", "flax", "dyglib_tpu"}, p.name


def test_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot be shown here")
    proc = subprocess.run([sys.executable, str(ROOT / "run.py"), "--workload",
                           "tgat_wikipedia.eval", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=CHECKOUT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_unknown_workload_fails():
    proc = subprocess.run([sys.executable, str(ROOT / "run.py"), "--workload", "no_such.cell",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=CHECKOUT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
