"""No JAX in the benchmark: the forbidden names compared whole, the
reference's imports, and a run that finds no card."""

import ast
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from port_bench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"


@pytest.mark.parametrize("name, caught", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax", True),
    ("symbolicregression_jl_tpu", True), ("symbolicregression_jl_tpu.ops.interp", True),
    ("symbolicregression_jl_tpu_torch", False), ("symbolicregression_jl_tpu_torch.ops", False),
    ("jaxtyping", False), ("flaxen", False),
])
def test_forbidden_names_are_whole_top_level_names(monkeypatch, name, caught):
    for m in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (harness.forbidden_modules() != []) is caught


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_neither_jax_nor_the_program():
    for f in ("reference.py", "checks.py", "problems.py", "workcounts.py"):
        got = _imports(BENCH / f)
        assert not got & {"jax", "jaxlib", "flax", "symbolicregression_jl_tpu",
                          harness.PORT}, (f, got)
    for f in BENCH.rglob("*.py"):
        assert not _imports(f) & {"jax", "jaxlib", "flax", "symbolicregression_jl_tpu"}, f


def test_a_search_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from port_bench import harness\n"
        "cell = harness.load_cell('config3.noconst')\n"
        "cell.config['data']['rows'] = 100\n"
        "cell.config['options'].update(populations=2, population_size=12,"
        " ncycles_per_iteration=2)\n"
        "harness.measure(cell, 3, 0.5, False, 'cpu', time.perf_counter())\n"
        "print('FORBIDDEN', harness.forbidden_modules())\n" % str(ROOT)
    )
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "FORBIDDEN []" in p.stdout


def _run(cwd: Path):
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "config3.search", "--seed",
         str(2**31 + 9), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == "", (p.returncode, p.stdout)


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and port_bench/ has no program."""
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["port_bench"]
