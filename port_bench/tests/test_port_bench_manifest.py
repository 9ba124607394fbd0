"""BENCHMARK.json against the benchmark's contract, and the harness finding
each cell's, metric's and kernel's files by name."""

import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["command"]) <= 32
    assert all(TEXT.match(w) for w in manifest["command"])
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    for w in manifest["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    n = 24  # the cells the budget must hold
    rs = manifest["run_seconds"]
    assert (2 + 14 * n) * (rs + 60) + n * 2 * 90 + 1200 <= 43200


def test_names_units_and_text(manifest):
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    for group, keys in (
        (manifest["configs"], {"name", "source", "file", "reduced", "why"}),
        (manifest["workloads"], {"name", "config", "traffic", "chips", "why"}),
    ):
        for e in group:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and TEXT.match(e["why"])
    for c in manifest["configs"]:
        assert TEXT.match(c["source"]) and c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    names = [m["name"] for m in metrics]
    for group in (names, [w["name"] for w in manifest["workloads"]],
                  [c["name"] for c in manifest["configs"]]):
        assert len(group) == len(set(group))
    assert "setup_s" in [m["name"] for m in manifest["end_to_end"]]
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)


def test_every_cell_reports_what_it_must(manifest):
    cells = [w["name"] for w in manifest["workloads"]]
    e2e = {m["name"]: m for m in manifest["end_to_end"]}

    def reports(metric, cell):
        return cell in metric.get("workloads", cells)

    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert any(reports(m, cell) for n, m in e2e.items() if n != "setup_s")
        assert any(reports(m, cell) for m in manifest["per_layer"])
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(e2e[m["moves"]], cell), (m["name"], cell)
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}


def test_every_file_resolves_by_name(manifest):
    for c in manifest["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith("port_bench/")
        cfg = json.loads(f.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for w in manifest["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for p in BENCH.rglob("*"):
        if "__pycache__" not in p.parts and p.is_file():
            assert PATH.match(str(p.relative_to(ROOT))), p


def test_a_cell_and_a_metric_are_added_as_files(tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell, its limits and a
    per-layer metric by new files and new manifest entries alone; the copy's
    harness runs the new cell on the host (a tiny cut) and reports the new
    metric, with no file of the benchmark edited."""
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "port_bench" / "traffic" / "dummy.json").write_text(json.dumps(
        {"options": {"should_optimize_constants": False}, "warmup_iterations": 1,
         "sample": 16}))
    (tmp_path / "port_bench" / "limits" / "config3.dummy.json").write_text(
        (BENCH / "limits" / "config3.noconst.json").read_text())
    (tmp_path / "port_bench" / "metrics" / "dummy_iters.py").write_text(
        "def read(run):\n    return run.iterations\n")
    man["workloads"].append({"name": "config3.dummy", "config": "config3", "traffic": "dummy",
                             "chips": 1, "why": "a dummy"})
    man["per_layer"].append({"name": "dummy_iters", "unit": "iterations", "better": "higher",
                             "source": "host_clock", "layer": "search driver",
                             "moves": "iter_ms", "workloads": ["config3.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    (tmp_path / "symbolicregression_jl_tpu_torch").symlink_to(
        ROOT / "symbolicregression_jl_tpu_torch")
    script = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {str(tmp_path)!r})
        from port_bench import harness
        assert harness.HERE == __import__("pathlib").Path({str(tmp_path / "port_bench")!r})
        cell = harness.load_cell("config3.dummy")
        cell.config["data"]["rows"] = 200
        cell.config["options"].update(populations=2, population_size=16,
                                      ncycles_per_iteration=3)
        run, X, y = harness.measure(cell, 5, 1.0, True, "cpu", time.perf_counter())
        m = harness.read_metrics(harness.cell_metrics(harness.load_manifest(),
                                                      "config3.dummy", True), run)
        assert list(m) == ["dummy_iters"] and m["dummy_iters"]["value"] == run.iterations >= 1
        ok, rows, *_ = harness.judge(cell, run, X, y, 5)
        assert [r[0] for r in rows] == list(cell.limits)
        print("OK")
    """)
    p = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=600, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "OK" in p.stdout
    after = {p: p.read_bytes() for p in before}
    assert after == before
