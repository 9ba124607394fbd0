"""One run of one cell: set-up, the measured window, the check, the line.

Everything that belongs to one configuration, traffic mix, metric or kernel
is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json`` (data and search options), ``traffic/<traffic>.json``
(the entry point, its option overrides, the warm-up and the sample size),
``limits/<cell>.json`` (each compared number's limit), ``metrics/<metric>.py``
(a reader: ``read(run) -> float | None``) and ``kernels/<id>.json`` (the
entry points a roofline's launches go through and their device kernels).

The window is one call of ``equation_search`` with ``timeout_in_seconds``
set to ``--seconds`` and an ``niterations`` the timeout always ends first: a
closed loop, one search at a time, as its user runs it. The benchmark stamps
each iteration's end in ``Options.iteration_callback``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

from . import checks, problems

__all__ = ["Cell", "Run", "load_cell", "make_options", "search", "main"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PORT = "symbolicregression_jl_tpu_torch"
#: top-level module names that must not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "symbolicregression_jl_tpu")
#: far more iterations than any window completes: the timeout ends the call
NITERATIONS = 1_000_000


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_manifest(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT, manifest: dict | None = None) -> Cell:
    manifest = load_manifest(root) if manifest is None else manifest
    wl = {w["name"]: w for w in manifest["workloads"]}.get(name)
    if wl is None:
        raise SystemExit(f"unknown workload {name!r}")
    cfg = {c["name"]: c for c in manifest["configs"]}[wl["config"]]
    bench = root / "port_bench"
    limits_path = bench / "limits" / f"{name}.json"
    return Cell(name, wl, _json(root / cfg["file"]), _json(bench / "traffic" / f"{wl['traffic']}.json"),
                _json(limits_path) if limits_path.exists() else {})


def make_options(T, cell: Cell, seed: int, device: str, **extra):
    """The port's Options of a cell: the configuration's search options (its
    ``mutation_weights`` over the package's defaults), the traffic's
    overrides, then what the harness fixes (device, seed, no files, no
    progress output) and ``extra``."""
    kw = dict(cell.config["options"])
    kw.update(cell.traffic.get("options", {}))
    if "mutation_weights" in kw:
        kw["mutation_weights"] = T.MutationWeights(**kw["mutation_weights"])
    kw.update(device=device, seed=int(seed), save_to_file=False, progress=False, verbosity=0)
    kw.update(extra)
    return T.Options(**kw)


def search(T, X, y, options, niterations: int):
    """One call of the entry point: its SearchResult."""
    return T.equation_search(X, y, options=options, niterations=niterations, verbosity=0)


class Stamps(list):
    """``Options.iteration_callback``: the end of each iteration on the
    benchmark's clock."""

    def __call__(self, report) -> bool:
        self.append(time.perf_counter())
        return False


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    setup_s: float
    call_s: float
    t_call0: float
    stamps: list  # each iteration's end (perf_counter)
    result: object  # the call's SearchResult
    launches: dict  # kernel id -> launches in the window
    profile: dict | None = None  # the program's StageProfiler summary (traced)
    trace: dict | None = None  # Tracer.read() (traced)
    work: dict | None = None  # KernelRecorder.work() (traced)
    trace_info: dict | None = None  # what the traced run's instruments did
    peaks: dict | None = None

    @property
    def iterations(self) -> int:
        return len(self.stamps)

    def iteration_walls(self) -> list:
        return list(np.diff([self.t_call0] + self.stamps))

    def stage_ms(self, name: str):
        st = (self.profile or {}).get("stages", {}).get(name)
        return None if st is None else st["mean_ms"]


def _load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The metrics a cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced (each listed for the cell or for every cell)."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metrics(metrics: list, run: Run) -> dict:
    out = {}
    for m in metrics:
        v = _load_reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def _launch_counts(kernels: dict) -> dict:
    out = {}
    for kid, spec in kernels.items():
        mod_name, attr = spec["counter"]
        out[kid] = int(getattr(importlib.import_module(mod_name), attr).launches)
    return out


def _power_limit() -> str:
    import subprocess

    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=20)
        return p.stdout.strip().splitlines()[0] if p.returncode == 0 and p.stdout else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float):
    """Set-up, warm-up and the window of one run (no check): (Run, X, y)."""
    import torch

    T = importlib.import_module(PORT)
    from . import trace as tr

    X, y = problems.make_data(cell.config, seed)
    on_card = device.startswith("cuda")
    warm = make_options(T, cell, seed, device)
    search(T, X, y, warm, int(cell.traffic["warmup_iterations"]))
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    kernels = tr.load_kernels()
    stamps = Stamps()
    opts = make_options(T, cell, seed, device, timeout_in_seconds=float(seconds),
                        iteration_callback=stamps, profile=bool(trace))
    recorder = tracer = None
    launches0 = _launch_counts(kernels)
    with contextlib.ExitStack() as stack:
        if trace:
            recorder = tr.KernelRecorder(kernels)
            stack.callback(recorder.close)
            if on_card:
                tracer = stack.enter_context(
                    tr.Tracer(importlib.import_module(f"{PORT}.models.device_search")))
        t0 = time.perf_counter()
        result = search(T, X, y, opts, NITERATIONS)
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches = {k: v - launches0[k] for k, v in _launch_counts(kernels).items()}
    run = Run(cell, setup_s, t1 - t0, t0, list(stamps), result, launches)
    if trace:
        run.profile = getattr(result, "engine_profile", None)
        run.trace = tracer.read() if tracer is not None else None
        run.work = recorder.work()
        run.trace_info = {"recorder_batches": recorder.batches}
        run.peaks = _json(HERE / "peaks.json")
    return run, X, y


def judge(cell: Cell, run: Run, X, y, seed: int) -> tuple:
    """(correct, check rows, attempted, failed, judged) of a run."""
    judged = checks.judge(run.result, X, y, cell.config, seed,
                          int(cell.traffic["sample"]), numbers=tuple(cell.limits))
    correct, rows = checks.verdict(judged["numbers"], cell.limits)
    gaps = judged["gaps"]["hof"] + judged["gaps"]["pop"]
    attempted = len(gaps)
    failed = (sum(g > float(cell.limits["hof_loss_gap"]) for g in judged["gaps"]["hof"])
              + sum(g > float(cell.limits["pop_loss_gap"]) for g in judged["gaps"]["pop"]))
    return correct, rows, attempted, int(failed), judged


def _breakdown(run: Run) -> dict:
    def top(d):
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(run.trace["device_s_by_name"]),
            "idle_gaps": top(run.trace["idle_s_by_host"])}


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    manifest = load_manifest()
    cell = load_cell(args.workload, manifest=manifest)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if not cell.limits:
        print(f"port_bench: no limits/{cell.name}.json", file=sys.stderr)
        return 2

    run, X, y = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    memory_peak = int(torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    metrics = read_metrics(cell_metrics(manifest, cell.name, bool(args.trace)), run)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: modules loaded in the benchmark's process: {bad}", file=sys.stderr)
        return 3
    correct, rows, attempted, failed, judged = judge(cell, run, X, y, args.seed)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": memory_peak}
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        line["breakdown"] = _breakdown(run)
        line["trace_info"] = {"kernel_events": run.trace["events"],
                              "parse_s": run.trace["parse_s"], "launches": run.launches,
                              **run.trace_info}
    line["card"] = _power_limit()
    walls = run.iteration_walls()
    line["run"] = {"iterations": run.iterations, "call_s": run.call_s,
                   "first_wall_s": walls[0] if walls else None,
                   "tail_s": run.t_call0 + run.call_s - run.stamps[-1] if walls else None,
                   "near_overflow": judged["near_overflow"],
                   "num_evals": float(run.result.num_evals)}
    # a non-finite reading (a loss the reference finds finite and the run
    # does not) is written as a string: JSON has no inf
    line["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                      for name, v, lim, _ in rows}
    print(f"port_bench: {cell.name} seed {args.seed}: {run.iterations} iterations in "
          f"{run.call_s:.3f} s, set-up {run.setup_s:.3f} s", file=sys.stderr)
    for name, v, lim, ok in rows:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
