#!/usr/bin/env python3
"""Time kernels B1 (fused eval+loss), B2 (fused loss+gradient), B3 (evolve
block) and B4 (prediction matrix) of one checkout of the PyTorch port on one
NVIDIA GPU, with the timing code of this repository's ``chip_smoke.py``.

    python3 chip_kernel_timing.py [--root DIR] [--label NAME]
    python3 chip_kernel_timing.py --pairs DIR [--n-pairs 10]
    python3 chip_kernel_timing.py --legs [--root DIR] [--label NAME] [--build-dir DIR]

``--root`` is the root of the checkout whose package is built and timed
(default: this repository). Because the timing code is always this file's
``chip_smoke.py``, two checkouts are timed by the same code, so a parent and
a change compare within one call on one card; run them in turns (parent,
change, change, parent):

    git archive <parent> | tar -x -C _ab/parent
    python3 chip_kernel_timing.py --root _ab/parent --label parent
    python3 chip_kernel_timing.py --label change

This prints what ``chip_smoke.py`` prints for its timings (B1 at P = 1024
and 4,200 programs x 10k rows with slot-evals/s, also as the device's time
alone; B2 at P = 4,200 x 10k rows,
the engine's constant-optimization shape, and at P = 1024 x 50 rows, a
minibatch; B3's 1- and 100-cycle times at config3 width on 256, 2,500 and
10,000 rows with the row sweep's intercept and slope; B4 at P = 1024 x 10k
rows; B2 and B4 also as the device's time alone), the ptxas lines of the
four kernels' builds, and as its last line one JSON object with the label,
the card's name and power limit, and the numbers.

``--shapes ROUNDS`` instead times B2 (at both shapes) and B4 of this
checkout at each launch shape (threads x rows per thread) in ``SHAPES``,
ROUNDS times over all shapes: how the launched shapes were chosen.

``--pairs DIR`` instead loads the package of the checkout under DIR beside
this repository's, in one process, and times one launch of one B3 cycle at
config3 width on 256 rows (the launch whose time is mostly per-launch cost)
for both, alternating which goes first, ``--n-pairs`` times: each side's
time as ``chip_smoke.time_ms`` takes it (host and device), the device time
alone (the launch queued behind a sleeping kernel, so the host's part is
hidden) and the host's time in the wrapper alone. Both sides get the same
inputs and must give the same outputs.

``--legs`` instead times, for the checkout at ``--root``, the two paths
whose time is the host's launch rate: config3's device engine on the event
leg (``chip_smoke.engine_path`` with ``SR_ENGINE_BLOCK=0``: evolve ms per
cycle from CUDA events, and each evolve leg's host ms) and the units run on
the engine (``chip_smoke.options_units``: its event leg's ms per cycle).
Run in turns as above, one process per side. ``--build-dir`` points the
checkout's kernel build directory there: the libraries are named by the
hash of their sources and flags, so checkouts with the same kernel sources
build once between them.

``--line-search`` instead checks and times the const-opt leg's line search
on the card: B1 on config3's shape with the 13 trial steps of 4,200
instances in one launch on 13 step lanes against 13 launches, bit for bit,
both timed in turns (``chip_smoke.line_search_launch_check``), then the
config3 engine with its first const-opt leg under the sync census
(``chip_smoke.engine_path``), which must find no sync. ``--const-opt``
times the quick start's const-opt legs of the checkout at ``--root``
(``chip_smoke.quick_start_const_opt``); run it in turns as above.
``--line-search-hist SEED`` runs one window of the benchmark's
``config3.search`` cell (``port_bench.harness.measure``, ``--seconds``,
default 51) and prints the engine's ``line_search`` counts: how many
instances accepted each step.

Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--pairs", default=None,
                    help="root of a second checkout: time one B3 cycle of both, alternating")
    ap.add_argument("--n-pairs", type=int, default=10)
    ap.add_argument("--shapes", type=int, default=0, metavar="ROUNDS",
                    help="time B2 and B4 at each launch shape in SHAPES, ROUNDS times")
    ap.add_argument("--legs", action="store_true",
                    help="time the config3 event leg and the units event leg")
    ap.add_argument("--build-dir", default=None,
                    help="the kernel build directory (shared between checkouts)")
    ap.add_argument("--line-search", action="store_true",
                    help="check and time the line search's one B1 launch; the sync census")
    ap.add_argument("--const-opt", action="store_true",
                    help="time the quick start's const-opt legs")
    ap.add_argument("--line-search-hist", type=int, default=None, metavar="SEED",
                    help="the line_search counts of one config3.search window")
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_timing: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    # the timed package comes from --root, the timing code from here
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from symbolicregression_jl_tpu_torch.ops import interp_cuda

    pkg = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(interp_cuda.__file__))))
    if pkg != root:
        print(f"chip_kernel_timing: the package came from {pkg}, not {root}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[{args.label}] card: {smi}; package {pkg}", flush=True)
    device = torch.device("cuda", 0)
    if args.build_dir:
        from pathlib import Path

        interp_cuda.BUILD_DIR = Path(os.path.abspath(args.build_dir))
    if args.line_search:
        interp_cuda.build_all()
        out = chip_smoke.line_search_launch_check(device)
        chip_smoke.engine_path(device, None, block=True, census=chip_smoke.lint_port())
        print(json.dumps({"label": args.label, "card": smi, "line_search": out}), flush=True)
        return 0
    if args.const_opt:
        interp_cuda.build_all()
        out = chip_smoke.quick_start_const_opt(device)
        print(json.dumps({"label": args.label, "card": smi, "const_opt": out}), flush=True)
        return 0
    if args.line_search_hist is not None:
        out = line_search_hist(args.line_search_hist, args.seconds)
        print(json.dumps({"label": args.label, "card": smi, "line_search_hist": out}),
              flush=True)
        return 0
    if args.legs:
        interp_cuda.build_all()
        out = legs(chip_smoke, device)
        print(json.dumps({"label": args.label, "card": smi, "legs": out}), flush=True)
        return 0
    if args.pairs:
        out = pairs(chip_smoke, device, os.path.abspath(args.pairs), args.n_pairs)
        print(json.dumps({"label": args.label, "card": smi, "pairs": out}), flush=True)
        return 0
    interp_cuda.build_all()
    ptxas = {}
    for name, info in interp_cuda.BUILD_INFO.items():
        ptxas[name] = [ln.strip() for ln in info["log"].splitlines()
                       if "Function properties" in ln or "spill" in ln or "registers" in ln]
        for line in ptxas[name]:
            print(f"  [{args.label}] {name}: {line}", flush=True)
    out = shapes(chip_smoke, device, args.shapes) if args.shapes else measure(chip_smoke, device)
    print(json.dumps({"label": args.label, "card": smi, "ptxas": ptxas, **out}), flush=True)
    return 0


def measure(chip_smoke, device) -> dict:
    """B1 at chip_smoke.B1_TIMED_P, B2 at chip_smoke.B2_TIMED, B3's row
    sweep and B4 at P = 1024, as chip_smoke.py times them."""
    b1 = {P: chip_smoke.b1_timing(device, P) for P in chip_smoke.B1_TIMED_P}
    b2 = {(P, R): chip_smoke.b2_timing(device, P, R) for P, R in chip_smoke.B2_TIMED}
    b3 = chip_smoke.b3_timing(device, plain=False)
    b4 = chip_smoke.b4_timing(device, 1024)
    rate = ("ms", "slot_evals_per_s")
    return {"b1": {str(P): {k: t[k] for k in rate + ("device_ms",)} for P, t in b1.items()},
            "b2": {f"{P}x{R}": {k: t[k] for k in rate + ("device_ms",)}
                   for (P, R), t in b2.items()},
            "b3": {k: b3[k] for k in ("ms", "ms_per_cycle", "sweep")},
            "b4": {k: b4[k] for k in rate + ("device_ms", "entry_ms")}}


def line_search_hist(seed: int, seconds: float) -> dict:
    """One window of the benchmark's ``config3.search`` cell, as the
    benchmark runs it untraced, and what the engine counted of its line
    searches; the run's ``correct`` as the benchmark judges it."""
    sys.path.insert(1, HERE)
    from port_bench import harness

    cell = harness.load_cell("config3.search")
    run, X, y = harness.measure(cell, seed, seconds, False, "cuda", time.perf_counter())
    correct = harness.judge(cell, run, X, y, seed)[0]
    ls = run.result.engine_stats["line_search"]
    hist = ls["accepted_at"]
    n = sum(hist)
    print(f"config3.search seed {seed}: {run.iterations} iterations in {run.call_s:.3f} s "
          f"({1e3 * run.call_s / max(run.iterations, 1):.2f} ms an iteration), correct "
          f"{correct}; line searches {ls['searches']} ({ls['wide']} wide), {n} instances, "
          "accepted at k = 0..12, frozen: " + ", ".join(
              f"{h} ({h / max(n, 1):.2%})" for h in hist), flush=True)
    return {"seed": seed, "iterations": run.iterations, "call_s": run.call_s,
            "correct": bool(correct), **ls}


#: the (threads, RPT) launch shapes ``--shapes`` times for B2 and B4
SHAPES = ((256, 4), (128, 4), (256, 2), (128, 2), (64, 4), (256, 1))


def legs(chip_smoke, device) -> dict:
    """The config3 event leg and the units run on the engine's event leg,
    as chip_smoke.py runs and checks them (phases 5 and 8 (b))."""
    _, event = chip_smoke.engine_path(device, None, block=False)
    units = chip_smoke.options_units(device)
    return {"event_ms_per_cycle": event["ms_per_cycle"],
            "event_evolve_leg_host_ms": event["leg_walls_ms"]["evolve"],
            "units_ms_per_cycle": units["device_ms_per_cycle"]}


def shapes(chip_smoke, device, rounds: int) -> dict:
    """B2 (at chip_smoke.B2_TIMED) and B4 (P = 1024) at each launch shape of
    SHAPES, set through interp_cuda's B2_THREADS / B2_RPT and B4_THREADS /
    B4_RPT, which the geometry reads at every launch; ``rounds`` rounds over
    all shapes, so that drift in the call shows. Each entry lists the rounds'
    (ms, device ms)."""
    from symbolicregression_jl_tpu_torch.ops import interp_cuda as ic

    saved = ic.B2_THREADS, ic.B2_RPT, ic.B4_THREADS, ic.B4_RPT
    out: dict = {}
    try:
        for _ in range(rounds):
            for threads, rpt in SHAPES:
                ic.B2_THREADS, ic.B2_RPT = ic.B4_THREADS, ic.B4_RPT = threads, rpt
                for P, R in chip_smoke.B2_TIMED:
                    t = chip_smoke.b2_timing(device, P, R)
                    out.setdefault(f"b2 {P}x{R} {threads}x{rpt}", []).append(
                        (t["ms"], t["device_ms"]))
                t = chip_smoke.b4_timing(device, 1024)
                out.setdefault(f"b4 1024x{chip_smoke.CONFIG3_ROWS} {threads}x{rpt}", []).append(
                    (t["ms"], t["device_ms"]))
    finally:
        ic.B2_THREADS, ic.B2_RPT, ic.B4_THREADS, ic.B4_RPT = saved
    for k, v in out.items():
        print(f"{k}: ms " + ", ".join(f"{a:.4f}" for a, _ in v) + "; device ms "
              + ", ".join(f"{b:.4f}" for _, b in v), flush=True)
    return {"shapes": out}


def load_package(root: str, alias: str):
    """The port's package of the checkout at ``root``, imported as ``alias``
    (its modules import each other relatively, so two copies coexist)."""
    pkg_dir = os.path.join(root, "symbolicregression_jl_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def pairs(chip_smoke, device, other_root: str, n_pairs: int, rows: int = 256) -> dict:
    """One B3 launch of one cycle at config3 width on ``rows`` rows, this
    repository's package ("change") against the one at ``other_root``
    ("parent"), alternating, ``n_pairs`` times. Per side and pair, medians of
    20 timings each: ``wall`` as chip_smoke.time_ms takes it, ``device`` the
    launch queued behind a sleeping kernel (the host's part hidden),
    ``host`` the wrapper's Python time (no synchronization inside)."""
    import dataclasses

    import numpy as np
    import torch

    other = load_package(other_root, "sr_parent")
    import symbolicregression_jl_tpu_torch as this

    Xn, yn = chip_smoke.config3_data(n_rows=rows)
    X, y = torch.from_numpy(Xn).to(device), torch.from_numpy(yn).to(device)
    opts = this.Options(maxsize=20, populations=100, population_size=100, device=device.type,
                        **chip_smoke.CONFIG3_OPS)
    cfg, pop, scal = chip_smoke.block_setup(device, opts, X, y, None, 100, 1, seed=5)
    sides = {}
    for name, pkg in (("parent", other), ("change", this)):
        o = pkg.Options(maxsize=20, populations=100, population_size=100, device=device.type,
                        **chip_smoke.CONFIG3_OPS)
        ds = importlib.import_module(f"{pkg.__name__}.models.device_search")
        c = dataclasses.replace(
            ds.build_evo_config(o, n_features=Xn.shape[0], baseline_loss=1.0, use_baseline=True,
                                niterations=1, n_islands=100, n_rows=rows), ncycles=1)
        fn = importlib.import_module(f"{pkg.__name__}.ops.evolve_block_cuda").evolve_block
        args = (*pop, *scal, X, y, None, c, o.operators, o.loss)
        sides[name] = (fn, args)
    outs = {k: fn(*a) for k, (fn, a) in sides.items()}
    for a, b in zip(outs["parent"], outs["change"]):
        if not torch.equal(a, b):
            raise SystemExit("chip_kernel_timing: parent and change disagree on one cycle")

    def host_ms(fn, a):
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*a)
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    rec = {k: {"wall": [], "device": [], "host": []} for k in sides}
    for i in range(n_pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for k in order:
            fn, a = sides[k]
            rec[k]["wall"].append(chip_smoke.time_ms(lambda: fn(*a)))
            rec[k]["device"].append(chip_smoke.device_time_ms(lambda: fn(*a)))
            rec[k]["host"].append(host_ms(fn, a))
        print(f"pair {i} ({order[0]} first): " + "; ".join(
            f"{k} wall {rec[k]['wall'][-1]:.4f} device {rec[k]['device'][-1]:.4f} "
            f"host {rec[k]['host'][-1]:.4f} ms" for k in ("parent", "change")), flush=True)
    summary = {k: {m: statistics.median(v) for m, v in r.items()} for k, r in rec.items()}
    wins = sum(c < p for c, p in zip(rec["change"]["wall"], rec["parent"]["wall"]))
    print(f"one B3 cycle at {rows} rows, medians over {n_pairs} pairs: " + "; ".join(
        f"{k} wall {s['wall']:.4f} device {s['device']:.4f} host {s['host']:.4f} ms"
        for k, s in summary.items()) + f"; change faster in {wins} of {n_pairs}", flush=True)
    return {"rows": rows, "n_pairs": n_pairs, "per_pair": rec, "median": summary,
            "change_faster": wins}


if __name__ == "__main__":
    sys.exit(main())
