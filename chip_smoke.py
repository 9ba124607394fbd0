#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (the kernels are built from the checkout's
sources at first use) and the packages of the port; it imports nothing of
JAX or of the JAX package. Phases, each of which raises on failure:

1. the card's name and power limit; build every kernel and report the build;
2. kernel check: the fused eval+loss kernel (``fused_loss``) against its
   plain PyTorch version on the card, at the main path's shapes (config3:
   10,000 rows x 5 features, maxsize 20), weighted and unweighted, on
   minibatches, on a corpus touching every built-in operator, and for every
   built-in real loss; timings with CUDA events;
3. the main path at full width: lockstep ``equation_search`` on config3
   (100 populations x 100 members), with every scoring dispatch counted as a
   kernel launch;
4. the README quick start through ``SRRegressor`` on the card.

The last lines are the kernels JSON line, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
port beside this file, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# config3 (the reference benchmark-suite configuration the repo measures):
# 10k rows x 5 features, binary + - * /, unary cos exp abs, L2, 100 x 100,
# maxsize 20. Only depth is cut: one iteration of CONFIG3_CYCLES cycles
# (the configuration's ncycles_per_iteration is 550).
CONFIG3_ROWS, CONFIG3_FEATURES = 10_000, 5
CONFIG3_CYCLES = 100
CONFIG3_OPS = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp", "abs"])
# README quick start: 200 x 2, + - *, cos; README budget is 20 iterations,
# cut to QUICKSTART_ITERATIONS to fit the time limit.
QUICKSTART_ITERATIONS = 6

# H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# tolerances of the kernel check: kernel and plain version compute the same
# f32 elementwise values; sums are f64 in both, in different orders
RTOL, ATOL = 1e-5, 1e-6


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def config3_data(n_rows=CONFIG3_ROWS, n_features=CONFIG3_FEATURES, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_features, n_rows)).astype(np.float32)
    y = (
        np.cos(2.13 * X[0]) + 0.5 * X[1] * np.abs(X[2]) ** 0.9 - 0.3 * np.abs(X[3]) ** 1.5
    ).astype(np.float32)
    return X, y


def random_programs(opset, n_trees, max_nodes, n_features, seed, max_len=10):
    """A packed batch of random trees over ``opset`` (numpy)."""
    import numpy as np

    from symbolicregression_jl_tpu_torch.models.mutation_functions import gen_random_tree
    from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import pack_programs_fused

    rng = np.random.default_rng(seed)
    trees = []
    while len(trees) < n_trees:
        t = gen_random_tree(int(rng.integers(1, max_len + 1)), opset, n_features, rng)
        if t.count_nodes() <= max_nodes:
            trees.append(t)
    return pack_programs_fused(flatten_trees(trees, max_nodes), opset)


def time_ms(fn, warmup=3, reps=20):
    """Median of ``reps`` CUDA-event timings of fn() after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(name, got, ref, atol=ATOL):
    """Max abs error over finite losses; raises on a mismatch of the ok
    flags or an error above atol + RTOL * |ref|."""
    import torch

    got, ref = got.double().cpu(), ref.double().cpu()
    fin_g, fin_r = torch.isfinite(got), torch.isfinite(ref)
    if not torch.equal(fin_g, fin_r):
        bad = torch.nonzero(fin_g != fin_r).flatten()[:5].tolist()
        _fail(f"{name}: ok flags differ at trees {bad}")
    if not bool(fin_r.any()):
        return 0.0
    err = (got[fin_r] - ref[fin_r]).abs()
    lim = atol + RTOL * ref[fin_r].abs()
    if bool((err > lim).any()):
        k = int(torch.argmax(err - lim))
        _fail(f"{name}: loss {got[fin_r][k]:.9g} vs plain {ref[fin_r][k]:.9g}")
    return float(err.max())


def kernel_check(device):
    """Phase 2. Returns the kernel record (without launches)."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops import losses as L
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, fused_loss_reference, work_counts,
    )
    from symbolicregression_jl_tpu_torch.ops.operators import (
        BINARY_OPS, UNARY_OPS, resolve_operators,
    )

    opts = Options(maxsize=20, device=device.type, **CONFIG3_OPS)
    opset, N = opts.operators, opts.max_nodes
    Xn, yn = config3_data()
    X = torch.from_numpy(Xn).to(device)
    y = torch.from_numpy(yn).to(device)
    w = torch.from_numpy(
        np.random.default_rng(1).uniform(0.1, 2.0, CONFIG3_ROWS).astype(np.float32)
    ).to(device)
    l2 = L.L2DistLoss
    max_err = 0.0
    n_cases = 0

    def check(tag, prog_np, vals_np, Xc, yc, wc, ops, loss, atol=ATOL):
        nonlocal max_err, n_cases
        prog = torch.from_numpy(prog_np).to(device)
        vals = torch.from_numpy(vals_np).to(device)
        got = fused_loss(prog, vals, Xc, yc, wc, ops, loss)
        ref = fused_loss_reference(prog, vals, Xc, yc, wc, ops, loss)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(tag, got, ref, atol))
        n_cases += 1

    # main shapes: full data, unweighted and weighted
    for P in (16, 256, 1024):
        prog, vals = random_programs(opset, P, N, CONFIG3_FEATURES, seed=P)
        check(f"config3 P={P}", prog, vals, X, y, None, opset, l2)
        check(f"config3 P={P} weighted", prog, vals, X, y, w, opset, l2)
    # minibatches (with-replacement row indices, as BatchScorer draws them)
    prog, vals = random_programs(opset, 1024, N, CONFIG3_FEATURES, seed=7)
    for Rb in (50, 2048):
        idx = torch.from_numpy(
            np.random.default_rng(Rb).integers(0, CONFIG3_ROWS, Rb)
        ).to(device)
        check(f"minibatch R={Rb}", prog, vals, X[:, idx].contiguous(), y[idx].contiguous(),
              None, opset, l2)
        check(f"minibatch R={Rb} weighted", prog, vals, X[:, idx].contiguous(),
              y[idx].contiguous(), w[idx].contiguous(), opset, l2)
    # a corpus touching every built-in operator
    all_ops = resolve_operators(list(BINARY_OPS), list(UNARY_OPS))
    prog_a, vals_a = random_programs(all_ops, 2048, N, CONFIG3_FEATURES, seed=11)
    codes = set(np.unique(prog_a[:, :N]).tolist())
    missing = set(range(2, 2 + all_ops.n_unary + all_ops.n_binary)) - codes
    if missing:
        _fail(f"operator corpus misses codes {sorted(missing)}")
    check("every operator", prog_a, vals_a, X, y, None, all_ops, l2)
    check("every operator weighted", prog_a, vals_a, X, y, w, all_ops, l2)
    # every built-in real loss at one small shape: shallow + - * trees on
    # rows in [-1, 1] keep predictions moderate, so the comparison tests the
    # loss code and not the conditioning of exp/sin at huge arguments
    rng = np.random.default_rng(5)
    Xs = torch.from_numpy(rng.uniform(-1, 1, (3, 257)).astype(np.float32)).to(device)
    ys = torch.from_numpy(np.sign(rng.uniform(-1, 1, 257)).astype(np.float32)).to(device)
    ws = torch.from_numpy(rng.uniform(0.1, 2.0, 257).astype(np.float32)).to(device)
    small_ops = resolve_operators(["add", "sub", "mult"], [])
    prog_s, vals_s = random_programs(small_ops, 64, N, 3, seed=13, max_len=4)
    zoo = dict(L.LOSSES)
    for spec in ("LPDistLoss(3.0)", "HuberLoss(0.5)", "QuantileLoss(0.9)",
                 "SmoothedL1HingeLoss(0.5)", "DWDMarginLoss(2.0)", "PeriodicLoss(2.0)"):
        zoo[spec] = L.resolve_loss(spec)
    for name, loss in zoo.items():
        # a ZeroOne decision flips when an f32 prediction sits on the boundary:
        # allow one row's weight of difference
        atol = float(ws.max() / ws.sum()) if name == "ZeroOneLoss" else ATOL
        check(f"loss {name}", prog_s, vals_s, Xs, ys, None, small_ops, loss, atol)
        check(f"loss {name} weighted", prog_s, vals_s, Xs, ys, ws, small_ops, loss, atol)
    print(f"kernel check: {n_cases} cases, max abs err {max_err:.3e} "
          f"(rtol {RTOL}, atol {ATOL})", flush=True)

    # timing at the main path's scoring shape: 1024 candidates x 10k rows
    prog_np, vals_np = random_programs(opset, 1024, N, CONFIG3_FEATURES, seed=1024)
    prog = torch.from_numpy(prog_np).to(device)
    vals = torch.from_numpy(vals_np).to(device)
    saved = fused_loss.launches
    ms = time_ms(lambda: fused_loss(prog, vals, X, y, None, opset, l2))
    plain_ms = time_ms(lambda: fused_loss_reference(prog, vals, X, y, None, opset, l2),
                       warmup=1, reps=20)
    fused_loss.launches = saved  # timing launches are not the main path's
    work = work_counts(prog_np, CONFIG3_ROWS, CONFIG3_FEATURES, weighted=False)
    bound_ops = work["operations"] / PEAK_F32_FLOPS * 1e3
    bound_bytes = work["bytes"] / PEAK_BYTES * 1e3
    print(f"fused_loss timing (P=1024, R={CONFIG3_ROWS}, N={N}): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, slot evals {work['slot_evals']}, "
          f"{work['slot_evals'] / (ms * 1e-3):.4g} slot-evals/s", flush=True)
    return {
        "name": "fused_loss",
        "route": "cuda",
        "source": "symbolicregression_jl_tpu_torch/csrc/fused_loss.cu",
        "replaces": "symbolicregression_jl_tpu/ops/interp_pallas.py:258",
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "library_ms": None,
    }


def main_path(device, cycles=CONFIG3_CYCLES, rows=CONFIG3_ROWS, populations=100,
              population_size=100):
    """Phase 3: lockstep equation_search at config3 width. Host clocks time
    the evolution cycles and the constant optimization; CUDA events around
    every kernel call sum the kernel's device time on the path."""
    import numpy as np
    import torch

    import symbolicregression_jl_tpu_torch.models.scorer as scorer_mod
    import symbolicregression_jl_tpu_torch.search as search_mod
    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import fused_loss

    X, y = config3_data(n_rows=rows)
    options = Options(
        populations=populations, population_size=population_size, maxsize=20,
        ncycles_per_iteration=cycles, seed=0, save_to_file=False, progress=False,
        device=device.type, **CONFIG3_OPS,
    )
    spent = {"s_r_cycle_lockstep": 0.0, "optimize_and_simplify_populations": 0.0}
    saved = {name: getattr(search_mod, name) for name in spent}
    events = []

    def host_timed(name):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = saved[name](*args, **kwargs)
            spent[name] += time.perf_counter() - t0
            return out
        return run

    def device_timed(*args, **kwargs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fused_loss(*args, **kwargs)
        b.record()
        events.append((a, b))
        return out

    for name in spent:
        setattr(search_mod, name, host_timed(name))
    scorer_mod.fused_loss = device_timed
    try:
        fused_loss.launches = 0
        t0 = time.perf_counter()
        res = equation_search(X, y, options=options, niterations=1, verbosity=0)
        wall = time.perf_counter() - t0
        launches = fused_loss.launches
    finally:
        for name, fn in saved.items():
            setattr(search_mod, name, fn)
        scorer_mod.fused_loss = fused_loss
    torch.cuda.synchronize()
    kernel_s = sum(a.elapsed_time(b) for a, b in events) * 1e-3
    if not res.use_kernel:
        _fail("config3 scorer did not select the fused loss kernel")
    if launches != res.scoring_dispatches or launches == 0:
        _fail(f"{launches} kernel launches for {res.scoring_dispatches} scoring dispatches")
    front = res.pareto_frontier
    if not front or not all(np.isfinite(m.loss) for m in front):
        _fail("config3 frontier is empty or not finite")
    best = min(m.loss for m in front)
    cycle_s = spent["s_r_cycle_lockstep"]
    const_s = spent["optimize_and_simplify_populations"]
    print(f"config3 lockstep: {populations}x{population_size}, {rows} rows, 1 iteration x "
          f"{cycles} cycles (cut from 550): wall {wall:.3f} s (set-up "
          f"{wall - res.iteration_seconds:.3f} s, main loop {res.iteration_seconds:.3f} s), "
          f"cycles {cycle_s:.3f} s = {cycle_s / cycles * 1e3:.2f} ms/cycle, "
          f"const-opt+simplify {const_s:.3f} s, "
          f"{res.num_evals / res.iteration_seconds:.4g} evals/s, "
          f"{launches} kernel launches = {res.scoring_dispatches} scoring dispatches, "
          f"kernel device time {kernel_s:.4f} s ({kernel_s / wall:.3%} of wall), "
          f"frontier {len(front)} members, best loss {best:.6g}", flush=True)
    return launches


def quick_start(device, niterations=QUICKSTART_ITERATIONS):
    """Phase 4: README quick start through SRRegressor."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import SRRegressor

    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 2)).astype(np.float32)
    y = 2 * np.cos(X[:, 1]) + X[:, 0] ** 2 - 2
    t0 = time.perf_counter()
    model = SRRegressor(
        niterations=niterations, binary_operators=["+", "-", "*"],
        unary_operators=["cos"], seed=0, save_to_file=False, progress=False,
        device=device.type,
    )
    model.fit(X, y)
    wall = time.perf_counter() - t0
    rows = model.equations_
    best = min(rows, key=lambda r: r["loss"])
    baseline = float(np.mean((y - y.mean()) ** 2))
    pred = model.predict(X)
    if not np.all(np.isfinite(pred)) or pred.shape != y.shape:
        _fail("quick start predictions are not finite")
    if not best["loss"] < baseline:
        _fail(f"quick start best loss {best['loss']} not below baseline {baseline}")
    print(f"quick start: {niterations} iterations (README: 20) in {wall:.3f} s, best loss "
          f"{best['loss']:.6g} (mean predictor {baseline:.6g}): {best['equation']}",
          flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from symbolicregression_jl_tpu_torch.ops import interp_cuda
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    interp_cuda.build()
    info = interp_cuda.BUILD_INFO
    print(f"build: fused_loss in {time.perf_counter() - t0:.2f} s ({info['library']})",
          flush=True)
    for line in info["log"].splitlines():
        if "ptxas info" in line or "spill" in line:
            print(f"  {line.strip()}", flush=True)

    record = kernel_check(device)
    launches = main_path(device)
    record["launches"] = launches
    quick_start(device)

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: record[k] for k in order}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
