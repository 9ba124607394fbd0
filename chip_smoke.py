#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (the kernels are built from the checkout's
sources at first use) and the packages of the port; it imports nothing of
JAX or of the JAX package. Phases, each of which raises on failure:

1. the card's name and power limit; build every kernel (one ``nvcc`` per
   source, all started together) and report the builds;
2. kernel check of B1, the fused eval+loss kernel (``fused_loss``), against
   its plain PyTorch version on the card, at the main paths' shapes
   (config3: 10,000 rows x 5 features, maxsize 20), weighted and
   unweighted, on minibatches, on a corpus touching every built-in
   operator, and for every built-in real loss; timings with CUDA events at
   the lockstep scoring shape (1024 programs) and the device engine's
   constant-optimization shape (4,200), with slot evaluations per second;
3. kernel check of B2, the fused loss+gradient kernel
   (``fused_loss_grad``), the same way, at the device engine's
   constant-optimization shape (4,200 instances x 10,000 rows), where two
   launches must give identical bits and rows that are not stack-sound
   must score inf with zero gradients; its timing there and at a 50-row
   minibatch (1024 programs), each with the device's time alone; then one
   tree per built-in operator on U(-2, 2) and U(-20, 20) rows through B4
   and its plain version, which must give equal values on every row;
   kernel check of B3, the evolve block (``evolve_block``): after 1 and 8
   cycles from one seed its integer outputs equal its plain version's and
   its float outputs agree, at config3 width (100 islands x 100 members),
   at the quick-start shape, on the all-operator corpus and for every loss;
   a block of ENGINE_CYCLES cycles checked for its own consistency; its
   timing at 1 and ENGINE_CYCLES cycles on 256, 2,500 and 10,000 rows, whose
   fitted line splits a cycle into what scales with rows (scoring) and what
   does not (stages 1-2, replacement, syncs); and
   kernel check of B4, the prediction matrix (``eval_trees_kernel``),
   every tree of both corpora held;
4. the lockstep main path at full width: ``equation_search`` on config3
   (100 populations x 100 members), with every scoring dispatch counted as a
   B1 launch;
5. the device-engine main path at full width: ``equation_search(...,
   scheduler="device")`` on config3, first with ``SR_ENGINE_BLOCK=0`` (the
   event leg; no B3 launch), then by default (the evolve leg is one B3
   launch per iteration); every B1 launch counted against the engine's
   scoring calls and every B2 launch against its gradient calls, the first
   iteration's evolve leg run with host syncs made errors, every leg timed
   between synchronizations and the last iteration's legs traced with
   torch.profiler (kernel time by name, the device's idle share);
6. the README quick start through ``SRRegressor`` on the card, under the
   lockstep scheduler, then twice under ``scheduler="device"`` with one
   seed, through B3 (the two frontiers must be identical);
7. ``resume``, kill and resume on the card: (a) lockstep at the quick
   start's size run twice uninterrupted (identical frontiers), then killed
   at iteration 2 by ``peer_death`` and resumed from its snapshot: the
   frontier must equal the uninterrupted run's string for string, and
   num_evals too; (b) the device engine at config3 width on the block,
   killed at iteration 2 and resumed from its ``exact=False`` snapshot: no
   frontier lost, more evaluations, the block's kernel, and each
   snapshot's host ms; (c) the engine with ``nan_flood@1:frac=0.75`` and a
   snapshot after every iteration: a finite frontier; (d) ``ckpt_crash@1`` on lockstep: the first snapshot
   stays loadable and a resume from it finishes. The resumed runs' launches
   are the kernels' ``resume`` path;
8. ``engine_options``, the device engine's single-card options: (a) config3
   on the block with ``profile=True`` (every iteration profiled, top-level
   fractions summing to 1, the frontier equal to the unprofiled run's in
   the synchronous readback the profile forces; each stage beside the leg
   timers, the iteration wall beside the unprofiled ones); (b) units on the
   planted y = x0 x1^2 / x2 (kg, m/s, m -> N, 10,000 rows) on lockstep and
   on the engine's event leg: every frontier member the host oracle flags
   carries the penalty, and the engine's batched check equals the oracle on
   every member of its final populations; (c) the quick start on the
   engine with the recorder: every evolve leg free of host syncs, the
   replay's mirror equal to the engine's populations after every
   iteration, the record's mutation count exact; (d) the quick start on
   the engine with NelderMead: no B2 launch, a finite frontier. Each run's
   launches are the kernels' path of the same name;
9. ``fleet``, many searches as one (``fleet_search``): (a) B1, B2 and B3 on
   the lane axis, 3 lanes over config3's X with a y each, against their
   plain versions and, bit for bit, against one solo launch per lane (B1
   and B2 at 4,200 programs a lane, where the solo cuts each program's rows
   into 2 chunks, and at 64), then timed at 1 and 4 lanes; whether one
   ``torch.bmm`` over the lanes gives each lane the bits of its own call is
   printed (the reason the fleet's BFGS calls it per lane); (b)
   ``multitarget_search`` of four targets on config3's X (config3's y and
   three planted laws) at config3 width, 3 iterations x ENGINE_CYCLES on
   the block, beside the four solo runs at seeds s + t: every lane's
   frontier and num_evals equal its solo's, B3 once per iteration for the
   fleet, B2 no more than one solo; the legs per iteration against the
   solos' sums and the const-opt leg's idle share; (c) a 6,000-row lane of
   3 iterations beside a 10,000-row lane of 1, each equal to its solo on the
   padded, weighted data; (d) two lanes on the event leg
   (``SR_ENGINE_BLOCK=0``) at the quick start's size, each equal to its
   solo. The fleet runs' launches are the path ``fleet``, their solo
   references' ``fleet solos``; the kernels line's ``lane_axis`` holds the
   lane-axis check's error and times.

The last lines are the kernels JSON line, the card's name and power limit,
and ``{"ok": true, "device": {...}}`` (``count`` is the number of cards the
run used: 1). Without a CUDA card, or without the
port beside this file, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import functools
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
# the device engine at config3 width: depth cut to ENGINE_ITERATIONS
# iterations of ENGINE_CYCLES cycles (the configuration's 550)
ENGINE_ITERATIONS, ENGINE_CYCLES = 3, 100
# B1 is timed at the lockstep scoring shape and at the device engine's
# constant-optimization shape (K*S = 1,400 x 3 instances); B3's row sweep
# times the same config3 block at these widths: the fitted intercept is the
# per-cycle cost that does not scale with rows, the slope the scoring
B1_TIMED_P = (1024, 4200)
# B2 (P programs, rows) at the engine's constant-optimization shape and at a
# minibatch of the default batch_size (50 rows)
B2_TIMED = ((4200, CONFIG3_ROWS), (1024, 50))
B3_SWEEP_ROWS = (256, 2500, 10_000)
# README quick start: 200 x 2, + - *, cos; README budget is 20 iterations,
# cut to QUICKSTART_ITERATIONS (lockstep) and DEVICE_QUICKSTART_ITERATIONS
# (each of the two device-engine runs) to fit the time limit.
QUICKSTART_ITERATIONS = 6
DEVICE_QUICKSTART_ITERATIONS = 3
# the resume phase's lockstep runs: the quick start's size (200 x 2, 15 x 33)
# at RESUME_ITERATIONS iterations of RESUME_CYCLES cycles
RESUME_ITERATIONS, RESUME_CYCLES = 3, 10
# the fleet phase's kernel check: lanes of one lane-axis launch
FLEET_CHECK_LANES = 3

# H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# tolerances of the kernel check: kernel and plain version compute the same
# f32 elementwise values; sums are f64 in both, in different orders
RTOL, ATOL = 1e-5, 1e-6
# B2's constant gradients: rtol, plus this factor times the largest finite
# gradient of the same tree (a sum over rows that cancels is held to its
# tree's scale); non-finite positions must be equal
GRAD_RTOL, GRAD_SCALE_ATOL = 1e-4, 1e-6


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
    """A packed batch of random trees over ``opset`` (numpy; fresh copies of
    a batch made once per argument tuple)."""
    prog, vals = _random_programs(opset, n_trees, max_nodes, n_features, seed, max_len)
    return prog.copy(), vals.copy()


@functools.lru_cache(maxsize=None)
def _random_programs(opset, n_trees, max_nodes, n_features, seed, max_len):
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


def device_time_ms(fn, reps=20):
    """Median of ``reps`` CUDA-event timings of fn() queued behind a sleeping
    kernel, so that the host's part (the wrapper's Python) is hidden: the
    device time alone."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(5_000_000)  # ~2.5 ms: the host enqueues the launch meanwhile
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


def compare_grads(name, got, ref):
    """Max abs error over finite gradients; raises on unequal non-finite
    positions or an error above GRAD_RTOL * |ref| + GRAD_SCALE_ATOL * (the
    largest finite |ref| of the same tree)."""
    import torch

    got, ref = got.double().cpu(), ref.double().cpu()
    for what, fn in (("NaN", torch.isnan), ("inf", torch.isinf)):
        if not torch.equal(fn(got), fn(ref)):
            bad = torch.nonzero(fn(got) != fn(ref))[:5].tolist()
            _fail(f"{name}: {what} positions differ at (tree, slot) {bad}")
    fin = torch.isfinite(ref)
    scale = torch.where(fin, ref.abs(), 0.0).amax(dim=1, keepdim=True)
    err = torch.where(fin, (got - ref).abs(), 0.0)
    lim = GRAD_RTOL * ref.abs() + GRAD_SCALE_ATOL * scale
    if bool((fin & (err > lim)).any()):
        k = tuple(torch.nonzero(fin & (err > lim))[0].tolist())
        _fail(f"{name}: gradient {got[k]:.9g} vs plain {ref[k]:.9g} at (tree, slot) {k}")
    return float(err.max()) if err.numel() else 0.0


def kernel_check(device):
    """Phase 2. Returns the kernel record (without launches)."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops import losses as L
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import fused_loss, fused_loss_reference
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

    # timing at the lockstep scoring shape (1024 candidates x 10k rows) and
    # at the device engine's constant-optimization shape (K*S = 4,200)
    t1024, t4200 = (b1_timing(device, P, plain=P == 1024) for P in B1_TIMED_P)
    return {
        "name": "fused_loss",
        "route": "cuda",
        "source": "symbolicregression_jl_tpu_torch/csrc/fused_loss.cu",
        "replaces": "symbolicregression_jl_tpu/ops/interp_pallas.py:258",
        "max_abs_err": max_err,
        "ms": t1024["ms"],
        "plain_ms": t1024["plain_ms"],
        "bound_ms": t1024["bound_ms"],
        "bound_by": t1024["bound_by"],
        "library_ms": None,
        "ms_p4200": t4200["ms"],
    }


def b1_timing(device, P, plain=False):
    """B1 on P random config3 programs (seed P) x 10k rows, unweighted: the
    median kernel ms (as ``time_ms`` takes it, the wrapper's host time
    included) and the device's alone (``device_time_ms``), slot evaluations
    per second, the bound and, with ``plain``, the plain version's ms.
    Timing launches are not counted."""
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops import losses as L
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, fused_loss_reference, work_counts,
    )

    opts = Options(maxsize=20, device=device.type, **CONFIG3_OPS)
    opset, N = opts.operators, opts.max_nodes
    Xn, yn = config3_data()
    X, y = torch.from_numpy(Xn).to(device), torch.from_numpy(yn).to(device)
    prog_np, vals_np = random_programs(opset, P, N, CONFIG3_FEATURES, seed=P)
    prog = torch.from_numpy(prog_np).to(device)
    vals = torch.from_numpy(vals_np).to(device)
    l2 = L.L2DistLoss
    saved = fused_loss.launches
    ms = time_ms(lambda: fused_loss(prog, vals, X, y, None, opset, l2))
    dev_ms = device_time_ms(lambda: fused_loss(prog, vals, X, y, None, opset, l2))
    plain_ms = (time_ms(lambda: fused_loss_reference(prog, vals, X, y, None, opset, l2),
                        warmup=1, reps=20) if plain else None)
    fused_loss.launches = saved  # timing launches are not the main path's
    work = work_counts(prog_np, CONFIG3_ROWS, CONFIG3_FEATURES, weighted=False)
    bound_ops = work["operations"] / PEAK_F32_FLOPS * 1e3
    bound_bytes = work["bytes"] / PEAK_BYTES * 1e3
    rate = work["slot_evals"] / (ms * 1e-3)
    print(f"fused_loss timing (P={P}, R={CONFIG3_ROWS}, N={N}): kernel {ms:.4f} ms (device "
          f"alone {dev_ms:.4f} ms)" + (f", plain {plain_ms:.4f} ms" if plain else "")
          + f", bound {max(bound_ops, bound_bytes):.5f} ms, slot evals {work['slot_evals']}, "
          f"{rate:.4g} slot-evals/s", flush=True)
    return {"P": P, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "slot_evals_per_s": rate,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes"}


def main_path(device, cycles=CONFIG3_CYCLES, rows=CONFIG3_ROWS, populations=100,
              population_size=100):
    """Phase 4: lockstep equation_search at config3 width. Host clocks time
    the evolution cycles and the constant optimization; CUDA events around
    every kernel call sum the kernel's device time on the path. Returns the
    launches of B1 and B2 in the run, and the ms per cycle and evals/s."""
    import numpy as np
    import torch

    import symbolicregression_jl_tpu_torch.models.scorer as scorer_mod
    import symbolicregression_jl_tpu_torch.search as search_mod
    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import fused_loss, fused_loss_grad

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
        fused_loss.launches = fused_loss_grad.launches = 0
        t0 = time.perf_counter()
        res = equation_search(X, y, options=options, niterations=1, verbosity=0)
        wall = time.perf_counter() - t0
        launches, grad_launches = fused_loss.launches, fused_loss_grad.launches
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
    return launches, grad_launches, {"ms_per_cycle": cycle_s / cycles * 1e3,
                                     "evals_per_s": res.num_evals / res.iteration_seconds}


def quick_start(device, niterations=QUICKSTART_ITERATIONS):
    """Phase 6a: README quick start through SRRegressor (lockstep)."""
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


def grad_kernel_check(device, n_instances=4200):
    """Phase 3: B2 against its plain version. Returns its record (without
    launches)."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops import losses as L
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, fused_loss_grad, fused_loss_grad_reference,
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
    errs = {"loss": 0.0, "grad": 0.0}
    n_cases = 0

    def check(tag, prog_np, vals_np, Xc, yc, wc, ops, loss, atol=ATOL):
        nonlocal n_cases
        prog = torch.from_numpy(prog_np).to(device)
        vals = torch.from_numpy(vals_np).to(device)
        lk, gk = fused_loss_grad(prog, vals, Xc, yc, wc, ops, loss)
        lr, gr = fused_loss_grad_reference(prog, vals, Xc, yc, wc, ops, loss)
        b1 = fused_loss(prog, vals, Xc, yc, wc, ops, loss)
        torch.cuda.synchronize()
        errs["loss"] = max(errs["loss"], compare(tag, lk, lr, atol),
                           compare(tag + " (B2 vs B1 losses)", lk, b1, atol))
        errs["grad"] = max(errs["grad"], compare_grads(tag, gk, gr))
        n_cases += 1

    # the engine's shape: K*S instances x 10k rows, plain and weighted
    prog, vals = random_programs(opset, n_instances, N, CONFIG3_FEATURES, seed=4200)
    check(f"engine shape P={n_instances}", prog, vals, X, y, None, opset, L.L2DistLoss)
    check(f"engine shape P={n_instances} weighted", prog, vals, X, y, w, opset, L.L2DistLoss)
    # a minibatch of the default batch_size
    idx = torch.from_numpy(np.random.default_rng(50).integers(0, CONFIG3_ROWS, 50)).to(device)
    prog_m, vals_m = random_programs(opset, 1024, N, CONFIG3_FEATURES, seed=8)
    check("minibatch R=50", prog_m, vals_m, X[:, idx].contiguous(), y[idx].contiguous(),
          None, opset, L.L2DistLoss)
    check("minibatch R=50 weighted", prog_m, vals_m, X[:, idx].contiguous(),
          y[idx].contiguous(), w[idx].contiguous(), opset, L.L2DistLoss)
    # a corpus touching every built-in operator, on B1's corpus data
    all_ops = resolve_operators(list(BINARY_OPS), list(UNARY_OPS))
    prog_a, vals_a = random_programs(all_ops, 2048, N, CONFIG3_FEATURES, seed=11)
    codes = set(np.unique(prog_a[:, :N]).tolist())
    missing = set(range(2, 2 + all_ops.n_unary + all_ops.n_binary)) - codes
    if missing:
        _fail(f"operator corpus misses codes {sorted(missing)}")
    check("every operator", prog_a, vals_a, X, y, None, all_ops, L.L2DistLoss)
    check("every operator weighted", prog_a, vals_a, X, y, w, all_ops, L.L2DistLoss)
    # every built-in real loss at a small shape
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
        atol = float(ws.max() / ws.sum()) if name == "ZeroOneLoss" else ATOL
        check(f"loss {name}", prog_s, vals_s, Xs, ys, None, small_ops, loss, atol)
        check(f"loss {name} weighted", prog_s, vals_s, Xs, ys, ws, small_ops, loss, atol)
    # two launches on the same inputs give identical bits: the engine's shape
    # (row chunks and the finalize kernel) and the minibatch (several trees
    # per block)
    for tag, p_np, v_np, Xc, yc, wc in (
            ("engine shape", prog, vals, X, y, w),
            ("minibatch R=50", prog_m, vals_m, X[:, idx].contiguous(), y[idx].contiguous(),
             w[idx].contiguous())):
        pt, vt = torch.from_numpy(p_np).to(device), torch.from_numpy(v_np).to(device)
        first = fused_loss_grad(pt, vt, Xc, yc, wc, opset, L.L2DistLoss)
        again = fused_loss_grad(pt, vt, Xc, yc, wc, opset, L.L2DistLoss)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(first, again)):
            _fail(f"B2 {tag}: two launches on the same inputs differ")
    # rows that are not stack-sound score inf with zero gradients; the
    # batch's other rows keep the plain version's values
    bad, rows = unsound_rows(prog_m, opset)
    pt, vt = torch.from_numpy(bad).to(device), torch.from_numpy(vals_m).to(device)
    lk, gk = fused_loss_grad(pt, vt, X, y, None, opset, L.L2DistLoss)
    lr, gr = fused_loss_grad_reference(torch.from_numpy(prog_m).to(device), vt, X, y, None,
                                       opset, L.L2DistLoss)
    torch.cuda.synchronize()
    if not (bool(torch.isinf(lk[rows]).all()) and bool((gk[rows] == 0).all())):
        _fail(f"B2 on unsound rows {rows}: losses {lk[rows].tolist()}, not inf with zero "
              "gradients")
    keep = torch.ones(len(bad), dtype=torch.bool, device=device)
    keep[rows] = False
    compare("unsound batch, other rows", lk[keep], lr[keep])
    compare_grads("unsound batch, other rows", gk[keep], gr[keep])
    print(f"grad kernel check: {n_cases} cases, max abs err losses {errs['loss']:.3e}, "
          f"gradients {errs['grad']:.3e} (losses rtol {RTOL}, atol {ATOL}; gradients rtol "
          f"{GRAD_RTOL} + {GRAD_SCALE_ATOL} x tree scale); two launches bit-identical at the "
          f"engine shape and R=50; unsound rows {rows} inf with zero gradients", flush=True)

    # timing at the engine's shape and at a minibatch of the default batch_size
    t = b2_timing(device, n_instances, CONFIG3_ROWS, plain=True)
    for P, rows in B2_TIMED[1:]:
        b2_timing(device, P, rows)
    return {
        "name": "fused_loss_grad",
        "route": "cuda",
        "source": "symbolicregression_jl_tpu_torch/csrc/fused_loss_grad.cu",
        "replaces": "symbolicregression_jl_tpu/ops/interp_pallas.py:725",
        "max_abs_err": max(errs.values()),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }


def unsound_rows(prog, opset):
    """A copy of a packed batch (numpy) with two rows made not stack-sound:
    the first binary-rooted row's root children swapped, the second's root
    cut off. Returns (copy, [the two rows])."""
    import numpy as np

    N = (prog.shape[1] - 1) // 4
    length = prog[:, 4 * N]
    root = prog[np.arange(len(prog)), np.maximum(length - 1, 0)]
    a, b = np.nonzero((length > 1) & (root >= 2 + opset.n_unary))[0][:2].tolist()
    bad = prog.copy()
    i = length[a] - 1
    bad[a, N + i], bad[a, 2 * N + i] = prog[a, 2 * N + i], prog[a, N + i]
    bad[b, 4 * N] = length[b] - 1
    return bad, [a, b]


def b2_timing(device, P, rows, plain=False):
    """B2 on P random config3 programs (seed P), unweighted, on config3's
    10k rows or, for fewer ``rows``, on a minibatch of them drawn with
    replacement (seed ``rows``), as the engine's batching draws them: the
    median kernel ms (as ``time_ms`` takes it, the wrapper's host time
    included) and the device's alone (``device_time_ms``), slot evaluations
    (forward + reverse) per second, the bound and, with ``plain``, the plain
    version's ms. Timing launches are not counted."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops import losses as L
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss_grad, fused_loss_grad_reference, grad_work_counts,
    )

    opts = Options(maxsize=20, device=device.type, **CONFIG3_OPS)
    opset, N = opts.operators, opts.max_nodes
    Xn, yn = config3_data()
    if rows < CONFIG3_ROWS:
        idx = np.random.default_rng(rows).integers(0, CONFIG3_ROWS, rows)
        Xn, yn = np.ascontiguousarray(Xn[:, idx]), np.ascontiguousarray(yn[idx])
    X, y = torch.from_numpy(Xn).to(device), torch.from_numpy(yn).to(device)
    prog_np, vals_np = random_programs(opset, P, N, CONFIG3_FEATURES, seed=P)
    prog = torch.from_numpy(prog_np).to(device)
    vals = torch.from_numpy(vals_np).to(device)
    l2 = L.L2DistLoss
    saved = fused_loss_grad.launches
    ms = time_ms(lambda: fused_loss_grad(prog, vals, X, y, None, opset, l2))
    dev_ms = device_time_ms(lambda: fused_loss_grad(prog, vals, X, y, None, opset, l2))
    plain_ms = (time_ms(lambda: fused_loss_grad_reference(prog, vals, X, y, None, opset, l2),
                        warmup=1, reps=20) if plain else None)
    fused_loss_grad.launches = saved  # timing launches are not the main path's
    work = grad_work_counts(prog_np, rows, CONFIG3_FEATURES, weighted=False)
    bound_ops = work["operations"] / PEAK_F32_FLOPS * 1e3
    bound_bytes = work["bytes"] / PEAK_BYTES * 1e3
    rate = work["slot_evals"] / (ms * 1e-3)
    print(f"fused_loss_grad timing (P={P}, R={rows}, N={N}): kernel {ms:.4f} ms (device alone "
          f"{dev_ms:.4f} ms)" + (f", plain {plain_ms:.4f} ms" if plain else "")
          + f", bound {max(bound_ops, bound_bytes):.5f} ms, slot evals (forward + reverse) "
          f"{work['slot_evals']}, {rate:.4g} slot-evals/s", flush=True)
    return {"P": P, "rows": rows, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "slot_evals_per_s": rate,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes"}


def block_setup(device, options, X, y, w, n_islands, ncycles, seed=0):
    """The evolve block's inputs at ``options``' widths: a packed population
    of random trees scored by B1, a size-frequency snapshot with ties and
    uneven weights, births with ties, and the scalars on the card. Returns
    (cfg, pop, scalars) with scalars = (fnorm, seed, step0, curmaxsize,
    norm)."""
    import dataclasses

    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch.models.device_search import build_evo_config
    from symbolicregression_jl_tpu_torch.ops.evolve_block import pack_state_words
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, unpack_programs_fused,
    )

    F, R = X.shape
    cfg = build_evo_config(options, n_features=F, baseline_loss=1.0, use_baseline=True,
                           niterations=1, n_islands=n_islands, n_rows=R)
    cfg = dataclasses.replace(cfg, ncycles=ncycles)
    I, P, N, S1 = cfg.n_islands, cfg.pop_size, cfg.n_slots, cfg.maxsize + 1
    opset = options.operators
    prog_np, vals_np = random_programs(opset, I * P, N, F, seed=seed, max_len=10)
    flat = unpack_programs_fused(prog_np, vals_np, opset)
    kind, op, feat, val = (torch.from_numpy(np.asarray(a)).to(device)
                           for a in (flat.kind, flat.op, flat.feat, flat.val))
    words, consts = pack_state_words(kind, op, feat, val)
    prog = torch.from_numpy(prog_np).to(device)
    vals = torch.from_numpy(vals_np).to(device)
    loss = fused_loss(prog, vals, X, y, w, opset, options.loss).reshape(I, P)
    length = torch.from_numpy(np.asarray(flat.length, np.int32)).to(device).reshape(I, P)
    rng = np.random.default_rng(seed)
    norm = torch.full((), float(np.float32(max(float(y.double().var()), 0.01))),
                      dtype=torch.float32, device=device)
    score = loss / norm + length.to(torch.float32) * cfg.parsimony
    birth = torch.from_numpy(rng.integers(0, P // 2, (I, P)).astype(np.int32)).to(device)
    fnorm = torch.from_numpy(rng.dirichlet(np.ones(S1) * 0.5).astype(np.float32)).to(device)
    pop = (words.reshape(I, P, N).contiguous(), consts.reshape(I, P, N).contiguous(),
           length.contiguous(), loss.contiguous(), score.contiguous(), birth)
    scalars = (fnorm, torch.tensor(0x9E3779B1 ^ seed, dtype=torch.int64, device=device),
               torch.tensor(P, dtype=torch.int32, device=device),
               torch.tensor(cfg.maxsize, dtype=torch.int32, device=device), norm)
    return cfg, pop, scalars


def compare_block(tag, got, ref):
    """Integer outputs equal, float outputs within RTOL/ATOL with equal
    non-finite positions; on a mismatch name the island and the field.
    Returns the largest abs error of the float fields."""
    import torch

    from symbolicregression_jl_tpu_torch.convert import BLOCK_FIELDS

    err = 0.0
    for name, g, r in zip(BLOCK_FIELDS, got, ref):
        g, r = g.cpu(), r.cpu()
        if not r.dtype.is_floating_point:
            bad = (g != r).reshape(g.shape[0], -1).any(1)
        else:
            g64, r64 = g.double(), r.double()
            fin = torch.isfinite(r64)
            diff = torch.where(fin, (g64 - r64).abs(), 0.0)
            over = fin & (diff > ATOL + RTOL * r64.abs())
            nonfin = (torch.isnan(g64) != torch.isnan(r64)) | (torch.isinf(g64) != torch.isinf(r64))
            nonfin |= torch.isinf(g64) & torch.isinf(r64) & (torch.sign(g64) != torch.sign(r64))
            bad = (over | nonfin).reshape(g.shape[0], -1).any(1)
            if diff.numel():
                err = max(err, float(diff.max()))
        if bool(bad.any()):
            isl = int(torch.nonzero(bad)[0])
            _fail(f"{tag}: field {name} differs from the plain version on island {isl} "
                  f"({int(bad.sum())} islands)")
    return err


def block_kernel_check(device, islands=100, rows=CONFIG3_ROWS):
    """Phase 3: B3 against its plain version on the card, at config3 width
    (``islands`` x 100 members, ``rows`` rows). Integer equality needs
    bit-identical scores, which rest on every built-in operator alone giving
    equal values (operator_isolation). Returns the record (without launches)."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.analysis.ir_verify import verify_packed_programs
    from symbolicregression_jl_tpu_torch.convert import BLOCK_FIELDS
    from symbolicregression_jl_tpu_torch.ops import losses as L
    from symbolicregression_jl_tpu_torch.ops.evolve_block import unpack_pointers
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import (
        evolve_block, evolve_block_reference,
    )
    from symbolicregression_jl_tpu_torch.ops.flat import FlatTrees, PackedPrograms
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import fused_loss, pack_programs_fused
    from symbolicregression_jl_tpu_torch.ops.operators import BINARY_OPS, UNARY_OPS

    Xn, yn = config3_data(n_rows=rows)
    X = torch.from_numpy(Xn).to(device)
    y = torch.from_numpy(yn).to(device)
    c3 = Options(maxsize=20, populations=islands, population_size=100, device=device.type,
                 **CONFIG3_OPS)
    max_err = 0.0
    n_cases = 0

    def check(tag, options, Xc, yc, wc, n_islands, cycles=(1, 8), seed=0, flood=None):
        nonlocal max_err, n_cases
        for ncyc in cycles:
            cfg, pop, scal = block_setup(device, options, Xc, yc, wc, n_islands, ncyc, seed)
            if flood is not None:
                # what a nan_flood fault leaves: the losses of the leading
                # islands NaN, and a third of their scores (the NaN members
                # the const-opt leg tuned)
                k = max(1, int(round(n_islands * flood)))
                loss, score = pop[3].clone(), pop[4].clone()
                loss[:k] = float("nan")
                score[:k, ::3] = float("nan")
                pop = pop[:3] + (loss, score) + pop[5:]
            args = (*pop, *scal, Xc, yc, wc, cfg, options.operators, options.loss)
            got = evolve_block(*args)
            ref = evolve_block_reference(*args)
            torch.cuda.synchronize()
            max_err = max(max_err, compare_block(f"{tag}, {ncyc} cycles", got, ref))
            n_cases += 1

    # (a) config3 width: 100 islands x 100 members, 10k rows x 5 features;
    # and after a nan_flood fault over 75% of the islands
    check("config3", c3, X, y, None, islands)
    check("config3 nan_flood", c3, X, y, None, islands, seed=5, flood=0.75)
    # (c) the quick-start shape, weighted and unweighted; the all-operator
    # corpus; every built-in real loss at a small shape
    rng = np.random.default_rng(0)
    Xq = torch.from_numpy(rng.normal(size=(2, 200)).astype(np.float32)).to(device)
    yq = 2 * torch.cos(Xq[1]) + Xq[0] ** 2 - 2
    wq = torch.from_numpy(rng.uniform(0.5, 2.0, 200).astype(np.float32)).to(device)
    qs = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], device=device.type)
    check("quick start", qs, Xq, yq, None, qs.populations)
    check("quick start weighted", qs, Xq, yq, wq, qs.populations)
    all_ops = Options(binary_operators=list(BINARY_OPS), unary_operators=list(UNARY_OPS),
                      maxsize=20, populations=islands // 5, population_size=100,
                      device=device.type)
    check("every operator", all_ops, X, y, None, islands // 5, seed=11)
    Xs = torch.from_numpy(rng.uniform(-1, 1, (3, 257)).astype(np.float32)).to(device)
    ys = torch.from_numpy(np.sign(rng.uniform(-1, 1, 257)).astype(np.float32)).to(device)
    ws = torch.from_numpy(rng.uniform(0.1, 2.0, 257).astype(np.float32)).to(device)
    zoo = dict(L.LOSSES)
    for spec in ("LPDistLoss(3.0)", "HuberLoss(0.5)", "QuantileLoss(0.9)",
                 "SmoothedL1HingeLoss(0.5)", "DWDMarginLoss(2.0)", "PeriodicLoss(2.0)"):
        zoo[spec] = L.resolve_loss(spec)
    for name, loss in zoo.items():
        lo = Options(binary_operators=["add", "sub", "mult"], unary_operators=[],
                     elementwise_loss=loss,
                     populations=4, population_size=16, maxsize=12, device=device.type)
        check(f"loss {name}", lo, Xs, ys, ws, 4, cycles=(8,), seed=13)
    print(f"block kernel check: {n_cases} cases equal to the plain version on every integer "
          f"output, max abs err of float outputs {max_err:.3e} (rtol {RTOL}, atol {ATOL}; "
          f"all {len(BINARY_OPS) + len(UNARY_OPS)} operators in the all-operator corpus; "
          f"config3 with 75% of the islands' losses NaN)", flush=True)

    # (b) a whole block of ENGINE_CYCLES cycles at config3 width: the
    # kernel's own consistency
    cfg, pop, scal = block_setup(device, c3, X, y, None, islands, ENGINE_CYCLES, seed=3)
    args = (*pop, *scal, X, y, None, cfg, c3.operators, c3.loss)
    out = evolve_block(*args)
    again = evolve_block(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(BLOCK_FIELDS, out, again):
        if not torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b):
            _fail(f"block consistency: two launches differ in {name}")
    I, P, N, S1 = cfg.n_islands, cfg.pop_size, cfg.n_slots, cfg.maxsize + 1
    words, consts, length, loss, score = (t.cpu() for t in out[:5])
    norm = scal[4]
    if bool((length > cfg.maxsize).any()) or bool((length < 1).any()):
        _fail("block consistency: a length is outside [1, curmaxsize]")
    want_score = (out[3] / norm + out[2].to(torch.float32) * cfg.parsimony).cpu()
    fin = torch.isfinite(score)
    if not torch.equal(fin, torch.isfinite(want_score)) or bool(
            ((score - want_score).abs() > 1e-6 * want_score.abs())[fin].any()):
        _fail("block consistency: a score is not _score_of(loss, length)")

    def b1_of(w_, c_, ln_):
        kind, op, lhs, rhs, feat = (a.cpu().numpy() for a in unpack_pointers(w_, ln_))
        flat = FlatTrees(kind, op, lhs, rhs, feat, c_.cpu().numpy(), ln_.cpu().numpy())
        prog, vals = pack_programs_fused(flat, c3.operators)
        return fused_loss(torch.from_numpy(prog).to(device), torch.from_numpy(vals).to(device),
                          X, y, None, c3.operators, c3.loss)

    compare("block consistency: member losses vs B1", loss.reshape(-1),
            b1_of(out[0].reshape(I * P, N), out[1].reshape(I * P, N), out[2].reshape(I * P)))
    bs_fin = torch.isfinite(out[7].reshape(-1))
    if not bool(bs_fin.any()):
        _fail("block consistency: no best-seen entry")
    bw, bc, bl = (t.reshape(I * S1, -1)[bs_fin] for t in (out[8], out[9], out[10][..., None]))
    compare("block consistency: best-seen losses vs B1", out[7].reshape(-1)[bs_fin],
            b1_of(bw, bc, bl[:, 0]))
    for name, (wd, cs, ln) in (("population", (words.reshape(I * P, N), consts.reshape(I * P, N),
                                               length.reshape(I * P))),
                               ("best seen", (bw.cpu(), bc.cpu(), bl[:, 0].cpu()))):
        verify_packed_programs(
            PackedPrograms(wd.numpy().astype(np.int16), cs.numpy(), ln.numpy()), c3.operators,
            n_features=CONFIG3_FEATURES, allow_empty=False, where=f"block {name}: ")
    print(f"block consistency ({ENGINE_CYCLES} cycles, {I} x {P}): losses and best-seen losses "
          f"equal B1's, scores equal _score_of, programs stack-sound with zero pads, lengths "
          f"<= {cfg.maxsize}, two launches bit-identical", flush=True)

    t = b3_timing(device, islands, sweep=tuple(r for r in B3_SWEEP_ROWS if r <= rows))
    return {
        "name": "evolve_block",
        "route": "cuda",
        "source": "symbolicregression_jl_tpu_torch/csrc/evolve_block.cu",
        "replaces": "symbolicregression_jl_tpu/ops/interp_pallas.py:1114",
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "ms_per_cycle": t["ms_per_cycle"],
        "row_sweep": t["sweep"],
    }


def b3_timing(device, islands=100, sweep=B3_SWEEP_ROWS, plain=True):
    """B3 timed at config3 width (``islands`` x 100 members) from one seed's
    population: 1 cycle and ENGINE_CYCLES cycles at each row count of
    ``sweep`` (the first rows of config3's data), the per-cycle time
    (ENGINE_CYCLES - 1 cycles' difference) at each, and a least-squares line
    through them: its intercept is the per-cycle cost that does not scale
    with rows (stages 1-2, replacement, histogram, syncs), its slope the
    scoring. The record (1 cycle at the widest sweep, beside the plain
    version with ``plain``, and the bound) is that of the widest sweep.
    Timing launches are not counted."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import (
        block_work_counts, evolve_block, evolve_block_reference,
    )

    Xn, yn = config3_data(n_rows=max(sweep))
    c3 = Options(maxsize=20, populations=islands, population_size=100, device=device.type,
                 **CONFIG3_OPS)
    saved = evolve_block.launches
    points = []
    for rows in sweep:
        X = torch.from_numpy(np.ascontiguousarray(Xn[:, :rows])).to(device)
        y = torch.from_numpy(np.ascontiguousarray(yn[:rows])).to(device)
        runs = {}
        for ncyc in (1, ENGINE_CYCLES):
            cfg, pop, scal = block_setup(device, c3, X, y, None, islands, ncyc, seed=5)
            runs[ncyc] = (cfg, (*pop, *scal, X, y, None, cfg, c3.operators, c3.loss))
        ms1 = time_ms(lambda: evolve_block(*runs[1][1]))
        msk = time_ms(lambda: evolve_block(*runs[ENGINE_CYCLES][1]))
        points.append({"rows": rows, "ms_1": ms1, "ms_k": msk,
                       "ms_per_cycle": (msk - ms1) / (ENGINE_CYCLES - 1)})
    evolve_block.launches = saved
    r = np.array([p["rows"] for p in points], np.float64)
    c = np.array([p["ms_per_cycle"] for p in points], np.float64)
    slope, intercept = np.polyfit(r, c, 1) if len(points) > 1 else (0.0, float("nan"))
    top = points[-1]
    cfg1, args1 = runs[1]
    counts = {}
    evolve_block_reference(*args1, counts=counts)
    plain_ms = time_ms(lambda: evolve_block_reference(*args1), warmup=1, reps=20) if plain else None
    work = block_work_counts(cfg1, top["rows"], CONFIG3_FEATURES, False, counts["candidates"],
                             counts["slots"])
    bound_ops = work["operations"] / PEAK_F32_FLOPS * 1e3
    bound_bytes = work["bytes"] / PEAK_BYTES * 1e3
    for p in points:
        print(f"evolve_block timing (config3: {islands} islands x 100, "
              f"E={cfg1.events_per_cycle}, R={p['rows']}, N={cfg1.n_slots}): 1 cycle "
              f"{p['ms_1']:.4f} ms, {ENGINE_CYCLES} cycles {p['ms_k']:.4f} ms, "
              f"{p['ms_per_cycle']:.4f} ms per cycle", flush=True)
    share = intercept / top["ms_per_cycle"] if top["ms_per_cycle"] > 0 else float("nan")
    print(f"evolve_block row sweep: per-cycle ms = {intercept:.5f} + {slope * 1e3:.5f} x "
          f"(rows / 1000); the intercept is {share:.1%} of a cycle at {top['rows']} rows; "
          + (f"plain 1 cycle {plain_ms:.4f} ms; " if plain else "")
          + f"bound (1 cycle, {counts['candidates']} candidates) "
          f"{max(bound_ops, bound_bytes):.5f} ms", flush=True)
    return {"ms": top["ms_1"], "ms_per_cycle": top["ms_per_cycle"], "plain_ms": plain_ms,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "sweep": {"points": points, "intercept_ms": float(intercept),
                      "slope_ms_per_1k_rows": float(slope * 1e3)}}


def preds_kernel_check(device, rows=CONFIG3_ROWS):
    """Phase 3: B4 (the prediction matrix) against ops/interp.eval_trees at
    1024 trees x ``rows`` rows, every prediction within RTOL/ATOL with equal
    non-finite positions; then ``b4_timing`` at P = 1024. Returns the
    record (without launches)."""
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops.interp import eval_trees
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        eval_trees_kernel, unpack_programs_fused,
    )
    from symbolicregression_jl_tpu_torch.ops.operators import (
        BINARY_OPS, UNARY_OPS, resolve_operators,
    )

    Xn, _ = config3_data(n_rows=rows)
    X = torch.from_numpy(Xn).to(device)
    opts = Options(maxsize=20, device=device.type, **CONFIG3_OPS)
    N = opts.max_nodes
    all_ops = resolve_operators(list(BINARY_OPS), list(UNARY_OPS))
    max_err = 0.0
    for tag, ops, seed in (("config3", opts.operators, 1024), ("every operator", all_ops, 11)):
        prog, vals = random_programs(ops, 1024, N, CONFIG3_FEATURES, seed=seed)
        flat = unpack_programs_fused(prog, vals, ops)
        got = eval_trees_kernel(flat, X, ops)
        ref = eval_trees(flat, X, ops)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(f"eval_preds {tag}", got.reshape(-1), ref.reshape(-1)))
    t = b4_timing(device, 1024, rows, plain=True)
    print(f"eval_preds check: config3 and every-operator corpora (1024 trees x "
          f"{rows} rows) equal eval_trees within rtol {RTOL}, atol {ATOL}, every tree held, "
          f"max abs err {max_err:.3e}", flush=True)
    return {
        "name": "eval_preds",
        "route": "cuda",
        "source": "symbolicregression_jl_tpu_torch/csrc/eval_preds.cu",
        "replaces": "symbolicregression_jl_tpu/ops/interp_pallas.py:73",
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }


def b4_timing(device, P, rows=CONFIG3_ROWS, plain=False):
    """B4 on P random config3 programs (seed P) x ``rows`` rows: the median
    ms of the launch alone (``eval_preds`` on programs already on the card;
    also the device's time alone, ``device_time_ms``), of the entry point (``eval_trees_kernel``, with its host packing and
    upload), the bound and, with ``plain``, the plain version's ms. Timing
    launches are not counted."""
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops.interp import eval_trees
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        eval_preds, eval_trees_kernel, preds_work_counts, unpack_programs_fused,
    )

    Xn, _ = config3_data(n_rows=rows)
    X = torch.from_numpy(Xn).to(device)
    opts = Options(maxsize=20, device=device.type, **CONFIG3_OPS)
    prog, vals = random_programs(opts.operators, P, opts.max_nodes, CONFIG3_FEATURES, seed=P)
    flat = unpack_programs_fused(prog, vals, opts.operators)
    prog_t, vals_t = torch.from_numpy(prog).to(device), torch.from_numpy(vals).to(device)
    saved = eval_trees_kernel.launches
    ms = time_ms(lambda: eval_preds(prog_t, vals_t, X, opts.operators))
    dev_ms = device_time_ms(lambda: eval_preds(prog_t, vals_t, X, opts.operators))
    entry_ms = time_ms(lambda: eval_trees_kernel(flat, X, opts.operators))
    plain_ms = (time_ms(lambda: eval_trees(flat, X, opts.operators), warmup=1, reps=20)
                if plain else None)
    eval_trees_kernel.launches = saved
    work = preds_work_counts(prog, rows, CONFIG3_FEATURES)
    bound_ops = work["operations"] / PEAK_F32_FLOPS * 1e3
    bound_bytes = work["bytes"] / PEAK_BYTES * 1e3
    rate = work["slot_evals"] / (ms * 1e-3)
    print(f"eval_preds timing (P={P}, R={rows}): kernel {ms:.4f} ms (programs on the card; "
          f"device alone {dev_ms:.4f} ms), "
          f"entry point {entry_ms:.4f} ms (with host packing and upload)"
          + (f", plain {plain_ms:.4f} ms" if plain else "")
          + f", bound {max(bound_ops, bound_bytes):.5f} ms "
          f"({'bytes' if bound_bytes >= bound_ops else 'operations'}), "
          f"{rate:.4g} slot-evals/s", flush=True)
    return {"P": P, "ms": ms, "device_ms": dev_ms, "entry_ms": entry_ms, "plain_ms": plain_ms,
            "slot_evals_per_s": rate, "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes"}


def operator_isolation(device, n_rows=10_000, spans=(2.0, 20.0)):
    """Phase 3: one-operator trees (each built-in operator on features drawn
    from U(-a, a), for each a in ``spans``) through B4 and through the plain
    version. Every operator must give equal values on every row (NaN where
    NaN): the kernels' exact comparisons (B3's integer outputs) rest on it.
    Prints the largest relative difference per operator of any that
    differs, and fails."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch.ops.flat import FlatTrees
    from symbolicregression_jl_tpu_torch.ops.interp import eval_trees
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import eval_trees_kernel
    from symbolicregression_jl_tpu_torch.ops.operators import (
        BINARY_OPS, UNARY_OPS, resolve_operators,
    )

    ops = resolve_operators(list(BINARY_OPS), list(UNARY_OPS))
    nu, nb = ops.n_unary, ops.n_binary
    P, N = nu + nb, 3
    kind = np.zeros((P, N), np.int32)
    op = np.zeros((P, N), np.int32)
    lhs = np.zeros((P, N), np.int32)
    rhs = np.zeros((P, N), np.int32)
    feat = np.zeros((P, N), np.int32)
    length = np.zeros(P, np.int32)
    kind[:, 0] = 2
    kind[:nu, 1], op[:nu, 1], length[:nu] = 3, np.arange(nu), 2
    kind[nu:, 1], feat[nu:, 1] = 2, 1
    kind[nu:, 2], op[nu:, 2], lhs[nu:, 2], rhs[nu:, 2], length[nu:] = 4, np.arange(nb), 0, 1, 3
    flat = FlatTrees(kind, op, lhs, rhs, feat, np.zeros((P, N), np.float32), length)
    names = [o.name for o in ops.unary] + [o.name for o in ops.binary]
    for a in spans:
        X = torch.from_numpy(
            np.random.default_rng(2).uniform(-a, a, (2, n_rows)).astype(np.float32)).to(device)
        got = eval_trees_kernel(flat, X, ops).cpu()
        ref = eval_trees(flat, X, ops).cpu()
        same = (got == ref) | (got.isnan() & ref.isnan())
        bad = []
        for k in torch.nonzero(~same.all(1)).flatten().tolist():
            g, r = got[k].double(), ref[k].double()
            fin = torch.isfinite(g) & torch.isfinite(r)
            rel = ((g - r).abs() / r.abs().clamp_min(1e-30))[fin]
            bad.append(f"{names[k]} ({int((~same[k]).sum())} rows, largest relative difference "
                       f"{float(rel.max()) if rel.numel() else float('nan'):.3g})")
        if bad:
            _fail(f"operator isolation on U(-{a:g}, {a:g}) rows: B4 differs from the plain "
                  f"version in {', '.join(bad)}")
        print(f"operator isolation: all {P} built-in operators alone on {n_rows} rows from "
              f"U(-{a:g}, {a:g}) equal the plain version on every row",
              flush=True)


@contextlib.contextmanager
def engine_block_env(block):
    """SR_ENGINE_BLOCK unset (the default: the block where eligible) or "0"
    (the event leg) inside the context, restored after."""
    saved = os.environ.get("SR_ENGINE_BLOCK")
    if block:
        os.environ.pop("SR_ENGINE_BLOCK", None)
    else:
        os.environ["SR_ENGINE_BLOCK"] = "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("SR_ENGINE_BLOCK", None)
        else:
            os.environ["SR_ENGINE_BLOCK"] = saved


def engine_path(device, lockstep=None, block=True, iterations=ENGINE_ITERATIONS,
                cycles=ENGINE_CYCLES, rows=CONFIG3_ROWS, populations=100, population_size=100):
    """Phase 5: the device engine at config3 width, with the evolve block
    (the default: B3 runs the evolve leg, one launch per iteration) or with
    ``SR_ENGINE_BLOCK=0`` (the event leg). Every evolve and const-opt leg is
    timed on the host clock between two synchronizations; the first evolve
    leg runs with host syncs made errors; the last iteration's legs run
    under torch.profiler (CUDA activity only), which gives the device time
    of their kernels by name and the device's idle share inside the leg
    (1 - device time / wall; the engine runs one stream, so its kernels do
    not overlap). Returns the launches of B1, B2 and B3 in the run, and the
    ms per cycle and evals/s. ``lockstep``: phase 4's numbers, printed
    beside the engine's."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import fused_loss, fused_loss_grad

    X, y = config3_data(n_rows=rows)
    options = Options(
        populations=populations, population_size=population_size, maxsize=20,
        ncycles_per_iteration=cycles, seed=0, save_to_file=False, progress=False,
        device=device.type, scheduler="device", **CONFIG3_OPS,
    )
    legs = []
    checked = []
    seen = {}
    walls = {}
    traces = {}
    on_card = device.type == "cuda"

    def leg_wrap(name):
        seen[name] = nth = seen.get(name, 0) + 1
        if name == "readback":
            return contextlib.nullcontext()
        no_sync = on_card and name == "evolve" and nth == 1
        traced = nth == iterations

        @contextlib.contextmanager
        def timed():
            acts = [ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
            with (profile(activities=acts) if traced else contextlib.nullcontext()) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if no_sync:
                    checked.append(name)
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    yield
                finally:
                    if no_sync:
                        torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            walls.setdefault(name, []).append(wall)
            if traced:
                traces[name] = (wall, prof)
        return timed()

    saved = ds._DISPATCH_HOOK, ds._LEG_WRAP
    ds._DISPATCH_HOOK, ds._LEG_WRAP = legs.append, leg_wrap
    try:
        with engine_block_env(block):
            fused_loss.launches = fused_loss_grad.launches = evolve_block.launches = 0
            t0 = time.perf_counter()
            res = equation_search(X, y, options=options, niterations=iterations, verbosity=0)
            wall = time.perf_counter() - t0
            b1, b2, b3 = fused_loss.launches, fused_loss_grad.launches, evolve_block.launches
    finally:
        ds._DISPATCH_HOOK, ds._LEG_WRAP = saved
    st = res.engine_stats
    leg_name = "block" if block else "event leg"
    if not res.use_kernel:
        _fail("the device engine did not select the kernels")
    if st["block"] != ("kernel" if block else None):
        _fail(f"the evolve leg ran {st['block']!r}, not the {leg_name}")
    if on_card and not checked:
        _fail("the evolve leg ran without the host-sync check")
    if b1 != st["score_calls"] or b1 == 0:
        _fail(f"{b1} B1 launches for {st['score_calls']} engine scoring calls")
    if b2 != st["grad_calls"] or b2 == 0:
        _fail(f"{b2} B2 launches for {st['grad_calls']} engine gradient calls")
    if b3 != (st["iterations"] if block else 0):
        _fail(f"{b3} B3 launches in {st['iterations']} iterations ({leg_name})")
    if legs != ["evolve", "const_opt", "readback"] * iterations:
        _fail(f"legs per iteration: {legs}")
    if sorted(traces) != ["const_opt", "evolve"]:
        _fail(f"the last iteration's legs were not all traced: {sorted(traces)}")
    front = res.pareto_frontier
    if not front or not all(np.isfinite(m.loss) for m in front):
        _fail("device-engine frontier is empty or not finite")
    dev_s = st["device_seconds"]
    host_s = st["host_seconds"]
    n_cycles = iterations * cycles
    evolve_s = dev_s.get("evolve", host_s["evolve"])
    stats = {"ms_per_cycle": evolve_s / n_cycles * 1e3,
             "evals_per_s": res.num_evals / res.iteration_seconds,
             "main_loop_s": res.iteration_seconds}
    print(f"config3 device engine, {leg_name}: {populations}x{population_size}, {rows} rows, "
          f"{iterations} iterations x {cycles} cycles (cut from 550; the last under "
          f"torch.profiler): wall {wall:.3f} s (set-up "
          f"{res.setup_seconds:.3f} s, main loop {res.iteration_seconds:.3f} s); per leg, "
          f"device s (CUDA events) / host s: evolve {dev_s.get('evolve', 0):.4f} / "
          f"{host_s['evolve']:.4f}, const-opt {dev_s.get('const_opt', 0):.3f} / "
          f"{host_s['const_opt']:.3f}, readback + host work {dev_s.get('readback', 0):.3f} / "
          f"{host_s['readback']:.3f}; evolve {stats['ms_per_cycle']:.4f} ms/cycle; "
          f"{stats['evals_per_s']:.4g} evals/s; B1 {b1} launches = {st['score_calls']} scoring "
          f"calls, B2 {b2} launches = {st['grad_calls']} gradient calls, B3 {b3} launches; "
          f"first evolve leg made no host sync; frontier {len(front)} members, best loss "
          f"{min(m.loss for m in front):.6g}", flush=True)
    print(f"legs, config3 device engine ({leg_name}), host ms between synchronizations per "
          "iteration: " + "; ".join(f"{n} " + ", ".join(f"{w * 1e3:.3f}" for w in ws)
                                    for n, ws in walls.items()), flush=True)
    for name, (lwall, prof) in traces.items():
        kern = {}
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                kern[ev.key] = kern.get(ev.key, 0.0) + dev_us * 1e-6
        busy = sum(kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:5]
        idle = f"{1 - busy / lwall:.1%}" if busy > 0 else "not measured (no device time traced)"
        print(f"profile, config3 device engine ({leg_name}), iteration {iterations} {name} leg: "
              f"wall {lwall * 1e3:.3f} ms, device time {busy * 1e3:.3f} ms in {len(kern)} "
              f"kernel names, device idle {idle}; largest: "
              + ", ".join(f"{k[:48]} {v * 1e3:.3f} ms" for k, v in top), flush=True)
    if lockstep is not None:
        print(f"config3, device engine ({leg_name}) vs lockstep: "
              f"{stats['ms_per_cycle']:.4f} vs {lockstep['ms_per_cycle']:.2f} ms/cycle, "
              f"{stats['evals_per_s']:.4g} vs {lockstep['evals_per_s']:.4g} evals/s", flush=True)
    return b1, b2, b3, stats


def quick_start_device(device, niterations=DEVICE_QUICKSTART_ITERATIONS):
    """Phase 6b: the README quick start under scheduler="device", twice with
    one seed."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import SRRegressor
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block

    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 2)).astype(np.float32)
    y = 2 * np.cos(X[:, 1]) + X[:, 0] ** 2 - 2
    baseline = float(np.mean((y - y.mean()) ** 2))
    fronts = []
    evolve_block.launches = 0
    for run in range(2):
        t0 = time.perf_counter()
        model = SRRegressor(
            niterations=niterations, binary_operators=["+", "-", "*"],
            unary_operators=["cos"], seed=0, save_to_file=False, progress=False,
            device=device.type, scheduler="device",
        )
        model.fit(X, y)
        wall = time.perf_counter() - t0
        rows = model.equations_
        best = min(rows, key=lambda r: r["loss"])
        pred = model.predict(X)
        if not np.all(np.isfinite(pred)) or pred.shape != y.shape:
            _fail("device quick start predictions are not finite")
        if not best["loss"] < baseline:
            _fail(f"device quick start best loss {best['loss']} not below baseline {baseline}")
        fronts.append([(r["complexity"], r["loss"], r["equation"]) for r in rows])
        print(f"quick start, scheduler='device', run {run + 1}: {niterations} iterations "
              f"(README: 20) in {wall:.3f} s, best loss {best['loss']:.6g} (mean predictor "
              f"{baseline:.6g}): {best['equation']}", flush=True)
    if fronts[0] != fronts[1]:
        _fail("two device quick starts with one seed gave different frontiers")
    if evolve_block.launches != 2 * niterations:
        _fail(f"{evolve_block.launches} B3 launches in two device quick starts of "
              f"{niterations} iterations")
    print(f"quick start, scheduler='device': the two frontiers are identical; the evolve leg "
          f"ran on B3 ({evolve_block.launches} launches)", flush=True)


def _frontier(res):
    o = res.options
    return [(m.get_complexity(o), m.loss, m.tree.string_tree(o.operators, precision=17))
            for m in res.pareto_frontier]


def resume_lockstep(device, tmp):
    """Phase 7 (a) and (d): lockstep at the quick start's size. (a) Run
    uninterrupted twice (identical frontiers), then with a snapshot after
    every iteration and ``peer_death@2:mode=raise``, then resumed from the
    snapshot: the frontier string for string and the evaluation count equal
    the uninterrupted run's. (d) ``ckpt_crash@1``: the first snapshot stays
    loadable and a resume from it finishes. Returns B1's launches in the
    resumed run of (a)."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import Options, equation_search, load_checkpoint
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import fused_loss
    from symbolicregression_jl_tpu_torch.utils.faults import CheckpointWriteCrash, FaultInjected

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 200)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    base = os.path.join(tmp, "lockstep.pkl")

    def opts(checkpoint_file=base, **kw):
        return Options(binary_operators=["+", "-", "*"], unary_operators=["cos"],
                       ncycles_per_iteration=RESUME_CYCLES, seed=0, save_to_file=False,
                       progress=False, device=device.type, checkpoint_file=checkpoint_file,
                       **kw)

    n = RESUME_ITERATIONS
    t0 = time.perf_counter()
    full = [equation_search(X, y, options=opts(), niterations=n, verbosity=0)
            for _ in range(2)]
    if _frontier(full[0]) != _frontier(full[1]):
        _fail("two uninterrupted lockstep runs with one seed gave different frontiers")
    try:
        equation_search(X, y, options=opts(checkpoint_every=1,
                                           fault_spec="peer_death@2:mode=raise"),
                        niterations=n, verbosity=0)
        _fail("the peer_death fault did not stop the lockstep run")
    except FaultInjected:
        pass
    ck = load_checkpoint(base)
    if (ck.iteration, ck.exact, ck.scheduler) != (2, True, "lockstep"):
        _fail(f"lockstep snapshot: iteration {ck.iteration}, exact {ck.exact}, {ck.scheduler}")
    fused_loss.launches = 0
    resumed = equation_search(X, y, options=opts(), niterations=n, verbosity=0,
                              resume_from=base)
    b1 = fused_loss.launches
    if _frontier(resumed) != _frontier(full[0]):
        _fail("the resumed lockstep frontier differs from the uninterrupted run's")
    if resumed.num_evals != full[0].num_evals:
        _fail(f"resumed num_evals {resumed.num_evals} != {full[0].num_evals}")
    if b1 == 0 or b1 != resumed.scoring_dispatches:
        _fail(f"{b1} B1 launches in the resumed lockstep run for "
              f"{resumed.scoring_dispatches} scoring dispatches")
    print(f"resume (a), lockstep: 200 x 2, 15 x 33, {n} iterations x {RESUME_CYCLES} cycles: "
          f"two uninterrupted runs identical; killed at iteration 2 (peer_death), resumed "
          f"from the snapshot of iteration {ck.iteration}: frontier identical string for "
          f"string ({len(full[0].pareto_frontier)} members), num_evals {resumed.num_evals:.0f} "
          f"equal; B1 {b1} launches in the resumed run; {time.perf_counter() - t0:.3f} s",
          flush=True)

    t0 = time.perf_counter()
    crash = os.path.join(tmp, "crash.pkl")
    try:
        equation_search(X, y, options=opts(checkpoint_every=1, fault_spec="ckpt_crash@1",
                                           checkpoint_file=crash),
                        niterations=n, verbosity=0)
        _fail("the ckpt_crash fault did not stop the lockstep run")
    except CheckpointWriteCrash:
        pass
    orphans = [f for f in os.listdir(tmp) if f.startswith("crash.pkl.") and f.endswith(".tmp")]
    ck = load_checkpoint(crash)
    if ck.iteration != 1 or not orphans:
        _fail(f"after ckpt_crash: snapshot of iteration {ck.iteration}, orphans {orphans}")
    after = equation_search(X, y, options=opts(checkpoint_file=crash), niterations=n,
                            verbosity=0, resume_from=crash)
    if not all(np.isfinite(m.loss) for m in after.pareto_frontier) or not after.pareto_frontier:
        _fail("the resume after ckpt_crash gave no finite frontier")
    print(f"resume (d), ckpt_crash@1 on lockstep: the second write died before its rename "
          f"({orphans[0]} left), the snapshot of iteration 1 loaded and the resume from it "
          f"finished (best loss {min(m.loss for m in after.pareto_frontier):.6g}); "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return b1


def resume_engine(device, tmp, iterations=4, cycles=ENGINE_CYCLES, rows=CONFIG3_ROWS):
    """Phase 7 (b) and (c): the device engine at config3 width on the block.
    (b) A snapshot after every iteration and ``peer_death@2:mode=raise``;
    the snapshot of iteration 2 (exact=False, scheduler "device") resumes as
    a warm start on the block without losing its frontier. (c)
    ``nan_flood@1:frac=0.75``, with a snapshot after every iteration: the
    search ends with a finite frontier.
    Returns the launches of B1, B2 and B3 in the resumed run of (b)."""
    import numpy as np

    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch import Options, equation_search, load_checkpoint
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import fused_loss, fused_loss_grad
    from symbolicregression_jl_tpu_torch.utils.faults import FaultInjected

    X, y = config3_data(n_rows=rows)
    base = os.path.join(tmp, "engine.pkl")

    def opts(checkpoint_file=base, **kw):
        return Options(populations=100, population_size=100, maxsize=20,
                       ncycles_per_iteration=cycles, seed=0, save_to_file=False,
                       progress=False, device=device.type, scheduler="device",
                       checkpoint_file=checkpoint_file, **CONFIG3_OPS, **kw)

    # a snapshot's host time splits into the decode of the live state (its
    # readback and unflattening) and the write (flatten, pickle, fsync)
    decode_s = []
    decode = ds._decode_state_populations

    def timed_decode(*args, **kwargs):
        t = time.perf_counter()
        out = decode(*args, **kwargs)
        decode_s.append(time.perf_counter() - t)
        return out

    t0 = time.perf_counter()
    with engine_block_env(True):
        try:
            equation_search(X, y, options=opts(checkpoint_every=1,
                                               fault_spec="peer_death@2:mode=raise"),
                            niterations=iterations, verbosity=0)
            _fail("the peer_death fault did not stop the engine")
        except FaultInjected:
            pass
        ck = load_checkpoint(base)
        if (ck.iteration, ck.exact, ck.scheduler) != (2, False, "device"):
            _fail(f"engine snapshot: iteration {ck.iteration}, exact {ck.exact}, "
                  f"{ck.scheduler}")
        # the resumed run snapshots every iteration too: its engine_stats
        # time each snapshot on the host
        fused_loss.launches = fused_loss_grad.launches = evolve_block.launches = 0
        ds._decode_state_populations = timed_decode
        try:
            res = equation_search(X, y, options=opts(checkpoint_every=1),
                                  niterations=iterations, verbosity=0, resume_from=base)
        finally:
            ds._decode_state_populations = decode
        b1, b2, b3 = fused_loss.launches, fused_loss_grad.launches, evolve_block.launches
    st = res.engine_stats
    ck_best = min(m.loss for m in ck.pareto_frontier)
    best = min(m.loss for m in res.pareto_frontier)
    if st["block"] != "kernel" or st["iterations"] != iterations - 2:
        _fail(f"resumed engine: block {st['block']!r}, {st['iterations']} iterations")
    if not best <= ck_best + 1e-5:
        _fail(f"resumed engine best loss {best} above the snapshot's {ck_best}")
    if not res.num_evals > ck.num_evals:
        _fail(f"resumed engine num_evals {res.num_evals} <= the snapshot's {ck.num_evals}")
    if b1 != st["score_calls"] or b2 != st["grad_calls"] or b3 != st["iterations"] or not b2:
        _fail(f"resumed engine launches B1 {b1}, B2 {b2}, B3 {b3} for {st['score_calls']} "
              f"scoring calls, {st['grad_calls']} gradient calls, {st['iterations']} iterations")
    ck_ms = [round(t * 1e3, 3) for t in st["checkpoint_seconds"]]
    dec_ms = [round(t * 1e3, 3) for t in decode_s[:len(ck_ms)]]
    legs_ms = {k: round(v / st["iterations"] * 1e3, 3) for k, v in st["host_seconds"].items()}
    print(f"resume (b), device engine on the block: 100x100, {rows} rows, {iterations} "
          f"iterations x {cycles} cycles, killed at iteration 2 (peer_death); snapshot of "
          f"iteration {ck.iteration} (exact {ck.exact}, {sum(p.n for p in ck.populations)} "
          f"members, best {ck_best:.6g}, num_evals {ck.num_evals:.0f}); resumed for "
          f"{st['iterations']} iterations: best {best:.6g}, num_evals {res.num_evals:.0f}; "
          f"launches B1 {b1}, B2 {b2}, B3 {b3}; snapshot host ms per iteration "
          f"{ck_ms} (decode of the live state {dec_ms}, the rest the write); the "
          f"iteration's legs, host ms per iteration: {legs_ms}; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    t0 = time.perf_counter()
    with engine_block_env(True):
        flooded = equation_search(X, y, options=opts(
            checkpoint_file=os.path.join(tmp, "flood.pkl"), checkpoint_every=1,
            fault_spec="nan_flood@1:frac=0.75"), niterations=3, verbosity=0)
    fst = flooded.engine_stats
    front = flooded.pareto_frontier
    if fst["block"] != "kernel" or fst["nan_flooded_islands"] != 75:
        _fail(f"nan_flood engine: block {fst['block']!r}, "
              f"{fst['nan_flooded_islands']} islands flooded")
    if not front or not all(np.isfinite(m.loss) for m in front):
        _fail("the nan_flood engine run gave no finite frontier")
    finite = np.mean([np.isfinite(m.loss) for p in flooded.populations for m in p.members])
    print(f"resume (c), nan_flood@1:frac=0.75 on the engine (block): "
          f"{fst['nan_flooded_islands']} of 100 islands flooded at iteration 2 of 3; finite "
          f"frontier of {len(front)} members, best {min(m.loss for m in front):.6g}; "
          f"{finite:.1%} of the final members finite; snapshot host ms per iteration "
          f"{[round(t * 1e3, 3) for t in fst['checkpoint_seconds']]}; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return b1, b2, b3


def resume_path(device):
    """Phase 7: kill and resume of both schedulers, and the two faults of
    the checkpoint writer and the NaN storm. Returns the launches of B1, B2
    and B3 on the resumed runs."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        lock_b1 = resume_lockstep(device, tmp)
        b1, b2, b3 = resume_engine(device, tmp)
    print(f"resume phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return lock_b1 + b1, b2, b3


# the engine_options phase's units run: x0 kg, x1 m/s, x2 m, all U(1, 5), and
# y = x0 * x1^2 / x2 in N, at the quick start's width with 100-cycle
# iterations
UNITS_ROWS, UNITS_X, UNITS_Y = 10_000, ["kg", "m/s", "m"], "N"
OPTIONS_ITERATIONS, OPTIONS_CYCLES = 3, 100


def _counted(run):
    """Run ``run()`` with the launch counts of B1, B2 and B3 set to 0 just
    before; returns (its result, B1, B2, B3 launches)."""
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import fused_loss, fused_loss_grad

    fused_loss.launches = fused_loss_grad.launches = evolve_block.launches = 0
    out = run()
    return out, fused_loss.launches, fused_loss_grad.launches, evolve_block.launches


def _check_engine_launches(tag, res, b1, b2, b3, block):
    st = res.engine_stats
    if b1 != st["score_calls"] or b1 == 0:
        _fail(f"{tag}: {b1} B1 launches for {st['score_calls']} engine scoring calls")
    if b2 != st["grad_calls"]:
        _fail(f"{tag}: {b2} B2 launches for {st['grad_calls']} engine gradient calls")
    if st["block"] != ("kernel" if block else None) or b3 != (st["iterations"] if block else 0):
        _fail(f"{tag}: evolve leg {st['block']!r} with {b3} B3 launches in "
              f"{st['iterations']} iterations")


def options_profile(device, block_run_s, iterations=ENGINE_ITERATIONS, cycles=ENGINE_CYCLES):
    """engine_options (a): config3 on the engine, on the block, with
    ``profile=True``, and the same search unprofiled in the readback mode
    the profile forces (synchronous): the frontiers must be equal, the
    profile must cover every iteration, and its top-level fractions must
    sum to 1. Prints each stage's mean ms and fraction, the evolve and
    const-opt stages beside the engine's own leg timers, and the profiled
    mean iteration wall beside the unprofiled ones (``block_run_s``: phase
    5's default run on the block, whose legs ran under its timing wrap).
    Returns the profiled run's launches of B1, B2 and B3."""
    from symbolicregression_jl_tpu_torch import Options, equation_search

    X, y = config3_data()

    def run(**kw):
        options = Options(populations=100, population_size=100, maxsize=20,
                          ncycles_per_iteration=cycles, seed=0, save_to_file=False,
                          progress=False, device=device.type, scheduler="device",
                          **CONFIG3_OPS, **kw)
        return equation_search(X, y, options=options, niterations=iterations, verbosity=0)

    with engine_block_env(True):
        res, b1, b2, b3 = _counted(lambda: run(profile=True))
        plain = run(async_readback=False)
    _check_engine_launches("profile", res, b1, b2, b3, block=True)
    prof = res.engine_profile
    stages = prof["stages"]
    total = sum(v["fraction"] for k, v in stages.items() if "/" not in k)
    if prof["iterations"] != iterations or not 0.99 <= total <= 1.01:
        _fail(f"profile: {prof['iterations']} iterations, top-level fractions sum to {total}")
    if _frontier(res) != _frontier(plain):
        _fail("profile: the profiled frontier differs from the unprofiled one")
    st = res.engine_stats
    print(f"engine_options (a) profile, config3 device engine on the block, {iterations} "
          f"iterations x {cycles} cycles: stages (mean ms, fraction) "
          + "; ".join(f"{k} {v['mean_ms']:.3f} ({v['fraction']:.4f})" for k, v in stages.items())
          + f"; fractions sum {total:.6f}", flush=True)
    print("engine_options (a) profile: stage vs the engine's leg timer per iteration (host ms "
          "/ CUDA-event device ms): " + "; ".join(
              f"{leg} {stages[leg]['mean_ms']:.3f} vs {st['host_seconds'][leg] / iterations * 1e3:.3f}"
              f" / {st['device_seconds'].get(leg, 0.0) / iterations * 1e3:.3f}"
              for leg in ("evolve", "const_opt")), flush=True)
    walls = {"profiled": prof["iteration_mean_ms"],
             "unprofiled, synchronous readback": plain.iteration_seconds / iterations * 1e3,
             "phase 5 block run (pipelined readback, timing wrap)": block_run_s / iterations * 1e3}
    print("engine_options (a) profile: mean iteration wall ms: "
          + "; ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f"; overhead {walls['profiled'] / walls['unprofiled, synchronous readback'] - 1:.2%}"
          f" against the synchronous run; frontiers of the profiled and unprofiled runs equal "
          f"({len(res.pareto_frontier)} members); B1 {b1}, B2 {b2}, B3 {b3}", flush=True)
    return b1, b2, b3


def options_units(device, iterations=OPTIONS_ITERATIONS, cycles=OPTIONS_CYCLES):
    """engine_options (b): the planted units problem on lockstep and on the
    device engine (whose units runs take the event leg). On each frontier
    every member the host oracle flags must carry the penalty; on the
    engine's final populations its batched check must equal the oracle on
    every member. Returns the launches of B1, B2 and B3 of each run."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.dimensional_analysis import (
        violates_dimensional_constraints,
    )
    from symbolicregression_jl_tpu_torch.models.device_search import build_evo_config
    from symbolicregression_jl_tpu_torch.ops.evolve import dim_violates_batch
    from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees
    from symbolicregression_jl_tpu_torch.ops.treeops import Tree

    rng = np.random.default_rng(0)
    X = rng.uniform(1, 5, size=(3, UNITS_ROWS)).astype(np.float32)
    y = (X[0] * X[1] ** 2 / X[2]).astype(np.float32)
    out = {}
    for scheduler in ("lockstep", "device"):
        options = Options(binary_operators=["+", "-", "*", "/"],
                          unary_operators=["sqrt", "cos"], populations=15, population_size=33,
                          ncycles_per_iteration=cycles, seed=0, save_to_file=False,
                          progress=False, device=device.type, scheduler=scheduler)
        t0 = time.perf_counter()
        res, b1, b2, b3 = _counted(lambda: equation_search(
            X, y, options=options, niterations=iterations, verbosity=0, X_units=UNITS_X,
            y_units=UNITS_Y))
        wall = time.perf_counter() - t0
        pen = 1000.0
        front = res.pareto_frontier
        flagged = [m for m in front
                   if violates_dimensional_constraints(m.tree, res.dataset, options)]
        if not front or any(m.loss < pen for m in flagged):
            _fail(f"units {scheduler}: a frontier member the oracle flags lacks the penalty")
        best = min(front, key=lambda m: m.loss)
        line = (f"engine_options (b) units, {scheduler}: 15x33, {UNITS_ROWS} rows, "
                f"{iterations} iterations x {cycles} cycles in {wall:.3f} s; frontier "
                f"{len(front)} members, {len(flagged)} flagged (each with the penalty); best "
                f"loss {best.loss:.6g}: {best.tree.string_tree(options.operators)}; B1 {b1}, "
                f"B2 {b2}, B3 {b3}")
        if scheduler == "device":
            _check_engine_launches("units device", res, b1, b2, b3, block=False)
            members = [m for pop in res.populations for m in pop.members]
            flat = flatten_trees([m.tree for m in members], options.max_nodes)
            batch = Tree(*(torch.from_numpy(np.asarray(getattr(flat, f))).to(device)
                           for f in ("kind", "op", "lhs", "rhs", "feat", "val", "length")))
            cfg = build_evo_config(options, 3, 1.0, True, iterations, dataset=res.dataset)
            got = dim_violates_batch(batch, cfg).cpu().numpy()
            want = np.array([violates_dimensional_constraints(m.tree, res.dataset, options)
                             for m in members])
            bad = [members[i].tree.string_tree(options.operators)
                   for i in np.flatnonzero(got != want)]
            if bad:
                _fail(f"units device: the engine's check and the oracle differ on {bad[:5]}")
            st = res.engine_stats
            evolve_s = st["device_seconds"].get("evolve", st["host_seconds"]["evolve"])
            line += (f"; the engine's check equals the oracle on all {len(members)} final "
                     f"members ({int(want.sum())} flagged); evolve (event leg) "
                     f"{evolve_s / (iterations * cycles) * 1e3:.4f} ms/cycle, const-opt "
                     f"{st['device_seconds'].get('const_opt', 0.0) / iterations * 1e3:.3f} ms "
                     f"per iteration")
        print(line, flush=True)
        out[scheduler] = (b1, b2, b3)
    return out


def options_recorder(device, tmp, iterations=3, cycles=None):
    """engine_options (c): the README quick start on the engine with the
    recorder. Every evolve leg runs with host syncs made errors; after
    every iteration the replay's mirror must equal the engine's populations
    slot for slot on kind, op, feat, val and length; the recorder file must
    parse and hold islands x events per cycle x cycles x iterations
    mutation events. Returns the launches of B1, B2 and B3."""
    import numpy as np
    import torch

    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.models import device_recorder
    from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees

    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 2)).astype(np.float32)
    y = 2 * np.cos(X[:, 1]) + X[:, 0] ** 2 - 2
    path = os.path.join(tmp, "recorder.json")
    readme = {} if cycles is None else {"ncycles_per_iteration": cycles}
    options = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], seed=0,
                      save_to_file=False, progress=False, device=device.type,
                      scheduler="device", use_recorder=True, recorder_file=path,
                      crossover_probability=0.0, **readme)
    checked, no_sync = [], []
    snapshot = device_recorder.EngineLineageReplay.snapshot_populations

    def mirror_check(replay, arrays, iteration):
        kind, op, _, _, feat, val, length = arrays[:7]
        I, P, N = kind.shape
        flat = flatten_trees(list(replay.trees.reshape(-1)), N, dtype=val.dtype)
        live = np.arange(N)[None, None, :] < length[:, :, None]
        for name, got, want in (("kind", flat.kind, kind), ("op", flat.op, op),
                                ("feat", flat.feat, feat), ("val", flat.val, val)):
            got = np.asarray(got).reshape(I, P, N)
            if not np.array_equal(np.where(live, got, 0), np.where(live, want, 0)):
                _fail(f"recorder: the mirror's {name} differs from the engine's at "
                      f"iteration {iteration}")
        if not np.array_equal(np.asarray(flat.length).reshape(I, P), length):
            _fail(f"recorder: the mirror's lengths differ at iteration {iteration}")
        checked.append(iteration)
        snapshot(replay, arrays, iteration)

    @contextlib.contextmanager
    def sync_free(name):
        if name != "evolve":
            yield
            return
        no_sync.append(name)
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    saved = device_recorder.EngineLineageReplay.snapshot_populations, ds._LEG_WRAP
    device_recorder.EngineLineageReplay.snapshot_populations = mirror_check
    ds._LEG_WRAP = sync_free
    t0 = time.perf_counter()
    try:
        res, b1, b2, b3 = _counted(lambda: equation_search(
            X.T, y, options=options, niterations=iterations, verbosity=0))
    finally:
        device_recorder.EngineLineageReplay.snapshot_populations, ds._LEG_WRAP = saved
    wall = time.perf_counter() - t0
    _check_engine_launches("recorder", res, b1, b2, b3, block=False)
    if checked != list(range(1, iterations + 1)) or len(no_sync) != iterations:
        _fail(f"recorder: mirror checked at {checked}, {len(no_sync)} sync-free evolve legs")
    with open(path) as fh:
        data = json.load(fh)
    events = [e for m in data["mutations"].values() for e in m["events"]]
    n_mut = sum(e["type"] == "mutate" for e in events)
    E = -(-options.population_size // min(options.tournament_selection_n,
                                          options.population_size))
    want = options.populations * E * options.ncycles_per_iteration * iterations
    if n_mut != want:
        _fail(f"recorder: {n_mut} mutation events, expected {want}")
    print(f"engine_options (c) recorder, README quick start on the engine: {iterations} "
          f"iterations x {options.ncycles_per_iteration} cycles in {wall:.3f} s; every evolve "
          f"leg made no host sync; the mirror equalled the engine's populations after each "
          f"iteration; {os.path.getsize(path)} bytes of record, {n_mut} mutation events = "
          f"{options.populations} x {E} x {options.ncycles_per_iteration} x {iterations}, "
          f"{sum(e['type'] == 'death' for e in events)} deaths, "
          f"{sum(e['type'] == 'tuning' for e in events)} tunings; B1 {b1}, B2 {b2}, B3 {b3}",
          flush=True)
    return b1, b2, b3


def options_neldermead(device, iterations=3, cycles=None):
    """engine_options (d): the README quick start on the engine with
    ``optimizer_algorithm="NelderMead"``: B2 must not launch, B1 must, and
    the frontier must be finite. Returns the launches of B1, B2 and B3."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import Options, equation_search

    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 2)).astype(np.float32)
    y = 2 * np.cos(X[:, 1]) + X[:, 0] ** 2 - 2
    readme = {} if cycles is None else {"ncycles_per_iteration": cycles}
    options = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], seed=0,
                      save_to_file=False, progress=False, device=device.type,
                      scheduler="device", optimizer_algorithm="NelderMead", **readme)
    t0 = time.perf_counter()
    with engine_block_env(True):
        res, b1, b2, b3 = _counted(lambda: equation_search(
            X.T, y, options=options, niterations=iterations, verbosity=0))
    wall = time.perf_counter() - t0
    _check_engine_launches("neldermead", res, b1, b2, b3, block=True)
    front = res.pareto_frontier
    if b2 != 0 or b1 == 0 or not front or not all(np.isfinite(m.loss) for m in front):
        _fail(f"neldermead: B2 {b2}, B1 {b1} launches, frontier "
              f"{[m.loss for m in front]}")
    best = min(front, key=lambda m: m.loss)
    st = res.engine_stats
    print(f"engine_options (d) NelderMead, README quick start on the engine (block): "
          f"{iterations} iterations in {wall:.3f} s; const-opt "
          f"{st['device_seconds'].get('const_opt', 0.0) / iterations * 1e3:.3f} ms per "
          f"iteration on the device; best loss {best.loss:.6g}: "
          f"{best.tree.string_tree(options.operators)}; B1 {b1} = {st['score_calls']} scoring "
          f"calls, B2 {b2}, B3 {b3}", flush=True)
    return b1, b2, b3


def engine_options(device, block_run_s):
    """Phase 8: the device engine's single-card options: (a) the stage
    profile, (b) units on both schedulers, (c) the recorder, (d) NelderMead.
    Returns {path: (B1, B2, B3 launches)} for the kernels line."""
    import tempfile

    t0 = time.perf_counter()
    paths = {"profile": options_profile(device, block_run_s)}
    units = options_units(device)
    paths["units lockstep"], paths["units device"] = units["lockstep"], units["device"]
    with tempfile.TemporaryDirectory() as tmp:
        paths["recorder"] = options_recorder(device, tmp)
    paths["neldermead"] = options_neldermead(device)
    print(f"engine_options phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return paths


# ---------------------------------------------------------------------------
# Phase 9: the fleet
# ---------------------------------------------------------------------------


def fleet_targets(X):
    """The fleet cell's four targets over config3's X: config3's own y, then
    three planted laws the operator set can express (PERF.md section 4)."""
    import numpy as np

    y0 = config3_data(n_rows=X.shape[1])[1]
    y1 = X[1] * X[2] - 0.5 * X[0]
    y2 = np.cos(1.7 * X[3]) + np.abs(X[4])
    y3 = np.exp(0.3 * X[0]) / (1.0 + np.abs(X[1]))
    return np.stack([y0, y1, y2, y3]).astype(np.float32)


def _bits(t):
    """A tensor's bits, for bitwise comparison (NaN equal to itself)."""
    import torch

    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def _same_bits(tag, got, want):
    import torch

    if not torch.equal(_bits(got), _bits(want)):
        bad = torch.nonzero((_bits(got) != _bits(want)).reshape(got.shape[0], -1).any(1))
        _fail(f"{tag}: the lane-axis launch differs from the solo launches at rows "
              f"{bad.flatten()[:5].tolist()}")


def fleet_kernel_check(device, lanes=FLEET_CHECK_LANES, P_lane=4200, islands=100):
    """Phase 9 (a): B1, B2 and B3 on the lane axis at L = ``lanes``, on
    config3's X with a different y per lane: against their plain versions
    (the smoke's tolerances), then against one solo launch per lane, bit for
    bit. B1 and B2 at the const-opt shape (``P_lane`` programs a lane, 10k
    rows: the solo launch cuts each program's rows into 2 chunks, which a
    geometry taken from L * P_lane programs would not) and at 64 programs a
    lane (many chunks), weighted and unweighted; B3 at config3 width, 2
    cycles. Then each kernel timed at L = 1 and L = 4 on the same lane shapes,
    beside its bound at each (B3's for one cycle).
    Returns {name: {"max_abs_err", "ms_l1", "ms_l4"}}; timing launches are
    not counted."""
    import numpy as np
    import torch

    from symbolicregression_jl_tpu_torch import Options
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import (
        block_work_counts, evolve_block, evolve_block_reference,
    )
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        fused_loss, fused_loss_grad, fused_loss_grad_reference, fused_loss_reference,
        grad_geometry, grad_work_counts, loss_geometry, work_counts,
    )

    saved = fused_loss.launches, fused_loss_grad.launches, evolve_block.launches
    opts = Options(maxsize=20, populations=islands, population_size=100, device=device.type,
                   **CONFIG3_OPS)
    opset, N, l2 = opts.operators, opts.max_nodes, opts.loss
    Xn, _ = config3_data()
    Yn = fleet_targets(Xn)
    L4 = Yn.shape[0]
    X4 = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(Xn, (L4,) + Xn.shape))).to(device)
    Y4 = torch.from_numpy(Yn).to(device)
    W4 = torch.from_numpy(
        np.random.default_rng(3).uniform(0.1, 2.0, Yn.shape).astype(np.float32)).to(device)
    out = {}
    errs = {"fused_loss": 0.0, "fused_loss_grad": 0.0, "evolve_block": 0.0}
    for P in (P_lane, 64):
        n_chunks = loss_geometry(P, N, CONFIG3_ROWS)[4]
        if n_chunks == loss_geometry(lanes * P, N, CONFIG3_ROWS)[4] and P == P_lane:
            _fail(f"P_lane={P}: the check does not separate the lane's chunking from the "
                  "fleet's")
        prog_np, vals_np = random_programs(opset, lanes * P, N, CONFIG3_FEATURES, seed=P + 1)
        prog = torch.from_numpy(prog_np).to(device)
        vals = torch.from_numpy(vals_np).to(device)
        X, Y = X4[:lanes], Y4[:lanes]
        for W in (None, W4[:lanes]):
            tag = f"L={lanes} x {P} programs{' weighted' if W is not None else ''}"
            got = fused_loss(prog, vals, X, Y, W, opset, l2)
            ref = fused_loss_reference(prog, vals, X, Y, W, opset, l2)
            gl, gg = fused_loss_grad(prog, vals, X, Y, W, opset, l2)
            rl, rg = fused_loss_grad_reference(prog, vals, X, Y, W, opset, l2)
            solo = [fused_loss(prog[l * P:(l + 1) * P], vals[l * P:(l + 1) * P], X[l], Y[l],
                               None if W is None else W[l], opset, l2) for l in range(lanes)]
            solo_g = [fused_loss_grad(prog[l * P:(l + 1) * P], vals[l * P:(l + 1) * P], X[l],
                                      Y[l], None if W is None else W[l], opset, l2)
                      for l in range(lanes)]
            torch.cuda.synchronize()
            errs["fused_loss"] = max(errs["fused_loss"], compare(f"B1 lanes {tag}", got, ref))
            errs["fused_loss_grad"] = max(errs["fused_loss_grad"],
                                          compare(f"B2 lanes {tag}", gl, rl),
                                          compare_grads(f"B2 lanes {tag}", gg, rg))
            _same_bits(f"B1 {tag}", got, torch.cat(solo))
            _same_bits(f"B2 losses {tag}", gl, torch.cat([s[0] for s in solo_g]))
            _same_bits(f"B2 gradients {tag}", gg, torch.cat([s[1] for s in solo_g]))
        print(f"fleet kernel check, B1 and B2: L={lanes} lanes x {P} programs x "
              f"{CONFIG3_ROWS} rows (a lane's launch shape: {n_chunks} row chunks per program "
              f"for B1, {grad_geometry(P, N, CONFIG3_ROWS)[4]} for B2), weighted and not: "
              "within tolerance of the plain versions and bit for bit the solo launches",
              flush=True)

    # B3: each lane its own population (seed), y and scalars
    setups = [block_setup(device, opts, X4[l], Y4[l], None, islands, 2, seed=l)
              for l in range(lanes)]
    cfg = setups[0][0]
    pops = [s[1] for s in setups]
    scal = [s[2] for s in setups]
    stacked = tuple(torch.cat([p[k] for p in pops]) for k in range(6))
    lane_scal = tuple(torch.stack([s[k] for s in scal]) for k in range(5))
    args = (*stacked, *lane_scal, X4[:lanes], Y4[:lanes], None, cfg, opset, l2)
    got = evolve_block(*args)
    ref = evolve_block_reference(*args)
    solo = [evolve_block(*pops[l], *scal[l], X4[l], Y4[l], None, cfg, opset, l2)
            for l in range(lanes)]
    torch.cuda.synchronize()
    errs["evolve_block"] = compare_block(f"B3 lanes L={lanes}", got, ref)
    for k, field in enumerate(got):
        _same_bits(f"B3 output {k}", field, torch.cat([s[k] for s in solo]))
    print(f"fleet kernel check, B3: L={lanes} lanes x {islands} islands x 100 (config3), 2 "
          f"cycles, one launch of {lanes * islands} blocks: within tolerance of the plain "
          "version, and every output bit for bit the solo launches'", flush=True)

    bmm_batch_count(device, N)

    # timings on the lane shapes, at L = 1 and L = 4
    prog_np, vals_np = random_programs(opset, L4 * P_lane, N, CONFIG3_FEATURES, seed=P_lane + 1)
    prog = torch.from_numpy(prog_np).to(device)
    vals = torch.from_numpy(vals_np).to(device)
    t, bound = {}, {}

    def bound_ms(work):
        return max(work["operations"] / PEAK_F32_FLOPS, work["bytes"] / PEAK_BYTES) * 1e3

    for L in (1, L4):
        n = L * P_lane
        t[("fused_loss", L)] = time_ms(lambda: fused_loss(prog[:n], vals[:n], X4[:L], Y4[:L],
                                                            None, opset, l2))
        t[("fused_loss_grad", L)] = time_ms(lambda: fused_loss_grad(
            prog[:n], vals[:n], X4[:L], Y4[:L], None, opset, l2))
        bound[("fused_loss", L)] = bound_ms(work_counts(
            prog_np[:n], CONFIG3_ROWS, CONFIG3_FEATURES, False, lanes=L))
        bound[("fused_loss_grad", L)] = bound_ms(grad_work_counts(
            prog_np[:n], CONFIG3_ROWS, CONFIG3_FEATURES, False, lanes=L))
    ksetups = [block_setup(device, opts, X4[l], Y4[l], None, islands, ENGINE_CYCLES, seed=l)
               for l in range(L4)]
    ones = [block_setup(device, opts, X4[l], Y4[l], None, islands, 1, seed=l)
            for l in range(L4)]
    for L in (1, L4):
        per = {}
        for tag, su in (("k", ksetups), ("1", ones)):
            st = tuple(torch.cat([s[1][k] for s in su[:L]]) for k in range(6))
            sc = tuple(torch.stack([s[2][k] for s in su[:L]]) for k in range(5))
            a = (*st, *sc, X4[:L], Y4[:L], None, su[0][0], opset, l2)
            per[tag] = time_ms(lambda: evolve_block(*a))
            if tag == "1":
                # the bound of one cycle, from the candidates the plain
                # version scores in it
                counts = {}
                evolve_block_reference(*a, counts=counts)
                bound[("evolve_block", L)] = bound_ms(block_work_counts(
                    su[0][0], CONFIG3_ROWS, CONFIG3_FEATURES, False, counts["candidates"],
                    counts["slots"], lanes=L))
        t[("evolve_block", L)] = (per["k"] - per["1"]) / (ENGINE_CYCLES - 1)
    fused_loss.launches, fused_loss_grad.launches, evolve_block.launches = saved
    for name in ("fused_loss", "fused_loss_grad", "evolve_block"):
        a, b = t[(name, 1)], t[(name, L4)]
        unit = "ms per cycle" if name == "evolve_block" else "ms"
        what = (f"{islands} islands a lane ({islands} and {L4 * islands} blocks)"
                if name == "evolve_block" else f"{P_lane} programs a lane x {CONFIG3_ROWS} rows")
        b1, b4 = bound[(name, 1)], bound[(name, L4)]
        print(f"fleet timing, {name} on the lane axis, {what}: L=1 {a:.4f} {unit}, L={L4} "
              f"{b:.4f} {unit} ({b / a:.2f}x the one lane's); bound L=1 {b1:.5f} ms, "
              f"L={L4} {b4:.5f} ms{' (one cycle)' if name == 'evolve_block' else ''}",
              flush=True)
        out[name] = {"max_abs_err": errs[name], "ms_l1": a, f"ms_l{L4}": b,
                     "bound_ms_l1": b1, f"bound_ms_l{L4}": b4}
    return out


def bmm_batch_count(device, N, lanes=4, batches=(4200, 64)):
    """Whether one ``torch.bmm`` over a fleet's lane-major batch gives each
    lane the bits of one call on that lane alone, for the BFGS's products
    (H g, and the two of the H update) at B instances a lane: the reason
    the fleet's BFGS calls bmm once per lane (``_lane_bmm``). Prints what it
    finds; fails on nothing."""
    import torch

    g = torch.Generator(device=device).manual_seed(0)
    for B in batches:
        def r(*shape):
            return torch.randn(*shape, device=device, generator=g)

        A = r(lanes * B, N, N)
        found = []
        for name, b in (("H g", r(lanes * B, N, 1)), ("A H", r(lanes * B, N, N)),
                        ("A H A^T", r(lanes * B, N, N).transpose(1, 2))):
            whole = torch.bmm(A, b)
            parts = torch.cat([torch.bmm(u, v) for u, v in zip(A.chunk(lanes), b.chunk(lanes))])
            same = torch.equal(whole.view(torch.int32), parts.view(torch.int32))
            found.append(f"{name} {'equal' if same else 'DIFFERENT'} "
                         f"(max abs diff {float((whole - parts).abs().max()):.3g})")
        print(f"bmm over {lanes} lanes x {B} instances x {N} slots against one bmm per lane: "
              + ", ".join(found), flush=True)


def _leg_timer(last_iteration, trace=("const_opt",)):
    """A ``device_search._LEG_WRAP`` that times each evolve and const-opt leg
    on the host clock between two synchronizations, and traces the legs
    named in ``trace`` of iteration ``last_iteration`` under torch.profiler
    (CUDA activity). Returns (wrap, walls {leg: [s]}, idle {leg: (wall s,
    busy s)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls, idle, seen = {}, {}, {}

    def wrap(name):
        seen[name] = nth = seen.get(name, 0) + 1
        if name not in ("evolve", "const_opt"):
            return contextlib.nullcontext()
        traced = name in trace and nth == last_iteration

        @contextlib.contextmanager
        def timed():
            acts = [ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]
            with profile(activities=acts) if traced else contextlib.nullcontext() as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                yield
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            walls.setdefault(name, []).append(wall)
            if traced:
                busy = 0.0
                for ev in prof.key_averages():
                    us = getattr(ev, "self_device_time_total", None)
                    busy += (getattr(ev, "self_cuda_time_total", 0.0) if us is None else us) * 1e-6
                idle[name] = (wall, busy)
        return timed()

    return wrap, walls, idle


def _timed_run(run, last_iteration):
    """``run()`` with its legs timed (``_leg_timer``) and B1-B3 counted from 0;
    returns (its result, (B1, B2, B3), walls, idle)."""
    import symbolicregression_jl_tpu_torch.models.device_search as ds

    wrap, walls, idle = _leg_timer(last_iteration)
    saved = ds._LEG_WRAP
    ds._LEG_WRAP = wrap
    try:
        out, b1, b2, b3 = _counted(run)
    finally:
        ds._LEG_WRAP = saved
    return out, (b1, b2, b3), walls, idle


def _idle_text(idle):
    wall, busy = idle
    return (f"{1 - busy / wall:.1%} of {wall * 1e3:.3f} ms" if busy > 0
            else "not measured (no device time traced)")


def fleet_multitarget(device, iterations=ENGINE_ITERATIONS, cycles=ENGINE_CYCLES, seed=0):
    """Phase 9 (b): ``multitarget_search`` of the four fleet targets on
    config3's X at config3 width, on the block, and the four solo
    ``scheduler="device"`` runs at seeds ``seed + t``: each lane's frontier
    (complexities, losses, strings) and num_evals equal its solo's; the
    fleet launches B3 once per iteration and B2 no more than one solo; legs
    timed per iteration against the solos' sums, and the const-opt leg's idle
    share in the last iteration. Returns (fleet launches, solo launches)."""
    from symbolicregression_jl_tpu_torch import Options, equation_search, multitarget_search

    Xn, _ = config3_data()
    Y = fleet_targets(Xn)
    T = Y.shape[0]

    def opts(s):
        return Options(populations=100, population_size=100, maxsize=20,
                       ncycles_per_iteration=cycles, seed=s, save_to_file=False, progress=False,
                       device=device.type, scheduler="device", **CONFIG3_OPS)

    with engine_block_env(True):
        t0 = time.perf_counter()
        fleet, fl, fwalls, fidle = _timed_run(
            lambda: multitarget_search(Xn, Y, opts(seed), niterations=iterations), iterations)
        fleet_wall = time.perf_counter() - t0
        solos, swalls, sidle = [], [], []
        sl = [0, 0, 0]
        solo_wall = 0.0
        for t in range(T):
            t0 = time.perf_counter()
            res, counts, walls, idle = _timed_run(
                lambda: equation_search(Xn, Y[t], options=opts(seed + t), niterations=iterations,
                                        verbosity=0), iterations)
            solo_wall += time.perf_counter() - t0
            solos.append(res)
            swalls.append(walls)
            sidle.append(idle)
            sl = [a + b for a, b in zip(sl, counts)]
            if res.engine_stats["block"] != "kernel":
                _fail(f"solo target {t} ran the evolve leg {res.engine_stats['block']!r}")
    for t in range(T):
        if _frontier(fleet[t]) != _frontier(solos[t]):
            _fail(f"multitarget lane {t}: frontier differs from its solo run")
        if fleet[t].num_evals != solos[t].num_evals:
            _fail(f"multitarget lane {t}: num_evals {fleet[t].num_evals} vs solo "
                  f"{solos[t].num_evals}")
    st = fleet[0].engine_stats
    if st["block"] != "kernel":
        _fail(f"the fleet ran the evolve leg {st['block']!r}, not the block")
    if fl[2] != iterations or sl[2] != T * iterations:
        _fail(f"B3 launches: fleet {fl[2]}, solos {sl[2]} (want {iterations} and "
              f"{T * iterations})")
    solo_b2 = [s.engine_stats["grad_calls"] for s in solos]
    if fl[1] != st["fleet"]["grad_calls"] or fl[1] > max(solo_b2):
        _fail(f"B2 launches: fleet {fl[1]} ({st['fleet']['grad_calls']} gradient calls) "
              f"against solos {solo_b2}")
    fleet_score = st["fleet"]["score_calls"] + sum(r.engine_stats["score_calls"] for r in fleet)
    if fl[0] != fleet_score:
        _fail(f"B1 launches: fleet {fl[0]} for {fleet_score} scoring calls")
    print(f"fleet multitarget_search: {T} targets on config3's X (100x100, "
          f"{CONFIG3_ROWS} rows), {iterations} iterations x {cycles} cycles on the block: "
          f"every lane's frontier and num_evals equal its solo run at seed {seed}+t; "
          f"launches fleet B1 {fl[0]}, B2 {fl[1]}, B3 {fl[2]} against the four solos' "
          f"B1 {sl[0]}, B2 {sl[1]}, B3 {sl[2]}; wall fleet {fleet_wall:.3f} s (set-up "
          f"{fleet[0].setup_seconds:.3f} s, main loop "
          f"{max(r.iteration_seconds for r in fleet):.3f} s), the four solos {solo_wall:.3f} s "
          f"(set-up {sum(r.setup_seconds for r in solos):.3f} s, main loops "
          f"{sum(r.iteration_seconds for r in solos):.3f} s)", flush=True)
    for leg in ("evolve", "const_opt"):
        f_ms = [w * 1e3 for w in fwalls[leg]]
        s_ms = [sum(w[leg][i] for w in swalls) * 1e3 for i in range(iterations)]
        print(f"fleet legs, {leg}, host ms between synchronizations per iteration: fleet "
              + ", ".join(f"{v:.3f}" for v in f_ms) + "; sum of the four solos "
              + ", ".join(f"{v:.3f}" for v in s_ms), flush=True)
    print(f"fleet const-opt leg, iteration {iterations}, device idle under torch.profiler: "
          f"fleet {_idle_text(fidle['const_opt'])}; solos "
          + ", ".join(_idle_text(i["const_opt"]) for i in sidle), flush=True)
    for t, r in enumerate(fleet):
        best = min(r.pareto_frontier, key=lambda m: m.loss)
        print(f"  target {t}: best loss {best.loss:.6g}, "
              f"{best.tree.string_tree(r.options.operators)}", flush=True)
    return tuple(fl), tuple(sl)


def fleet_mixed(device, cycles=ENGINE_CYCLES, seed=0):
    """Phase 9 (c): a 6,000-row lane of 3 iterations beside a 10,000-row
    lane of 1 iteration, at config3 width on the block: the short-rowed lane
    equals its solo on its data padded to 10,000 rows (``pad_rows_np``), the
    other its solo with explicit ones weights (a fleet of mixed rows weights
    every lane), and the 1-iteration lane stops while the other goes on.
    Returns (fleet launches, solo launches)."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.models.device_search import FleetLaneSpec, fleet_search
    from symbolicregression_jl_tpu_torch.ops.scoring import pad_rows_np

    Xn, _ = config3_data()
    Y = fleet_targets(Xn)

    def opts(s):
        return Options(populations=100, population_size=100, maxsize=20,
                       ncycles_per_iteration=cycles, seed=s, save_to_file=False, progress=False,
                       device=device.type, scheduler="device", **CONFIG3_OPS)

    short_X, short_y = np.ascontiguousarray(Xn[:, :6000]), np.ascontiguousarray(Y[1][:6000])
    with engine_block_env(True):
        res, *fl = _counted(lambda: fleet_search([
            FleetLaneSpec(X=short_X, y=short_y, options=opts(seed + 1), niterations=3),
            FleetLaneSpec(X=Xn, y=Y[0], options=opts(seed), niterations=1),
        ]))
        Xp, yp, wp = pad_rows_np(short_X, short_y, None, CONFIG3_ROWS)
        solo_a, *sa = _counted(lambda: equation_search(Xp, yp, weights=wp, options=opts(seed + 1),
                                                        niterations=3, verbosity=0))
        solo_b, *sb = _counted(lambda: equation_search(
            Xn, Y[0], weights=np.ones(CONFIG3_ROWS, np.float32), options=opts(seed),
            niterations=1, verbosity=0))
    for tag, got, want in (("6,000-row lane (3 iterations)", res[0], solo_a),
                           ("10,000-row lane (1 iteration)", res[1], solo_b)):
        if _frontier(got) != _frontier(want) or got.num_evals != want.num_evals:
            _fail(f"fleet, mixed rows and budgets: the {tag} differs from its solo run")
    iters = [r.engine_stats["iterations"] for r in res]
    if iters != [3, 1] or fl[2] != 3:
        _fail(f"fleet, mixed budgets: lanes ran {iters} iterations in {fl[2]} B3 launches")
    print(f"fleet, mixed rows and budgets (6,000 rows x 3 iterations beside 10,000 rows x 1, "
          f"config3 width, on the block): each lane equal to its solo run on the padded, "
          f"weighted data (frontier and num_evals); launches fleet B1 {fl[0]}, B2 {fl[1]}, B3 "
          f"{fl[2]}; solos B1 {sa[0] + sb[0]}, B2 {sa[1] + sb[1]}, B3 {sa[2] + sb[2]}",
          flush=True)
    return tuple(fl), tuple(a + b for a, b in zip(sa, sb))


def fleet_event_leg(device, iterations=2, cycles=100, seed=0):
    """Phase 9 (d): two lanes at the quick start's size (200 x 2, 15 x 33,
    ``+ - *``, ``cos``) with ``SR_ENGINE_BLOCK=0``: the event leg runs lane
    after lane, the const-opt leg once for both; each lane equals its solo
    run. Cycles cut from 550 to ``cycles``. Returns (fleet launches, solo
    launches)."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.models.device_search import FleetLaneSpec, fleet_search

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 200)).astype(np.float32)
    ys = [(2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32),
          (X[0] * X[1] + np.cos(X[0])).astype(np.float32)]

    def opts(s):
        return Options(binary_operators=["+", "-", "*"], unary_operators=["cos"],
                       ncycles_per_iteration=cycles, seed=s, save_to_file=False, progress=False,
                       device=device.type, scheduler="device")

    with engine_block_env(False):
        t0 = time.perf_counter()
        res, *fl = _counted(lambda: fleet_search(
            [FleetLaneSpec(X=X, y=ys[t], options=opts(seed + t), niterations=iterations)
             for t in range(2)]))
        fleet_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        solos, *sl = _counted(lambda: [equation_search(X, ys[t], options=opts(seed + t),
                                                       niterations=iterations, verbosity=0)
                                       for t in range(2)])
        solo_wall = time.perf_counter() - t0
    for t in range(2):
        if _frontier(res[t]) != _frontier(solos[t]) or res[t].num_evals != solos[t].num_evals:
            _fail(f"fleet, event leg: lane {t} differs from its solo run")
    if res[0].engine_stats["block"] is not None or fl[2] != 0:
        _fail("fleet, event leg: the block ran")
    print(f"fleet, event leg (SR_ENGINE_BLOCK=0; quick start's size, 2 lanes x {iterations} "
          f"iterations x {cycles} cycles): each lane equal to its solo run; wall fleet "
          f"{fleet_wall:.3f} s, two solos {solo_wall:.3f} s; launches fleet B1 {fl[0]}, B2 "
          f"{fl[1]}; solos B1 {sl[0]}, B2 {sl[1]}", flush=True)
    return tuple(fl), tuple(sl)


def fleet_path(device):
    """Phase 9: the fleet. (a) the lane-axis kernels, (b) multitarget_search
    at config3 width, (c) mixed rows and budgets, (d) the event leg. Returns
    ({kernel name: lane-axis record}, {path: (B1, B2, B3 launches)}): the
    fleet runs under "fleet", their solo references under "fleet solos"."""
    t0 = time.perf_counter()
    lanes = fleet_kernel_check(device)
    fleets, solos = zip(fleet_multitarget(device), fleet_mixed(device), fleet_event_leg(device))
    paths = {"fleet": tuple(map(sum, zip(*fleets))),
             "fleet solos": tuple(map(sum, zip(*solos)))}
    print(f"fleet phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return lanes, paths


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
    interp_cuda.build_all()
    print(f"build: {', '.join(interp_cuda.SOURCES)} in {time.perf_counter() - t0:.2f} s "
          f"(one nvcc per source, in parallel)", flush=True)
    for name, info in interp_cuda.BUILD_INFO.items():
        print(f"  {name}: {info['library']}", flush=True)
        for line in info["log"].splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"    {line.strip()}", flush=True)

    b1 = kernel_check(device)
    b2 = grad_kernel_check(device)
    operator_isolation(device)
    b3 = block_kernel_check(device)
    b4 = preds_kernel_check(device)
    lockstep_b1, lockstep_b2, lockstep_stats = main_path(device)
    event_b1, event_b2, event_b3, _ = engine_path(device, lockstep_stats, block=False)
    engine_b1, engine_b2, engine_b3, block_stats = engine_path(device, lockstep_stats,
                                                                block=True)
    b1["launches_by_path"] = {"lockstep": lockstep_b1, "device": engine_b1,
                              "device SR_ENGINE_BLOCK=0": event_b1}
    b2["launches_by_path"] = {"lockstep": lockstep_b2, "device": engine_b2,
                              "device SR_ENGINE_BLOCK=0": event_b2}
    b3["launches_by_path"] = {"lockstep": 0, "device": engine_b3,
                              "device SR_ENGINE_BLOCK=0": event_b3}
    # B4 is on no main path: as in the JAX package, only tests call it
    b4["launches_by_path"] = {"lockstep": 0, "device": 0, "device SR_ENGINE_BLOCK=0": 0}
    quick_start(device)
    quick_start_device(device)
    resume_b1, resume_b2, resume_b3 = resume_path(device)
    for rec, n in ((b1, resume_b1), (b2, resume_b2), (b3, resume_b3), (b4, 0)):
        rec["launches_by_path"]["resume"] = n
    for path, counts in engine_options(device, block_stats["main_loop_s"]).items():
        for rec, n in zip((b1, b2, b3, b4), (*counts, 0)):
            rec["launches_by_path"][path] = n
    lanes, fleet_paths = fleet_path(device)
    for path, counts in fleet_paths.items():
        for rec, n in zip((b1, b2, b3, b4), (*counts, 0)):
            rec["launches_by_path"][path] = n
    for rec in (b1, b2, b3):
        rec["lane_axis"] = lanes[rec["name"]]
    for rec in (b1, b2, b3, b4):
        rec["launches"] = sum(rec["launches_by_path"].values())

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path", "lane_axis"]
    print(json.dumps({"kernels": [{k: r[k] for k in order if k in r}
                                  for r in (b1, b2, b3, b4)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            # the cards this run used
            "count": 1,
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
