"""The readings a cell's limits are set from: the program's compared numbers
and the control's, over many seeds in one process, on the card.

    python3 port_bench/readings.py --workload <cell> --seeds 1,2,3 --seconds 10 [--fault F]

For each seed it makes a run as the benchmark does (``harness.measure``: the
cell's data, its warm-up, then one call with ``timeout_in_seconds=--seconds``),
then prints one JSON line: ``program`` (every number ``checks.judge`` can
compare, whether the cell's limits name it or not), ``control`` (the same
numbers with the reference in bfloat16 put in the program's place, on the
same members) and ``refit`` (each hall-of-fame member's ``refit_gain``). The
benchmark's own runs never run it. ``--fault`` plants a fault in the timed
path for a number's upper reading:

- ``b3_unchanged``: B3 returns the population it was given;
- ``b2_zero_grad``: B2 returns its losses with zero gradients.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def read_seed(cell, seed: int, seconds: float) -> dict:
    from port_bench import checks, harness

    run, X, y = harness.measure(cell, seed, seconds, False, "cuda", time.perf_counter())
    sample = int(cell.traffic["sample"])
    prog = checks.judge(run.result, X, y, cell.config, seed, sample)
    ctrl = checks.judge(run.result, X, y, cell.config, seed, sample, dtype="bfloat16",
                        numbers=("hof_loss_gap", "pop_loss_gap"))
    return {"seed": seed, "iterations": run.iterations, "call_s": run.call_s,
            "compared": len(prog["gaps"]["hof"]) + len(prog["gaps"]["pop"]),
            "near_overflow": prog["near_overflow"], "program": prog["numbers"],
            "control": ctrl["numbers"], "refit": sorted(prog["refit"])}


def plant(fault: str) -> None:
    """Break the timed path underneath the entry point, on the card."""
    from symbolicregression_jl_tpu_torch.models import device_search as ds
    from symbolicregression_jl_tpu_torch.ops import evolve_block as eb
    from symbolicregression_jl_tpu_torch.ops import interp_cuda as ic

    if fault == "b3_unchanged":
        # (words, consts, length, loss, score, birth, fnorm, seed, step0,
        #  curmaxsize, norm, X, y, w, cfg, ...) -> the carry of cycle 0
        ds.evolve_block = lambda *a: eb.block_carry0(tuple(t.clone() for t in a[:6]), a[14])
    elif fault == "b2_zero_grad":
        orig = ic.fused_loss_grad

        def zero_grad(*a, **k):
            losses, grads = orig(*a, **k)
            return losses, grads.zero_()

        zero_grad.launches = 0  # the program counts its launches on the name it calls
        ic.fused_loss_grad = zero_grad


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from port_bench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", choices=("b3_unchanged", "b2_zero_grad"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if args.fault:
        plant(args.fault)
    for s in args.seeds.split(","):
        print(json.dumps(read_seed(cell, int(s), args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
