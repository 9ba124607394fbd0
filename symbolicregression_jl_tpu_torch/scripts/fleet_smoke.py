#!/usr/bin/env python
"""Fleet-coalescing smoke: one SearchServer(fleet=True), 8 mixed-dataset
same-bucket jobs, and a mid-fleet cancel, end to end on the port.

Asserts (the CI gate):
- the 8 jobs (distinct datasets AND distinct seeds, one shape bucket)
  coalesce into >= 2 fleet batches instead of 8 solo runs;
- every job's final frontier is bit-identical to the same search run solo
  through equation_search on the same device (lane batching + serve demux
  change nothing);
- cancelling one job mid-fleet evicts only its lane: the survivors still
  finish DONE with frontiers bit-identical to their solo runs.

The cancel lands while the fleet is held at its first iteration boundary
(lane 0's ``Options.iteration_callback``), so it cannot come after the fleet
has ended however fast an iteration runs: the cancelled lane stops after at
least one iteration and before its last.

Run: python symbolicregression_jl_tpu_torch/scripts/fleet_smoke.py [--device cpu]
(or python -m symbolicregression_jl_tpu_torch.scripts.fleet_smoke). The jobs
run on the card unless ``--device cpu``; no card is exit 2.
"""

import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _problem(n=100, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y


def _opts(device, seed=0, cycles=40, **kw):
    from symbolicregression_jl_tpu_torch import Options

    return Options(
        binary_operators=["+", "-", "*"],
        unary_operators=["cos"],
        populations=4,
        population_size=16,
        ncycles_per_iteration=cycles,
        maxsize=14,
        save_to_file=False,
        seed=seed,
        scheduler="device",
        progress=False,
        device=str(device),
        **kw,
    )


def _sig(res):
    return [(m.complexity, m.loss, str(m.tree)) for m in res.pareto_frontier]


def _solo(device, dataset, seed, iterations, cycles):
    from symbolicregression_jl_tpu_torch import equation_search

    X, y = dataset
    return equation_search(X, y, options=_opts(device, seed, cycles), niterations=iterations,
                           verbosity=0)


def server():
    """The drill's server: one worker, fleets of up to 4 lanes gathered in a
    2 s window, and a quota that covers a full-width batch of one tenant."""
    from symbolicregression_jl_tpu_torch.serve import SearchServer

    return SearchServer(max_concurrency=1, fleet=True, fleet_max=4, fleet_window_s=2.0,
                        default_quota=8)


def coalesce(device, srv, iterations=2, cycles=40, t0=None):
    """Phase 1: 8 mixed-dataset jobs submitted back to back coalesce into
    ceil(8 / fleet_max) = 2 fleet batches, each frontier bitwise its solo
    run's. Returns the server's fleet stats."""
    from symbolicregression_jl_tpu_torch.serve import DONE, JobSpec

    t0 = time.time() if t0 is None else t0
    datasets = [_problem(seed=i) for i in range(8)]
    ids = [
        srv.submit(JobSpec(X, y, options=_opts(device, seed=i, cycles=cycles),
                           niterations=iterations, label=f"f{i}"))
        for i, (X, y) in enumerate(datasets)
    ]
    jobs = [srv.wait(i, timeout=1800) for i in ids]
    if not all(j.state == DONE for j in jobs):
        raise AssertionError([j.summary() for j in jobs])
    st = srv.stats()["fleet"]
    if st["batches"] < 2 or st["coalesced_lanes"] != 8 or st["largest_batch"] != 4:
        raise AssertionError(st)
    print(f"[fleet_smoke] phase 1: 8 jobs in {st['batches']} fleet batches "
          f"(largest {st['largest_batch']}) -- {time.time() - t0:.1f}s", flush=True)

    for i, job in enumerate(jobs):
        if _sig(job.result) != _sig(_solo(device, datasets[i], i, iterations, cycles)):
            raise AssertionError(f"job {i}: fleet frontier != solo frontier")
        if not job.frames:
            raise AssertionError(f"job {i}: no demuxed frontier frames")
    print(f"[fleet_smoke] phase 1: all 8 frontiers bitwise == solo -- "
          f"{time.time() - t0:.1f}s", flush=True)
    return st


def cancel_mid_fleet(device, srv=None, iterations=12, lanes=4, cycles=40, t0=None):
    """Phase 2: ``lanes`` jobs coalesce into one fleet; lane 1 is cancelled
    while the fleet is held at an iteration boundary. Lane 1 ends CANCELLED
    after more than 0 and fewer than ``iterations`` iterations; every other
    lane ends DONE bitwise equal to its solo run. ``srv``: a running
    ``server()`` (a new one when None). Returns the jobs."""
    from symbolicregression_jl_tpu_torch.serve import CANCELLED, DONE, JobSpec

    t0 = time.time() if t0 is None else t0
    datasets = [_problem(seed=i) for i in range(lanes)]
    arrived, go = threading.Event(), threading.Event()

    def hold(report):
        if report.iteration == 1 and not go.is_set():
            arrived.set()
            go.wait(600)
        return None

    own = srv is None
    srv = server().start() if own else srv
    try:
        ids = []
        try:
            for i, (X, y) in enumerate(datasets):
                kw = {"iteration_callback": hold} if i == 0 else {}
                ids.append(srv.submit(JobSpec(X, y, options=_opts(device, seed=i, cycles=cycles,
                                                                  **kw),
                                              niterations=iterations, label=f"c{i}")))
            if not arrived.wait(600):
                raise AssertionError("the fleet reached no iteration boundary within 600s")
            srv.cancel(ids[1])
        finally:
            go.set()
        jobs = [srv.wait(i, timeout=1800) for i in ids]
    finally:
        if own:
            srv.shutdown()
    states = [j.state for j in jobs]
    if states[1] != CANCELLED or not all(s == DONE for i, s in enumerate(states) if i != 1):
        raise AssertionError(states)
    if not 0 < jobs[1].iterations_done < iterations:
        raise AssertionError(f"cancelled lane ran {jobs[1].iterations_done} of "
                             f"{iterations} iterations")
    for i in range(lanes):
        if i != 1 and _sig(jobs[i].result) != _sig(
                _solo(device, datasets[i], i, iterations, cycles)):
            raise AssertionError(f"survivor {i}: frontier changed by mid-fleet cancel")
    print(f"[fleet_smoke] phase 2: mid-fleet cancel evicted one lane, "
          f"{lanes - 1} survivors bitwise == solo -- {time.time() - t0:.1f}s", flush=True)
    return jobs


def run(device: str = "cuda", iterations: int = 2, cancel_iterations: int = 12) -> None:
    """Both phases on one server, as the CLI runs them."""
    t0 = time.time()
    srv = server().start()
    try:
        coalesce(device, srv, iterations, t0=t0)
        cancel_mid_fleet(device, srv, cancel_iterations, t0=t0)
    finally:
        srv.shutdown()
    print(f"[fleet_smoke] OK in {time.time() - t0:.1f}s", flush=True)


def main(argv=None) -> int:
    from symbolicregression_jl_tpu_torch.scripts import _drill

    args = _drill.parser(__doc__).parse_args(argv)
    _drill.check_device("fleet_smoke", args.device)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
