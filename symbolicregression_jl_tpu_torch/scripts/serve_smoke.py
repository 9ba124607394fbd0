#!/usr/bin/env python
"""Serve-layer smoke: one in-process SearchServer, 8 tiny mixed-shape jobs,
2 tenants, a deadline expiry, and a preempt+resume, end to end on the port.

Asserts (the CI gate):
- every job reaches the CORRECT terminal state (6 done, 1 expired-in-queue,
  the preempted job done with preemptions >= 1 and its FULL iteration budget);
- streamed frontier frames decode via load_frontier_bytes and the final
  frame carries iteration == niterations;
- the warm program-cache hit ratio across the batch exceeds 0.5. The port's
  program cache holds what a search keeps on its device, with no compile
  kinds: each search looks up its dataset upload (``score_data``, one entry
  per shape bucket and dataset) and its operator table (``optab``, one per
  operator set and device), so the first search of a bucket misses and every
  later one, the preempted job's resume included, hits.

The preempting job is submitted while the low-priority job is held at its
first iteration boundary (``Options.iteration_callback``), so the preemption
does not depend on how fast an iteration runs.

Run: python symbolicregression_jl_tpu_torch/scripts/serve_smoke.py [--device cpu]
(or python -m symbolicregression_jl_tpu_torch.scripts.serve_smoke). The jobs
run on the card unless ``--device cpu``; no card is exit 2.
"""

import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _problem(n, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y


def _opts(device, cycles=40, **kw):
    from symbolicregression_jl_tpu_torch import Options

    return Options(
        binary_operators=["+", "-", "*"],
        unary_operators=["cos"],
        populations=4,
        population_size=16,
        ncycles_per_iteration=cycles,
        maxsize=14,
        save_to_file=False,
        seed=0,
        scheduler="device",
        progress=False,
        device=str(device),
        **kw,
    )


def run(device: str = "cuda", low_iterations: int = 6, cycles: int = 40) -> dict:
    """The drill on ``device``; ``low_iterations`` is the preempted job's
    budget, ``cycles`` every job's cycles per iteration. Returns the
    server's ``stats()``."""
    from symbolicregression_jl_tpu_torch.serve import (
        DONE,
        EXPIRED,
        JobSpec,
        SearchServer,
        global_program_cache,
    )
    from symbolicregression_jl_tpu_torch.utils.checkpoint import load_frontier_bytes

    t0 = time.time()
    cache = global_program_cache()
    cache.clear()  # clean counters: the hit-ratio assertion is batch-scoped
    XA, yA = _problem(100)
    XB, yB = _problem(64, seed=1)
    arrived, go = threading.Event(), threading.Event()

    def hold(report):
        # the low job waits at its first iteration boundary until the
        # preempting job is queued
        if report.iteration == 1 and not go.is_set():
            arrived.set()
            go.wait(600)
        return None

    with SearchServer(max_concurrency=1, default_quota=4) as srv:
        try:
            # 1: low-priority long job, preempted by the vip job below
            low = srv.submit(JobSpec(XA, yA, options=_opts(device, cycles, iteration_callback=hold),
                                     niterations=low_iterations, tenant="acme", priority=0,
                                     label="low"))
            if not arrived.wait(600):
                raise AssertionError("low job reached no iteration boundary within 600s")

            # 2: expires in the queue (the single worker is busy with `low`)
            doomed = srv.submit(JobSpec(XA, yA, options=_opts(device, cycles), niterations=1,
                                        tenant="zeta", deadline_seconds=0.05, label="doomed"))
            # 3: high-priority job preempts `low` at its next iteration boundary
            vip = srv.submit(JobSpec(XA, yA, options=_opts(device, cycles), niterations=1,
                                     tenant="zeta", priority=5, label="vip"))
            # 4-8: warm bucket-A jobs + a second (cold) shape bucket, both tenants
            rest = [
                srv.submit(JobSpec(XA, yA, options=_opts(device, cycles), niterations=1,
                                   tenant="acme", label=f"a{i}"))
                for i in range(3)
            ] + [
                srv.submit(JobSpec(XB, yB, options=_opts(device, cycles), niterations=1,
                                   tenant="zeta", label=f"b{i}"))
                for i in range(2)
            ]
        finally:
            go.set()

        jobs = {i: srv.wait(i, timeout=1200) for i in [low, doomed, vip] + rest}
        for job in jobs.values():
            if not job.terminal:
                raise AssertionError(job.summary())

        if jobs[doomed].state != EXPIRED:
            raise AssertionError(jobs[doomed].summary())
        if jobs[doomed].started_at is not None:  # expired while QUEUED
            raise AssertionError(jobs[doomed].summary())
        if jobs[vip].state != DONE:
            raise AssertionError(jobs[vip].summary())
        lj = jobs[low]
        if lj.state != DONE or lj.preemptions < 1 or lj.resume_path is None:
            raise AssertionError(lj.summary())
        if lj.iterations_done != low_iterations:
            raise AssertionError(lj.summary())
        for jid in [vip] + rest:
            if jobs[jid].state != DONE:
                raise AssertionError(jobs[jid].summary())

        # streamed frames decode, and the last one closes the budget
        for jid in [low, vip] + rest:
            frames = srv.frames(jid)
            if not frames:
                raise AssertionError(jobs[jid].summary())
            upd = load_frontier_bytes(frames[-1])
            if upd.iteration != jobs[jid].spec.niterations or len(upd.members) < 1:
                raise AssertionError(f"{jid}: last frame at iteration {upd.iteration}, "
                                     f"{len(upd.members)} members")
            if not min(m.loss for m in upd.members) < 50.0:
                raise AssertionError(f"{jid}: best loss {min(m.loss for m in upd.members)}")

        st = srv.stats()

    ratio = st["warm_hit_ratio"]
    print(f"terminal states: {[j.summary()['state'] for j in jobs.values()]}")
    print(f"preemptions(low)={lj.preemptions} iterations_done={lj.iterations_done}")
    print(f"program cache: {st['program_cache']['hits']} hits / "
          f"{st['program_cache']['misses']} misses (ratio {ratio:.3f}), "
          f"{st['program_cache']['entries']} entries")
    if not ratio > 0.5:
        raise AssertionError(f"warm-hit ratio {ratio:.3f} <= 0.5")
    print(f"serve smoke OK in {time.time() - t0:.1f}s", flush=True)
    return st


def main(argv=None) -> int:
    from symbolicregression_jl_tpu_torch.scripts import _drill

    args = _drill.parser(__doc__).parse_args(argv)
    _drill.check_device("serve_smoke", args.device)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
