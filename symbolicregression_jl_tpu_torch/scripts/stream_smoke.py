#!/usr/bin/env python
"""Streaming-runtime smoke: one SearchServer subscription job end to end on
the port: live row pushes, a drifted replace, frontier frames, clean cancel.

Asserts (the CI gate):
- a ``kind="subscription"`` job streams format-2 frontier frames from a
  long-lived lane (deadline-less, never coalesced);
- in-bucket ``push_rows``/``replace_rows`` cost ZERO ProgramCache misses
  and build no kernel (the engine swaps same-shape rows into the lane's
  resident tensors);
- a distribution shift trips the drift detector: the frontier is re-scored
  against the new buffer and a later frame reports the honest (worse)
  losses;
- ``cancel`` ends the subscription cleanly: terminal DONE, stop_reason
  "cancelled", final SearchResult attached.

Run: python symbolicregression_jl_tpu_torch/scripts/stream_smoke.py [--device cpu]
(or python -m symbolicregression_jl_tpu_torch.scripts.stream_smoke). The
subscription runs on the card unless ``--device cpu``; no card is exit 2.
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _problem(n=60, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y


def _opts(device):
    from symbolicregression_jl_tpu_torch import Options

    return Options(
        binary_operators=["+", "-", "*"],
        unary_operators=["cos"],
        populations=4,
        population_size=16,
        ncycles_per_iteration=40,
        maxsize=14,
        save_to_file=False,
        seed=0,
        scheduler="device",
        progress=False,
        device=str(device),
    )


def _best_loss(frame: bytes) -> float:
    from symbolicregression_jl_tpu_torch.utils.checkpoint import load_frontier_bytes

    return min(m.loss for m in load_frontier_bytes(frame).members)


def _builds():
    from symbolicregression_jl_tpu_torch.ops import interp_cuda

    return {k: v["library"] for k, v in interp_cuda.BUILD_INFO.items()}


def _wait_for(cond, timeout):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)
    return cond()


def run(device: str = "cuda") -> None:
    import numpy as np

    from symbolicregression_jl_tpu_torch.serve import DONE, JobSpec, SearchServer
    from symbolicregression_jl_tpu_torch.serve.program_cache import global_program_cache

    t0 = time.time()
    X, y = _problem(60)
    srv = SearchServer(max_concurrency=1).start()
    try:
        jid = srv.submit(JobSpec(X=X, y=y, options=_opts(device), kind="subscription",
                                 stream_config={"row_bucket": 64}))
        job = srv.job(jid)
        if not _wait_for(lambda: srv.frames(jid), 900):
            raise AssertionError("no first frame within budget")
        fitted = _best_loss(srv.frames(jid)[-1])
        print(f"[stream_smoke] first frame: best loss {fitted:.4f} -- "
              f"{time.time() - t0:.1f}s", flush=True)

        # -- in-bucket push: 60 -> 64 rows, zero recompiles -------------------
        cache = global_program_cache()
        m0, builds = cache.stats()["misses"], _builds()
        Xn, yn = _problem(4, seed=5)
        srv.push_rows(jid, Xn, yn)
        session = job.session
        if not _wait_for(lambda: session.stats.rows == 64, 300):
            raise AssertionError(session.stats.summary())
        misses = cache.stats()["misses"] - m0
        if misses != 0 or _builds() != builds:
            raise AssertionError(f"{misses} ProgramCache misses on in-bucket push; kernel "
                                 f"builds {builds} -> {_builds()}")
        print(f"[stream_smoke] in-bucket push applied with 0 cache misses -- "
              f"{time.time() - t0:.1f}s", flush=True)

        # -- drifted replace: same shapes, shifted target ---------------------
        Xd, yd = _problem(60, seed=9)
        srv.replace_rows(jid, Xd, (yd + 10.0).astype(np.float32))
        if not _wait_for(lambda: session.stats.drifts >= 1, 300):
            raise AssertionError(session.stats.summary())
        if session.stats.rescores < 1:
            raise AssertionError(session.stats.summary())
        # the honest post-rescore loss: the next iteration's const-opt can
        # absorb a +10 target shift, so read the recorded rescore observable
        # rather than racing the live frontier
        shifted = session.stats.last_rescore_best
        if shifted is None or not shifted > fitted:
            raise AssertionError((shifted, fitted))
        n_before = len(srv.frames(jid))
        if not _wait_for(lambda: len(srv.frames(jid)) > n_before, 300):
            raise AssertionError("no frame after rescore")
        misses = cache.stats()["misses"] - m0
        if misses != 0 or _builds() != builds:
            raise AssertionError(f"{misses} ProgramCache misses on drift rescore; kernel "
                                 f"builds {builds} -> {_builds()}")
        print(f"[stream_smoke] drift detected; frontier re-scored "
              f"{fitted:.4f} -> {shifted:.4f}, still 0 cache misses -- "
              f"{time.time() - t0:.1f}s", flush=True)

        # -- clean client cancel ----------------------------------------------
        srv.cancel(jid)
        job = srv.wait(jid, timeout=600)
        if job.state != DONE or job.stop_reason != "cancelled" or job.result is None:
            raise AssertionError(job.summary())
        print(f"[stream_smoke] cancelled cleanly: DONE after "
              f"{job.iterations_done} iterations, "
              f"{len(srv.frames(jid))} frames -- {time.time() - t0:.1f}s", flush=True)
    finally:
        srv.shutdown()
    print(f"[stream_smoke] OK in {time.time() - t0:.1f}s", flush=True)


def main(argv=None) -> int:
    from symbolicregression_jl_tpu_torch.scripts import _drill

    args = _drill.parser(__doc__).parse_args(argv)
    _drill.check_device("stream_smoke", args.device)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
