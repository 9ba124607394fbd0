#!/usr/bin/env python
"""Debug-checks smoke: a tiny end-to-end search on both schedulers with
``SR_DEBUG_CHECKS=1``, so the flat-IR verifier is live at every gated
decode site of the port (the lockstep scorer's batches, the device engine's
frontier readback and its population decode), then a checkpoint and a
resume, which cover the always-on checkpoint verification.

Exits non-zero if any invariant check fires on real search traffic (which
would mean either a genuine IR corruption bug or an over-strict invariant).

Run: python symbolicregression_jl_tpu_torch/scripts/debug_checks_smoke.py [--device cpu]
(or python -m symbolicregression_jl_tpu_torch.scripts.debug_checks_smoke).
The searches run on the card unless ``--device cpu``; no card is exit 2.
"""

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(device: str = "cuda", niterations: int = 2, resume_iterations: int = 3) -> None:
    """The drill on ``device``: each scheduler searches ``niterations`` with a
    snapshot after every iteration, then resumes from the latest snapshot to
    ``resume_iterations``. ``SR_DEBUG_CHECKS`` is 1 for the drill only."""
    import numpy as np

    from symbolicregression_jl_tpu_torch import Options, equation_search
    from symbolicregression_jl_tpu_torch.utils.checkpoint import latest_checkpoint

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 80)).astype(np.float32)
    y = (2.0 * np.cos(X[1]) + X[0] ** 2).astype(np.float32)

    before = os.environ.get("SR_DEBUG_CHECKS")
    os.environ["SR_DEBUG_CHECKS"] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for scheduler in ("lockstep", "device"):
                opts = Options(
                    binary_operators=["+", "-", "*"],
                    unary_operators=["cos"],
                    populations=2,
                    population_size=12,
                    ncycles_per_iteration=8,
                    maxsize=12,
                    seed=0,
                    scheduler=scheduler,
                    save_to_file=False,
                    progress=False,
                    device=str(device),
                    checkpoint_file=os.path.join(tmp, f"ck_{scheduler}.pkl"),
                    checkpoint_every=1,
                )
                res = equation_search(X, y, niterations=niterations, options=opts,
                                      verbosity=0)
                n = len(res.hall_of_fame.pareto_frontier())
                print(f"[debug-checks-smoke] scheduler={scheduler}: "
                      f"{n} pareto-frontier members", flush=True)
                if n < 1:
                    raise AssertionError(f"empty hall of fame under scheduler={scheduler}")

                path = latest_checkpoint(opts.checkpoint_file)
                if not path:
                    raise AssertionError(f"no checkpoint written under scheduler={scheduler}")
                res = equation_search(X, y, niterations=resume_iterations, options=opts,
                                      verbosity=0, resume_from=path)
                if len(res.hall_of_fame.pareto_frontier()) < 1:
                    raise AssertionError(f"empty resumed hall of fame under "
                                         f"scheduler={scheduler}")
                print(f"[debug-checks-smoke] scheduler={scheduler}: resume ok", flush=True)
    finally:
        if before is None:
            os.environ.pop("SR_DEBUG_CHECKS", None)
        else:
            os.environ["SR_DEBUG_CHECKS"] = before
    print("[debug-checks-smoke] PASS", flush=True)


def main(argv=None) -> int:
    from symbolicregression_jl_tpu_torch.scripts import _drill

    args = _drill.parser(__doc__).parse_args(argv)
    _drill.check_device("debug_checks_smoke", args.device)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
