"""Preflight checks run before a search starts.

Copy of ``symbolicregression_jl_tpu/configure.py`` for the PyTorch package
(real dtypes only).

Counterpart of the reference's Configure.jl
(SymbolicRegression.jl/src/Configure.jl:3-112): operator totality smoke test over a
point grid, configuration validation, dataset validation with the >10k-row
batching hint, and an optional miniature end-to-end pipeline self-test
(the reference runs one on every worker, :254-307). Run by equation_search
when ``options.runtests`` is on (the reference's default too).
"""

from __future__ import annotations

import warnings

import numpy as np

__all__ = ["test_option_configuration", "test_dataset_configuration", "test_mini_pipeline"]


def test_option_configuration(options) -> None:
    """Operator totality: every operator must be total (finite or NaN, no
    raise) over a grid of 99 points in [-100, 100], like the reference
    (SymbolicRegression.jl/src/Configure.jl:3-44). Our safe operators return
    NaN outside their domain, so anything else is a broken custom
    operator."""
    grid = np.linspace(-100.0, 100.0, 99).astype(np.float64)
    from .ops.operators import SCALAR_IMPLS, apply_np

    def check(op, args):
        try:
            with np.errstate(all="ignore"):
                impl = SCALAR_IMPLS.get(op.name)
                if impl is not None:
                    out = np.array([impl(*a) for a in zip(*args)], dtype=np.float64)
                else:
                    out = np.asarray(apply_np(op.fn, *args), np.float64)
        except Exception as e:  # noqa: BLE001
            raise ValueError(
                f"operator {op.name!r} is not total: raised {type(e).__name__} "
                "on the test grid; operators must return NaN outside their "
                "domain instead of raising"
            ) from e
        bad = np.isinf(out)
        if bad.any():
            # infinities are tolerated (gamma etc. map them to NaN at eval
            # time on device); warn so custom-operator authors notice
            warnings.warn(
                f"operator {op.name!r} returns inf on {int(bad.sum())} grid points"
            )

    for op in options.operators.unary:
        check(op, [grid])
    for op in options.operators.binary:
        check(op, [np.repeat(grid, 3)[: 99 * 2 : 2], np.tile(grid, 2)[: 99 * 2 : 2]])

    if options.operators.n_unary == 0 and options.operators.n_binary == 0:
        raise ValueError("need at least one operator")
    # same operator in both arities is a reference-level error (:47-83)
    shared = {o.name for o in options.operators.unary} & {
        o.name for o in options.operators.binary
    }
    if shared:
        raise ValueError(f"operators appear as both unary and binary: {shared}")


def test_dataset_configuration(dataset, options, verbosity: int = 1) -> None:
    """Dataset sanity + the reference's >10k-row batching hint
    (SymbolicRegression.jl/src/Configure.jl:86-112)."""
    if dataset.n == 0:
        raise ValueError("dataset has zero rows")
    if dataset.n > 10_000 and not options.batching and verbosity > 0:
        warnings.warn(
            f"dataset has {dataset.n} rows; consider batching=True for faster "
            "evolution (full-data rescoring still happens at iteration ends)"
        )
    if dataset.weights is not None and np.any(dataset.weights < 0):
        raise ValueError("weights must be non-negative")
    if not np.all(np.isfinite(dataset.X)):
        raise ValueError("X contains non-finite values")
    if dataset.y is not None and not np.all(np.isfinite(dataset.y)):
        raise ValueError("y contains non-finite values")


def test_mini_pipeline(options) -> None:
    """Miniature end-to-end search (the reference's per-worker
    test_entire_pipeline, SymbolicRegression.jl/src/Configure.jl:254-307): 2
    features, tiny populations, one iteration. Raises if the full stack cannot
    run with these options. Opt-in via runtests='full' (compile cost)."""
    import dataclasses

    from .search import equation_search

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 32)).astype(np.float32)
    y = (X[0] + np.cos(X[1])).astype(np.float32) if options.operators.n_unary else (
        X[0] * 2
    ).astype(np.float32)
    mini = dataclasses.replace(
        options,
        populations=2,
        population_size=8,
        ncycles_per_iteration=5,
        maxsize=min(10, options.maxsize),
        save_to_file=False,
        use_recorder=False,
        runtests=False,
        timeout_in_seconds=None,
        max_evals=None,
        early_stop_condition=None,
    )
    res = equation_search(X, y, options=mini, niterations=1, verbosity=0)
    if not res.pareto_frontier:
        raise RuntimeError("preflight mini pipeline produced an empty hall of fame")
