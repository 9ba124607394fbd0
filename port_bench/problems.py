"""The benchmark's data, made from the run's seed: one general generator.

A configuration file names its generator under ``data.generator`` with its
parameters; ``make_data`` makes X [features, rows] and y [rows] in f32 from
``--seed``. The same seed gives the same bytes.

``search_suite`` is the data of SymbolicRegression.jl's search benchmark
(``benchmark/benchmarks.jl``, ``create_search_benchmark``): features drawn
uniformly from [low, high] (the suite: ``rand(T, 5, n) .* 10 .- 5``), the
target ``cos(2.13 x1) + 0.5 x2 |x3|^0.9 - 0.3 |x4|^1.5`` worked out in f64
and rounded to f32, plus ``noise`` times a standard normal draw: a target
outside the operator basis by construction, so the search never ends early.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_data", "GENERATORS"]


def suite_target(X: np.ndarray) -> np.ndarray:
    x = X.astype(np.float64)
    return (np.cos(2.13 * x[0]) + 0.5 * x[1] * np.abs(x[2]) ** 0.9
            - 0.3 * np.abs(x[3]) ** 1.5).astype(np.float32)


def _search_suite(data: dict, rng: np.random.Generator):
    rows, features = int(data["rows"]), int(data["features"])
    X = rng.uniform(float(data["low"]), float(data["high"]),
                    size=(features, rows)).astype(np.float32)
    noise = np.float32(data["noise"]) * rng.standard_normal(rows).astype(np.float32)
    return X, suite_target(X) + noise


#: generator name (a configuration's ``data.generator``) -> fn(data, rng)
GENERATORS = {"search_suite": _search_suite}


def make_data(config: dict, seed: int):
    """(X [F, R] f32, y [R] f32) of ``config`` for ``seed`` (any whole
    number >= 0; numpy's generator takes seeds of any size)."""
    data = config["data"]
    X, y = GENERATORS[data["generator"]](data, np.random.default_rng(int(seed)))
    return np.ascontiguousarray(X), np.ascontiguousarray(y)
