"""Multi-target SR: one search per target row of Y, batched as a fleet.

Counterpart of ``symbolicregression_jl_tpu/stream/multitarget.py``. The
reference exposes multi-target fitting as ``MultitargetSRRegressor``:
independent searches over a shared X. On the device engine that is a fleet
of lanes (``models/device_search.fleet_search``): T targets share each
kernel launch and one readback per iteration. Options that are not
fleet-eligible (another scheduler, the recorder, ...) run the same searches
solo, one after another, with the same results.

Per-target randomness: target t runs with ``seed + t`` (when a seed is
set), so the targets explore independently.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["MultitargetSearch", "multitarget_search"]


def multitarget_search(
    X,
    Y,
    options,
    niterations: int = 10,
    weights=None,
    lane_bucket: int | None = None,
    verbosity: int = 0,
):
    """Fit one expression per target row of ``Y [targets, rows]`` over a
    shared ``X [features, rows]``. ``weights`` is either [rows] (shared) or
    [targets, rows] (per target). Returns ``[SearchResult]`` in target
    order."""
    from ..models.device_search import FleetLaneSpec, fleet_eligibility, fleet_search

    X = np.asarray(X)
    Y = np.asarray(Y)
    if Y.ndim == 1:
        Y = Y[None]
    if Y.ndim != 2 or X.ndim != 2 or Y.shape[1] != X.shape[1]:
        raise ValueError(
            f"expected X [features, rows] and Y [targets, rows]; got {X.shape} and {Y.shape}"
        )
    T = Y.shape[0]
    W = None
    if weights is not None:
        W = np.asarray(weights)
        if W.shape == (Y.shape[1],):
            W = np.broadcast_to(W, Y.shape)
        if W.shape != Y.shape:
            raise ValueError(f"weights must be [rows] or [targets, rows]; got {W.shape}")

    def opts_for(t: int):
        if options.seed is None:
            return options
        return dataclasses.replace(options, seed=options.seed + t)

    if fleet_eligibility(options) is None:
        specs = [
            FleetLaneSpec(
                X=X, y=Y[t], weights=None if W is None else W[t], options=opts_for(t),
                niterations=niterations, label=f"target-{t}",
            )
            for t in range(T)
        ]
        return fleet_search(specs, verbosity=verbosity, lane_bucket=lane_bucket)

    # options a fleet cannot take: the same searches, solo, in sequence
    from ..search import equation_search

    return [
        equation_search(
            X, Y[t], weights=None if W is None else W[t], options=opts_for(t),
            niterations=niterations, verbosity=verbosity,
        )
        for t in range(T)
    ]


class MultitargetSearch:
    """A thin wrapper over :func:`multitarget_search`::

        mt = MultitargetSearch(options, niterations=20)
        results = mt.run(X, Y)          # [SearchResult] per target
        mt.frontiers                    # per-target Pareto frontiers
    """

    def __init__(self, options, niterations: int = 10, lane_bucket: int | None = None):
        self.options = options
        self.niterations = int(niterations)
        self.lane_bucket = lane_bucket
        self.results = None

    def run(self, X, Y, weights=None, verbosity: int = 0):
        self.results = multitarget_search(
            X, Y, self.options, niterations=self.niterations, weights=weights,
            lane_bucket=self.lane_bucket, verbosity=verbosity,
        )
        return self.results

    @property
    def frontiers(self):
        if self.results is None:
            raise RuntimeError("run() first")
        return [r.hall_of_fame.pareto_frontier() for r in self.results]
