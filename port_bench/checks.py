"""The comparison that decides ``correct``: what the timed call returned,
held against the plain reference (``reference.py``).

- ``hof_loss_gap``: the widest gap between a hall-of-fame member's loss, as
  the search reports it, and the reference's exact (f64) loss of its tree on
  the cell's data, in units of the gap that f32 rounding alone gives that
  tree (the reference's own f32 loss against its f64 loss, at least one f32
  ulp of the loss). A tree whose loss swings on the last ulp of an
  exp(exp(x)) has a wide unit, a plain sum of features a narrow one, so one
  limit fits both. Every member: the scoring of B3 and B1.
- ``pop_loss_gap``: the same over a sample, drawn from the seed, of the
  final populations: the evolve leg's scoring of what it kept.
- ``shape_faults``: hall-of-fame members whose tree breaks the
  configuration (node count other than the complexity it is filed under,
  more nodes than ``maxsize``, an operator or a feature outside the
  configuration, a constant that is not finite), and a search that returned
  no member. Exact: its limit is 0.
- ``frontier_shortfall``: ``maxsize`` less the node count of the largest
  hall-of-fame member. A search starts from trees of at most three
  operators (seven nodes) and only the evolve leg grows them, so a search
  whose evolution returns its population unchanged reads ``maxsize`` - 7 or
  more.
- ``const_fit_gain``: the median, over the hall-of-fame members that hold a
  constant, of ``reference.refit_gain``: the share of the f64 loss that a
  few reference Levenberg-Marquardt steps from the member's own constants
  remove. Constants fitted by const-opt leave almost none; constants that
  only mutation moved, as with const-opt off, skipped or fed a wrong
  gradient, leave a share.

A member whose reference walk passes ``reference.NEAR_OVERFLOW`` is left out
of the gaps and counted in ``near_overflow``. A cell compares the numbers its
``limits/<cell>.json`` names; PERF.md gives the readings each limit was set
from.
"""

from __future__ import annotations

import math

import numpy as np

from . import reference

__all__ = ["judge", "verdict", "member_gaps", "result_members", "NUMBERS"]

NUMBERS = ("hof_loss_gap", "pop_loss_gap", "shape_faults", "frontier_shortfall",
           "const_fit_gain")
#: f32's unit roundoff, 2**-23
F32_EPS = 2.0 ** -23


def result_members(result, sample: int, rng: np.random.Generator):
    """(hall-of-fame [(complexity slot, member)], sampled population
    members) of a SearchResult."""
    hof = result.hall_of_fame
    hof_members = [(i + 1, m) for i, (m, e) in enumerate(zip(hof.members, hof.exists)) if e]
    pop = [m for p in result.populations for m in p.members]
    idx = rng.choice(len(pop), size=min(sample, len(pop)), replace=False) if pop else []
    return hof_members, [pop[i] for i in sorted(idx)]


def _gap(got: float, f32: float, exact: float) -> float:
    """How far ``got`` lies from the exact loss, in units of how far the f32
    reference lies from it (at least one f32 ulp of the loss)."""
    if not math.isfinite(exact):
        return 0.0 if not math.isfinite(got) else math.inf
    if not math.isfinite(got):
        return math.inf
    unit = abs(f32 - exact) + abs(exact) * F32_EPS + 1e-30
    return abs(got - exact) / unit


def member_gaps(members, X, y, names, dtype: str = "float32"):
    """Per member (gap, near_overflow): ``member.loss`` against the
    reference's losses of its tree (``_gap``); with ``dtype="bfloat16"`` the
    control, the reference's bfloat16 loss in the program's place."""
    unary, binary = names
    out = []
    for m in members:
        pred32, top = reference.evaluate(m.tree, X, unary, binary, "float32")
        if top > reference.NEAR_OVERFLOW:
            out.append((0.0, True))
            continue
        f32 = reference.loss(pred32, y)
        exact = reference.loss(reference.evaluate(m.tree, X, unary, binary, "float64")[0], y,
                               "float64")
        if dtype == "float32":
            got = float(m.loss)
        else:
            cpred, _ = reference.evaluate(m.tree, X, unary, binary, dtype)
            got = reference.loss(cpred, y, dtype)
        out.append((_gap(got, f32, exact), False))
    return out


def judge(result, X, y, config: dict, seed: int, sample: int, dtype: str = "float32",
          numbers=NUMBERS) -> dict:
    """The ``numbers`` compared, and what was compared, for one call's
    SearchResult on the cell's data. ``dtype="bfloat16"`` reads the
    control's gaps on the same members instead of the program's."""
    opts = config["options"]
    names = (list(opts["unary_operators"]), list(opts["binary_operators"]))
    maxsize = int(opts["maxsize"])
    hof_members, pop_members = result_members(result, sample,
                                              np.random.default_rng([int(seed), 20]))
    shape_faults = 0 if hof_members else 1
    largest = 0
    for slot, m in hof_members:
        facts = reference.tree_facts(m.tree, X.shape[0], len(names[0]), len(names[1]))
        largest = max(largest, facts["nodes"])
        if facts["bad_nodes"] or facts["nodes"] != slot or facts["nodes"] > maxsize:
            shape_faults += 1
    gaps = {}
    near = 0
    for which, ms in (("hof", [m for _, m in hof_members]), ("pop", pop_members)):
        g = member_gaps(ms, X, y, names, dtype)
        near += sum(n for _, n in g)
        gaps[which] = [v for v, n in g if not n]
    out = {"hof_loss_gap": max(gaps["hof"], default=0.0),
           "pop_loss_gap": max(gaps["pop"], default=0.0),
           "shape_faults": shape_faults, "frontier_shortfall": maxsize - largest}
    refit = []
    if "const_fit_gain" in numbers:
        refit = [r for r in (reference.refit_gain(m.tree, X, y, *names)
                             for _, m in hof_members) if r is not None]
        out["const_fit_gain"] = float(np.median(refit)) if refit else math.inf
    return {"numbers": {k: out[k] for k in numbers}, "gaps": gaps, "refit": refit,
            "near_overflow": near}


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit, ok)]) for every number ``limits``
    names; a NaN fails."""
    rows = []
    for name in (n for n in NUMBERS if n in limits):
        v, lim = numbers[name], float(limits[name])
        ok = v == v and v <= lim
        rows.append((name, v, lim, ok))
    return all(r[3] for r in rows), rows
