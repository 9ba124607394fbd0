"""Carry search state across from the JAX package, as numpy arrays.

The two packages share no objects: the JAX package's state reaches this one
as plain arrays — a flat tree batch's fields ``kind, op, lhs, rhs, feat,
val, length``, the operator names, and per-member loss / score / birth — and
is rebuilt here into this package's ``Node`` trees (through its own
``unflatten_tree``), ``PopMember``, ``Population`` and ``HallOfFame``. The
reverse direction, ``flat_arrays``, turns this package's trees into the same
plain arrays. Tests use both so the two packages compute on identical
inputs.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

from .models.hall_of_fame import HallOfFame
from .models.pop_member import PopMember
from .models.population import Population
from .ops.flat import FlatTrees, flatten_trees, unflatten_tree
from .ops.operators import OperatorSet, resolve_operators
from .tree import Node

__all__ = [
    "FIELDS",
    "flat_trees",
    "flat_arrays",
    "trees_from_arrays",
    "operators_from_names",
    "members_from_arrays",
    "population_from_arrays",
    "hall_of_fame_from_arrays",
]

#: the FlatTrees fields, in order
FIELDS = ("kind", "op", "lhs", "rhs", "feat", "val", "length")


def _field(src: Any, name: str) -> np.ndarray:
    value = src[name] if isinstance(src, Mapping) else getattr(src, name)
    return np.asarray(value)


def flat_trees(src: Any, dtype=np.float32) -> FlatTrees:
    """This package's FlatTrees from a mapping or any object carrying the
    seven fields (a JAX-package FlatTrees qualifies)."""
    out = {
        name: _field(src, name).astype(np.int32)
        for name in FIELDS
        if name != "val"
    }
    out["val"] = _field(src, "val").astype(dtype)
    return FlatTrees(**out)


def flat_arrays(trees: Sequence[Node], max_nodes: int, dtype=np.float32) -> dict:
    """Flatten this package's trees into the plain field arrays."""
    flat = flatten_trees(list(trees), max_nodes, dtype=dtype)
    return {name: np.asarray(getattr(flat, name)) for name in FIELDS}


def trees_from_arrays(src: Any) -> list[Node]:
    """Rebuild every tree of a flat batch (round-trip of flatten_trees)."""
    flat = flat_trees(src, dtype=np.float64)
    return [unflatten_tree(flat, p) for p in range(flat.n_trees)]


def operators_from_names(
    binary_names: Sequence[str], unary_names: Sequence[str]
) -> OperatorSet:
    """This package's OperatorSet for the operator names of the other side,
    in the same order (so operator indices mean the same operators)."""
    return resolve_operators(list(binary_names), list(unary_names))


def members_from_arrays(
    src: Any,
    loss: Sequence[float],
    score: Sequence[float],
    options,
    birth: Sequence[int] | None = None,
) -> list[PopMember]:
    trees = trees_from_arrays(src)
    if not (len(trees) == len(loss) == len(score)):
        raise ValueError("trees, loss and score must have one entry per member")
    members = []
    for k, tree in enumerate(trees):
        m = PopMember(tree, float(score[k]), float(loss[k]))
        if birth is not None:
            m.birth = int(birth[k])
        m.get_complexity(options)
        members.append(m)
    return members


def population_from_arrays(src, loss, score, options, birth=None) -> Population:
    return Population(members_from_arrays(src, loss, score, options, birth))


def hall_of_fame_from_arrays(src, loss, score, options, birth=None) -> HallOfFame:
    """A hall of fame holding the given members (each enters at its
    complexity by the usual update rule)."""
    hof = HallOfFame(options.maxsize)
    hof.update_many(members_from_arrays(src, loss, score, options, birth), options)
    return hof
