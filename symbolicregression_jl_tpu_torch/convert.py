"""Carry search state across from the JAX package, as numpy arrays.

The two packages share no objects: the JAX package's state reaches this one
as plain arrays — a flat tree batch's fields ``kind, op, lhs, rhs, feat,
val, length``, the operator names, and per-member loss / score / birth — and
is rebuilt here into this package's ``Node`` trees (through its own
``unflatten_tree``), ``PopMember``, ``Population`` and ``HallOfFame``. The
reverse direction, ``flat_arrays``, turns this package's trees into the same
plain arrays. The device engine's state crosses the same way:
``evo_state_from_arrays`` builds this package's ``EvoState`` from the
fields of the JAX package's (its PRNG key is dropped: this package keeps a
``torch.Generator`` beside the state), and ``evo_state_arrays`` goes back.
The evolve block's 11-tuple carry (packed population, per-island columns,
frequency delta and best-seen carry) crosses with
``block_carry_from_arrays`` / ``block_carry_arrays``. Tests use these so
the two packages compute on identical inputs.
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
    "EVO_FIELDS",
    "evo_state_from_arrays",
    "evo_state_arrays",
    "BLOCK_FIELDS",
    "block_carry_from_arrays",
    "block_carry_arrays",
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


#: the EvoState fields that cross between the packages (all but the JAX
#: state's ``key``), in order; ``bs_tree`` is the 7-tuple of tree fields
EVO_FIELDS = (
    "kind", "op", "lhs", "rhs", "feat", "val", "length", "loss", "score", "birth",
    "freq", "bs_loss", "bs_tree", "bs_exists", "step", "num_evals", "iteration",
)


def evo_state_from_arrays(src: Any, device="cpu"):
    """This package's EvoState from a mapping or any object carrying
    ``EVO_FIELDS`` (a JAX-package EvoState qualifies). Integer fields become
    int32, ``freq`` float32, ``num_evals`` float64; values, losses and
    scores keep their float dtype."""
    import torch

    from .ops.evolve import EvoState

    def get(name):
        return src[name] if isinstance(src, Mapping) else getattr(src, name)

    def t(a, dtype=None):
        a = np.asarray(a)
        out = torch.from_numpy(np.array(a)).to(device)
        return out if dtype is None else out.to(dtype)

    ints = ("kind", "op", "lhs", "rhs", "feat", "length", "birth", "step", "iteration")
    out = {}
    for name in EVO_FIELDS:
        if name == "bs_tree":
            bt = [np.asarray(a) for a in get(name)]
            out[name] = tuple(
                t(a, None if k == 5 else torch.int32) for k, a in enumerate(bt)
            )
        elif name in ints:
            out[name] = t(get(name), torch.int32)
        elif name == "bs_exists":
            out[name] = t(get(name), torch.bool)
        elif name == "freq":
            out[name] = t(get(name), torch.float32)
        elif name == "num_evals":
            out[name] = t(get(name), torch.float64)
        else:
            out[name] = t(get(name))
    return EvoState(**out)


def evo_state_arrays(state) -> dict:
    """The EvoState's fields as numpy arrays (``bs_tree`` as a tuple), the
    inverse of ``evo_state_from_arrays``."""
    out = {}
    for name in EVO_FIELDS:
        v = getattr(state, name)
        out[name] = (
            tuple(np.asarray(a.cpu()) for a in v) if name == "bs_tree" else np.asarray(v.cpu())
        )
    return out


#: the evolve block's carry, in order (the JAX package's ``_block_cycle``
#: carry and this package's ``evolve_block.block_cycle`` carry alike)
BLOCK_FIELDS = ("words", "consts", "length", "loss", "score", "birth", "fd", "bs_loss",
                "bs_words", "bs_consts", "bs_length")
_BLOCK_INTS = ("words", "length", "birth", "bs_words", "bs_length")


def block_carry_from_arrays(carry, device="cpu") -> tuple:
    """This package's block carry from the 11 arrays of a block carry (the
    JAX package's, or numpy) in ``BLOCK_FIELDS`` order, leading island axis
    first: integer fields int32, the others float32."""
    import torch

    if len(carry) != len(BLOCK_FIELDS):
        raise ValueError(f"a block carry has {len(BLOCK_FIELDS)} fields, got {len(carry)}")
    return tuple(
        torch.from_numpy(np.array(np.asarray(a), dtype=np.int32 if name in _BLOCK_INTS
                                  else np.float32)).to(device)
        for name, a in zip(BLOCK_FIELDS, carry)
    )


def block_carry_arrays(carry) -> tuple:
    """The block carry's fields as numpy arrays (the inverse)."""
    return tuple(np.asarray(a.cpu()) for a in carry)
