"""Mutation proposal + Metropolis accept/reject.

Reference: next_generation (SymbolicRegression.jl/src/Mutate.jl:80-358). This
restructuring splits it in two phases so that scoring can be batched across
many events (and across islands) into one device program:

  1. ``propose_mutation`` — condition weights, sample a mutation kind, apply
     it with <=10 constraint-checked retries (host-side tree surgery).
  2. ``accept_mutation`` — given the batch-computed score, apply the
     simulated-annealing x complexity-frequency Metropolis rule
     (SymbolicRegression.jl/src/Mutate.jl:276-341).

Divergence from the reference (documented): within one evolve pass, proposals
are drawn from the same population snapshot instead of strictly sequentially;
with the default pop_size/tournament_n ratio this is ~3 concurrent events.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..complexity import compute_complexity
from ..constraints import check_constraints
from ..tree import Node
from . import mutation_functions as mf
from .adaptive_parsimony import RunningSearchStatistics
from .pop_member import PopMember
from .simplify import combine_operators, simplify_tree

__all__ = ["Proposal", "propose_mutation", "accept_mutation", "propose_crossover", "accept_crossover"]


def _copy_tree(tree: Node, options) -> Node:
    """Copy that preserves DAG sharing in graph_nodes mode (Julia's GraphNode
    copy preserves sharing; plain copy() would silently expand it and inflate
    complexity past constraints)."""
    return tree.copy_preserve_sharing() if options.graph_nodes else tree.copy()


@dataclasses.dataclass
class Proposal:
    """One evolution event awaiting batch scoring."""

    kind: str
    parent: PopMember
    tree: Node | None  # candidate (None when mutation failed entirely)
    needs_score: bool
    failed: bool = False  # constraint retries exhausted
    # filled by the scorer stage:
    score: float = np.nan
    loss: float = np.nan


def condition_mutation_weights(
    member: PopMember, options, curmaxsize: int
) -> np.ndarray:
    """Zero out mutations that are illegal in context (reference:
    condition_mutation_weights!, SymbolicRegression.jl/src/Mutate.jl:34-76)."""
    w = options.mutation_weights.as_vector().copy()
    names = options.mutation_weights.NAMES
    i = {n: k for k, n in enumerate(names)}
    tree = member.tree

    if not options.graph_nodes:
        # plain Node trees don't share subexpressions
        w[i["form_connection"]] = 0.0
        w[i["break_connection"]] = 0.0

    if tree.degree == 0:
        w[i["mutate_operator"]] = 0.0
        w[i["swap_operands"]] = 0.0
        w[i["delete_node"]] = 0.0
        w[i["simplify"]] = 0.0
        if not tree.is_const:
            w[i["optimize"]] = 0.0
            w[i["mutate_constant"]] = 0.0
        return w

    if not any(n.degree == 2 for n in tree):
        w[i["swap_operands"]] = 0.0

    n_constants = tree.count_constants()
    w[i["mutate_constant"]] *= min(8, n_constants) / 8.0

    if member.get_complexity(options) >= curmaxsize:
        w[i["add_node"]] = 0.0
        w[i["insert_node"]] = 0.0

    if not options.should_simplify:
        w[i["simplify"]] = 0.0

    if options.operators.n_unary == 0 and options.operators.n_binary == 0:
        w[:] = 0.0
    return w


def _apply_mutation(
    kind: str,
    tree: Node,
    temperature: float,
    options,
    nfeatures: int,
    rng: np.random.Generator,
) -> Node:
    ops = options.operators
    if kind == "mutate_constant":
        return mf.mutate_constant(tree, temperature, options, rng)
    if kind == "mutate_operator":
        return mf.mutate_operator(tree, ops, rng)
    if kind == "swap_operands":
        return mf.swap_operands(tree, rng)
    if kind == "add_node":
        return mf.append_random_op(tree, ops, nfeatures, rng, dtype=options.dtype)
    if kind == "insert_node":
        return mf.insert_random_op(tree, ops, nfeatures, rng, dtype=options.dtype)
    if kind == "delete_node":
        return mf.delete_random_op(tree, ops, nfeatures, rng, dtype=options.dtype)
    if kind == "simplify":
        tree = simplify_tree(tree, options)
        return combine_operators(tree, options)
    if kind == "randomize":
        tree_size = max(tree.count_nodes(), 3)
        return mf.gen_random_tree_fixed_size(
            int(rng.integers(1, tree_size + 1)), ops, nfeatures, rng,
            dtype=options.dtype,
        )
    if kind == "form_connection":
        return mf.form_random_connection(tree, rng)
    if kind == "break_connection":
        return mf.break_random_connection(tree, rng)
    raise ValueError(f"unhandled mutation kind {kind}")


def propose_mutation(
    member: PopMember,
    temperature: float,
    curmaxsize: int,
    options,
    nfeatures: int,
    rng: np.random.Generator,
) -> Proposal:
    weights = condition_mutation_weights(member, options, curmaxsize)
    kind = options.mutation_weights.sample(rng, weights)

    if kind == "do_nothing":
        return Proposal(kind, member, _copy_tree(member.tree, options), needs_score=False)
    if kind == "optimize":
        # routed to the batched constant optimizer by the caller
        return Proposal(kind, member, _copy_tree(member.tree, options), needs_score=True)

    # `simplify` preserves semantics and always passes constraints the parent
    # passed; others need the retry loop (reference: <=10 attempts,
    # SymbolicRegression.jl/src/Mutate.jl:121-244).
    attempts = 1 if kind == "simplify" else 10
    for _ in range(attempts):
        tree = _apply_mutation(
            kind, _copy_tree(member.tree, options), temperature, options,
            nfeatures, rng,
        )
        if check_constraints(tree, options, curmaxsize):
            return Proposal(kind, member, tree, needs_score=True)
    # all retries failed
    return Proposal(kind, member, None, needs_score=False, failed=True)


def accept_mutation(
    prop: Proposal,
    temperature: float,
    stats: RunningSearchStatistics,
    options,
    rng: np.random.Generator,
) -> tuple[PopMember, bool]:
    """Metropolis rule on the batch-computed score. Returns (member, accepted);
    on rejection the member is a copy of the parent (lineage preserved),
    matching the reference's return shape."""
    parent = prop.parent

    def rejected() -> tuple[PopMember, bool]:
        m = PopMember(
            _copy_tree(parent.tree, options),
            parent.score,
            parent.loss,
            complexity=parent.get_complexity(options),
            parent=parent.ref,
        )
        return m, False

    if prop.failed or prop.tree is None:
        return rejected()

    if prop.kind == "do_nothing":
        m = PopMember(
            prop.tree,
            parent.score,
            parent.loss,
            complexity=parent.get_complexity(options),
            parent=parent.ref,
        )
        return m, True

    if np.isnan(prop.score):
        return rejected()

    prob_change = 1.0
    if options.annealing:
        delta = prop.score - parent.score
        # temperature reaches exactly 0.0 on the final annealed cycle; IEEE
        # division gives +-inf and exp() then 0 or inf, matching the Julia
        # reference's float semantics instead of raising ZeroDivisionError.
        # (0/0 -> NaN -> "NaN < rand()" is False -> accept, same as Julia)
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            prob_change *= float(
                np.exp(-np.float64(delta) / (np.float64(temperature) * options.alpha))
            )
    if options.use_frequency:
        old_size = parent.get_complexity(options)
        new_size = compute_complexity(prop.tree, options)
        old_freq = stats.frequency_of(old_size) or 1e-6
        new_freq = stats.frequency_of(new_size) or 1e-6
        if not (0 < old_size <= options.maxsize):
            old_freq = 1e-6
        if not (0 < new_size <= options.maxsize):
            new_freq = 1e-6
        prob_change *= old_freq / new_freq

    if prob_change < rng.random():
        return rejected()

    m = PopMember(
        prop.tree,
        prop.score,
        prop.loss,
        parent=parent.ref,
    )
    m.get_complexity(options)
    return m, True


# -- crossover ---------------------------------------------------------------


@dataclasses.dataclass
class CrossoverProposal:
    parent1: PopMember
    parent2: PopMember
    child1: Node | None
    child2: Node | None
    failed: bool = False
    score1: float = np.nan
    loss1: float = np.nan
    score2: float = np.nan
    loss2: float = np.nan


def propose_crossover(
    m1: PopMember,
    m2: PopMember,
    curmaxsize: int,
    options,
    rng: np.random.Generator,
) -> CrossoverProposal:
    """Breed until both children pass constraints, <=10 tries
    (reference: crossover_generation, SymbolicRegression.jl/src/Mutate.jl:361-429)."""
    for _ in range(10):
        c1, c2 = mf.crossover_trees(
            m1.tree, m2.tree, rng, preserve_sharing=options.graph_nodes
        )
        if check_constraints(c1, options, curmaxsize) and check_constraints(
            c2, options, curmaxsize
        ):
            return CrossoverProposal(m1, m2, c1, c2)
    return CrossoverProposal(m1, m2, None, None, failed=True)


def accept_crossover(
    prop: CrossoverProposal, options
) -> tuple[PopMember, PopMember, bool]:
    """Crossover children are always accepted once scored (no annealing rule in
    the reference either); NaN scores fall back to parents."""
    if prop.failed or np.isnan(prop.score1) or np.isnan(prop.score2):
        p1, p2 = prop.parent1, prop.parent2
        c1 = PopMember(
            _copy_tree(p1.tree, options), p1.score, p1.loss,
            complexity=p1.get_complexity(options), parent=p1.ref,
        )
        c2 = PopMember(
            _copy_tree(p2.tree, options), p2.score, p2.loss,
            complexity=p2.get_complexity(options), parent=p2.ref,
        )
        return c1, c2, False
    c1 = PopMember(prop.child1, prop.score1, prop.loss1, parent=prop.parent1.ref)
    c2 = PopMember(prop.child2, prop.score2, prop.loss2, parent=prop.parent2.ref)
    c1.get_complexity(options)
    c2.get_complexity(options)
    return c1, c2, True
