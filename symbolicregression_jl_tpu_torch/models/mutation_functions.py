"""Tree-rewrite primitives (host side).

Role-equivalent to the reference's MutationFunctions
(SymbolicRegression.jl/src/MutationFunctions.jl:34-303). All functions are
RNG-parameterized (numpy Generator) and operate in place on trees the caller
has already copied — mirroring the reference's copy-then-mutate discipline in
next_generation. Evolution stays on the host by design (SURVEY.md §7.1):
these are cheap, irregular pointer edits; only *scoring* goes to the device.
"""

from __future__ import annotations

import numpy as np

from ..tree import Node, constant, feature
from ..ops.operators import OperatorSet

__all__ = [
    "swap_operands",
    "mutate_operator",
    "mutate_constant",
    "append_random_op",
    "insert_random_op",
    "prepend_random_op",
    "make_random_leaf",
    "delete_random_op",
    "gen_random_tree",
    "gen_random_tree_fixed_size",
    "crossover_trees",
    "random_node",
]


def _nodes(tree: Node, pred=None) -> list[Node]:
    out = [n for n in tree]
    if pred is not None:
        out = [n for n in out if pred(n)]
    return out


def random_node(tree: Node, rng: np.random.Generator, pred=None) -> Node | None:
    cands = _nodes(tree, pred)
    if not cands:
        return None
    return cands[rng.integers(len(cands))]


def _set_node(dst: Node, src: Node) -> None:
    dst.degree = src.degree
    dst.is_const = src.is_const
    dst.val = src.val
    dst.feat = src.feat
    dst.op = src.op
    dst.l = src.l
    dst.r = src.r


def swap_operands(tree: Node, rng: np.random.Generator) -> Node:
    node = random_node(tree, rng, lambda t: t.degree == 2)
    if node is None:
        return tree
    node.l, node.r = node.r, node.l
    return tree


def mutate_operator(tree: Node, opset: OperatorSet, rng: np.random.Generator) -> Node:
    node = random_node(tree, rng, lambda t: t.degree != 0)
    if node is None:
        return tree
    if node.degree == 1:
        node.op = int(rng.integers(opset.n_unary))
    else:
        node.op = int(rng.integers(opset.n_binary))
    return tree


def mutate_constant(
    tree: Node, temperature: float, options, rng: np.random.Generator
) -> Node:
    """Multiply or divide a random constant by `maxChange^U(0,1)`, and negate
    with probability `probability_negate_constant`.

    Reference: SymbolicRegression.jl/src/MutationFunctions.jl:60-89. NOTE: v0.24.5
    negates when `rand() > p_negate` (i.e. 99% of the time at the default
    0.01) — an upstream sign bug fixed in later releases; we implement the
    intended semantics (negate with probability p_negate).
    """
    node = random_node(tree, rng, lambda t: t.degree == 0 and t.is_const)
    if node is None:
        return tree
    max_change = options.perturbation_factor * temperature + 1.0 + 0.1
    if isinstance(node.val, complex) or np.dtype(options.dtype).kind == "c":
        # complex exponent rotates the phase as well as scaling the
        # magnitude — the reference's `maxChange^rand(rng, T)` draws a
        # complex uniform for complex T (MutationFunctions.jl:70), and
        # without rotation a constant's phase could only ever be negated
        factor = complex(max_change ** complex(rng.random(), rng.random()))
    else:
        factor = float(max_change ** rng.random())
    if rng.random() < 0.5:
        node.val *= factor
    else:
        node.val /= factor
    if rng.random() < options.probability_negate_constant:
        node.val *= -1.0
    return tree


def make_random_leaf(
    nfeatures: int, rng: np.random.Generator, dtype=None
) -> Node:
    """50/50 constant (randn) or random feature
    (reference: SymbolicRegression.jl/src/MutationFunctions.jl:167-175). For a
    complex compute dtype the constant is drawn on the complex plane —
    phase diversity has to enter through leaves, exactly as the reference's
    `randn(T)` draws complex normals."""
    if rng.random() < 0.5:
        if dtype is not None and np.dtype(dtype).kind == "c":
            return constant(
                complex(rng.standard_normal(), rng.standard_normal())
            )
        return constant(float(rng.standard_normal()))
    return feature(int(rng.integers(nfeatures)))


def _random_new_op_node(
    opset: OperatorSet,
    nfeatures: int,
    rng: np.random.Generator,
    child: Node,
    make_bin: bool | None = None,
    dtype=None,
) -> Node:
    if make_bin is None:
        total = opset.n_binary + opset.n_unary
        make_bin = rng.random() < opset.n_binary / total
    if make_bin:
        new = Node(
            2,
            op=int(rng.integers(opset.n_binary)),
            l=child,
            r=make_random_leaf(nfeatures, rng, dtype),
        )
    else:
        new = Node(1, op=int(rng.integers(opset.n_unary)), l=child)
    return new


def append_random_op(
    tree: Node,
    opset: OperatorSet,
    nfeatures: int,
    rng: np.random.Generator,
    make_bin: bool | None = None,
    dtype=None,
) -> Node:
    """Replace a random leaf by a random operator over fresh random leaves
    (reference: SymbolicRegression.jl/src/MutationFunctions.jl:92-121)."""
    node = random_node(tree, rng, lambda t: t.degree == 0)
    if make_bin is None:
        total = opset.n_binary + opset.n_unary
        make_bin = rng.random() < opset.n_binary / total
    if make_bin:
        new = Node(
            2,
            op=int(rng.integers(opset.n_binary)),
            l=make_random_leaf(nfeatures, rng, dtype),
            r=make_random_leaf(nfeatures, rng, dtype),
        )
    else:
        new = Node(
            1, op=int(rng.integers(opset.n_unary)),
            l=make_random_leaf(nfeatures, rng, dtype),
        )
    _set_node(node, new)
    return tree


def insert_random_op(
    tree: Node, opset: OperatorSet, nfeatures: int, rng: np.random.Generator,
    dtype=None,
) -> Node:
    """Wrap a random node in a new random operator
    (reference: SymbolicRegression.jl/src/MutationFunctions.jl:124-143)."""
    node = random_node(tree, rng)
    new = _random_new_op_node(opset, nfeatures, rng, node.copy(), dtype=dtype)
    _set_node(node, new)
    return tree


def prepend_random_op(
    tree: Node, opset: OperatorSet, nfeatures: int, rng: np.random.Generator,
    dtype=None,
) -> Node:
    """Wrap the root in a new random operator
    (reference: SymbolicRegression.jl/src/MutationFunctions.jl:146-165)."""
    new = _random_new_op_node(opset, nfeatures, rng, tree.copy(), dtype=dtype)
    _set_node(tree, new)
    return tree


def _random_node_and_parent(tree: Node, rng: np.random.Generator):
    """(node, parent, side); side 'n' when node is the root
    (reference: SymbolicRegression.jl/src/MutationFunctions.jl:178-188)."""
    if tree.degree == 0:
        return tree, tree, "n"
    parent = random_node(tree, rng, lambda t: t.degree != 0)
    if parent.degree == 1 or rng.random() < 0.5:
        return parent.l, parent, "l"
    return parent.r, parent, "r"


def delete_random_op(
    tree: Node, opset: OperatorSet, nfeatures: int, rng: np.random.Generator,
    dtype=None,
) -> Node:
    """Splice a random node out of the tree
    (reference: SymbolicRegression.jl/src/MutationFunctions.jl:191-234)."""
    node, parent, side = _random_node_and_parent(tree, rng)
    if node.degree == 0:
        _set_node(node, make_random_leaf(nfeatures, rng, dtype))
        return tree
    keep = node.l if (node.degree == 1 or rng.random() < 0.5) else node.r
    if side == "n":
        return keep
    if side == "l":
        parent.l = keep
    else:
        parent.r = keep
    return tree


def gen_random_tree(
    length: int, opset: OperatorSet, nfeatures: int, rng: np.random.Generator,
    dtype=None,
) -> Node:
    """Grow by repeatedly appending random ops — may exceed `length` nodes,
    like the reference (SymbolicRegression.jl/src/MutationFunctions.jl:237-248)."""
    tree = constant(1.0)
    for _ in range(length):
        tree = append_random_op(tree, opset, nfeatures, rng, dtype=dtype)
    return tree


def gen_random_tree_fixed_size(
    node_count: int, opset: OperatorSet, nfeatures: int, rng: np.random.Generator,
    dtype=None,
) -> Node:
    """Grow to exactly node_count nodes when possible
    (reference: SymbolicRegression.jl/src/MutationFunctions.jl:250-268)."""
    tree = make_random_leaf(nfeatures, rng, dtype)
    cur = tree.count_nodes()
    while cur < node_count:
        if cur == node_count - 1:  # only a unary op fits
            if opset.n_unary == 0:
                break
            tree = append_random_op(
                tree, opset, nfeatures, rng, make_bin=False, dtype=dtype
            )
        else:
            tree = append_random_op(tree, opset, nfeatures, rng, dtype=dtype)
        cur = tree.count_nodes()
    return tree


def crossover_trees(
    a: Node, b: Node, rng: np.random.Generator, preserve_sharing: bool = False
) -> tuple[Node, Node]:
    """Swap random subtrees between copies of a and b
    (reference: SymbolicRegression.jl/src/MutationFunctions.jl:271-303)."""
    if preserve_sharing:
        a, b = a.copy_preserve_sharing(), b.copy_preserve_sharing()
    else:
        a, b = a.copy(), b.copy()
    na, pa, sa = _random_node_and_parent(a, rng)
    nb, pb, sb = _random_node_and_parent(b, rng)
    if preserve_sharing:
        na_copy = na.copy_preserve_sharing()
        nb_copy = nb.copy_preserve_sharing()
    else:
        na_copy = na.copy()
        nb_copy = nb.copy()
    if sa == "n":
        a = nb_copy
    elif sa == "l":
        pa.l = nb_copy
    else:
        pa.r = nb_copy
    if sb == "n":
        b = na_copy
    elif sb == "l":
        pb.l = na_copy
    else:
        pb.r = na_copy
    return a, b


# -- GraphNode-only mutations (shared-subtree DAGs) ---------------------------


def form_random_connection(tree: Node, rng: np.random.Generator) -> Node:
    """Make one node's child POINT at another subtree (shared reference),
    turning the tree into a DAG. No-op for tiny trees or when every candidate
    pair would form a loop (reference: form_random_connection!,
    SymbolicRegression.jl/src/MutationFunctions.jl:318-336)."""
    if tree.count_nodes() < 5:
        return tree
    parents = _nodes(tree, lambda t: t.degree >= 1)
    others = _nodes(tree)
    for _ in range(10):
        parent = parents[rng.integers(len(parents))]
        new_child = others[rng.integers(len(others))]
        # loop check: parent must not be reachable from new_child
        if new_child.contains(parent):
            continue
        if parent.degree == 1 or rng.random() < 0.5:
            parent.l = new_child
        else:
            parent.r = new_child
        return tree
    return tree


def break_random_connection(tree: Node, rng: np.random.Generator) -> Node:
    """Unshare one child by copying it (reference: break_random_connection!,
    SymbolicRegression.jl/src/MutationFunctions.jl:337-346)."""
    if tree.degree == 0:
        return tree
    parent = random_node(tree, rng, lambda t: t.degree >= 1)
    if parent is None:
        return tree
    if parent.degree == 1 or rng.random() < 0.5:
        parent.l = parent.l.copy_preserve_sharing()
    else:
        parent.r = parent.r.copy_preserve_sharing()
    return tree
