"""Host-side expression tree.

The canonical mutable tree objects live on the host (mirroring how the
reference keeps evolution in Julia while this framework keeps all *scoring* on
the device). Role-equivalent to DynamicExpressions.jl's ``Node{T}`` as consumed by
the reference (SymbolicRegression.jl/src/Mutate.jl:44-55,
SymbolicRegression.jl/src/MutationFunctions.jl), but deliberately minimal: the device
never sees these objects — populations are flattened to padded postorder
tensors (see ops/flat.py) before any math happens.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .ops.operators import OperatorSet

__all__ = ["Node", "constant", "feature", "unary", "binary"]


class Node:
    """A node in an expression tree.

    degree 0: leaf. ``is_const`` selects constant (``val``) vs feature index
    (``feat``). degree 1: unary op index ``op`` with child ``l``. degree 2:
    binary op index ``op`` with children ``l``, ``r``.
    """

    __slots__ = ("degree", "is_const", "val", "feat", "op", "l", "r")

    def __init__(self, degree, is_const=False, val=0.0, feat=0, op=0, l=None, r=None):
        self.degree = degree
        self.is_const = is_const
        self.val = val
        self.feat = feat
        self.op = op
        self.l = l
        self.r = r

    # -- construction helpers ------------------------------------------------

    def copy(self) -> "Node":
        if self.degree == 0:
            return Node(0, self.is_const, self.val, self.feat)
        if self.degree == 1:
            return Node(1, op=self.op, l=self.l.copy())
        return Node(2, op=self.op, l=self.l.copy(), r=self.r.copy())

    def copy_preserve_sharing(self, memo: dict | None = None) -> "Node":
        """Copy that keeps shared-subtree topology (GraphNode semantics —
        the reference's GraphNode copy, used when preserve_sharing is on)."""
        if memo is None:
            memo = {}
        hit = memo.get(id(self))
        if hit is not None:
            return hit
        if self.degree == 0:
            new = Node(0, self.is_const, self.val, self.feat)
        elif self.degree == 1:
            new = Node(1, op=self.op, l=self.l.copy_preserve_sharing(memo))
        else:
            new = Node(
                2,
                op=self.op,
                l=self.l.copy_preserve_sharing(memo),
                r=self.r.copy_preserve_sharing(memo),
            )
        memo[id(self)] = new
        return new

    def iter_unique(self) -> Iterator["Node"]:
        """Traversal visiting each node ONCE by identity (O(unique) even on
        shared-subtree DAGs, unlike __iter__ which expands sharing)."""
        seen: set[int] = set()
        stack = [self]
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            yield n
            if n.degree >= 1:
                stack.append(n.l)
            if n.degree == 2:
                stack.append(n.r)

    def count_unique_nodes(self) -> int:
        """Node count with shared subtrees counted ONCE (GraphNode complexity,
        reference: shared-node-aware tree_mapreduce in Complexity.jl:17-50)."""
        return sum(1 for _ in self.iter_unique())

    def contains(self, other: "Node") -> bool:
        """True iff `other` (by identity) is reachable from self."""
        return any(n is other for n in self)

    # -- traversal -----------------------------------------------------------

    def __iter__(self) -> Iterator["Node"]:
        """Preorder traversal (iterative; trees can be deep)."""
        stack = [self]
        while stack:
            n = stack.pop()
            yield n
            if n.degree == 2:
                stack.append(n.r)
            if n.degree >= 1:
                stack.append(n.l)

    def postorder(self) -> list["Node"]:
        out: list[Node] = []
        stack: list[tuple[Node, bool]] = [(self, False)]
        while stack:
            n, expanded = stack.pop()
            if expanded:
                out.append(n)
            else:
                stack.append((n, True))
                if n.degree == 2:
                    stack.append((n.r, False))
                if n.degree >= 1:
                    stack.append((n.l, False))
        return out

    def count_nodes(self) -> int:
        return sum(1 for _ in self)

    def count_depth(self) -> int:
        # Iterative to avoid Python recursion limits on degenerate trees.
        best = 1
        stack = [(self, 1)]
        while stack:
            n, d = stack.pop()
            best = max(best, d)
            if n.degree >= 1:
                stack.append((n.l, d + 1))
            if n.degree == 2:
                stack.append((n.r, d + 1))
        return best

    def count_constants(self) -> int:
        return sum(1 for n in self if n.degree == 0 and n.is_const)

    def get_constants(self) -> np.ndarray:
        """Constants in postorder — the device flattening order."""
        vals = [n.val for n in self.postorder() if n.degree == 0 and n.is_const]
        dt = np.complex128 if any(isinstance(v, complex) for v in vals) else np.float64
        return np.array(vals, dtype=dt)

    def set_constants(self, vals) -> None:
        it = iter(np.asarray(vals).tolist())
        for n in self.postorder():
            if n.degree == 0 and n.is_const:
                v = next(it)
                n.val = complex(v) if isinstance(v, complex) else float(v)

    def has_constants(self) -> bool:
        return any(n.degree == 0 and n.is_const for n in self)

    # -- evaluation on host (golden path; tests + tiny utilities) ------------

    def eval_np(self, X: np.ndarray, opset: OperatorSet) -> np.ndarray:
        """Recursive host evaluation. X is (n_features, n_rows) feature-major,
        matching the reference's FEATURE_DIM=1/BATCH_DIM=2 layout
        (SymbolicRegression.jl src/ProgramConstants.jl:3-5). Each operator's
        torch fn runs on CPU tensors in X's dtype. Used as the golden oracle
        for the batched interpreter and by ``SRRegressor.predict``."""
        from .ops.operators import apply_np

        if X.dtype.kind == "c":
            raise NotImplementedError(
                "complex evaluation is outside the port's first slice "
                "(ROADMAP.md, A, slice 2: complex dtypes)"
            )
        post = self.postorder()
        vals: dict[int, np.ndarray] = {}
        with np.errstate(all="ignore"):
            for n in post:
                if n.degree == 0:
                    v = (
                        np.full(X.shape[1], n.val, dtype=X.dtype)
                        if n.is_const
                        else X[n.feat].astype(X.dtype)
                    )
                elif n.degree == 1:
                    v = apply_np(opset.unary[n.op].fn, vals[id(n.l)]).astype(X.dtype)
                else:
                    v = apply_np(
                        opset.binary[n.op].fn, vals[id(n.l)], vals[id(n.r)]
                    ).astype(X.dtype)
                vals[id(n)] = v
        return vals[id(post[-1])]

    # -- printing ------------------------------------------------------------

    def string_tree(
        self,
        opset: OperatorSet,
        variable_names: list[str] | None = None,
        precision: int = 3,
    ) -> str:
        """Render as a human-readable equation (reference: string_tree,
        SymbolicRegression.jl/src/InterfaceDynamicExpressions.jl:138-241)."""

        def fmt_const(v) -> str:
            if isinstance(v, complex):
                return (
                    f"({v.real:.{precision}g}"
                    f"{v.imag:+.{precision}g}im)"
                )
            return f"{v:.{precision}g}"

        def render(n: Node) -> str:
            if n.degree == 0:
                if n.is_const:
                    return fmt_const(n.val)
                if variable_names is not None and n.feat < len(variable_names):
                    return variable_names[n.feat]
                return f"x{n.feat + 1}"
            if n.degree == 1:
                op = opset.unary[n.op]
                if op.name == "neg":
                    return f"-({render(n.l)})"
                return f"{op.name}({render(n.l)})"
            op = opset.binary[n.op]
            if op.display is not None:
                return f"({render(n.l)} {op.display} {render(n.r)})"
            return f"{op.name}({render(n.l)}, {render(n.r)})"

        return render(self)

    def __repr__(self):
        return f"Node<{self.count_nodes()} nodes>"


def constant(val) -> Node:
    """Constant leaf; complex values are first-class (the reference searches
    on ℂ, SymbolicRegression.jl/test/test_abstract_numbers.jl)."""
    return Node(
        0, is_const=True, val=complex(val) if isinstance(val, complex) else float(val)
    )


def feature(idx: int) -> Node:
    return Node(0, is_const=False, feat=int(idx))


def unary(op: int, child: Node) -> Node:
    return Node(1, op=int(op), l=child)


def binary(op: int, left: Node, right: Node) -> Node:
    return Node(2, op=int(op), l=left, r=right)
