"""Population member: tree + score + loss + lineage.

Reference: PopMember (SymbolicRegression.jl/src/PopMember.jl:12-37): tree, score
(parsimony-adjusted), raw loss, birth order, cached complexity (invalidated on
tree replacement), and ref/parent lineage ids for the recorder.
"""

from __future__ import annotations

import threading

from ..complexity import compute_complexity
from ..tree import Node

__all__ = [
    "PopMember",
    "generate_reference",
    "counter_state",
    "restore_counter_state",
]


class _Counter:
    """Monotone id source. Thread-safe (the async island scheduler creates
    members from worker threads) and — unlike itertools.count — queryable and
    settable, which SearchCheckpointer needs: birth order drives
    ``Population.oldest_index`` replacement, so a bit-exact resume must
    restore the counters along with the populations."""

    __slots__ = ("_value", "_lock")

    def __init__(self, start: int = 1):
        self._value = start
        self._lock = threading.Lock()

    def __next__(self) -> int:
        with self._lock:
            v = self._value
            self._value = v + 1
        return v

    def peek(self) -> int:
        return self._value

    def set(self, value: int) -> None:
        with self._lock:
            self._value = int(value)


_ref_counter = _Counter()
_birth_counter = _Counter()


def generate_reference() -> int:
    return next(_ref_counter)


def next_birth() -> int:
    """Deterministic monotone birth counter. The reference uses wall-clock
    time in non-deterministic mode (SymbolicRegression.jl/src/Utils.jl:7-19); a
    counter gives identical ordering semantics and is always deterministic."""
    return next(_birth_counter)


def counter_state() -> tuple[int, int]:
    """(next ref, next birth) — captured by full-state checkpoints."""
    return (_ref_counter.peek(), _birth_counter.peek())


def restore_counter_state(state) -> None:
    """Restore the counters from ``counter_state()`` (bit-exact resume)."""
    ref, birth = state
    _ref_counter.set(ref)
    _birth_counter.set(birth)


class PopMember:
    __slots__ = ("tree", "score", "loss", "birth", "complexity", "ref", "parent")

    def __init__(
        self,
        tree: Node,
        score: float,
        loss: float,
        complexity: int | None = None,
        ref: int | None = None,
        parent: int = -1,
    ):
        self.tree = tree
        self.score = float(score)
        self.loss = float(loss)
        self.birth = next_birth()
        self.complexity = complexity
        self.ref = generate_reference() if ref is None else ref
        self.parent = parent

    def copy(self) -> "PopMember":
        new = PopMember.__new__(PopMember)
        new.tree = self.tree.copy()
        new.score = self.score
        new.loss = self.loss
        new.birth = self.birth
        new.complexity = self.complexity
        new.ref = self.ref
        new.parent = self.parent
        return new

    def set_tree(self, tree: Node) -> None:
        """Replace the tree, invalidating the cached complexity (the reference
        enforces this with a setproperty! guard, SymbolicRegression.jl/src/PopMember.jl:23-35)."""
        self.tree = tree
        self.complexity = None

    def get_complexity(self, options) -> int:
        if self.complexity is None:
            self.complexity = compute_complexity(self.tree, options)
        return self.complexity

    def reset_birth(self) -> None:
        self.birth = next_birth()

    def __repr__(self):
        return (
            f"PopMember(loss={self.loss:.4g}, score={self.score:.4g}, "
            f"complexity={self.complexity}, birth={self.birth})"
        )
