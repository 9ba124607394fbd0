"""Complexity-indexed hall of fame + Pareto frontier.

Reference: SymbolicRegression.jl/src/HallOfFame.jl — ``members[c]`` holds the best
member seen at complexity ``c``; the search output is the Pareto frontier
(member dominates iff its loss beats every lower-complexity member), and the
reported "score" along the frontier is ``-Δlog(loss)/Δcomplexity``.
"""

from __future__ import annotations

import math

import numpy as np

from .pop_member import PopMember

__all__ = ["HallOfFame"]


class HallOfFame:
    def __init__(self, maxsize: int):
        # capacity maxsize + 2, matching members[1:maxsize+MAX_DEGREE]
        # (SymbolicRegression.jl/src/HallOfFame.jl:45-63)
        self.capacity = maxsize + 2
        self.members: list[PopMember | None] = [None] * self.capacity
        self.exists = [False] * self.capacity

    def copy(self) -> "HallOfFame":
        new = HallOfFame.__new__(HallOfFame)
        new.capacity = self.capacity
        new.members = [m.copy() if m is not None else None for m in self.members]
        new.exists = list(self.exists)
        return new

    def update(self, member: PopMember, options) -> bool:
        """Insert if best-at-its-complexity (reference: update_hall_of_fame!,
        SymbolicRegression.jl/src/SearchUtils.jl:513-529). Returns True if inserted.

        Non-finite losses never enter: a NaN occupant would permanently block
        its slot (`finite < nan` is False) and inf members would pollute the
        returned frontier and warm-start state."""
        if not np.isfinite(member.loss):
            return False
        size = member.get_complexity(options)
        if not (0 < size <= self.capacity):
            return False
        i = size - 1
        if not self.exists[i] or member.loss < self.members[i].loss:
            self.members[i] = member.copy()
            self.exists[i] = True
            return True
        return False

    def update_many(self, members, options) -> int:
        return sum(self.update(m, options) for m in members)

    def merge(self, other: "HallOfFame", options) -> None:
        for m, e in zip(other.members, other.exists):
            if e:
                self.update(m, options)

    def pareto_frontier(self) -> list[PopMember]:
        """Members whose loss beats every smaller-complexity member
        (reference: calculate_pareto_frontier, SymbolicRegression.jl/src/HallOfFame.jl:74-103)."""
        out: list[PopMember] = []
        best = math.inf
        for m, e in zip(self.members, self.exists):
            if not e:
                continue
            if m.loss < best:
                out.append(m)
                best = m.loss
        return out

    def format(self, options, variable_names=None, precision=None) -> list[dict]:
        """Frontier rows with the -dlog(loss)/dcomplexity score
        (reference: format_hall_of_fame, SymbolicRegression.jl/src/HallOfFame.jl:155-198).
        ``precision``: constant digits (default options.print_precision; the
        CSV writer passes 17 so checkpoints round-trip float64 exactly)."""
        frontier = self.pareto_frontier()
        rows = []
        prev_loss, prev_c = None, None
        ZERO = 1e-38
        for m in frontier:
            c = m.complexity
            loss = m.loss
            if prev_loss is None:
                score = 0.0
            else:
                dc = c - prev_c
                if dc <= 0 or not (math.isfinite(loss) and loss >= 0):
                    score = 0.0
                else:
                    score = -(
                        math.log(max(loss, ZERO)) - math.log(max(prev_loss, ZERO))
                    ) / dc
            rows.append(
                {
                    "complexity": c,
                    "loss": loss,
                    "score": max(score, 0.0),
                    "equation": m.tree.string_tree(
                        options.operators,
                        variable_names,
                        precision=(
                            precision
                            if precision is not None
                            else options.print_precision
                        ),
                    ),
                    "member": m,
                }
            )
            prev_loss, prev_c = loss, c
        return rows

    def render(self, options, variable_names=None, y_variable_name=None) -> str:
        """Terminal table (reference: string_dominating_pareto_curve,
        SymbolicRegression.jl/src/HallOfFame.jl:105-153). Equations are prefixed
        ``<y_variable_name> = `` like the reference's live Pareto table
        (SymbolicRegression.jl/src/HallOfFame.jl:128-134)."""
        rows = self.format(options, variable_names)
        prefix = f"{y_variable_name} = " if y_variable_name else ""
        lines = [
            "-" * 72,
            f"{'Complexity':<12}{'Loss':<14}{'Score':<14}Equation",
        ]
        for r in rows:
            lines.append(
                f"{r['complexity']:<12}{r['loss']:<14.6g}{r['score']:<14.6g}"
                f"{prefix}{r['equation']}"
            )
        lines.append("-" * 72)
        return "\n".join(lines)

    def best(self) -> PopMember | None:
        frontier = self.pareto_frontier()
        if not frontier:
            return None
        return min(frontier, key=lambda m: m.loss)
