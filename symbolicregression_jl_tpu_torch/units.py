"""SI unit parsing and rational-exponent dimension arithmetic.

Host-side counterpart of the reference's DynamicQuantities integration
(SymbolicRegression.jl/src/InterfaceDynamicQuantities.jl:24-66): user-supplied unit
strings (or per-feature lists) are parsed into ``Quantity`` values — a scale
factor times a ``Dimensions`` vector of rational exponents over the 7 SI base
dimensions. Small and cold: dimensional analysis runs on one sample per tree
(see dimensional_analysis.py), so plain Python fractions are plenty.
"""

from __future__ import annotations

import dataclasses
import re
from fractions import Fraction

__all__ = ["Dimensions", "Quantity", "parse_unit", "parse_units_vector"]

_BASE = ("length", "mass", "time", "current", "temperature", "luminosity", "amount")


@dataclasses.dataclass(frozen=True)
class Dimensions:
    """Rational exponents over the SI base dimensions (m kg s A K cd mol)."""

    length: Fraction = Fraction(0)
    mass: Fraction = Fraction(0)
    time: Fraction = Fraction(0)
    current: Fraction = Fraction(0)
    temperature: Fraction = Fraction(0)
    luminosity: Fraction = Fraction(0)
    amount: Fraction = Fraction(0)

    def __mul__(self, other: "Dimensions") -> "Dimensions":
        return Dimensions(
            *(getattr(self, b) + getattr(other, b) for b in _BASE)
        )

    def __truediv__(self, other: "Dimensions") -> "Dimensions":
        return Dimensions(
            *(getattr(self, b) - getattr(other, b) for b in _BASE)
        )

    def __pow__(self, p) -> "Dimensions":
        p = Fraction(p).limit_denominator(1000)
        return Dimensions(*(getattr(self, b) * p for b in _BASE))

    @property
    def dimensionless(self) -> bool:
        return all(getattr(self, b) == 0 for b in _BASE)

    def __str__(self):
        sym = dict(
            length="m", mass="kg", time="s", current="A",
            temperature="K", luminosity="cd", amount="mol",
        )
        parts = []
        for b in _BASE:
            e = getattr(self, b)
            if e != 0:
                parts.append(sym[b] if e == 1 else f"{sym[b]}^{e}")
        return " ".join(parts) if parts else "1"


DIMENSIONLESS = Dimensions()


@dataclasses.dataclass(frozen=True)
class Quantity:
    """value x dimensions (value used for unit scale factors, e.g. km = 1000 m)."""

    value: float
    dims: Dimensions

    def __mul__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.value * other.value, self.dims * other.dims)

    def __truediv__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.value / other.value, self.dims / other.dims)

    def __pow__(self, p) -> "Quantity":
        return Quantity(self.value ** float(p), self.dims**p)


def _d(**kw) -> Dimensions:
    return Dimensions(**{k: Fraction(v) for k, v in kw.items()})


# base + derived units (value = scale to SI base)
_UNITS: dict[str, Quantity] = {
    "m": Quantity(1.0, _d(length=1)),
    "g": Quantity(1e-3, _d(mass=1)),
    "s": Quantity(1.0, _d(time=1)),
    "A": Quantity(1.0, _d(current=1)),
    "K": Quantity(1.0, _d(temperature=1)),
    "cd": Quantity(1.0, _d(luminosity=1)),
    "mol": Quantity(1.0, _d(amount=1)),
    # derived
    "Hz": Quantity(1.0, _d(time=-1)),
    "N": Quantity(1.0, _d(mass=1, length=1, time=-2)),
    "Pa": Quantity(1.0, _d(mass=1, length=-1, time=-2)),
    "J": Quantity(1.0, _d(mass=1, length=2, time=-2)),
    "W": Quantity(1.0, _d(mass=1, length=2, time=-3)),
    "C": Quantity(1.0, _d(current=1, time=1)),
    "V": Quantity(1.0, _d(mass=1, length=2, time=-3, current=-1)),
    "F": Quantity(1.0, _d(mass=-1, length=-2, time=4, current=2)),
    "Ohm": Quantity(1.0, _d(mass=1, length=2, time=-3, current=-2)),
    "T": Quantity(1.0, _d(mass=1, time=-2, current=-1)),
    "Wb": Quantity(1.0, _d(mass=1, length=2, time=-2, current=-1)),
    "L": Quantity(1e-3, _d(length=3)),
    "bar": Quantity(1e5, _d(mass=1, length=-1, time=-2)),
    "eV": Quantity(1.602176634e-19, _d(mass=1, length=2, time=-2)),
    "h": Quantity(3600.0, _d(time=1)),
    "min": Quantity(60.0, _d(time=1)),
    "day": Quantity(86400.0, _d(time=1)),
}

_PREFIXES = {
    "Q": 1e30, "R": 1e27, "Y": 1e24, "Z": 1e21, "E": 1e18, "P": 1e15,
    "T": 1e12, "G": 1e9, "M": 1e6, "k": 1e3, "h": 1e2, "da": 1e1,
    "d": 1e-1, "c": 1e-2, "m": 1e-3, "u": 1e-6, "µ": 1e-6, "n": 1e-9,
    "p": 1e-12, "f": 1e-15, "a": 1e-18, "z": 1e-21, "y": 1e-24,
}

_TOKEN = re.compile(
    r"\s*([*/])?\s*([A-Za-zµΩ]+)\s*(?:\^\s*(-?\d+(?:\s*//?\s*\d+)?(?:\.\d+)?))?"
)


def _lookup(sym: str) -> Quantity:
    if sym in ("Ω",):
        sym = "Ohm"
    if sym in _UNITS:
        return _UNITS[sym]
    # prefixed form: longest-prefix match with a known remainder
    for plen in (2, 1):
        if len(sym) > plen and sym[:plen] in _PREFIXES and sym[plen:] in _UNITS:
            base = _UNITS[sym[plen:]]
            return Quantity(base.value * _PREFIXES[sym[:plen]], base.dims)
    raise ValueError(f"unknown unit {sym!r}")


def _parse_exponent(exp: str) -> Fraction:
    exp = exp.replace(" ", "").replace("//", "/")
    if "." in exp:
        return Fraction(exp).limit_denominator(1000)
    return Fraction(exp)


class _Parser:
    """Recursive-descent parser for unit expressions with grouping:
    expr := factor ((* | /) factor)* ; factor := (unit | '(' expr ')')['^'exp]."""

    def __init__(self, s: str, spec: str):
        self.s = s
        self.spec = spec
        self.pos = 0

    def _ws(self):
        while self.pos < len(self.s) and self.s[self.pos].isspace():
            self.pos += 1

    def peek(self) -> str:
        self._ws()
        return self.s[self.pos] if self.pos < len(self.s) else ""

    def expr(self) -> Quantity:
        out = self.factor()
        while True:
            ch = self.peek()
            if ch == "*":
                self.pos += 1
                out = out * self.factor()
            elif ch == "/":
                self.pos += 1
                out = out / self.factor()
            else:
                return out

    def factor(self) -> Quantity:
        self._ws()
        if self.peek() == "(":
            self.pos += 1
            q = self.expr()
            if self.peek() != ")":
                raise ValueError(f"unbalanced parentheses in unit {self.spec!r}")
            self.pos += 1
        else:
            m = re.compile(r"[A-Za-zµΩ]+").match(self.s, self.pos)
            if m is None:
                raise ValueError(
                    f"cannot parse unit {self.spec!r} at {self.s[self.pos:]!r}"
                )
            q = _lookup(m.group(0))
            self.pos = m.end()
        if self.peek() == "^":
            self.pos += 1
            self._ws()
            if self.peek() == "(":
                self.pos += 1
                m = re.compile(r"[^)]*").match(self.s, self.pos)
                exp = m.group(0)
                self.pos = m.end()
                if self.peek() != ")":
                    raise ValueError(f"unbalanced exponent parens in {self.spec!r}")
                self.pos += 1
            else:
                m = re.compile(r"-?\d+(?:\s*//?\s*\d+)?(?:\.\d+)?").match(
                    self.s, self.pos
                )
                if m is None:
                    raise ValueError(f"bad exponent in unit {self.spec!r}")
                exp = m.group(0)
                self.pos = m.end()
            q = q ** _parse_exponent(exp)
        return q


def parse_unit(spec) -> Quantity:
    """Parse a unit spec: Quantity | Dimensions | number | string like
    'km/s^2', 'kg * m^2', 'J/(mol*K)', 'm^(1//2)' (Julia-style rational
    exponents and parenthesized groups supported)."""
    if spec is None or (isinstance(spec, (int, float)) and spec == 1):
        return Quantity(1.0, DIMENSIONLESS)
    if isinstance(spec, Quantity):
        return spec
    if isinstance(spec, Dimensions):
        return Quantity(1.0, spec)
    if isinstance(spec, (int, float)):
        return Quantity(float(spec), DIMENSIONLESS)
    if not isinstance(spec, str):
        raise TypeError(f"cannot parse unit spec {spec!r}")
    s = spec.strip()
    if s in ("", "1", "one"):
        return Quantity(1.0, DIMENSIONLESS)
    p = _Parser(s, spec)
    out = p.expr()
    p._ws()
    if p.pos != len(s):
        raise ValueError(f"trailing junk in unit {spec!r}: {s[p.pos:]!r}")
    return out


def parse_units_vector(spec, n: int) -> list[Quantity] | None:
    """Per-feature unit vector from a scalar spec or a list of specs
    (reference: get_units, SymbolicRegression.jl/src/InterfaceDynamicQuantities.jl:24-66)."""
    if spec is None:
        return None
    if isinstance(spec, (list, tuple)):
        if len(spec) != n:
            raise ValueError(f"expected {n} unit entries, got {len(spec)}")
        return [parse_unit(u) for u in spec]
    return [parse_unit(spec)] * n
