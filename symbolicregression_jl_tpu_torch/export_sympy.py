"""CAS export/import: expression trees <-> sympy.

Counterpart of the reference's SymbolicUtils extension
(SymbolicRegression.jl/ext/SymbolicRegressionSymbolicUtilsExt.jl:14-53:
node_to_symbolic / symbolic_to_node / convert glue). Safe operators un-alias
to their plain mathematical forms on export (the reference does the same for
printing/export, SymbolicRegression.jl/src/InterfaceDynamicExpressions.jl:283-305).

sympy is an optional integration: import errors surface only when these
functions are called.
"""

from __future__ import annotations

from .tree import Node, binary, constant, feature, unary

__all__ = ["node_to_sympy", "sympy_to_node"]


def _sym():
    try:
        import sympy
    except ImportError as e:  # pragma: no cover
        raise ImportError("sympy is required for CAS export") from e
    return sympy


_UNARY_TO_SYMPY = {
    "cos": "cos", "sin": "sin", "tan": "tan", "exp": "exp", "log": "log",
    "log2": None, "log10": None, "log1p": None, "sqrt": "sqrt", "abs": "Abs",
    "sinh": "sinh", "cosh": "cosh", "tanh": "tanh", "asin": "asin",
    "acos": "acos", "atan": "atan", "asinh": "asinh", "acosh": "acosh",
    "atanh": "atanh", "erf": "erf", "erfc": "erfc", "gamma": "gamma",
    "floor": "floor", "ceil": "ceiling", "sign": "sign",
}


def node_to_sympy(node: Node, opset, variable_names: list[str] | None = None):
    """Convert a tree to a sympy expression. Variables become symbols named
    after ``variable_names`` (default x1, x2, ...)."""
    sympy = _sym()

    def var(i: int):
        name = (
            variable_names[i]
            if variable_names is not None and i < len(variable_names)
            else f"x{i + 1}"
        )
        return sympy.Symbol(name)

    def rec(n: Node):
        if n.degree == 0:
            return sympy.Float(n.val) if n.is_const else var(n.feat)
        if n.degree == 1:
            name = opset.unary[n.op].name
            c = rec(n.l)
            if name == "neg":
                return -c
            if name == "square":
                return c**2
            if name == "cube":
                return c**3
            if name == "log2":
                return sympy.log(c, 2)
            if name == "log10":
                return sympy.log(c, 10)
            if name == "log1p":
                return sympy.log(1 + c)
            if name == "relu":
                return sympy.Max(c, 0)
            fn = _UNARY_TO_SYMPY.get(name)
            if fn is None:
                raise ValueError(f"no sympy mapping for unary operator {name!r}")
            return getattr(sympy, fn)(c)
        name = opset.binary[n.op].name
        l, r = rec(n.l), rec(n.r)
        if name in ("add", "plus"):
            return l + r
        if name == "sub":
            return l - r
        if name == "mult":
            return l * r
        if name == "div":
            return l / r
        if name in ("pow", "safe_pow"):
            return l**r
        if name == "max":
            return sympy.Max(l, r)
        if name == "min":
            return sympy.Min(l, r)
        if name == "mod":
            return sympy.Mod(l, r)
        raise ValueError(f"no sympy mapping for binary operator {name!r}")

    return rec(node)


def sympy_to_node(expr, opset, variable_names: list[str] | None = None) -> Node:
    """Convert a sympy expression back into a tree over ``opset``. Raises if
    the expression uses an operator the set lacks."""
    sympy = _sym()

    names = {}
    if variable_names is not None:
        names = {name: i for i, name in enumerate(variable_names)}

    def find_bin(name: str) -> int:
        return opset.binary_index(name)

    def find_una(name: str) -> int:
        return opset.unary_index(name)

    def nary(op_name: str, args):
        out = rec(args[0])
        i = find_bin(op_name)
        for a in args[1:]:
            out = binary(i, out, rec(a))
        return out

    def rec(e) -> Node:
        if e.is_Symbol:
            s = str(e)
            if s in names:
                return feature(names[s])
            if s.startswith("x") and s[1:].isdigit():
                return feature(int(s[1:]) - 1)
            raise ValueError(f"unknown symbol {s!r}")
        if e.is_Number:
            return constant(float(e))
        if e.is_Add:
            return nary("add", e.args)
        if e.is_Mul:
            return nary("mult", e.args)
        if e.is_Pow:
            base, exp = e.args
            # common sugar: x**2, x**3, sqrt, 1/x
            try:
                if exp == 2:
                    return unary(find_una("square"), rec(base))
            except KeyError:
                pass
            try:
                if exp == 3:
                    return unary(find_una("cube"), rec(base))
            except KeyError:
                pass
            try:
                if exp == sympy.Rational(1, 2):
                    return unary(find_una("sqrt"), rec(base))
            except KeyError:
                pass
            return binary(find_bin("pow"), rec(base), rec(exp))
        fname = type(e).__name__.lower()
        fmap = {"abs": "abs", "ceiling": "ceil"}
        fname = fmap.get(fname, fname)
        try:
            return unary(find_una(fname), *[rec(a) for a in e.args])
        except KeyError as err:
            raise ValueError(
                f"operator set has no operator for sympy node {type(e).__name__}"
            ) from err

    return rec(sympy.sympify(expr))
