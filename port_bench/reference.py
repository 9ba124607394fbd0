"""The plain reference: an expression tree's predictions, its loss and its
size, worked out again from the tree and the cell's data.

It imports neither JAX nor anything of the program under test. It reads a
tree through four duck-typed fields of each node (``degree``; ``is_const``,
``val``, ``feat`` for a leaf; ``op``, ``l``, ``r`` for an operator), the
operator index being a position in the configuration's own operator lists.

Precision. The configuration states f32. The reference walks each tree
twice: in numpy f64 (the loss as exactly as the data allow) and in numpy f32
as the configuration states it, one IEEE operation per node in the tree's
order, the loss elementwise in f32 and its sum in f64 over the row count,
cast back to f32. The second walk's distance from the first is how far
f32 rounding alone moves this tree's loss (``checks.py``). A tree with a
non-finite prediction on any row has the loss inf.
``evaluate(..., dtype="bfloat16")`` is the control: the same walk in torch's
bfloat16 on the host (numpy has no bfloat16), which the comparison must
refuse.

``refit_gain`` judges a tree's constants: from the constants the tree holds,
a few damped Gauss-Newton steps on the f64 L2 loss, and the share of that
loss they remove. Constants that a local optimizer fitted leave almost
nothing to remove; constants that only mutation moved leave a share.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["evaluate", "loss", "tree_facts", "refit_gain", "UNARY", "BINARY", "NEAR_OVERFLOW"]

#: the reference's own operators, by the configuration's names: plain IEEE
#: arithmetic, as SymbolicRegression.jl's defaults (no safe division)
UNARY = {
    "cos": lambda x, m: m.cos(x),
    "exp": lambda x, m: m.exp(x),
    "abs": lambda x, m: m.abs(x),
}
BINARY = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
}
#: a tree whose intermediate values pass this magnitude is at the edge of
#: f32's range (3.4e38): the last ulp of a transcendental decides whether
#: it overflows, so its loss is not compared (it is counted apart)
NEAR_OVERFLOW = 1e37


def _walk(node, leaf, unary, binary):
    if node.degree == 0:
        return leaf(node)
    if node.degree == 1:
        return unary(node.op, _walk(node.l, leaf, unary, binary))
    return binary(node.op, _walk(node.l, leaf, unary, binary), _walk(node.r, leaf, unary, binary))


def evaluate(tree, X: np.ndarray, unary_names, binary_names, dtype: str = "float32"):
    """(predictions [R] as float64 numpy, largest |intermediate| seen) of
    ``tree`` on X [F, R], computed in ``dtype`` ("float64", "float32" or
    "bfloat16")."""
    top = [0.0]

    def track(v, absmax):
        m = float(absmax(v))
        if m == m:  # NaN tells nothing of the range
            top[0] = max(top[0], m)
        return v

    if dtype in ("float32", "float64"):
        dt = np.dtype(dtype)
        Xd = np.asarray(X, np.float32).astype(dt)
        R = Xd.shape[1]

        def absmax(v):
            a = np.abs(v[~np.isnan(v)])
            return a.max() if a.size else np.nan

        def leaf(n):
            if n.is_const:
                return np.full(R, np.float32(n.val), dt)
            return Xd[n.feat]

        with np.errstate(all="ignore"):
            pred = _walk(
                tree, lambda n: track(leaf(n), absmax),
                lambda op, x: track(UNARY[unary_names[op]](x, np).astype(dt), absmax),
                lambda op, a, b: track(BINARY[binary_names[op]](a, b).astype(dt), absmax),
            )
            return np.asarray(pred, np.float64), top[0]
    if dtype != "bfloat16":
        raise ValueError(f"unsupported reference dtype {dtype}")
    import torch

    Xt = torch.from_numpy(np.asarray(X, np.float32)).to(torch.bfloat16)
    R = Xt.shape[1]

    def tabsmax(v):
        a = v[~torch.isnan(v)].abs().float()
        return a.max().item() if a.numel() else float("nan")

    def tleaf(n):
        if n.is_const:
            return torch.full((R,), float(np.float32(n.val)), dtype=torch.bfloat16)
        return Xt[n.feat]

    pred = _walk(
        tree, lambda n: track(tleaf(n), tabsmax),
        lambda op, x: track(UNARY[unary_names[op]](x, torch), tabsmax),
        lambda op, a, b: track(BINARY[binary_names[op]](a, b), tabsmax),
    )
    return pred.float().double().numpy(), top[0]


def loss(pred: np.ndarray, y: np.ndarray, dtype: str = "float32") -> float:
    """L2 loss of predictions (float64 numpy holding ``dtype`` values) on y:
    the elementwise (p - y)^2 in ``dtype``, summed in f64, over the rows,
    rounded to f32 (kept in f64 for "float64"); inf when any prediction is
    not finite."""
    if not np.isfinite(pred).all():
        return float("inf")
    if dtype == "float64":
        d = pred - np.asarray(y, np.float32).astype(np.float64)
        return float((d * d).sum() / len(d))
    if dtype == "float32":
        d = pred.astype(np.float32) - np.asarray(y, np.float32)
        with np.errstate(over="ignore"):
            elem = (d * d).astype(np.float64)
    else:
        import torch

        p = torch.from_numpy(pred).to(torch.bfloat16)
        t = torch.from_numpy(np.asarray(y, np.float32)).to(torch.bfloat16)
        d = p - t
        elem = (d * d).double().numpy()
    return float(np.float32(elem.sum() / len(elem)))


def tree_facts(tree, n_features: int, n_unary: int, n_binary: int) -> dict:
    """What the reference reads off a tree: its node count (the complexity
    with every node of complexity 1), and the nodes that break the
    configuration (an operator index outside its lists, a feature index
    outside X, a constant that is not finite)."""
    nodes = 0
    bad = 0
    stack = [tree]
    while stack:
        n = stack.pop()
        nodes += 1
        if n.degree == 0:
            if n.is_const:
                bad += not np.isfinite(float(n.val))
            else:
                bad += not 0 <= int(n.feat) < n_features
        elif n.degree == 1:
            bad += not 0 <= int(n.op) < n_unary
            stack.append(n.l)
        elif n.degree == 2:
            bad += not 0 <= int(n.op) < n_binary
            stack += [n.l, n.r]
        else:
            bad += 1
    return {"nodes": nodes, "bad_nodes": bad}


def _eval64(tree, X64: np.ndarray, unary_names, binary_names, consts: dict):
    """The f64 walk, each constant leaf taking ``consts[id(leaf)]``."""
    R = X64.shape[1]
    with np.errstate(all="ignore"):
        return _walk(
            tree,
            lambda n: np.full(R, consts[id(n)]) if n.is_const else X64[n.feat],
            lambda op, x: UNARY[unary_names[op]](x, np),
            lambda op, a, b: BINARY[binary_names[op]](a, b),
        )


def refit_gain(tree, X: np.ndarray, y: np.ndarray, unary_names, binary_names,
               steps: int = 8):
    """(L0 - L) / L0, where L0 is the f64 L2 loss of ``tree`` with its own
    constants and L the lowest that ``steps`` Levenberg-Marquardt steps on
    its constants reach from there (Jacobian by central differences, each
    step kept only where it lowers the loss); None for a tree without
    constants or whose loss is not finite and above 0."""
    leaves = []
    stack = [tree]
    while stack:
        n = stack.pop()
        if n.degree == 0:
            if n.is_const:
                leaves.append(n)
        else:
            stack += [n.l] if n.degree == 1 else [n.l, n.r]
    if not leaves:
        return None
    X64 = np.asarray(X, np.float32).astype(np.float64)
    y64 = np.asarray(y, np.float32).astype(np.float64)
    c = np.array([float(np.float32(n.val)) for n in leaves])

    def resid(cv):
        return _eval64(tree, X64, unary_names, binary_names,
                       {id(n): v for n, v in zip(leaves, cv)}) - y64

    r = resid(c)
    L0 = float(r @ r) / len(r)
    if not (math.isfinite(L0) and L0 > 0):
        return None
    L, lam = L0, 1e-3
    for _ in range(steps):
        J = np.empty((len(r), len(c)))
        for j in range(len(c)):
            h = 1e-6 * max(1.0, abs(c[j]))
            e = np.zeros_like(c)
            e[j] = h
            J[:, j] = (resid(c + e) - resid(c - e)) / (2 * h)
        if not np.isfinite(J).all():
            break
        A, g = J.T @ J, J.T @ r
        while lam < 1e12:
            try:
                step = np.linalg.solve(A + lam * (np.diag(np.diag(A)) + 1e-12 * np.eye(len(c))),
                                       -g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            r_new = resid(c + step)
            L_new = float(r_new @ r_new) / len(r_new)
            if math.isfinite(L_new) and L_new < L:
                c, r, L, lam = c + step, r_new, L_new, max(lam / 3, 1e-9)
                break
            lam *= 10
        else:
            break
    return (L0 - L) / L0
