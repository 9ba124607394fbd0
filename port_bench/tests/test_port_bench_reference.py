"""The plain reference against hand-worked trees, and the comparison's gap."""

import math

import numpy as np
import pytest

from port_bench import checks, reference

UNARY = ["cos", "exp", "abs"]
BINARY = ["+", "-", "*", "/"]


class N:
    """A tree node with the four fields the reference reads."""

    def __init__(self, degree, is_const=False, val=0.0, feat=0, op=0, l=None, r=None):
        self.degree, self.is_const, self.val, self.feat = degree, is_const, val, feat
        self.op, self.l, self.r = op, l, r


def c(v):
    return N(0, True, v)


def x(i):
    return N(0, feat=i)


def u(name, a):
    return N(1, op=UNARY.index(name), l=a)


def b(name, a, bb):
    return N(2, op=BINARY.index(name), l=a, r=bb)


X = np.array([[0.0, 1.0, -2.0], [3.0, -0.5, 0.25]], np.float32)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("tree, want", [
    (c(1.5), [1.5, 1.5, 1.5]),
    (x(1), [3.0, -0.5, 0.25]),
    (b("+", x(0), c(2.0)), [2.0, 3.0, 0.0]),
    (b("*", x(0), x(1)), [0.0, -0.5, -0.5]),
    (b("/", c(1.0), x(1)), [1 / 3, -2.0, 4.0]),
    (u("abs", b("-", x(0), x(1))), [3.0, 1.5, 2.25]),
    (u("cos", x(0)), [1.0, math.cos(1.0), math.cos(-2.0)]),
    (u("exp", u("abs", x(0))), [1.0, math.e, math.exp(2.0)]),
])
def test_hand_worked_trees(tree, want, dtype):
    pred, top = reference.evaluate(tree, X, UNARY, BINARY, dtype)
    np.testing.assert_allclose(pred, want, rtol=1e-6)
    assert top >= np.abs(want).max() * (1 - 1e-6)


def test_f32_walk_rounds_each_operation():
    # 1 + 1e-8 is 1 in f32 and not in f64
    tree = b("-", b("+", c(1.0), c(1e-8)), c(1.0))
    p32, _ = reference.evaluate(tree, X, UNARY, BINARY, "float32")
    p64, _ = reference.evaluate(tree, X, UNARY, BINARY, "float64")
    assert (p32 == 0).all() and (p64 > 0).all()


def test_loss_and_its_non_finite_rule():
    y = np.array([1.0, 2.0, 3.0], np.float32)
    pred = np.array([1.0, 0.0, 5.0])
    assert reference.loss(pred, y) == pytest.approx((0 + 4 + 4) / 3)
    assert reference.loss(pred, y, "float64") == pytest.approx(8 / 3)
    assert reference.loss(np.array([1.0, np.inf, 0.0]), y) == math.inf
    assert reference.loss(np.array([1.0, np.nan, 0.0]), y) == math.inf
    div0, _ = reference.evaluate(b("/", c(1.0), x(0)), X, UNARY, BINARY)
    assert reference.loss(div0, y) == math.inf


def test_bfloat16_control_is_coarser():
    tree = b("*", u("cos", x(0)), c(1.2345678))
    p32, _ = reference.evaluate(tree, X, UNARY, BINARY, "float32")
    p16, _ = reference.evaluate(tree, X, UNARY, BINARY, "bfloat16")
    rel = np.abs(p16 - p32) / np.abs(p32)
    assert rel.max() > 1e-4 and rel.max() < 2e-2


def test_tree_facts():
    tree = b("+", u("cos", x(1)), c(2.0))
    assert reference.tree_facts(tree, 2, 3, 4) == {"nodes": 4, "bad_nodes": 0}
    assert reference.tree_facts(b("+", x(5), c(math.nan)), 2, 3, 4)["bad_nodes"] == 2
    assert reference.tree_facts(N(1, op=7, l=x(0)), 2, 3, 4)["bad_nodes"] == 1


def test_gap_is_in_units_of_the_trees_own_f32_rounding():
    assert checks._gap(1.0, 1.0, 1.0) == 0.0
    # one f32 ulp from the exact loss, with the f32 reference exact: one unit
    assert checks._gap(1.0 + 2.0 ** -23, 1.0, 1.0) == pytest.approx(1.0, rel=1e-6)
    # an ill-conditioned tree's f32 reference lies 1e-3 off: a 1e-3 gap is one unit
    assert checks._gap(1.001, 0.999, 1.0) == pytest.approx(1.0, rel=1e-3)
    assert checks._gap(math.inf, 1.0, 1.0) == math.inf
    assert checks._gap(math.inf, math.inf, math.inf) == 0.0
    assert checks._gap(1.0, math.inf, math.inf) == math.inf


def test_port_tree_is_read_as_it_is_built():
    T = pytest.importorskip("symbolicregression_jl_tpu_torch")
    tree = T.binary(0, T.unary(0, T.feature(1)), T.constant(2.0))
    pred, _ = reference.evaluate(tree, X, UNARY, BINARY)
    np.testing.assert_allclose(pred, np.cos(X[1]) + 2.0, rtol=1e-6)


@pytest.mark.parametrize("tree_of, fitted", [
    (lambda a, k: b("+", b("*", c(a), x(0)), c(k)), True),
    (lambda a, k: b("+", b("*", c(a + 0.3), x(0)), c(k - 1.0)), False),
    (lambda a, k: b("+", u("exp", b("*", c(0.1), x(1))), c(k)), False),
])
def test_refit_gain_reads_how_far_constants_are_from_fitted(tree_of, fitted):
    """Least squares of y on (x0, 1) in f64: the fitted line leaves nothing
    to remove; moved constants, or a wrong shape with a free offset, leave a
    share."""
    rng = np.random.default_rng(3)
    XX = rng.uniform(-5, 5, (2, 2000)).astype(np.float32)
    y = (1.7 * XX[0] - 0.4 + 0.1 * rng.standard_normal(2000)).astype(np.float32)
    A = np.stack([XX[0].astype(np.float64), np.ones(2000)], 1)
    a, k = np.linalg.lstsq(A, y.astype(np.float64), rcond=None)[0]
    gain = reference.refit_gain(tree_of(a, k), XX, y, UNARY, BINARY)
    if fitted:
        assert 0 <= gain < 1e-6
    else:
        assert gain > 1e-2


def test_refit_gain_needs_a_constant_and_a_finite_loss():
    y = np.zeros(3, np.float32)
    assert reference.refit_gain(b("+", x(0), x(1)), X, y, UNARY, BINARY) is None
    assert reference.refit_gain(b("/", c(1.0), x(0)), X, y, UNARY, BINARY) is None
