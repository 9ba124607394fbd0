"""The port's tree helpers against the JAX package's, exactly.

``Node.has_operators``, ``Node.same_structure``, ``Node.structure_key``,
``map_tree`` and ``pop_member.scored_member`` on seeded random trees that
are rebuilt alike in both packages from one flat batch (the JAX package's
``unflatten_tree`` and the port's ``convert.trees_from_arrays`` of the same
f64 arrays): booleans, keys and their hashes, ``map_tree`` results through
``structure_key``, and complexities. Cases include trees that differ only in
a constant, NaN constants (unequal to everything, themselves included) and
``-0.0`` against ``0.0`` (equal).
"""

import math

import numpy as np
import pytest

import symbolicregression_jl_tpu as J
from symbolicregression_jl_tpu.models.mutation_functions import gen_random_tree as j_gen
from symbolicregression_jl_tpu.models.pop_member import scored_member as j_scored_member
from symbolicregression_jl_tpu.ops.flat import unflatten_tree as j_unflatten
from symbolicregression_jl_tpu.tree import map_tree as j_map_tree
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.models.pop_member import scored_member
from symbolicregression_jl_tpu_torch.tree import Node, map_tree

BIN = ["add", "sub", "mult", "div"]
UNA = ["cos", "exp", "abs"]


def _pair(n=80, seed=0):
    """(JAX options, port options, JAX trees, port trees): the same trees in
    both packages, constants as f64."""
    jopts = J.Options(binary_operators=BIN, unary_operators=UNA, maxsize=20,
                      save_to_file=False)
    topts = T.Options(binary_operators=BIN, unary_operators=UNA, maxsize=20,
                      save_to_file=False, device="cpu")
    rng = np.random.default_rng(seed)
    trees = [J.tree.constant(float(rng.normal())), J.tree.feature(int(rng.integers(0, 3)))]
    while len(trees) < n:
        t = j_gen(int(rng.integers(1, 9)), jopts.operators, 3, rng)
        if t.count_nodes() <= jopts.max_nodes:
            trees.append(t)
    flat = J.flatten_trees(trees, jopts.max_nodes, dtype=np.float64)
    jtrees = [j_unflatten(flat, p) for p in range(len(trees))]
    return jopts, topts, jtrees, convert.trees_from_arrays(flat)


def _consts(tree):
    return [n for n in tree.postorder() if n.degree == 0 and n.is_const]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_has_operators_and_structure_key_equal_jax(seed):
    _, _, jtrees, ttrees = _pair(seed=seed)
    assert any(not t.has_operators() for t in ttrees)
    for jt, tt in zip(jtrees, ttrees):
        assert isinstance(tt, Node)
        assert tt.has_operators() == jt.has_operators()
        key = tt.structure_key()
        assert key == jt.structure_key()
        assert hash(key) == hash(jt.structure_key())
        assert key == tt.copy().structure_key()


@pytest.mark.parametrize("seed", [0, 1])
def test_same_structure_equal_jax_on_every_pair(seed):
    _, _, jtrees, ttrees = _pair(n=40, seed=seed)
    for ja, ta in zip(jtrees, ttrees):
        for jb, tb in zip(jtrees, ttrees):
            got = ta.same_structure(tb)
            assert got == ja.same_structure(jb)
            assert got == (ta.structure_key() == tb.structure_key())
        assert ta.same_structure(ta.copy())


def test_constant_only_difference():
    _, _, jtrees, ttrees = _pair(seed=3)
    pairs = [(jt, tt) for jt, tt in zip(jtrees, ttrees) if _consts(tt)]
    assert pairs
    for jt, tt in pairs:
        jb, tb = jt.copy(), tt.copy()
        for t in (jb, tb):
            c = _consts(t)[-1]
            c.val = float(np.nextafter(c.val, np.inf))
        assert not tt.same_structure(tb) and not jt.same_structure(jb)
        assert tt.structure_key() != tb.structure_key()
        assert tb.structure_key() == jb.structure_key()
        assert hash(tb.structure_key()) == hash(jb.structure_key())


def test_nan_constant_equals_nothing():
    _, _, jtrees, ttrees = _pair(seed=4)
    pairs = [(jt, tt) for jt, tt in zip(jtrees, ttrees) if _consts(tt)]
    for jt, tt in pairs:
        for t in (jt, tt):
            _consts(t)[0].val = math.nan
        # x.val != y.val: a NaN constant is unequal even to itself
        assert tt.same_structure(tt) is jt.same_structure(jt) is False
        assert tt.same_structure(tt.copy()) is jt.same_structure(jt.copy()) is False
        assert repr(tt.structure_key()) == repr(jt.structure_key())


def test_negative_zero_equals_zero():
    _, _, jtrees, ttrees = _pair(seed=5)
    pairs = [(jt, tt) for jt, tt in zip(jtrees, ttrees) if _consts(tt)]
    for jt, tt in pairs:
        ja, jb, ta, tb = jt.copy(), jt.copy(), tt.copy(), tt.copy()
        for t, v in ((ja, 0.0), (jb, -0.0), (ta, 0.0), (tb, -0.0)):
            _consts(t)[0].val = v
        assert ta.same_structure(tb) is ja.same_structure(jb) is True
        assert ta.structure_key() == tb.structure_key() == jb.structure_key()
        assert hash(ta.structure_key()) == hash(tb.structure_key()) == hash(jb.structure_key())


def _rewrites(pkg):
    """map_tree callbacks, built on one package's tree constructors: replace
    feature 0 by a constant; negate every constant (a replacement that is a
    new leaf); wrap every feature in cos (a replacement embedding the
    visited node, which must not be revisited); replace nothing."""
    from importlib import import_module

    tree = import_module(f"{pkg}.tree")

    def feat0_to_const(n):
        if n.degree == 0 and not n.is_const and n.feat == 0:
            return tree.constant(2.5)
        return None

    def negate(n):
        if n.degree == 0 and n.is_const:
            return tree.constant(-n.val)
        return None

    def wrap(n):
        if n.degree == 0 and not n.is_const:
            return tree.unary(0, tree.feature(n.feat))
        return None

    return [feat0_to_const, negate, wrap, lambda n: None, lambda n: n]


def test_map_tree_equal_jax():
    _, _, jtrees, ttrees = _pair(seed=6)
    jfns = _rewrites("symbolicregression_jl_tpu")
    tfns = _rewrites("symbolicregression_jl_tpu_torch")
    for jt, tt in zip(jtrees, ttrees):
        before = tt.structure_key()
        for jf, tf in zip(jfns, tfns):
            got = map_tree(tt, tf)
            assert got is not tt
            assert got.structure_key() == j_map_tree(jt, jf).structure_key()
        assert tt.structure_key() == before  # the input is not touched


@pytest.mark.parametrize("seed", [7, 8])
def test_scored_member_equal_jax(seed):
    jopts, topts, jtrees, ttrees = _pair(seed=seed)
    rng = np.random.default_rng(seed)
    for jt, tt in zip(jtrees, ttrees):
        score, loss, parent = float(rng.normal()), float(rng.random()), int(rng.integers(-1, 9))
        jm = j_scored_member(jt, score, loss, jopts, parent=parent)
        tm = scored_member(tt, score, loss, topts, parent=parent)
        assert tm.complexity == jm.complexity is not None
        assert (tm.score, tm.loss, tm.parent) == (jm.score, jm.loss, jm.parent)
        assert tm.tree is tt
