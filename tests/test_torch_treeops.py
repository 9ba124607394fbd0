"""PyTorch port vs JAX package: batched tree surgery (ops/treeops.py).

Random populations are drawn once with numpy (the JAX package's tree
generator and flattener) and handed to both packages as plain arrays. The
JAX package computes per tree under ``jax.vmap``; the port computes on a
[L, N] batch. Integer results must be identical; the gathered constants too
(a gather moves values, it computes nothing). Random trees cannot share
draws, so ``random_tree`` is held to the flat-IR invariants instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbolicregression_jl_tpu.models.mutation_functions import gen_random_tree
from symbolicregression_jl_tpu.ops import operators as jops
from symbolicregression_jl_tpu.ops import treeops as jt
from symbolicregression_jl_tpu.ops.flat import flatten_trees
from symbolicregression_jl_tpu_torch.analysis.ir_verify import verify_flat_trees
from symbolicregression_jl_tpu_torch.ops import treeops as tt
from symbolicregression_jl_tpu_torch.ops.flat import FlatTrees
from symbolicregression_jl_tpu_torch.ops.operators import resolve_operators

N = 16
NFEAT = 3
OPS = (["add", "sub", "mult", "div"], ["cos", "exp", "neg"])


@pytest.fixture(autouse=True, scope="module")
def _x64_off():
    """Keep JAX in 32-bit mode: a test module run earlier in this process may
    have enabled x64.

    One torch thread: tier-1 runs test files in parallel pytest-xdist
    workers, where per-process thread pools oversubscribe the cores, and
    CPU sums split by thread count would make the port's results depend
    on the machine."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", x64)


def population(n=400, seed=0, max_len=N):
    """numpy flat fields of n random trees of 1..max_len nodes."""
    opset = jops.resolve_operators(*OPS)
    rng = np.random.default_rng(seed)
    trees = []
    while len(trees) < n:
        t = gen_random_tree(int(rng.integers(1, max_len + 1)), opset, NFEAT, rng)
        if t.count_nodes() <= N:
            trees.append(t)
    flat = flatten_trees(trees, N)
    return {f: np.asarray(getattr(flat, f)) for f in
            ("kind", "op", "lhs", "rhs", "feat", "val", "length")}


def jtree(a):
    return jt.Tree(*(jnp.asarray(a[f]) for f in ("kind", "op", "lhs", "rhs", "feat", "val",
                                                 "length")))


def ttree(a):
    return tt.Tree(*(torch.from_numpy(np.ascontiguousarray(a[f])) for f in
                     ("kind", "op", "lhs", "rhs", "feat", "val", "length")))


def assert_trees_equal(j, t, lanes=None):
    for name, a, b in zip(jt.Tree._fields, j, t):
        a, b = np.asarray(a), b.numpy()
        if lanes is not None:
            a, b = a[lanes], b[lanes]
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_subtree_sizes_and_depth():
    a = population()
    j, t = jtree(a), ttree(a)
    np.testing.assert_array_equal(np.asarray(jax.vmap(jt.subtree_sizes)(j)),
                                  tt.subtree_sizes(t).numpy())
    np.testing.assert_array_equal(np.asarray(jax.vmap(jt.tree_depth)(j)),
                                  tt.tree_depth(t).numpy())


def test_gather_slots():
    a = population(seed=1)
    src = np.random.default_rng(2).integers(0, N, size=(400, N)).astype(np.int32)
    # non-finite constants ride the JAX package's one-hot gather too
    a["val"][:3, 0] = [np.inf, -np.inf, np.nan]
    got_j = jax.vmap(jt.gather_slots)(jtree(a), jnp.asarray(src))
    got_t = tt.gather_slots(ttree(a), torch.from_numpy(src))
    for x, y in zip(got_j, got_t):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def _subtree(a, seed):
    """A random subtree [start, root+1) per lane."""
    sizes = np.asarray(jax.vmap(jt.subtree_sizes)(jtree(a)))
    rng = np.random.default_rng(seed)
    p = (rng.random(len(a["length"])) * a["length"]).astype(np.int32)
    start = p - sizes[np.arange(len(p)), p] + 1
    return start.astype(np.int32), (p + 1).astype(np.int32)


def test_extract_block():
    a = population(seed=3)
    lo, hi = _subtree(a, 4)
    got_j = jax.vmap(jt.extract_block)(jtree(a), jnp.asarray(lo), jnp.asarray(hi))
    got_t = tt.extract_block(ttree(a), torch.from_numpy(lo), torch.from_numpy(hi))
    assert_trees_equal(got_j, got_t)


def test_replace_range():
    a, b = population(seed=5), population(seed=6)
    lo, hi = _subtree(a, 7)
    blo, bhi = _subtree(b, 8)
    mat_j = jax.vmap(jt.extract_block)(jtree(b), jnp.asarray(blo), jnp.asarray(bhi))
    mat_t = tt.extract_block(ttree(b), torch.from_numpy(blo), torch.from_numpy(bhi))
    out_j = jax.vmap(jt.replace_range)(jtree(a), jnp.asarray(lo), jnp.asarray(hi), mat_j)
    out_t = tt.replace_range(ttree(a), torch.from_numpy(lo), torch.from_numpy(hi), mat_t)
    # callers reject results that outgrow the slots; compare the rest
    fits = np.asarray(out_j.length) <= N
    assert fits.sum() > 300
    assert_trees_equal(out_j, out_t, lanes=fits)


@pytest.mark.parametrize("n_unary", [0, 3])
def test_random_tree_is_valid_ir(n_unary):
    gen = torch.Generator().manual_seed(0)
    m = torch.randint(1, N + 1, (2000,), generator=gen, dtype=torch.int32)
    t = tt.random_tree(gen, m, N, NFEAT, n_unary, 4)
    flat = FlatTrees(*(x.numpy() for x in t))
    opset = resolve_operators(OPS[0], OPS[1][:n_unary])
    verify_flat_trees(flat, opset, n_features=NFEAT, max_nodes=N, allow_empty=False)
    want = m.numpy() if n_unary else np.where(m.numpy() % 2 == 0, m.numpy() - 1, m.numpy())
    np.testing.assert_array_equal(flat.length, np.maximum(want, 1))
