"""Graph-node DAGs (``Options(graph_nodes=True)``) in the PyTorch port
against the JAX package (``tests/test_graph_nodes.py``; the reference's
GraphNode mode).

Every case of the JAX package's test runs here on the port, and the port's
DAG-specific pieces are held to the JAX package on the same inputs:

- ``flatten_trees`` of DAGs equals the JAX package's integer for integer
  (the port's ``ops/flat.py`` is a copy of JAX's), DAGs built by
  ``form_random_connection`` from one numpy stream in both packages;
- ``stack_sound_pointers`` makes every flattening stack-sound (the
  kernels' decode rule, checked by a Python walk of it here; the compiled
  core checks the lockstep path's batches in
  ``tests/test_torch_interp_core.py``), leaves a tree's flattening
  unchanged, and keeps every value: the plain interpreter on the re-pointed
  programs equals it on the raw ones bit for bit, and equals the JAX
  package's ``eval_trees`` on the raw programs bit for bit on ``+ - *``
  (IEEE arithmetic in both) and within rtol 1e-6 with ``cos`` (two libms);
- trees with shared subtrees pass constant optimization unchanged and
  rescored, as in the JAX package;
- a DAG population survives a checkpoint (format-1 raw pickling keeps the
  sharing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu.models import mutation_functions as jmf
from symbolicregression_jl_tpu.models.device_search import (
    device_mode_supported as j_device_mode_supported,
)
from symbolicregression_jl_tpu.ops.interp import eval_trees as j_eval_trees
from symbolicregression_jl_tpu_torch.complexity import compute_complexity
from symbolicregression_jl_tpu_torch.models.device_search import device_mode_supported
from symbolicregression_jl_tpu_torch.models.mutation_functions import (
    break_random_connection,
    form_random_connection,
)
from symbolicregression_jl_tpu_torch.ops import interp_cuda as ic
from symbolicregression_jl_tpu_torch.ops.flat import (
    KIND_BINARY, KIND_CONST, KIND_UNARY, KIND_VAR, flatten_trees, unflatten_tree,
)
from symbolicregression_jl_tpu_torch.ops.interp import eval_trees
from symbolicregression_jl_tpu_torch.tree import Node, binary, constant, feature, unary

OPS = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"])
OPTS = T.Options(graph_nodes=True, save_to_file=False, device="cpu", **OPS)
ADD, SUB, MUL = 0, 1, 2
COS = 0


@pytest.fixture(autouse=True, scope="module")
def _f32_jax():
    """Keep JAX in 32-bit mode: a test module run earlier in this process
    may have enabled x64."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", x64)


def _shared_tree():
    """cos(x1) used twice via a genuinely shared node."""
    shared = unary(COS, feature(0))
    return binary(ADD, shared, binary(MUL, shared, constant(2.0))), shared


# -- the JAX package's cases ------------------------------------------------------


class TestSharing:
    def test_unique_vs_expanded_count(self):
        t, _ = _shared_tree()
        assert t.count_nodes() == 7
        assert t.count_unique_nodes() == 5
        assert compute_complexity(t, OPTS) == 5

    def test_copy_preserve_sharing(self):
        t, _ = _shared_tree()
        c = t.copy_preserve_sharing()
        assert c.l is c.r.l
        assert c.count_unique_nodes() == 5
        plain = t.copy()
        assert plain.l is not plain.r.l

    def test_eval_matches_expanded(self):
        t, _ = _shared_tree()
        X = np.random.default_rng(0).normal(size=(1, 40))
        got = t.eval_np(X, OPTS.operators)
        want = np.cos(X[0]) + np.cos(X[0]) * 2.0
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_flatten_expands_sharing(self):
        t, _ = _shared_tree()
        flat = flatten_trees([t], OPTS.max_nodes)
        assert int(flat.length[0]) == 7
        back = unflatten_tree(flat, 0)
        X = np.random.default_rng(1).normal(size=(1, 20))
        np.testing.assert_allclose(
            back.eval_np(X, OPTS.operators), t.eval_np(X, OPTS.operators), rtol=1e-6)


def _connection_tree():
    return binary(ADD, unary(COS, binary(MUL, feature(0), constant(1.0))),
                  binary(MUL, feature(0), constant(3.0)))


class TestConnectionMutations:
    def test_form_connection_creates_sharing(self):
        made_dag = False
        for seed in range(30):
            out = form_random_connection(_connection_tree(), np.random.default_rng(seed))
            if out.count_unique_nodes() < out.count_nodes():
                made_dag = True
                break
        assert made_dag

    def test_form_connection_never_loops(self):
        for seed in range(50):
            out = form_random_connection(_connection_tree(), np.random.default_rng(seed))
            assert out.count_nodes() < 200

    def test_break_connection_unshares(self):
        t, _ = _shared_tree()
        rng = np.random.default_rng(3)
        for _ in range(20):
            break_random_connection(t, rng)
        assert t.count_unique_nodes() == t.count_nodes()


def test_graph_search_end_to_end():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 80)).astype(np.float32)
    y = (np.cos(X[0]) + 2 * np.cos(X[0]) * X[1]).astype(np.float32)
    opts = T.Options(graph_nodes=True, populations=4, population_size=16,
                     ncycles_per_iteration=40, maxsize=14, save_to_file=False, seed=0,
                     device="cpu", **OPS)
    res = T.equation_search(X, y, options=opts, niterations=3, verbosity=0)
    assert np.isfinite(min(m.loss for m in res.pareto_frontier))


def test_device_mode_rejects_graph_nodes():
    opts = T.Options(binary_operators=["+"], graph_nodes=True, scheduler="device",
                     save_to_file=False, device="cpu")
    jopts = J.Options(binary_operators=["+"], graph_nodes=True, scheduler="device",
                      save_to_file=False)
    assert device_mode_supported(opts) == j_device_mode_supported(jopts)
    X = np.random.default_rng(0).normal(size=(1, 30)).astype(np.float32)
    with pytest.raises(ValueError, match="GraphNode"):
        T.equation_search(X, X[0], options=opts, niterations=1, verbosity=0)


# -- the port's DAG pieces against the JAX package ------------------------------------


def _to_port(jnode, memo):
    """A JAX-package tree as a port tree with the same sharing (one port
    node per JAX node object)."""
    if id(jnode) in memo:
        return memo[id(jnode)]
    l = None if jnode.l is None or jnode.degree < 1 else _to_port(jnode.l, memo)
    r = None if jnode.r is None or jnode.degree < 2 else _to_port(jnode.r, memo)
    out = Node(jnode.degree, is_const=jnode.is_const, val=jnode.val, feat=jnode.feat,
               op=jnode.op, l=l, r=r)
    memo[id(jnode)] = out
    return out


def _dag_corpus(binary_operators, unary_operators, n=120, seed=0):
    """(JAX options, JAX DAGs, port DAGs): random trees with up to three
    connections formed on each, most of them sharing a subtree, every one
    within the node cap."""
    jopts = J.Options(binary_operators=binary_operators, unary_operators=unary_operators,
                      graph_nodes=True, maxsize=20, save_to_file=False)
    rng = np.random.default_rng(seed)
    jtrees = []
    while len(jtrees) < n:
        t = jmf.gen_random_tree(int(rng.integers(2, 8)), jopts.operators, 3, rng)
        for _ in range(int(rng.integers(0, 4))):
            t = jmf.form_random_connection(t, rng)
        if t.count_nodes() <= jopts.max_nodes:
            jtrees.append(t)
    return jopts, jtrees, [_to_port(t, {}) for t in jtrees]


def _stack_sound(flat) -> np.ndarray:
    """Per row: the kernels' decode rule (``decode_code``): each operator's
    children are the postfix stack's top entries and the stack ends with one
    entry."""
    kind, lhs, rhs, length = (np.asarray(a) for a in (flat.kind, flat.lhs, flat.rhs,
                                                      flat.length))
    out = np.zeros(len(kind), bool)
    for p in range(len(kind)):
        st, ok = [], True
        for i in range(int(length[p])):
            k = kind[p, i]
            if k in (KIND_CONST, KIND_VAR):
                st.append(i)
            elif k == KIND_UNARY:
                ok = ok and len(st) >= 1 and lhs[p, i] == st[-1]
                st[-1:] = [i]
            else:
                ok = ok and len(st) >= 2 and lhs[p, i] == st[-2] and rhs[p, i] == st[-1]
                st[-2:] = [i]
        out[p] = ok and len(st) == 1
    return out


@pytest.mark.parametrize("ops", [(["+", "-", "*"], []), (["+", "-", "*"], ["cos"])],
                         ids=["arith", "cos"])
def test_dag_flattening_and_repointing_against_jax(ops):
    jopts, jtrees, ttrees = _dag_corpus(*ops, seed=len(ops[1]))
    shared = np.array([t.count_unique_nodes() < t.count_nodes() for t in ttrees])
    assert shared.sum() >= 30
    # the same DAGs: the port's form_random_connection consumes the same
    # numpy stream
    rng_j, rng_t = np.random.default_rng(9), np.random.default_rng(9)
    for jt, tt in zip(jtrees[:40], ttrees[:40]):
        a = jmf.form_random_connection(jt.copy_preserve_sharing(), rng_j)
        b = form_random_connection(tt.copy_preserve_sharing(), rng_t)
        assert (a.count_nodes(), a.count_unique_nodes()) == (b.count_nodes(),
                                                             b.count_unique_nodes())
    N = jopts.max_nodes
    jflat = J.flatten_trees(jtrees, N)
    flat = flatten_trees(ttrees, N)
    for f in ("kind", "op", "lhs", "rhs", "feat", "length"):
        np.testing.assert_array_equal(np.asarray(getattr(flat, f)),
                                      np.asarray(getattr(jflat, f)), err_msg=f)
    np.testing.assert_array_equal(np.asarray(flat.val), np.asarray(jflat.val))
    # the raw flattening of most DAGs is not stack-sound; re-pointed, all are
    raw_sound = _stack_sound(flat)
    assert (~raw_sound).sum() >= 10 and raw_sound[~shared].all()
    rep = ic.stack_sound_pointers(flat)
    assert _stack_sound(rep).all()
    for f in ("kind", "op", "feat", "val", "length"):
        np.testing.assert_array_equal(np.asarray(getattr(rep, f)), np.asarray(getattr(flat, f)))
    np.testing.assert_array_equal(np.asarray(rep.lhs)[raw_sound], np.asarray(flat.lhs)[raw_sound])
    np.testing.assert_array_equal(np.asarray(rep.rhs)[raw_sound], np.asarray(flat.rhs)[raw_sound])
    # every value kept
    X = np.random.default_rng(4).normal(size=(3, 257)).astype(np.float32)
    opset = T.Options(graph_nodes=True, device="cpu", binary_operators=ops[0],
                      unary_operators=ops[1]).operators
    p_raw = eval_trees(flat, torch.from_numpy(X), opset).numpy()
    p_rep = eval_trees(rep, torch.from_numpy(X), opset).numpy()
    np.testing.assert_array_equal(p_rep.view(np.int32), p_raw.view(np.int32))
    p_jax = np.asarray(j_eval_trees(jflat, jnp.asarray(X), jopts.operators))
    if ops[1]:
        np.testing.assert_allclose(p_rep, p_jax, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(p_rep, p_jax)


def test_repointing_keeps_tree_flattenings():
    """A batch without sharing comes back integer for integer."""
    jopts = J.Options(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                      maxsize=20, save_to_file=False)
    rng = np.random.default_rng(2)
    trees = [jmf.gen_random_tree(int(rng.integers(1, 10)), jopts.operators, 3, rng)
             for _ in range(200)]
    trees = [t for t in trees if t.count_nodes() <= jopts.max_nodes]
    flat = convert.flat_trees(J.flatten_trees(trees, jopts.max_nodes))
    rep = ic.stack_sound_pointers(flat)
    for a, b in zip(rep, flat):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_shared_trees_pass_constant_optimization_unchanged():
    """The JAX package's rule (``ops/constant_opt.py:534-560``): trees with
    shared subtrees keep their constants and are rescored; the others are
    optimized. The same batch through both packages: the shared tree keeps
    its constant and its sharing, its loss agrees with JAX's and with the
    closed form to f32 tolerance, and the sharing-free tree's constant is
    fitted in both."""
    from symbolicregression_jl_tpu import tree as jt
    from symbolicregression_jl_tpu.dataset import Dataset as JDataset
    from symbolicregression_jl_tpu.models.scorer import BatchScorer as JScorer
    from symbolicregression_jl_tpu.ops.constant_opt import (
        optimize_constants_batched as j_opt,
    )
    from symbolicregression_jl_tpu_torch.dataset import Dataset
    from symbolicregression_jl_tpu_torch.models.scorer import BatchScorer
    from symbolicregression_jl_tpu_torch.ops.constant_opt import optimize_constants_batched

    rng = np.random.default_rng(0)
    X = rng.normal(size=(1, 64)).astype(np.float32)
    y = (np.cos(X[0]) * 3.5).astype(np.float32)
    t_dag, _ = _shared_tree()  # cos(x1) + cos(x1) * 2.0
    t_plain = binary(MUL, constant(1.0), unary(COS, feature(0)))
    j_shared = jt.unary(COS, jt.feature(0))
    j_dag = jt.binary(ADD, j_shared, jt.binary(MUL, j_shared, jt.constant(2.0)))
    j_plain = jt.binary(MUL, jt.constant(1.0), jt.unary(COS, jt.feature(0)))
    topts = T.Options(graph_nodes=True, save_to_file=False, device="cpu", **OPS)
    jopts = J.Options(graph_nodes=True, save_to_file=False, **OPS)
    out_t, loss_t, imp_t = optimize_constants_batched(
        [t_dag, t_plain], BatchScorer(Dataset(X, y), topts), topts, np.random.default_rng(1))
    out_j, loss_j, imp_j = j_opt([j_dag, j_plain], JScorer(JDataset(X, y), jopts), jopts,
                                 np.random.default_rng(1))
    assert not imp_t[0] and not imp_j[0]
    assert out_t[0] is t_dag and out_t[0].l is out_t[0].r.l
    np.testing.assert_array_equal(out_t[0].get_constants(), [2.0])
    np.testing.assert_allclose(loss_t[0], loss_j[0], rtol=1e-5)
    want = float(np.mean((np.cos(X[0]) * 3.0 - y) ** 2))
    np.testing.assert_allclose(loss_t[0], want, rtol=1e-4)
    assert imp_t[1] and imp_j[1]
    np.testing.assert_allclose(out_t[1].get_constants(), [3.5], rtol=1e-3)
    np.testing.assert_allclose(out_j[1].get_constants(), [3.5], rtol=1e-3)


def test_dag_population_checkpoint_round_trip(tmp_path):
    """Format-1 raw pickling keeps a DAG population's sharing through a
    snapshot on disk; a tree population next to it flat-encodes (format 2)."""
    from symbolicregression_jl_tpu_torch.models.hall_of_fame import HallOfFame
    from symbolicregression_jl_tpu_torch.models.pop_member import PopMember
    from symbolicregression_jl_tpu_torch.models.population import Population
    from symbolicregression_jl_tpu_torch.utils import checkpoint as ck

    t, _ = _shared_tree()
    members = [PopMember(t, 1.5, 0.5, complexity=5), PopMember(_connection_tree(), 2.0, 1.0)]
    hof = HallOfFame(OPTS.maxsize)
    ckpt = ck.SearchCheckpoint(iteration=1, niterations=2, scheduler="lockstep", exact=True,
                               populations=[Population(members)], hall_of_fame=hof,
                               num_evals=10.0)
    writer = ck.SearchCheckpointer(str(tmp_path / "dag.pkl"), every_iterations=1)
    back = ck.load_checkpoint(writer.save(ckpt))
    assert isinstance(back.populations, list)  # the raw format-1 populations
    got = back.populations[0].members
    assert got[0].tree.l is got[0].tree.r.l and got[0].tree.count_unique_nodes() == 5
    assert got[1].tree.same_structure(_connection_tree())
    assert [m.loss for m in got] == [0.5, 1.0]
    # without a DAG the same populations flat-encode
    flat = ck.flatten_populations([Population([members[1]])])
    assert flat is not None and ck.flatten_populations([Population(members)]) is None


def test_graph_search_resumes_from_its_checkpoint(tmp_path):
    """A graph-node lockstep search with a snapshot after every iteration
    resumes from it to a finite frontier."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(2, 60)).astype(np.float32)
    y = (np.cos(X[0]) * X[1] + np.cos(X[0])).astype(np.float32)
    base = str(tmp_path / "graph.pkl")
    opts = T.Options(graph_nodes=True, populations=2, population_size=12,
                     ncycles_per_iteration=20, maxsize=12, seed=0, save_to_file=False,
                     checkpoint_every=1, checkpoint_file=base, device="cpu", **OPS)
    T.equation_search(X, y, options=opts, niterations=2, verbosity=0)
    res = T.equation_search(X, y, options=opts, niterations=3, verbosity=0, resume_from=base)
    assert np.isfinite(min(m.loss for m in res.pareto_frontier))
