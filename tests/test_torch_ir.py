"""PyTorch port vs JAX package: flat IR, packing, conversion, import hygiene,
and the out-of-slice options.

Integer and host-side work must match exactly: the same trees flatten to
identical arrays and print identical strings in both packages."""

import ast
import pathlib

import numpy as np
import pytest

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu.models.mutation_functions import gen_random_tree as j_gen
from symbolicregression_jl_tpu.ops.interp_pallas import pack_flat_fused
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
    pack_programs_fused,
    unpack_programs_fused,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
BIN = ["add", "sub", "mult", "div", "pow", "max"]
UNA = ["cos", "exp", "abs", "log", "sqrt", "gamma"]


def _jax_corpus(n=96, seed=0, max_nodes=24):
    opts = J.Options(binary_operators=BIN, unary_operators=UNA, maxsize=20, save_to_file=False)
    rng = np.random.default_rng(seed)
    trees = []
    while len(trees) < n:
        t = j_gen(int(rng.integers(1, 10)), opts.operators, 3, rng)
        if t.count_nodes() <= max_nodes:
            trees.append(t)
    return opts, trees


def test_flat_ir_and_strings_identical():
    jopts, jtrees = _jax_corpus()
    topts = T.Options(binary_operators=BIN, unary_operators=UNA, maxsize=20,
                      save_to_file=False, device="cpu")
    assert topts.max_nodes == jopts.max_nodes
    jflat = J.flatten_trees(jtrees, jopts.max_nodes)
    ttrees = convert.trees_from_arrays(jflat)
    tflat = convert.flat_arrays(ttrees, topts.max_nodes)
    for name in convert.FIELDS:
        np.testing.assert_array_equal(tflat[name], np.asarray(getattr(jflat, name)), err_msg=name)
    for jt, tt in zip(jtrees, ttrees):
        assert jt.string_tree(jopts.operators) == tt.string_tree(topts.operators)
        assert J.tree.Node.count_nodes(jt) == tt.count_nodes()
    jc = [J.complexity.compute_complexity(t, jopts) for t in jtrees]
    tc = [T.complexity.compute_complexity(t, topts) for t in ttrees]
    assert jc == tc


def test_packed_program_matches_tpu_layout():
    jopts, jtrees = _jax_corpus(seed=1)
    jflat = J.flatten_trees(jtrees, jopts.max_nodes)
    ints, vals = pack_flat_fused(jflat, jopts.operators)
    topset = convert.operators_from_names(
        [o.name for o in jopts.operators.binary], [o.name for o in jopts.operators.unary]
    )
    prog, tvals = pack_programs_fused(convert.flat_trees(jflat), topset)
    N = jopts.max_nodes
    np.testing.assert_array_equal(prog, np.asarray(ints)[:, : 4 * N + 1])
    np.testing.assert_array_equal(tvals, np.asarray(vals)[:, :N])
    back = unpack_programs_fused(prog, tvals, topset)
    for name in convert.FIELDS:
        np.testing.assert_array_equal(getattr(back, name), getattr(jflat, name), err_msg=name)


def test_packed_words_match_and_round_trip():
    """The pointerless int16 IR (the evolve-block engine's form) packs to
    identical words in both packages and unpacks to the same flat arrays."""
    from symbolicregression_jl_tpu.ops.flat import pack_programs as j_pack
    from symbolicregression_jl_tpu_torch.ops.flat import pack_programs, unpack_programs

    jopts, jtrees = _jax_corpus(seed=3)
    jflat = J.flatten_trees(jtrees, jopts.max_nodes)
    want = j_pack(jflat)
    got = pack_programs(convert.flat_trees(jflat))
    for name in ("words", "consts", "length"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    back = unpack_programs(got)
    for name in convert.FIELDS:
        np.testing.assert_array_equal(getattr(back, name), getattr(jflat, name), err_msg=name)


def test_ir_verifier_names_the_broken_invariant():
    from symbolicregression_jl_tpu_torch.ops.flat import pack_programs

    jopts, jtrees = _jax_corpus(n=16, seed=4)
    topset = convert.operators_from_names(
        [o.name for o in jopts.operators.binary], [o.name for o in jopts.operators.unary]
    )
    flat = convert.flat_trees(J.flatten_trees(jtrees, jopts.max_nodes))
    T.verify_flat_trees(flat, topset, n_features=3, max_nodes=jopts.max_nodes)
    T.analysis.ir_verify.verify_packed_programs(pack_programs(flat), topset, n_features=3)
    bad = flat._replace(lhs=flat.lhs.copy())
    p = int(np.argmax(np.asarray(flat.kind).max(-1) >= 3))  # a tree with an operator
    i = int(np.argmax(np.asarray(flat.kind)[p] >= 3))
    bad.lhs[p, i] = i  # a child at or after its parent breaks postorder
    with pytest.raises(T.FlatIRError, match="postorder"):
        T.verify_flat_trees(bad, topset, n_features=3)


def test_convert_population_and_hall_of_fame():
    jopts, jtrees = _jax_corpus(n=40, seed=2)
    topts = T.Options(binary_operators=BIN, unary_operators=UNA, maxsize=20,
                      save_to_file=False, device="cpu")
    jflat = J.flatten_trees(jtrees, jopts.max_nodes)
    rng = np.random.default_rng(0)
    loss = rng.uniform(0.1, 2.0, len(jtrees))
    score = loss * 2
    birth = np.arange(len(jtrees)) + 100
    pop = convert.population_from_arrays(jflat, loss, score, topts, birth=birth)
    assert pop.n == len(jtrees)
    assert [m.birth for m in pop.members] == list(birth)
    np.testing.assert_array_equal([m.loss for m in pop.members], loss)
    hof_t = convert.hall_of_fame_from_arrays(jflat, loss, score, topts)
    hof_j = J.HallOfFame(jopts.maxsize)
    for t, l_, s_ in zip(jtrees, loss, score):
        hof_j.update(J.PopMember(t, s_, l_), jopts)
    jf = [(m.get_complexity(jopts), m.loss) for m in hof_j.pareto_frontier()]
    tf = [(m.get_complexity(topts), m.loss) for m in hof_t.pareto_frontier()]
    assert jf == tf


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_and_smoke_import_no_jax():
    files = sorted((ROOT / "symbolicregression_jl_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib"), f"{f} imports {mod}"
            assert top != "symbolicregression_jl_tpu", f"{f} imports {mod}"


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(scheduler="async"),
        dict(data_sharding="rows"),
        dict(exchange_topology="ring"),
        dict(on_peer_loss="continue"),
    ],
    ids=lambda kw: next(iter(kw)),
)
def test_out_of_slice_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.Options(device="cpu", **kwargs)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(dtype=np.complex64),
        dict(loss_function_jit=lambda p, y, w: p.mean(-1)),
        dict(graph_nodes=True),
    ],
    ids=lambda kw: next(iter(kw)),
)
def test_slice2_options_construct(kwargs):
    """The slice-2 features build, as the JAX package's Options do."""
    opts = T.Options(device="cpu", **kwargs)
    jopts = J.Options(**kwargs)
    for k, v in kwargs.items():
        assert getattr(opts, k) is v or getattr(opts, k) == v
    assert [op.name for op in opts.operators.binary] == [
        op.name for op in jopts.operators.binary]
    assert opts.should_simplify == jopts.should_simplify


def test_complex_equation_search_runs_on_cpu():
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(1, 32)) + 1j * rng.normal(size=(1, 32))).astype(np.complex64)
    y = ((1 + 2j) * X[0]).astype(np.complex64)
    opts = T.Options(binary_operators=["+", "*"], dtype=np.complex64, populations=2,
                     population_size=10, ncycles_per_iteration=5, maxsize=6, seed=0,
                     save_to_file=False, device="cpu")
    res = T.equation_search(X, y, options=opts, niterations=1, verbosity=0)
    assert np.isfinite(min(m.loss for m in res.pareto_frontier))


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(scheduler="device", use_recorder=True, crossover_probability=0.0),
        dict(scheduler="device", profile=True),
        dict(scheduler="device", optimizer_algorithm="NelderMead"),
        dict(dimensional_constraint_penalty=100.0, dimensionless_constants_only=True),
    ],
    ids=["recorder", "profile", "neldermead", "units"],
)
def test_retired_refusals_now_construct(kwargs):
    """The options this slice ported construct, and a units dataset parses."""
    opts = T.Options(device="cpu", **kwargs)
    for k, v in kwargs.items():
        assert getattr(opts, k) == v
    X = np.ones((1, 4), np.float32)
    assert T.Dataset(X, np.ones(4, np.float32), X_units=["m"], y_units="m").has_units


def test_options_pickle_round_trip():
    import pickle

    o = T.Options(binary_operators=BIN, unary_operators=UNA, elementwise_loss="HuberLoss(0.5)",
                  device="cpu")
    back = pickle.loads(pickle.dumps(o))
    assert back.operators == o.operators
    assert back.loss is o.loss
    assert back.device == "cpu" and back.max_nodes == o.max_nodes
