"""PyTorch port vs JAX package: units and dimensional analysis.

Unit parsing and the host dimension oracle are pure Python in both
packages, so they must agree exactly: the same value and SI exponents for
every unit string, the same verdict for every tree. The device engine's
batched, structure-only check (``ops/evolve.dim_violates_batch``) must give
the JAX engine's ``_dim_violates`` bit for bit on the same flattened trees,
and the host oracle's verdict wherever the trees' sample values stay finite
(the oracle also latches non-finite values; the engine leaves those to
inf-loss scoring, in both packages). Searches are compared as a per-seed
quality band on the planted problem y = x0 * x1^2 / x2 (kg, m/s, m -> N).
"""

import jax
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu.models.device_search as jds
import symbolicregression_jl_tpu_torch as T
import symbolicregression_jl_tpu_torch.models.device_search as tds
from symbolicregression_jl_tpu import dimensional_analysis as jda
from symbolicregression_jl_tpu import units as ju
from symbolicregression_jl_tpu.models.mutation_functions import gen_random_tree
from symbolicregression_jl_tpu.ops.evolve import _dim_violates
from symbolicregression_jl_tpu.ops.flat import flatten_trees
from symbolicregression_jl_tpu.ops.treeops import Tree as JTree
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch import dimensional_analysis as tda
from symbolicregression_jl_tpu_torch import units as tu
from symbolicregression_jl_tpu_torch.models.scorer import BatchScorer
from symbolicregression_jl_tpu_torch.ops.evolve import dim_penalty_batch, dim_violates_batch
from symbolicregression_jl_tpu_torch.ops.treeops import Tree as TTree

# the unit strings of the JAX package's tests/test_units.py, and more of the
# grammar: prefixes, groups, rational and decimal exponents, derived units
UNITS = ["m", "kg*m^2/s^2", "J", "km", "mm", "km/s", "m^(1//2)", "1", None, "one", "", 1,
         2.5, "N", "kg * m^2", "km/s^2", "J/(mol*K)", "W/(m^2*K)", "Ohm", "Ω", "µm", "um",
         "eV", "m^-2", "m^1.5", "s^(-1//3)", "kWh", "kW*h", "mHz", "GPa", "daN", "cd/m^2",
         "(kg*m)/(s^2*A)", "bar", "L/min", "V*A", "T*m^2", "Wb"]
BIN = ["+", "-", "*", "/", "pow"]
UNA = ["cos", "sqrt", "square", "abs", "exp"]
X_UNITS = ["kg", "m/s", "m"]


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """JAX in 32-bit mode (an earlier module may have enabled x64) and one
    torch thread (xdist workers share the cores)."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", x64)


def _quantity(q):
    return q.value, tuple(getattr(q.dims, b) for b in ju._BASE)


@pytest.mark.parametrize("spec", UNITS, ids=repr)
def test_parse_unit_matches_jax(spec):
    try:
        want = _quantity(ju.parse_unit(spec))
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0][:20]):
            tu.parse_unit(spec)
        return
    assert _quantity(tu.parse_unit(spec)) == want


@pytest.mark.parametrize("spec", ["florp", "m^", "(m", "m)", "kg**2", 3 + 4j])
def test_bad_units_raise_in_both(spec):
    exc = ValueError if isinstance(spec, str) else TypeError
    with pytest.raises(exc):
        ju.parse_unit(spec)
    with pytest.raises(exc):
        tu.parse_unit(spec)


def test_units_vector_and_dataset_match_jax():
    X = np.ones((3, 4), np.float32)
    y = np.ones(4, np.float32)
    jd = J.Dataset(X, y, X_units=X_UNITS, y_units="N")
    td = T.Dataset(X, y, X_units=X_UNITS, y_units="N")
    assert td.has_units and jd.has_units
    assert [_quantity(q) for q in td.X_units_parsed] == [_quantity(q) for q in jd.X_units_parsed]
    assert _quantity(td.y_units_parsed) == _quantity(jd.y_units_parsed)
    assert not T.Dataset(X, y).has_units
    assert [_quantity(q) for q in tu.parse_units_vector("m", 3)] == [
        _quantity(q) for q in ju.parse_units_vector("m", 3)]
    with pytest.raises(ValueError):
        tu.parse_units_vector(["m"], 3)


def _setup(n_trees, seed, y_units="N", **opt_kw):
    """Random trees on a units dataset in both packages, flattened once."""
    rng = np.random.default_rng(seed)
    kw = dict(binary_operators=BIN, unary_operators=UNA, maxsize=16, save_to_file=False,
              **opt_kw)
    jo, to = J.Options(**kw), T.Options(device="cpu", **kw)
    X = rng.uniform(1, 5, size=(3, 16)).astype(np.float32)
    y = (X[0] * X[1] ** 2 / X[2]).astype(np.float32)
    jd = J.Dataset(X, y, X_units=X_UNITS, y_units=y_units)
    td = T.Dataset(X, y, X_units=X_UNITS, y_units=y_units)
    trees = []
    while len(trees) < n_trees:
        t = gen_random_tree(int(rng.integers(1, 12)), jo.operators, 3, rng)
        if t.count_nodes() <= jo.max_nodes:
            trees.append(t)
    flat = flatten_trees(trees, jo.max_nodes)
    arrays = {f: np.asarray(getattr(flat, f)) for f in convert.FIELDS}
    return jo, to, jd, td, trees, convert.trees_from_arrays(arrays), arrays


@pytest.mark.parametrize("seed,y_units,strict", [(0, "N", False), (1, None, False),
                                                  (2, None, True)])
def test_host_oracle_matches_jax(seed, y_units, strict):
    jo, to, jd, td, jtrees, ttrees, _ = _setup(500, seed, y_units,
                                               dimensionless_constants_only=strict)
    want = [jda.violates_dimensional_constraints(t, jd, jo) for t in jtrees]
    got = [tda.violates_dimensional_constraints(t, td, to) for t in ttrees]
    assert got == want
    assert 25 <= sum(want) <= 475  # both verdicts represented


def _sample_finite(tree, X, opset) -> bool:
    """Every node's value on the oracle's sample (row 0) is finite."""
    ok = True

    def walk(n):
        nonlocal ok
        v = n.eval_np(X[:, :1].astype(np.float64), opset)
        ok &= bool(np.all(np.isfinite(v)))
        for c in (n.l, n.r):
            if c is not None:
                walk(c)

    with np.errstate(all="ignore"):
        walk(tree)
    return ok


@pytest.mark.parametrize("seed,y_units,strict", [(3, "N", False), (4, None, False),
                                                  (5, None, True)])
def test_engine_dim_check_matches_jax_and_oracle(seed, y_units, strict):
    jo, to, jd, td, jtrees, ttrees, arrays = _setup(500, seed, y_units,
                                                    dimensionless_constants_only=strict)
    args = dict(n_features=3, baseline_loss=1.0, use_baseline=True, niterations=1)
    jcfg = jds.build_evo_config(jo, dataset=jd, **args)
    tcfg = tds.build_evo_config(to, dataset=td, **args)
    for f in ("units_check", "x_dims", "y_dims", "una_dim_pow", "bin_dim_code", "dim_penalty",
              "allow_wildcards"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.units_check
    jt = JTree(*(jax.numpy.asarray(arrays[f]) for f in convert.FIELDS))
    want = np.asarray(jax.vmap(lambda t: _dim_violates(t, jcfg))(jt))
    tt = TTree(*(torch.from_numpy(np.asarray(arrays[f])) for f in convert.FIELDS))
    got = dim_violates_batch(tt, tcfg).numpy()
    np.testing.assert_array_equal(got, want)
    oracle = np.array([tda.violates_dimensional_constraints(t, td, to) for t in ttrees])
    finite = np.array([_sample_finite(t, td.X, to.operators) for t in ttrees])
    assert finite.sum() >= 300
    np.testing.assert_array_equal(got[finite], oracle[finite])
    pen = dim_penalty_batch(tt, tcfg)
    assert pen.dtype == torch.float32
    np.testing.assert_array_equal(pen.numpy(), np.where(want, 1000.0, 0.0))


def _planted(n=200):
    rng = np.random.default_rng(0)
    X = rng.uniform(1, 5, size=(3, n)).astype(np.float32)
    return X, (X[0] * X[1] ** 2 / X[2]).astype(np.float32)


SEARCH = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["sqrt", "cos"],
              populations=4, population_size=16, ncycles_per_iteration=40, maxsize=12,
              save_to_file=False, progress=False)


@pytest.mark.parametrize("scheduler", ["lockstep", "device"])
def test_search_with_units_penalizes_flagged_frontier(scheduler):
    X, y = _planted()
    opts = T.Options(device="cpu", seed=0, scheduler=scheduler, **SEARCH)
    res = T.equation_search(X, y, options=opts, niterations=3, verbosity=0,
                            X_units=X_UNITS, y_units="N")
    assert res.dataset.has_units
    front = res.pareto_frontier
    flagged = [m for m in front if tda.violates_dimensional_constraints(m.tree, res.dataset, opts)]
    assert all(m.loss >= 1000.0 for m in flagged)
    best = min(front, key=lambda m: m.loss)
    assert not tda.violates_dimensional_constraints(best.tree, res.dataset, opts)
    if scheduler == "device":
        assert res.engine_stats["block"] is None  # units leave the block
        # the engine's check over the final populations equals the oracle's
        # where the sample stays finite, and every stored loss is the
        # member's loss on the data plus the oracle's penalty
        members = [m for pop in res.populations for m in pop.members]
        flat = convert.flat_trees(convert.flat_arrays([m.tree for m in members], opts.max_nodes))
        cfg = tds.build_evo_config(opts, 3, 1.0, True, 3, dataset=res.dataset)
        tt = TTree(*(torch.from_numpy(np.asarray(getattr(flat, f))) for f in convert.FIELDS))
        got = dim_violates_batch(tt, cfg).numpy()
        want = np.array([tda.violates_dimensional_constraints(m.tree, res.dataset, opts)
                         for m in members])
        finite = np.array([_sample_finite(m.tree, X, opts.operators) for m in members])
        assert finite.mean() > 0.9
        np.testing.assert_array_equal(got[finite], want[finite])
        rescored = BatchScorer(res.dataset, opts).loss_many([m.tree for m in members])
        stored = np.array([m.loss for m in members])
        ok = finite & np.isfinite(stored)
        np.testing.assert_allclose(stored[ok], rescored[ok], rtol=1e-4)


def test_engine_units_quality_band_against_jax():
    """Per-seed band of the two device engines on the planted units problem
    at a small budget (3 iterations x 40 cycles, 4 x 16): over seeds 0-15 on
    the CPU both engines' best losses lay between 0 and 0.84x the mean
    predictor's loss (143.6); the geometric means (floored at 0.01) were 86.3
    for JAX and 44.0 for the port, which found the exact law once. Each seed
    must beat the mean predictor in both engines, and the geometric means
    must lie within a factor of 3 of each other."""
    X, y = _planted()
    baseline = float(np.var(y.astype(np.float64)))
    best = {}
    for name, P, kw in (("jax", J, {}), ("port", T, {"device": "cpu"})):
        best[name] = []
        for seed in range(3):
            opts = P.Options(seed=seed, scheduler="device", **SEARCH, **kw)
            res = P.equation_search(X, y, options=opts, niterations=3, verbosity=0,
                                    X_units=X_UNITS, y_units="N")
            best[name].append(min(m.loss for m in res.pareto_frontier))
    for name, losses in best.items():
        assert all(loss < baseline for loss in losses), (name, losses, baseline)
    gmean = {k: float(np.exp(np.mean(np.log(np.maximum(v, 0.01))))) for k, v in best.items()}
    assert 1 / 3 < gmean["port"] / gmean["jax"] < 3, gmean
