"""PyTorch port vs JAX package: the device engine's state and evolve leg
(ops/evolve.py, models/device_search.py).

Deterministic parts are exact against the JAX package on the same numpy
inputs: complexity, constraint checks, mutation conditioning, the best-seen
merge, the const-opt accept, the engine config and the readback. Random
parts cannot share draws with JAX's threefry stream, so they are held to
invariants: every mutation kind and crossover yields trees the port's IR
verifier accepts, mutation kinds are drawn at the conditioned frequencies
(chi-squared at a fixed seed), and one evolve pass on a converted JAX state
keeps the engine's bookkeeping.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu.models import device_search as jds
from symbolicregression_jl_tpu.models.mutation_functions import gen_random_tree
from symbolicregression_jl_tpu.ops import evolve as je
from symbolicregression_jl_tpu.ops import treeops as jt
from symbolicregression_jl_tpu.ops.flat import flatten_trees
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.analysis.ir_verify import verify_flat_trees
from symbolicregression_jl_tpu_torch.models import device_search as tds
from symbolicregression_jl_tpu_torch.ops import evolve as te
from symbolicregression_jl_tpu_torch.ops import treeops as tt
from symbolicregression_jl_tpu_torch.ops.flat import FlatTrees

NFEAT = 3
BASE = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
            populations=4, population_size=24, maxsize=14, save_to_file=False)
MAPPING = dict(complexity_of_operators={"cos": 2, "*": 3}, complexity_of_constants=2,
               complexity_of_variables=1.5)
CONSTRAINTS = dict(constraints={"*": (3, -1), "cos": 4},
                   nested_constraints={"cos": {"cos": 0}, "*": {"exp": 1}})


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


def configs(**kw):
    jo = J.Options(scheduler="device", **BASE, **kw)
    to = T.Options(scheduler="device", device="cpu", **BASE, **kw)
    args = dict(n_features=NFEAT, baseline_loss=2.5, use_baseline=True, niterations=5,
                n_rows=100)
    return jo, to, jds.build_evo_config(jo, **args), tds.build_evo_config(to, **args)


def population(jo, n, seed, max_len=12):
    rng = np.random.default_rng(seed)
    trees = []
    while len(trees) < n:
        t = gen_random_tree(int(rng.integers(1, max_len + 1)), jo.operators, NFEAT, rng)
        if t.count_nodes() <= jo.max_nodes:
            trees.append(t)
    flat = flatten_trees(trees, jo.max_nodes)
    return {f: np.asarray(getattr(flat, f)) for f in
            ("kind", "op", "lhs", "rhs", "feat", "val", "length")}


def jtree(a):
    return jt.Tree(*(jnp.asarray(a[f]) for f in jt.Tree._fields))


def ttree(a):
    return tt.Tree(*(torch.from_numpy(np.ascontiguousarray(a[f])) for f in tt.Tree._fields))


def context(tcfg, to, seed=0):
    scorer = tds.EngineScorer(to, use_kernel=True)
    return te.EvoContext(tcfg, "cpu", torch.Generator().manual_seed(seed), scorer.losses)


def test_build_evo_config_field_for_field():
    for kw in ({}, MAPPING, CONSTRAINTS, dict(batching=True, batch_size=30, annealing=True,
                                               warmup_maxsize_by=0.5)):
        _, _, jc, tc = configs(**kw)
        jd = dataclasses.asdict(jc)
        td = dataclasses.asdict(tc)
        assert td == {k: jd[k] for k in td}, kw
        # the JAX fields the port leaves out hold the values it runs with
        assert jd["poisson_migration"] and jd["copt_updates_bs"], kw
        assert not jd["units_check"] and not jd["record_events"], kw


@pytest.mark.parametrize("kw", [{}, MAPPING], ids=["node_count", "mapping"])
def test_complexity_batch(kw):
    jo, to, jc, tc = configs(**kw)
    a = population(jo, 300, 0)
    np.testing.assert_array_equal(np.asarray(je.complexity_batch(jtree(a), jc)),
                                  te.complexity_batch(ttree(a), tc).numpy())


def test_constraints_ok():
    jo, to, jc, tc = configs(**CONSTRAINTS)
    a = population(jo, 600, 1)
    want = np.asarray(jax.vmap(lambda t: je._constraints_ok(t, jc))(jtree(a)))
    got = te._constraints_ok(ttree(a), tc).numpy()
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("curmaxsize", [3, 8, 14])
def test_condition_weights(curmaxsize):
    jo, to, jc, tc = configs(**MAPPING)
    a = population(jo, 300, 2)
    want = np.asarray(jax.vmap(lambda t: je._condition_weights(t, jc, curmaxsize))(jtree(a)))
    got = te._condition_weights(context(tc, to), ttree(a), curmaxsize).numpy()
    np.testing.assert_array_equal(want, got)


def states(jo, jc, seed=0):
    """A JAX EvoState with losses, scores, births and a partial frontier, and
    its port conversion."""
    I, P = jc.n_islands, jc.pop_size
    a = population(jo, I * P, seed)
    rng = np.random.default_rng(seed)
    losses = rng.uniform(0.1, 5.0, I * P).astype(np.float32)
    losses[::7] = np.inf
    js = je.init_state(J.ops.flat.FlatTrees(**a), losses, jc, seed)
    js = je.merge_best_seen(js, jc, jnp.asarray(losses[:40]), jnp.isfinite(losses[:40]),
                            [jnp.asarray(a[f][:40]) for f in jt.Tree._fields[:6]],
                            jnp.asarray(a["length"][:40]))
    js = js._replace(birth=jnp.asarray(rng.permutation(I * P).reshape(I, P), jnp.int32),
                     step=jnp.asarray(I * P + 3, jnp.int32))
    return js, convert.evo_state_from_arrays(js)


def assert_states_equal(js, ts):
    got = convert.evo_state_arrays(ts)
    for name in convert.EVO_FIELDS:
        if name == "bs_tree":
            for k, (a, b) in enumerate(zip(js.bs_tree, got[name])):
                np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"bs_tree[{k}]")
        else:
            np.testing.assert_allclose(np.asarray(getattr(js, name)).astype(np.float64),
                                       got[name].astype(np.float64), rtol=0, err_msg=name)


def test_state_conversion_round_trip():
    jo, to, jc, tc = configs()
    js, ts = states(jo, jc)
    assert_states_equal(js, ts)


def test_merge_best_seen():
    jo, to, jc, tc = configs(**MAPPING)
    js, ts = states(jo, jc, seed=1)
    b = population(jo, 200, 3)
    rng = np.random.default_rng(4)
    losses = rng.uniform(0.0, 3.0, 200).astype(np.float32)
    losses[:5] = losses[5]  # ties: the first lowest wins in both
    valid = rng.random(200) < 0.8
    comps = np.asarray(je.complexity_batch(jtree(b), jc))
    fields = [b[f] for f in jt.Tree._fields[:6]]
    jn = je.merge_best_seen(js, jc, jnp.asarray(losses), jnp.asarray(valid),
                            [jnp.asarray(f) for f in fields], jnp.asarray(b["length"]),
                            comps=jnp.asarray(comps))
    tn = te.merge_best_seen(ts, tc, torch.from_numpy(losses), torch.from_numpy(valid),
                            [torch.from_numpy(f) for f in fields],
                            torch.from_numpy(b["length"]), comps=torch.from_numpy(comps))
    assert_states_equal(jn, tn)


@pytest.mark.parametrize("batch_base", [False, True], ids=["full", "batch_base"])
def test_accept_and_scatter(batch_base):
    jo, to, jc, tc = configs(**MAPPING)
    js, ts = states(jo, jc, seed=2)
    I, P, N = jc.n_islands, jc.pop_size, jc.n_slots
    rng = np.random.default_rng(5)
    flat_idx = rng.choice(I * P, 30, replace=False)
    ii, pp = (flat_idx // P).astype(np.int32), (flat_idx % P).astype(np.int32)
    kind = np.asarray(js.kind)[ii, pp]
    mask = kind == 1
    val0 = np.asarray(js.val)[ii, pp]
    vals = (val0 * rng.uniform(0.5, 1.5, val0.shape)).astype(np.float32)
    loss0 = np.asarray(js.loss)[ii, pp]
    fbest = np.where(rng.random(30) < 0.5, loss0 * 0.5, loss0 * 2.0).astype(np.float32)
    base = rng.uniform(0.1, 5, 30).astype(np.float32) if batch_base else None
    norm = 2.5
    jn = jds._accept_and_scatter(
        js, jc, js.key, jnp.asarray(ii), jnp.asarray(pp), jnp.asarray(mask),
        jnp.asarray(val0), jnp.asarray(vals), jnp.asarray(fbest), 7.0,
        norm=jnp.asarray(norm, jnp.float32),
        base_loss=None if base is None else jnp.asarray(base),
    )
    tn = tds._accept_and_scatter(
        ts, tc, torch.from_numpy(ii).long(), torch.from_numpy(pp).long(),
        torch.from_numpy(mask), torch.from_numpy(val0), torch.from_numpy(vals),
        torch.from_numpy(fbest), 7.0, norm=torch.tensor(norm),
        base_loss=None if base is None else torch.from_numpy(base),
    )
    assert_states_equal(jn, tn)


def test_readback_pack_and_decode():
    jo, to, jc, tc = configs()
    js, ts = states(jo, jc, seed=3)
    jbuf = np.asarray(jds._make_readback_fn(jc)(js))
    tbuf = tds._readback_pack(ts).numpy()
    np.testing.assert_array_equal(jbuf, tbuf)
    for a, b in zip(jds._decode_readback(jbuf, jc), tds._decode_readback(tbuf, tc)):
        if isinstance(a, list):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


def _valid_lanes(t: tt.Tree, N):
    """FlatTrees of the lanes that fit the slots (the engine rejects the rest
    before scoring), and how many there are."""
    fits = (t.length <= N).numpy()
    return FlatTrees(*(np.asarray(x)[fits] for x in t)), int(fits.sum())


@pytest.mark.parametrize("kind", range(8), ids=["const", "operator", "swap", "add", "insert",
                                                "delete", "randomize", "nothing"])
def test_every_mutation_gives_valid_trees(kind):
    jo, to, jc, tc = configs()
    a = population(jo, 3000, 6)
    ctx = context(tc, to, seed=kind)
    t = ttree(a)
    sizes = tt.subtree_sizes(t)
    kinds = torch.full((3000,), kind)
    out = te._apply_mutation(ctx, t, kinds, 14, 0.7, sizes)
    flat, n_fit = _valid_lanes(out, jc.n_slots)
    assert n_fit > 2500
    verify_flat_trees(flat, to.operators, n_features=NFEAT, max_nodes=jc.n_slots,
                      allow_empty=False)
    if kind not in (3, 4, 6):  # growth and randomize change the structure
        if kind in (0, 7):
            np.testing.assert_array_equal(out.kind.numpy(), a["kind"])
        np.testing.assert_array_equal(out.length.numpy() <= a["length"], True)


def test_crossover_gives_valid_trees():
    jo, to, jc, tc = configs()
    a, b = population(jo, 3000, 7), population(jo, 3000, 8)
    ctx = context(tc, to)
    t1, t2 = ttree(a), ttree(b)
    c1, c2 = te._crossover(ctx, t1, t2, tt.subtree_sizes(t1), tt.subtree_sizes(t2))
    # node counts are conserved across the pair
    np.testing.assert_array_equal((c1.length + c2.length).numpy(), a["length"] + b["length"])
    for c in (c1, c2):
        flat, n_fit = _valid_lanes(c, jc.n_slots)
        assert n_fit > 2500
        verify_flat_trees(flat, to.operators, n_features=NFEAT, max_nodes=jc.n_slots,
                          allow_empty=False)


def test_mutation_kinds_follow_conditioned_weights():
    jo, to, jc, tc = configs()
    a = population(jo, 500, 9)
    t = tt.Tree(*(x.repeat(40, *([1] * (x.dim() - 1))) for x in ttree(a)))
    ctx = context(tc, to, seed=10)
    w = te._condition_weights(ctx, t, 10).double()
    expected = (w / w.sum(1, keepdim=True)).sum(0).numpy()
    counts = np.bincount(te._choose_kinds(ctx, t, 10).numpy(), minlength=8)
    used = expected > 5
    chi2 = float((((counts - expected) ** 2 / np.maximum(expected, 1e-12))[used]).sum())
    assert counts[~used].sum() <= 2
    # 7 degrees of freedom at most: the 0.1% critical value is 24.32
    assert chi2 < 24.32, (chi2, counts, expected)


@pytest.mark.parametrize("kw", [{}, dict(crossover_probability=0.3, **MAPPING),
                                dict(device_mutation_attempts=3, **CONSTRAINTS)],
                         ids=["default", "crossover_mapping", "attempts_constraints"])
def test_event_keeps_the_engine_bookkeeping(kw):
    jo, to, jc, tc = configs(**kw)
    rng = np.random.default_rng(11)
    X = rng.normal(size=(NFEAT, 100)).astype(np.float32)
    y = (np.cos(X[0]) * 2 + X[1]).astype(np.float32)
    js, _ = states(jo, jc, seed=4)
    ctx = context(tc, to, seed=12)
    ts = convert.evo_state_from_arrays(js)
    # real losses for the converted population
    tree = te.state_tree(ts)
    data = tds.ScoreData(torch.from_numpy(X), torch.from_numpy(y), None, torch.tensor(1.0))
    losses = ctx.score(tree, data).reshape(ts.loss.shape)
    ts = ts._replace(loss=losses, score=te._score_of(losses, ts.length.float(), tc, data.norm))
    for cycle in range(3):
        new = te._event(ts, data, ctx, 1.0 - cycle / 2, 14)
        I, P = ts.kind.shape[:2]
        E = min(tc.events_per_cycle, P)
        assert int(new.step) == int(ts.step) + 1
        # every lane replaces an old member (its baby or a parent copy), and
        # only replaced members change birth
        born = new.birth != ts.birth
        assert int(born.sum()) >= I * E
        assert bool((new.birth[born] == ts.step).all())
        # the histogram grows by whole accepted inserts, at most two per lane
        grown = float(new.freq.sum() - ts.freq.sum())
        assert grown == int(grown) and 0 <= grown <= 2 * I * E
        # best-seen losses never rise
        assert bool((new.bs_loss <= ts.bs_loss).all())
        flat = FlatTrees(*(x.numpy() for x in te.state_tree(new)))
        verify_flat_trees(flat, to.operators, n_features=NFEAT, max_nodes=tc.n_slots,
                          allow_empty=False)
        ts = new
