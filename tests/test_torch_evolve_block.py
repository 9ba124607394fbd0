"""PyTorch port vs JAX package: the kernel-resident evolve block
(ops/evolve_block.py) and the preds-matrix kernel's plain version.

The block's draws are a counter hash, so, unlike the event leg, the port and
the JAX package share trajectories for one seed. Integer results (hash bits,
u01 values, pointers, mutated words, lengths, tournament winners, replacement
slots, births, best-seen words) must be equal; constants, which pass through
log/cos/pow in f32 (libm differs by an ulp between XLA and PyTorch), agree to
rtol 1e-5. The trajectory test runs both cycles with one injected evaluator,
an exact integer function of words and length, so every decision is shared
and must stay equal cycle after cycle. The whole-iteration test scores with
the real evaluators: JAX sums the loss in f32 over its row tile, the port in
f64, so losses there agree to rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu.ops import evolve_block as jb
from symbolicregression_jl_tpu.ops.evolve import EvoConfig as JEvoConfig
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.models.mutation_functions import gen_random_tree
from symbolicregression_jl_tpu_torch.ops import evolve_block as tb
from symbolicregression_jl_tpu_torch.ops import interp_cuda
from symbolicregression_jl_tpu_torch.ops.evolve import EvoConfig as TEvoConfig
from symbolicregression_jl_tpu_torch.ops.evolve import EvoContext
from symbolicregression_jl_tpu_torch.ops.flat import (
    FlatTrees, flatten_trees, pack_programs, unpack_programs,
)

CONST_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """JAX in 32-bit mode (an earlier module in this process may have turned
    x64 on) and one torch thread (sums split by thread count would depend on
    the machine)."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", x64)


CFG = dict(
    n_islands=3, pop_size=12, n_slots=16, maxsize=13, maxdepth=8, nfeatures=2, n_unary=2,
    n_binary=3, tournament_n=3, tournament_weights=(0.6, 0.25, 0.15),
    mutation_weights=(0.2, 0.2, 0.1, 0.2, 0.1, 0.1, 0.05, 0.05), crossover_probability=0.0,
    annealing=True, alpha=0.1, parsimony=0.0032, use_frequency=True,
    use_frequency_in_tournament=True, adaptive_parsimony_scaling=20.0,
    perturbation_factor=0.076, probability_negate_constant=0.3, baseline_loss=1.0,
    use_baseline=True, ncycles=10, events_per_cycle=4, fraction_replaced=0.0,
    fraction_replaced_hof=0.0, migration=False, hof_migration=False, topn=4, niterations=4,
    warmup_maxsize_by=0.0,
)


def _cfgs(**kw):
    d = dict(CFG, **kw)
    return JEvoConfig(**d), TEvoConfig(**d)


OPSET = T.Options(binary_operators=["+", "-", "*"], unary_operators=["cos", "exp"],
                  device="cpu").operators


def _trees(n, N, seed, max_len=8, nfeat=2):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        t = gen_random_tree(int(rng.integers(1, max_len + 1)), OPSET, nfeat, rng)
        if t.count_nodes() <= N:
            out.append(t)
    return out


def _edge_flat(N):
    """Rows on the edges: a lone constant, a lone feature, an all-leaf
    garbage row (not stack-sound), a unary chain of length N, and a tree
    with no constants and no binary nodes."""
    kind = np.zeros((5, N), np.int32)
    op = np.zeros_like(kind)
    feat = np.zeros_like(kind)
    val = np.zeros((5, N), np.float32)
    length = np.array([1, 1, N, N, 3], np.int32)
    kind[0, 0], val[0, 0] = 1, 1.5
    kind[1, 0], feat[1, 0] = 2, 1
    kind[2, :] = np.where(np.arange(N) % 2 == 0, 1, 2)
    val[2] = np.where(kind[2] == 1, 0.25, 0.0)
    kind[3, 0], kind[3, 1:] = 2, 3
    op[3, 1:] = np.arange(N - 1) % 2
    kind[4, :3] = (2, 3, 3)
    lhs = np.zeros_like(kind)
    lhs[3, 1:] = np.arange(N - 1)
    lhs[4, 1:3] = (0, 1)
    return FlatTrees(kind, op, lhs, np.zeros_like(kind), feat, val, length)


def _packed(flat):
    pk = pack_programs(flat)
    return pk.words.astype(np.int32), pk.consts.astype(np.float32), pk.length


def _batch(N, n=40, seed=0):
    """Packed random trees plus the edge rows: (words, consts, length)."""
    flat = flatten_trees(_trees(n, N, seed), N)
    w, c, ln = _packed(flat)
    ew, ec, el = _packed(_edge_flat(N))
    return np.concatenate([w, ew]), np.concatenate([c, ec]), np.concatenate([ln, el])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_same(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind == "f":
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=name)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=CONST_RTOL, atol=1e-6,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64),
                                      err_msg=name)


# --------------------------------------------------------------------------
# The counter hash
# --------------------------------------------------------------------------


def test_hash_bits_u01_and_randint_are_bit_exact():
    seeds = [0, 1, 12345, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]
    cycles = [0, 1, 7, 549, 2**31 + 5]
    lanes = np.arange(0, 2000, 37, dtype=np.int32)
    draws = list(range(52))
    for seed in seeds:
        for cycle in cycles:
            for d in draws:
                want = np.asarray(jb._blk_bits(jnp.uint32(seed), jnp.uint32(cycle),
                                               jnp.asarray(lanes), d))
                got = tb._blk_bits(seed, cycle, _t(lanes), d)
                np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
                np.testing.assert_array_equal(
                    tb._blk_u01(got).numpy(), np.asarray(jb._blk_u01(jnp.asarray(want))))
    # a seed held in a tensor (the engine's device draw) gives the same bits
    got = tb._blk_bits(torch.tensor(2**32 - 1), torch.tensor(3), _t(lanes), 5)
    want = np.asarray(jb._blk_bits(jnp.uint32(2**32 - 1), jnp.uint32(3), jnp.asarray(lanes), 5))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    u = np.concatenate([np.linspace(0, 1, 997, endpoint=False, dtype=np.float32),
                        np.float32([1 - 2**-24, 0.5, 0.999999])])
    for n in (1, 2, 3, 7, 100, 2**20):
        np.testing.assert_array_equal(tb._randint(_t(u), n).numpy(),
                                      np.asarray(jb._randint(jnp.asarray(u), n)))
    nvec = (np.arange(u.size) % 13 + 1).astype(np.int32)
    np.testing.assert_array_equal(tb._randint(_t(u), _t(nvec)).numpy(),
                                  np.asarray(jb._randint(jnp.asarray(u), jnp.asarray(nvec))))
    u1, u2 = u[::-1].copy(), u
    _assert_same("normal", tb._blk_normal(_t(u1), _t(u2)).numpy(),
                 np.asarray(jb._blk_normal(jnp.asarray(u1), jnp.asarray(u2))))


# --------------------------------------------------------------------------
# Structure on packed words
# --------------------------------------------------------------------------


def test_block_pointers_and_unpack_match_jax():
    """On stack-sound rows (every row the block makes; row 42 of the batch
    is the garbage row, which only the kernel's stack pass reproduces)."""
    N = 16
    w, c, ln = _batch(N)
    sound = np.r_[0:40, 40, 41, 43, 44]
    got = tb._block_pointers(_t(w[sound]), _t(ln[sound]))
    want = jb._block_pointers(jnp.asarray(w[sound]), jnp.asarray(ln[sound]))
    for name, g, wv in zip(("lhs", "rhs", "start", "depth"), got, want):
        _assert_same(name, g.numpy(), wv)
    got_u = tb.unpack_pointers(_t(w[sound]), _t(ln[sound]))
    want_u = jb.unpack_pointers_jnp(jnp.asarray(w[sound]), jnp.asarray(ln[sound]))
    for name, g, wv in zip(("kind", "op", "lhs", "rhs", "feat"), got_u, want_u):
        _assert_same(name, g.numpy(), wv)
    # the pass rebuilds flatten_trees' pointers
    flat = unpack_programs(pack_programs(FlatTrees(
        *(g.numpy() for g in got_u), c[sound], ln[sound])))
    np.testing.assert_array_equal(flat.lhs, got_u[2].numpy())
    np.testing.assert_array_equal(flat.rhs, got_u[3].numpy())


def test_pack_state_words_matches_pack_words():
    N = 16
    flat = flatten_trees(_trees(30, N, 3), N)
    words, consts = tb.pack_state_words(*(_t(np.asarray(getattr(flat, f)))
                                          for f in ("kind", "op", "feat", "val")))
    pk = pack_programs(flat)
    np.testing.assert_array_equal(words.numpy(), pk.words.astype(np.int32))
    np.testing.assert_array_equal(consts.numpy(), pk.consts)


def _mut_inputs(N, seed=0):
    w, c, ln = _batch(N, seed=seed)
    L = w.shape[0]
    live = np.arange(N)[None, :] < ln[:, None]
    kind = np.where(live, w & 7, 0).astype(np.int32)
    lanes = np.arange(L, dtype=np.int32)
    us = {d: np.asarray(jb._blk_u01(jb._blk_bits(jnp.uint32(99), jnp.uint32(seed),
                                                 jnp.asarray(lanes), d)))
          for d in range(32, 52)}
    return w, c, ln, kind, live, lanes, us


@pytest.mark.parametrize("seed", [0, 1])
def test_each_mutation_matches_jax(seed):
    N = 16
    jcfg, tcfg = _cfgs()
    w, c, ln, kind, live, lanes, us = _mut_inputs(N, seed)
    lhs, rhs, start, _ = jb._block_pointers(jnp.asarray(w), jnp.asarray(ln))
    J_ = lambda a: jnp.asarray(a)  # noqa: E731
    tl, tr, ts = (_t(np.asarray(a)) for a in (lhs, rhs, start))
    temperature = np.float32(0.375)
    max_change = tb.f32(np.float32(tcfg.perturbation_factor) * temperature
                        + np.float32(1.0) + np.float32(0.1))
    u = lambda d: us[d]  # noqa: E731
    cases = {
        "constant": (
            jb._mut_constant(J_(w), J_(c), J_(ln), J_(kind), J_(live), u(34), u(37), u(38),
                             u(39), jcfg, jnp.float32(temperature)),
            tb._mut_constant(_t(w), _t(c), _t(ln), _t(kind), _t(live), _t(u(34)), _t(u(37)),
                             _t(u(38)), _t(u(39)), tcfg, max_change)),
        "operator": (
            jb._mut_operator(J_(w), J_(c), J_(ln), J_(kind), J_(live), u(34), u(40), u(41),
                             jcfg),
            tb._mut_operator(_t(w), _t(c), _t(ln), _t(kind), _t(live), _t(u(34)), _t(u(40)),
                             _t(u(41)), tcfg)),
        "rotate": (
            jb._mut_rotate(J_(w), J_(c), J_(ln), J_(kind), J_(live), lhs, rhs, start, u(34),
                           jcfg),
            tb._mut_rotate(_t(w), _t(c), _t(ln), _t(kind), _t(live), tl, tr, ts, _t(u(34)),
                           tcfg)),
        "add": (
            jb._mut_add(J_(w), J_(c), J_(ln), J_(kind), J_(live), jnp.uint32(99),
                        jnp.uint32(seed), J_(lanes), u(34), u(35), jcfg),
            tb._mut_add(_t(w), _t(c), _t(ln), _t(kind), _t(live), 99, seed, _t(lanes),
                        _t(u(34)), _t(u(35)), tcfg)),
        "insert": (
            jb._mut_insert(J_(w), J_(c), J_(ln), start, jnp.uint32(99), jnp.uint32(seed),
                           J_(lanes), u(34), u(35), jcfg),
            tb._mut_insert(_t(w), _t(c), _t(ln), 99, seed, _t(lanes), _t(u(34)), _t(u(35)),
                           tcfg)),
        "delete": (
            jb._mut_delete(J_(w), J_(c), J_(ln), J_(kind), J_(live), lhs, rhs, start, u(34),
                           u(35), jcfg),
            tb._mut_delete(_t(w), _t(c), _t(ln), _t(kind), _t(live), tl, tr, ts, _t(u(34)),
                           _t(u(35)), tcfg)),
    }
    for name, (want, got) in cases.items():
        for field, g, wv in zip(("words", "consts", "length"), got, want):
            _assert_same(f"{name} {field}", g.numpy(), wv)
    # every mutation keeps live rows stack-sound
    for name, (_, (mw, mc, ml)) in cases.items():
        sound = np.r_[0:40, 40, 41, 43, 44]
        mw, mc, ml = mw.numpy()[sound], mc.numpy()[sound], ml.numpy()[sound]
        ok = ml <= N
        tail = np.arange(N)[None, :] >= ml[:, None]
        unpack_programs(pack_programs(convert.flat_trees(dict(zip(
            ("kind", "op", "lhs", "rhs", "feat", "val", "length"),
            (*(a.numpy() for a in tb.unpack_pointers(_t(np.where(tail, 0, mw)[ok]),
                                                      _t(ml[ok]))),
             np.where(tail, 0, mc)[ok], ml[ok]))))))


def test_tournament_and_oldest_slots_match_jax():
    jcfg, tcfg = _cfgs(tournament_n=5, tournament_weights=(0.3, 0.25, 0.2, 0.15, 0.1))
    rng = np.random.default_rng(4)
    I, P, E = 3, 12, 4
    # ties on purpose: scores and sizes from a few values
    score = rng.choice(np.float32([0.5, 0.75, 1.0, np.inf, 2.0]), (I, P)).astype(np.float32)
    length = rng.integers(1, 14, (I, P)).astype(np.int32)
    fnorm = rng.dirichlet(np.ones(14)).astype(np.float32)
    birth = rng.integers(0, 5, (I, P)).astype(np.int32)
    for cycle in range(6):
        want = np.concatenate([np.asarray(jb._blk_tournament(
            jnp.asarray(score[i]), jnp.asarray(length[i]), jnp.asarray(fnorm), jnp.uint32(7),
            jnp.int32(cycle), i * E + jnp.arange(E, dtype=jnp.int32), jcfg)) for i in range(I)])
        lane = torch.arange(I * E, dtype=torch.int32)
        got = tb._blk_tournament(_t(score), _t(length), _t(fnorm), 7, cycle, lane,
                                 (lane // E).long(), tcfg)
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.stack([np.asarray(jb._oldest_slots(jnp.asarray(birth[i]), E)) for i in range(I)])
    np.testing.assert_array_equal(tb._oldest_slots(_t(birth), E).numpy(), want)


def test_block_eligible_verdicts_match_jax():
    cases = [dict(), dict(batching=True, eval_fraction=0.5), dict(eval_fraction=0.5),
             dict(complexity_table=((1.0,) * 3, (1.0,) * 2, 1.0, (1.0, 1.0))),
             dict(bin_caps=((3, -1), (-1, -1), (-1, -1)), una_caps=(-1, -1)),
             dict(nested_constraints=((1, 0, ((1, 0, 0),)),)),
             dict(mutation_attempts=2), dict(val_dtype="float64"),
             dict(events_per_cycle=13)]
    for kw in cases:
        jcfg, tcfg = _cfgs(**kw)
        assert tb.block_eligible(tcfg) == jb.block_eligible(jcfg), kw


# --------------------------------------------------------------------------
# The cycle, with one injected evaluator
# --------------------------------------------------------------------------


def _exact_eval(xp, iota_fn):
    """A deterministic loss both packages compute exactly from words and
    length: an integer hash, made f32 exactly; every 11th hash is inf."""
    def eval_fn(vw, vc, vlen):
        N = vw.shape[-1]
        iota = iota_fn(N)
        live = iota[None, :] < vlen[:, None]
        h = (xp.where(live, vw * (iota[None, :] + 1), 0)).sum(-1)
        h = (h * 37 + vlen) % 1009
        loss = h.astype(xp.float32) / 64.0 if xp is jnp else h.to(torch.float32) / 64.0
        return xp.where(h % 11 == 0, xp.inf, loss)
    return eval_fn


def _population(cfg, seed):
    I, P, N = cfg["n_islands"], cfg["pop_size"], cfg["n_slots"]
    rng = np.random.default_rng(seed)
    flat = flatten_trees(_trees(I * P, N, seed, max_len=9, nfeat=cfg["nfeatures"]), N)
    w, c, ln = _packed(flat)
    w = w.reshape(I, P, N)
    c = c.reshape(I, P, N)
    ln = ln.reshape(I, P)
    loss = rng.uniform(0.1, 5.0, (I, P)).astype(np.float32)
    loss[0, 3] = np.inf
    score = (loss / np.float32(1.5) + ln.astype(np.float32) * np.float32(0.0032))
    birth = rng.integers(0, 6, (I, P)).astype(np.int32)
    fnorm = rng.dirichlet(np.ones(cfg["maxsize"] + 1)).astype(np.float32)
    return (w, c, ln, loss, score.astype(np.float32), birth), fnorm


@pytest.mark.parametrize("kw", [dict(), dict(annealing=False, use_frequency=False,
                                             use_frequency_in_tournament=False,
                                             n_unary=0, tournament_n=1,
                                             tournament_weights=(1.0,), n_slots=12,
                                             maxsize=10, maxdepth=6, ncycles=8)],
                         ids=["annealing_frequency", "plain_unary_free"])
def test_block_cycle_trajectory_matches_jax(kw, monkeypatch):
    """Ten cycles from one numpy population, one seed, one fnorm, one exact
    evaluator: every integer field equal after every cycle."""
    _trajectory_matches_jax(kw, monkeypatch)


@pytest.mark.parametrize("kw", [dict(), dict(annealing=False, use_frequency=False,
                                             use_frequency_in_tournament=False)],
                         ids=["annealing_frequency", "plain"])
def test_block_cycle_nan_flooded_matches_jax(kw, monkeypatch):
    """The trajectory test on a population a ``nan_flood`` fault left: the
    losses of the leading round(0.75 I) islands are NaN, and a third of
    their scores too (what the const-opt leg writes for the NaN members it
    tuned). Tournaments, accepts, best-seen merges and replacement see NaN
    and stay equal to JAX's."""
    _trajectory_matches_jax(kw, monkeypatch, flood=0.75)


def _trajectory_matches_jax(kw, monkeypatch, flood=None):
    # the integer pointer pass compiled (exact either way), for speed
    monkeypatch.setattr(jb, "_block_pointers", jax.jit(jb._block_pointers))
    jcfg, tcfg = _cfgs(**kw)
    I = tcfg.n_islands
    pop, fnorm = _population(dict(CFG, **kw), seed=5)
    if flood is not None:
        k = max(1, int(round(I * flood)))
        loss, score = pop[3].copy(), pop[4].copy()
        loss[:k] = np.nan
        score[:k, ::3] = np.nan
        pop = pop[:3] + (loss, score) + pop[5:]
    seed, step0, cms, norm = 0xDEADBEEF, 40, 11, np.float32(1.5)
    j_eval = _exact_eval(jnp, lambda n: jnp.arange(n, dtype=jnp.int32))
    t_eval = _exact_eval(torch, lambda n: torch.arange(n, dtype=torch.int32))

    # eagerly, op by op: under jit, XLA's CPU backend contracts a * b + c
    # into one fused multiply-add (the score), which the port and its
    # kernel (built with --fmad=false) do not
    def j_step(carry, cycle):
        return jax.vmap(lambda c, i: jb._block_cycle(
            c, cycle, i, jnp.uint32(seed), jnp.int32(step0), jnp.int32(cms),
            jnp.asarray(fnorm), jnp.float32(norm), jcfg, j_eval, 4))(
            carry, jnp.arange(I, dtype=jnp.int32))

    S1 = tcfg.maxsize + 1
    N = tcfg.n_slots
    # one numpy carry, handed to both packages
    carry0 = pop + (np.zeros((I, S1), np.float32), np.full((I, S1), np.inf, np.float32),
                    np.zeros((I, S1, N), np.int32), np.zeros((I, S1, N), np.float32),
                    np.zeros((I, S1), np.int32))
    j_carry = tuple(jnp.asarray(a) for a in carry0)
    t_carry = convert.block_carry_from_arrays(carry0)
    for name, a, b in zip(convert.BLOCK_FIELDS, convert.block_carry_arrays(t_carry),
                          convert.block_carry_arrays(tb.block_carry0(t_carry[:6], tcfg))):
        _assert_same(f"carry0 {name}", a, b)
    changed = 0
    for cycle in range(tcfg.ncycles):
        j_carry = j_step(j_carry, jnp.int32(cycle))
        t_carry = tb.block_cycle(t_carry, cycle, seed, torch.tensor(step0, dtype=torch.int32),
                                 cms, _t(fnorm), torch.tensor(norm), tcfg, t_eval)
        for name, g, w in zip(convert.BLOCK_FIELDS, convert.block_carry_arrays(t_carry),
                              j_carry):
            _assert_same(f"cycle {cycle} {name}", g, w)
        changed += int((t_carry[0].numpy() != pop[0]).any(-1).sum())
    assert changed > 0


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_block_cycle_stages_match_jax(stages):
    """The profile's cut cycles (stop after mutation, the check or scoring)
    leave the carry as JAX's do, folding a NaN checksum into every loss of
    its island; the evaluator here makes island 1's scoring NaN."""
    jcfg, tcfg = _cfgs()
    I, E = tcfg.n_islands, tcfg.events_per_cycle
    pop, fnorm = _population(CFG, seed=7)
    S1, N = tcfg.maxsize + 1, tcfg.n_slots
    carry0 = pop + (np.zeros((I, S1), np.float32), np.full((I, S1), np.inf, np.float32),
                    np.zeros((I, S1, N), np.int32), np.zeros((I, S1, N), np.float32),
                    np.zeros((I, S1), np.int32))
    seed, step0, cms, norm = 12345, 3, 13, np.float32(1.5)
    j_exact = _exact_eval(jnp, lambda n: jnp.arange(n, dtype=jnp.int32))
    t_exact = _exact_eval(torch, lambda n: torch.arange(n, dtype=torch.int32))

    # under vmap, JAX's evaluator sees one island's E lanes
    j_out = jax.vmap(lambda c, i: jb._block_cycle(
        c, jnp.int32(0), i, jnp.uint32(seed), jnp.int32(step0), jnp.int32(cms),
        jnp.asarray(fnorm), jnp.float32(norm), jcfg,
        lambda vw, vc, vlen: jnp.where(i == 1, jnp.nan, j_exact(vw, vc, vlen)), stages))(
        tuple(jnp.asarray(a) for a in carry0), jnp.arange(I, dtype=jnp.int32))

    def t_eval(vw, vc, vlen):  # every island's lanes at once
        isl = torch.arange(vw.shape[0]) // E
        return torch.where(isl == 1, torch.nan, t_exact(vw, vc, vlen))

    t_out = tb.block_cycle(convert.block_carry_from_arrays(carry0), 0, seed,
                           torch.tensor(step0, dtype=torch.int32), cms, _t(fnorm),
                           torch.tensor(norm), tcfg, t_eval, stages)
    for name, g, w in zip(convert.BLOCK_FIELDS, convert.block_carry_arrays(t_out), j_out):
        _assert_same(f"stages {stages} {name}", g, w)
    loss = convert.block_carry_arrays(t_out)[3]
    assert np.isnan(loss[1]).all() == (stages == 3)
    assert not np.isnan(loss[[0, 2]]).any()


# --------------------------------------------------------------------------
# The whole iteration, with the real evaluators
# --------------------------------------------------------------------------


def test_run_block_iteration_matches_jax():
    """One cycle of run_block_iteration from one JAX state: JAX's reference
    evaluator against the port's plain evaluator, the seed passed to the
    port as JAX derives it from the state's key."""
    from symbolicregression_jl_tpu.ops.evolve import init_state as j_init
    from symbolicregression_jl_tpu.ops.flat import FlatTrees as JFlat
    from symbolicregression_jl_tpu.ops.interp_pallas import _reshape_rows
    from symbolicregression_jl_tpu.ops.operators import resolve_operators as j_ops

    jcfg, tcfg = _cfgs(ncycles=1, n_islands=2, pop_size=8, events_per_cycle=4, n_slots=8,
                       maxsize=7, maxdepth=6)
    I, P, N = 2, 8, 8
    flat = flatten_trees(_trees(I * P, N, 8), N)
    rng = np.random.default_rng(0)
    R = 100
    X = rng.normal(size=(2, R)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    tX, ty = _t(X), _t(y)
    losses = interp_cuda.plain_losses(flat, _t(flat.val), tX, ty, None, OPSET,
                                      T.Options(device="cpu").loss).numpy()
    jstate = j_init(JFlat(*(np.asarray(a) for a in flat)), losses, jcfg, seed=0)
    jopset = j_ops(["+", "-", "*"], ["cos", "exp"])

    def loss_elem(pred, yv):
        d = pred - yv
        return d * d

    Xr, yr, wr, _, _ = _reshape_rows(X, y, None)

    class Data:
        norm = jnp.float32(1.0)

    eval_fn = jb.make_reference_eval(jopset, loss_elem, Xr, yr, wr, R)
    j_out = jax.jit(lambda st: jb.run_block_iteration(st, Data(), jcfg, eval_fn=eval_fn))(jstate)
    _, k_blk = jax.random.split(jstate.key)
    kd = np.asarray(jax.random.key_data(k_blk) if not jnp.issubdtype(k_blk.dtype, jnp.integer)
                    else k_blk).reshape(-1).astype(np.uint32)
    seed = int(kd[0] ^ kd[1])

    tstate = convert.evo_state_from_arrays(jstate)
    ctx = EvoContext(tcfg, "cpu", torch.Generator().manual_seed(0), None)

    class TData:
        norm = torch.tensor(1.0)

    t_eval = tb.make_plain_eval(OPSET, T.Options(device="cpu").loss, tX, ty, None)
    t_out = tb.run_block_iteration(tstate, TData(), ctx, eval_fn=t_eval, seed=seed)
    want = convert.evo_state_arrays(t_out)
    for name in convert.EVO_FIELDS:
        j = getattr(j_out, name)
        if name == "bs_tree":
            for k, (a, b) in enumerate(zip(want[name], j)):
                _assert_same(f"bs_tree[{k}]", a, np.asarray(b))
        else:
            _assert_same(name, want[name], np.asarray(j))
    assert int(t_out.step) == int(jstate.step) + 1


# --------------------------------------------------------------------------
# Wrappers and B4's plain version
# --------------------------------------------------------------------------


def test_wrappers_raise_on_a_meta_tensor():
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block

    _, cfg = _cfgs()
    I, P, N, S1 = cfg.n_islands, cfg.pop_size, cfg.n_slots, cfg.maxsize + 1
    m = dict(device="meta")
    pop = (torch.zeros((I, P, N), dtype=torch.int32, **m), torch.zeros((I, P, N), **m),
           torch.ones((I, P), dtype=torch.int32, **m), torch.zeros((I, P), **m),
           torch.zeros((I, P), **m), torch.zeros((I, P), dtype=torch.int32, **m))
    scal = (torch.zeros((), dtype=torch.int64, **m), torch.zeros((), dtype=torch.int32, **m),
            torch.zeros((), dtype=torch.int32, **m), torch.ones((), **m))
    X, y = torch.zeros((2, 10), **m), torch.zeros(10, **m)
    opts = T.Options(device="cpu", binary_operators=["+", "-", "*"], unary_operators=["cos"])
    with pytest.raises(ValueError, match="unsupported device"):
        evolve_block(*pop, torch.zeros(S1, **m), *scal, X, y, None, cfg, opts.operators,
                     opts.loss)
    flat = flatten_trees(_trees(4, N, 0), N)
    with pytest.raises(ValueError, match="unsupported device"):
        interp_cuda.eval_trees_kernel(flat, X, opts.operators)
    prog, vals = interp_cuda.pack_programs_fused(flat, opts.operators)
    with pytest.raises(ValueError, match="unsupported device"):
        interp_cuda.eval_preds(torch.from_numpy(prog).to("meta"),
                               torch.from_numpy(vals).to("meta"), X, opts.operators)


def test_eval_preds_plain_version_matches_jax():
    """B4's plain version (the port's eval_trees, which eval_trees_kernel
    takes on the CPU) against the JAX package's eval_trees on 64 trees x
    777 rows."""
    from symbolicregression_jl_tpu.ops import flatten_trees as j_flatten
    from symbolicregression_jl_tpu.ops.interp import eval_trees as j_eval_trees
    from symbolicregression_jl_tpu.models.population import Population as JPopulation

    kw = dict(binary_operators=["+", "-", "*", "/", "pow"],
              unary_operators=["cos", "exp", "abs", "log", "sqrt"], maxsize=20,
              save_to_file=False)
    jopts = J.Options(**kw)
    topts = T.Options(device="cpu", **kw)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(5, 777)).astype(np.float32)
    trees = JPopulation.random_trees(64, jopts, 5, rng)
    jflat = j_flatten(trees, jopts.max_nodes)
    want = np.asarray(j_eval_trees(jflat, jnp.asarray(X), jopts.operators))
    got = interp_cuda.eval_trees_kernel(convert.flat_trees(jflat), _t(X), topts.operators)
    got = got.numpy()
    assert got.shape == (64, 777)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-5)


def test_eval_preds_takes_the_plain_version_on_the_cpu():
    """B4's launcher on packed programs: on CPU tensors it is the plain
    version, equal to eval_trees on the same batch, and launches nothing."""
    flat = flatten_trees(_trees(24, 16, 3), 16)
    X = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 101)).astype(np.float32))
    prog, vals = interp_cuda.pack_programs_fused(flat, OPSET)
    before = interp_cuda.eval_trees_kernel.launches
    got = interp_cuda.eval_preds(torch.from_numpy(prog), torch.from_numpy(vals), X, OPSET)
    want = interp_cuda.eval_trees_kernel(flat, X, OPSET)
    assert interp_cuda.eval_trees_kernel.launches == before
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
