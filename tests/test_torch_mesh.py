"""PyTorch port vs JAX package: the in-process mesh's primitives
(``parallel/mesh.py``: ``local_devices``, ``shard_map`` and its collectives,
``intra_host_pool_merge``; ``ops/evolve.py``: the sharded ``merge_best_seen``,
the event's frequency-delta and count reductions, ``shard_evo_state``;
``models/device_search.fleet_eligibility``'s mesh reasons).

The JAX side runs ``shard_map`` over the 8 virtual CPU devices of
``tests/conftest.py``; the port's meshes name the CPU several times, one
thread per shard. On the same numpy inputs the results are equal, exactly.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as PS

import symbolicregression_jl_tpu as J
from symbolicregression_jl_tpu.models.device_search import (
    build_evo_config as j_build_evo_config,
    fleet_eligibility as j_fleet_eligibility,
)
from symbolicregression_jl_tpu.ops import evolve as jev
from symbolicregression_jl_tpu.parallel import mesh as jmesh
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu_torch.models import device_search as ds
from symbolicregression_jl_tpu_torch.models.population import Population
from symbolicregression_jl_tpu_torch.ops import evolve as tev
from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees
from symbolicregression_jl_tpu_torch.parallel import mesh as tmesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8-device virtual CPU platform")

CPU = torch.device("cpu")
OPS = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], maxsize=10,
           save_to_file=False, scheduler="device")


@pytest.fixture(autouse=True, scope="module")
def _f32_jax():
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", x64)


def _cpu_mesh(n_pop, n_rows=1):
    return tmesh.make_mesh(n_pop, n_rows, devices=[CPU] * (n_pop * n_rows))


# ---------------------------------------------------------------------------
# local_devices and the collectives
# ---------------------------------------------------------------------------


def test_local_devices_names():
    """"cuda" means every visible card (at least one name), "cuda:N" that
    card alone, "cpu" one CPU; the caches' key names the card."""
    assert tmesh.local_devices("cpu") == [CPU]
    assert tmesh.local_devices("cuda:3") == [torch.device("cuda", 3)]
    everyone = tmesh.local_devices("cuda")
    assert everyone and all(d.type == "cuda" and d.index is not None for d in everyone)
    assert tmesh.indexed_device("cpu") == CPU
    assert tmesh.indexed_device("cuda:2") == torch.device("cuda", 2)


def test_shard_map_collectives_in_shard_order():
    """On a (2, 4) mesh every shard sees its coordinates, and each axis's
    all_gather, psum and pmin over exactly its group, in axis order."""
    mesh = _cpu_mesh(2, 4)

    def f(sh, x):
        pop, rows = sh.axis("pop"), sh.axis("rows")
        return (sh.coords, pop.index, rows.index, pop.all_gather(x), rows.psum(x),
                pop.pmin(x))

    xs = [torch.tensor([float(k), -float(k)]) for k in range(8)]
    out = tmesh.shard_map(f, mesh, [(x,) for x in xs])
    for k, (coords, pi, ri, g, s, m) in enumerate(out):
        i, j = divmod(k, 4)
        assert coords == (i, j) and (pi, ri) == (i, j)
        assert torch.equal(g, torch.stack([xs[j], xs[4 + j]]))
        want = xs[4 * i] + xs[4 * i + 1] + xs[4 * i + 2] + xs[4 * i + 3]
        assert torch.equal(s, want)
        assert torch.equal(m, torch.minimum(xs[j], xs[4 + j]))
    stats = tmesh.collective_stats(mesh)
    assert stats["pop"]["gathers"] == 2 * 4 and stats["rows"]["gathers"] == 2
    assert stats["pop"]["transport"] == "copy"


def test_a_shard_that_raises_ends_every_shard():
    """A shard that raises aborts the others' collectives: ``shard_map``
    raises the shard's own error at once, long before the barrier's
    timeout, and the mesh runs again afterwards."""
    mesh = _cpu_mesh(4)

    def f(sh, x):
        if sh.k == 2:
            raise KeyError("shard 2")
        for _ in range(3):
            x = sh.axis("pop").psum(x)
        return x

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="shard 2"):
        tmesh.shard_map(f, mesh, [(torch.ones(1),)] * 4)
    assert time.perf_counter() - t0 < 30
    assert threading.active_count() < 50
    out = tmesh.shard_map(lambda sh, x: sh.axis("pop").psum(x), mesh, [(torch.ones(1),)] * 4)
    assert all(float(o) == 4.0 for o in out)


def test_a_collective_nobody_joins_times_out(monkeypatch):
    """A collective that one shard never joins fails every shard within the
    barrier's timeout (``BARRIER_TIMEOUT_S``), as ``MeshAborted``."""
    monkeypatch.setattr(tmesh, "BARRIER_TIMEOUT_S", 0.5)
    mesh = _cpu_mesh(2)

    def f(sh, x):
        if sh.k == 0:
            return x
        return sh.axis("pop").psum(x)

    t0 = time.perf_counter()
    with pytest.raises(tmesh.MeshAborted):
        tmesh.shard_map(f, mesh, [(torch.ones(1),)] * 2)
    assert time.perf_counter() - t0 < 20


# ---------------------------------------------------------------------------
# exact parity with JAX's shard_map
# ---------------------------------------------------------------------------


def _states(I=8, P=6, seed=0):
    """The same initial state in both packages (8 islands of P members)."""
    jopts = J.Options(populations=I, population_size=P, **OPS)
    topts = T.Options(populations=I, population_size=P, device="cpu", **OPS)
    rng = np.random.default_rng(seed)
    trees = Population.random_trees(I * P, topts, 2, rng)
    flat = flatten_trees(trees, topts.max_nodes)
    losses = rng.uniform(0.1, 3.0, size=I * P).astype(np.float32)
    jcfg = j_build_evo_config(jopts, n_features=2, baseline_loss=1.0, use_baseline=True,
                              niterations=2)
    tcfg = ds.build_evo_config(topts, n_features=2, baseline_loss=1.0, use_baseline=True,
                               niterations=2)
    jst = jev.init_state(flat, losses, jcfg, seed=1)
    tst = tev.init_state(flat, losses, tcfg, CPU)
    return jcfg, tcfg, jst, tst, flat


def _candidates(n_shards, B, N, S, seed):
    """Per shard B scored candidates: sizes 0..S, losses on a coarse grid
    (ties within and across shards), some invalid, and distinct fields."""
    rng = np.random.default_rng(seed)
    n = n_shards * B
    lengths = rng.integers(1, S + 1, size=n).astype(np.int32)
    losses = (rng.integers(1, 6, size=n) * 0.25).astype(np.float32)
    valid = rng.uniform(size=n) < 0.8
    fields = [rng.integers(0, 50, size=(n, N)).astype(np.int32) for _ in range(5)]
    fields.append(rng.normal(size=(n, N)).astype(np.float32))
    return lengths, losses, valid, fields


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_merge_best_seen_equals_jax(n_shards):
    """``merge_best_seen`` over the island axis: the global lowest loss per
    size, the lowest shard index winning ties, the owner's tree and length:
    the port's frontier equals JAX's on every shard."""
    jcfg, tcfg, jst, tst, _ = _states()
    S, N = tcfg.maxsize, tcfg.n_slots
    B = 12
    lengths, losses, valid, fields = _candidates(n_shards, B, N, S, seed=n_shards)
    # a first round so the stored frontier is not all inf
    lengths0, losses0, valid0, fields0 = _candidates(1, 6, N, S, seed=99)

    jmesh_ = jmesh.make_mesh(n_shards, 1, jax.devices()[:n_shards])

    def jmerge(st, l0, v0, f0, n0, l, v, f, n):
        st = jev.merge_best_seen(st, jcfg, l0, v0, list(f0), n0)
        return jev.merge_best_seen(st, jcfg, l, v, list(f), n, axis="pop")

    rep = jax.tree_util.tree_map(lambda _: PS(), jst)
    fn = jmesh.shard_map_compat(
        jmerge, jmesh_,
        in_specs=(rep, PS(), PS(), (PS(),) * 6, PS(), PS("pop"), PS("pop"),
                  (PS("pop"),) * 6, PS("pop")),
        out_specs=rep, check_vma=False)
    jout = jax.jit(fn)(jst, jnp.asarray(losses0), jnp.asarray(valid0),
                       tuple(jnp.asarray(f) for f in fields0), jnp.asarray(lengths0),
                       jnp.asarray(losses), jnp.asarray(valid),
                       tuple(jnp.asarray(f) for f in fields), jnp.asarray(lengths))

    tm = _cpu_mesh(n_shards)

    def tmerge(sh, st):
        st = tev.merge_best_seen(st, tcfg, torch.from_numpy(losses0), torch.from_numpy(valid0),
                                 [torch.from_numpy(f) for f in fields0],
                                 torch.from_numpy(lengths0))
        part = slice(sh.k * B, (sh.k + 1) * B)
        return tev.merge_best_seen(
            st, tcfg, torch.from_numpy(losses[part]), torch.from_numpy(valid[part]),
            [torch.from_numpy(f[part]) for f in fields], torch.from_numpy(lengths[part]),
            axis=sh.axis("pop"))

    touts = tmesh.shard_map(tmerge, tm, [(tst,)] * n_shards)
    for tout in touts:
        np.testing.assert_array_equal(tout.bs_loss.numpy(), np.asarray(jout.bs_loss))
        np.testing.assert_array_equal(tout.bs_exists.numpy(), np.asarray(jout.bs_exists))
        for a, b in zip(tout.bs_tree, jout.bs_tree):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(np.asarray(jout.bs_exists).sum()) > 3


def test_frequency_delta_and_count_reductions_equal_jax():
    """The event's cross-shard reductions: the frequency delta (whole
    numbers) and the scored count (whole numbers times the eval fraction)
    summed over 8 shards equal JAX's ``psum``s bit for bit."""
    rng = np.random.default_rng(5)
    S1 = 11
    fd = rng.integers(0, 7, size=(8, S1)).astype(np.float32)
    n_scored = (rng.integers(10, 40, size=8) * 0.375).astype(np.float32)
    jm = jmesh.make_mesh(8, 1, jax.devices()[:8])
    fn = jmesh.shard_map_compat(
        lambda a, b: (jax.lax.psum(a, "pop"), jax.lax.psum(b, "pop")), jm,
        in_specs=(PS("pop"), PS("pop")), out_specs=(PS(), PS()), check_vma=False)
    jfd, jn = jax.jit(fn)(jnp.asarray(fd.reshape(-1)), jnp.asarray(n_scored))
    jfd = np.asarray(jfd).reshape(-1)

    def f(sh):
        extra = torch.zeros((S1, 2), dtype=torch.float64)
        extra[:, 0] = torch.from_numpy(fd[sh.k])
        extra[0, 1] = float(n_scored[sh.k])
        return sh.axis("pop").psum(extra)

    for out in tmesh.shard_map(f, _cpu_mesh(8), [()] * 8):
        np.testing.assert_array_equal(out[:, 0].float().numpy(), jfd)
        np.testing.assert_array_equal(jfd, fd.sum(0))
        assert float(out[0, 1]) == float(np.asarray(jn).reshape(-1)[0])


def test_intra_host_pool_merge_equals_jax():
    """The exchange's local stage: per-shard pool leaves gathered over the
    pop axis in island order, on every shard, equal to JAX's merge."""
    rng = np.random.default_rng(7)
    leaves = (rng.integers(0, 9, size=(8, 3, 5)).astype(np.int32),
              rng.normal(size=(8, 3)).astype(np.float32),
              rng.integers(0, 4, size=(8,)).astype(np.int32))
    jm = jmesh.make_mesh(4, 1, jax.devices()[:4])
    placed = [jax.device_put(a, NamedSharding(jm, PS("pop"))) for a in leaves]
    jout = jmesh.intra_host_pool_merge(jm)(*placed)
    parts = [tuple(torch.from_numpy(a[2 * k:2 * k + 2]) for a in leaves) for k in range(4)]
    touts = tmesh.intra_host_pool_merge(_cpu_mesh(4))(parts)
    assert len(touts) == 4
    for tout in touts:
        for a, b in zip(tout, jout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n_pop", [2, 4])
def test_shard_evo_state_split_equals_jax(n_pop):
    """``shard_evo_state``: island leaves split in island order, replicated
    leaves copied, each shard's block equal to the block JAX places on the
    mesh device of the same position; ``unshard_evo_state`` gives the
    state back."""
    jcfg, tcfg, jst, tst, _ = _states()
    jm = jmesh.make_mesh(n_pop, 1, jax.devices()[:n_pop])
    jsh = jev.shard_evo_state(jst, jm)
    tm = _cpu_mesh(n_pop)
    tsh = tev.shard_evo_state(tst, tm)
    assert len(tsh) == n_pop
    devs = list(jm.devices.reshape(-1))
    specs = tev.evo_state_specs()
    for name in tev.EvoState._fields:
        jleaf = getattr(jsh, name)
        if name == "bs_tree":
            for k, st in enumerate(tsh):
                for a, b in zip(st.bs_tree, jleaf):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            continue
        blocks = {s.device: np.asarray(s.data) for s in jleaf.addressable_shards}
        for k, st in enumerate(tsh):
            want = blocks[devs[k]]
            got = getattr(st, name).numpy()
            np.testing.assert_array_equal(got.astype(want.dtype), want)
        assert tuple(getattr(specs, name)) == tuple(getattr(jev.evo_state_specs(), name))
    back = tev.unshard_evo_state(tsh, tm)
    for a, b in zip(tev._leaves(back), tev._leaves(tst)):
        assert torch.equal(a[1], b[1])


def test_fleet_eligibility_mesh_reasons_equal_jax():
    """Over 8 devices (JAX's conftest devices; the port's ``mesh_devices``),
    the two mesh reasons (rows sharding; islands that divide over the
    devices) word for word JAX's, and a search the mesh would not take
    stays eligible in both; without ``mesh_devices`` the port's searches
    stay on one device and eligible."""
    base = dict(binary_operators=["+"], save_to_file=False, scheduler="device")
    for kw in (dict(data_sharding="rows", populations=5), dict(populations=16),
               dict(populations=6)):
        want = j_fleet_eligibility(J.Options(**base, **kw))
        got = ds.fleet_eligibility(T.Options(device="cpu", mesh_devices=["cpu"] * 8,
                                             **base, **kw))
        assert got == want, kw
        assert ds.fleet_eligibility(T.Options(device="cpu", **base, **kw)) is None
    assert ds.fleet_eligibility(T.Options(device="cpu", populations=6, **base)) is None
