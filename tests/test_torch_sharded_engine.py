"""PyTorch port vs JAX package: the device engine on its in-process mesh
(islands over 'pop', rows over 'rows'), held to the bars of the JAX
package's ``tests/test_sharded_engine.py``.

The port's meshes name the CPU several times (``Options.mesh_devices``
where the public API must engage the mesh: the counterpart of conftest's 8
virtual CPU devices); each shard runs in its own thread and takes the plain
versions of the kernels.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu_torch.dataset import Dataset
from symbolicregression_jl_tpu_torch.models import device_search as ds
from symbolicregression_jl_tpu_torch.models.population import Population
from symbolicregression_jl_tpu_torch.ops.evolve import unshard_evo_state
from symbolicregression_jl_tpu_torch.ops.flat import FlatTrees, flatten_trees, unflatten_tree
from symbolicregression_jl_tpu_torch.ops.treeops import Tree
from symbolicregression_jl_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _problem(n=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0]).astype(np.float32)
    return X, y


def _opts(**kw):
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=8,
                population_size=16, ncycles_per_iteration=4, maxsize=14, save_to_file=False,
                seed=0, scheduler="device", device="cpu")
    base.update(kw)
    return T.Options(**base)


def _host_mse(tree, X, y, options):
    pred = tree.eval_np(X.astype(np.float64), options.operators)
    return float(np.mean((pred - y.astype(np.float64)) ** 2))


def _frontier(res, options):
    return [(m.get_complexity(options), repr(m.loss), m.tree.string_tree(options.operators))
            for m in sorted(res.hall_of_fame.pareto_frontier(),
                            key=lambda m: m.get_complexity(options))]


@pytest.mark.parametrize("weighted", [False, True])
def test_rows_sharded_scoring_matches_unsharded(weighted):
    """The engine's scorer over 4 row blocks, each combined over the rows
    axis, against the unsharded scorer on all rows: the same inf pattern,
    and the losses within f32 tolerance (each block's mean is rounded to f32
    before the f64 combination)."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(2, 64)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0]).astype(np.float32)
    w = (np.abs(rng.normal(size=(64,))) + 0.1).astype(np.float32) if weighted else None
    options = T.Options(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "log"],
                        maxsize=14, save_to_file=False, scheduler="device", device="cpu")
    dataset = Dataset(X, y, weights=w)
    mesh = tmesh.make_mesh(1, 4, devices=[CPU] * 4)
    datas = ds._make_score_data_rows(dataset, np.float32, mesh, 1.0)
    assert [tuple(d.X.shape) for d in datas] == [(2, 16)] * 4
    assert ds.score_data_specs(datas[0]) == ds.ScoreData(
        (None, "rows"), ("rows",), ("rows",) if weighted else None, ())
    scorers = [ds.EngineScorer(options, True, CPU, rows_axis=tmesh.mesh_axis(mesh, "rows", k))
               for k in range(4)]
    trees = Population.random_trees(48, options, 2, np.random.default_rng(3))
    flat = flatten_trees(trees, options.max_nodes)
    batch = Tree(*(torch.from_numpy(np.asarray(a)) for a in flat))
    got = tmesh.shard_map(lambda sh, sc, d: sc.losses(batch, d.X, d.y, d.w), mesh,
                          zip(scorers, datas))
    for g in got[1:]:
        assert torch.equal(g, got[0])
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    want = ds.EngineScorer(options, True, CPU).losses(
        batch, Xt, yt, None if w is None else torch.from_numpy(w)).numpy()
    got = got[0].numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    m = np.isfinite(want)
    assert m.sum() >= 10 and (~m).sum() >= 1
    np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-6)


def test_rows_sharded_engine_2d_mesh_frontier_and_const_opt():
    """Engine iterations and constant optimization on a (pop 2, rows 4)
    mesh: every live member's stored loss is its host full-data loss (rel
    1e-3, abs 1e-4), and every frontier loss too, which fails if a loss or
    gradient the engine used were one row block's instead of the combined
    one; the rows-replicated states stay equal."""
    options = _opts(populations=4, ncycles_per_iteration=3)
    X, y = _problem()
    dataset = Dataset(X, y)
    mesh = tmesh.make_mesh(2, 4, devices=[CPU] * 8)
    lane = ds._EngineLane(dataset, options, 2, np.random.default_rng(0), mesh=mesh)
    assert lane.ecfg_local.n_islands == 2
    copts = [ds.make_const_opt_fn(options, lane.ecfg_local, sc, c)
             for sc, c in zip(lane.scorers, lane.ctxs)]
    legs = []

    def leg(name):
        legs.append(name)
        return ds.contextlib.nullcontext()

    states = lane.states
    for _ in range(2):
        states = lane.iterate(states, leg, copts)
    assert legs == ["evolve", "const_opt"] * 2
    for k in range(1, 8):  # rows shards of one pop shard hold the same islands
        i, _ = mesh.coords(k)
        a, b = states[k], states[4 * i]
        for name in ("kind", "val", "loss", "bs_loss", "freq", "num_evals"):
            assert torch.equal(getattr(a, name), getattr(b, name)), (k, name)
    st = unshard_evo_state(states, mesh)
    I, P = options.populations, options.population_size
    n_checked = 0
    for i in range(I):
        fl = FlatTrees(*(getattr(st, f)[i].numpy() for f in
                         ("kind", "op", "lhs", "rhs", "feat", "val", "length")))
        for p in range(P):
            if fl.length[p] < 1 or not np.isfinite(float(st.loss[i, p])):
                continue
            true = _host_mse(unflatten_tree(fl, p), X, y, options)
            assert true == pytest.approx(float(st.loss[i, p]), rel=1e-3, abs=1e-4), (i, p)
            n_checked += 1
    assert n_checked >= I * P // 2
    bsf = FlatTrees(*(t.numpy() for t in st.bs_tree))
    for s in range(options.maxsize + 1):
        if bool(st.bs_exists[s]) and bsf.length[s] >= 1:
            true = _host_mse(unflatten_tree(bsf, s), X, y, options)
            assert true == pytest.approx(float(st.bs_loss[s]), rel=1e-3, abs=1e-5)
    assert float(st.num_evals) > 0


def test_device_search_engages_mesh_end_to_end():
    """Islands that divide over the devices: the public API runs the sharded
    engine (2 shards here), passes JAX's bar on the planted problem, and
    every member decodes."""
    X, y = _problem(n=100)
    options = _opts(ncycles_per_iteration=40, mesh_devices=["cpu"] * 2)
    res = T.equation_search(X, y, options=options, niterations=3, verbosity=0)
    assert res.engine_stats["mesh"]["shape"] == (2, 1)
    assert res.engine_stats["block"] is None
    assert min(m.loss for m in res.pareto_frontier) < 1.5
    assert all(m.tree.count_nodes() >= 1 for p in res.populations for m in p.members)
    assert len(res.populations) == 8
    for m in res.pareto_frontier:
        assert _host_mse(m.tree, X, y, options) == pytest.approx(m.loss, rel=1e-3, abs=1e-4)


def test_device_search_rows_sharding_end_to_end():
    """data_sharding='rows' with islands that do not divide over the
    devices: the rows axis takes every device, and the frontier's losses are
    the full data's."""
    X, y = _problem(n=400)
    options = _opts(populations=5, ncycles_per_iteration=30, data_sharding="rows",
                    mesh_devices=["cpu"] * 4)
    res = T.equation_search(X, y, options=options, niterations=3, verbosity=0)
    assert res.engine_stats["mesh"]["shape"] == (1, 4)
    assert min(m.loss for m in res.pareto_frontier) < 1.5
    for m in res.pareto_frontier:
        assert _host_mse(m.tree, X, y, options) == pytest.approx(m.loss, rel=1e-3, abs=1e-4)


def test_device_search_rows_sharding_with_batching():
    """Rows sharding with minibatches: each row shard draws its own rows,
    the batch losses are combined, finalize rescores on all rows, so the
    frontier is honest; the evaluation count uses the effective draw."""
    X, y = _problem(n=800)
    options = _opts(populations=4, ncycles_per_iteration=30, batching=True, batch_size=64,
                    data_sharding="rows", mesh_devices=["cpu"] * 4)
    res = T.equation_search(X, y, options=options, niterations=3, verbosity=0)
    assert res.engine_stats["mesh"]["shape"] == (1, 4)
    assert min(m.loss for m in res.pareto_frontier) < 2.0
    for m in res.pareto_frontier:
        assert _host_mse(m.tree, X, y, options) == pytest.approx(m.loss, rel=1e-3, abs=1e-4)


def test_mesh_runs_are_deterministic_and_layout_free():
    """The same seed gives the same bits twice, and four shards named as
    one device give the bits of the same four shards laid out 2 + 2."""
    X, y = _problem(n=80)
    runs = []
    for devices in (["cpu"] * 4, ["cpu"] * 4, ["cpu:0"] * 2 + ["cpu:1"] * 2):
        options = _opts(populations=4, population_size=12, ncycles_per_iteration=8,
                        mesh_devices=devices)
        res = T.equation_search(X, y, options=options, niterations=2, verbosity=0)
        assert res.engine_stats["mesh"]["shape"] == (4, 1)
        runs.append((_frontier(res, options), res.num_evals))
    assert runs[0] == runs[1] == runs[2]


def test_sharded_snapshot_resumes_unsharded(tmp_path):
    """A sharded run's snapshot holds the global islands in island order:
    it resumes on one device, and an unsharded snapshot resumes sharded."""
    X, y = _problem(n=80)
    ck = str(tmp_path / "ck.pkl")

    def options(devices):
        return _opts(populations=4, population_size=12, ncycles_per_iteration=5,
                     checkpoint_file=ck, checkpoint_every=1, mesh_devices=devices)

    T.equation_search(X, y, options=options(["cpu"] * 2), niterations=1, verbosity=0)
    snap = T.load_checkpoint(ck)
    assert len(snap.populations) == 4
    res = T.equation_search(X, y, options=options(None), niterations=2, verbosity=0,
                            resume_from=ck)
    assert "mesh" not in res.engine_stats and len(res.populations) == 4
    res = T.equation_search(X, y, options=options(["cpu"] * 2), niterations=3, verbosity=0,
                            resume_from=ck)
    assert res.engine_stats["mesh"]["shape"] == (2, 1) and len(res.populations) == 4


def test_profile_on_a_mesh_keeps_the_frontier():
    """``profile=True`` on a 2-shard mesh: the stage profiler fences every
    shard's device, reports the legs, and leaves the frontier of the same
    search with the synchronous readback unchanged."""
    X, y = _problem(n=80)
    kw = dict(populations=4, population_size=12, ncycles_per_iteration=6,
              mesh_devices=["cpu"] * 2)
    prof = T.equation_search(X, y, options=_opts(profile=True, **kw), niterations=2,
                             verbosity=0)
    plain = T.equation_search(X, y, options=_opts(async_readback=False, **kw), niterations=2,
                              verbosity=0)
    assert prof.engine_stats["mesh"]["shape"] == (2, 1)
    assert {"evolve", "const_opt"} <= set(prof.engine_profile["stages"])
    assert _frontier(prof, prof.options) == _frontier(plain, plain.options)


_WORLD_WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
pid = int(sys.argv[1])
from symbolicregression_jl_tpu_torch.parallel.distributed import initialize
initialize(coordinator_address="127.0.0.1:{port}", num_processes=2, process_id=pid)
import numpy as np
from symbolicregression_jl_tpu_torch import Options, equation_search
rng = np.random.default_rng(0)
X = rng.normal(size=(2, 100)).astype(np.float32)
y = (2 * np.cos(X[1]) + X[0]).astype(np.float32)
options = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=4,
                  population_size=16, ncycles_per_iteration=20, maxsize=14,
                  save_to_file=False, seed=0, scheduler="device", device="cpu",
                  mesh_devices=["cpu"] * 2)
res = equation_search(X, y, options=options, niterations=3, verbosity=0)
st = res.engine_stats
assert st["mesh"]["shape"] == (2, 1), st.get("mesh")
assert tuple(st["islands"]) == ((0, 2) if pid == 0 else (2, 4))
front = ";".join(f"{{m.get_complexity(options)}}:{{m.loss!r}}" for m in sorted(
    res.hall_of_fame.pareto_frontier(), key=lambda m: m.get_complexity(options)))
print(f"RESULT p{{pid}} bytes={{st['exchange_bytes'][0]}} frontier=[{{front}}]", flush=True)
"""


def test_world_of_two_processes_each_on_a_two_shard_mesh(tmp_path):
    """Two processes, each sharding its two islands over a mesh of two CPU
    shards: each merges its shards' topn pools on the mesh (the exchange's
    local stage) before the exchange, and both end with the same hall of
    fame."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORLD_WORKER.format(repo=REPO, port=port))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    lines = [next(l for l in out.splitlines() if l.startswith("RESULT")) for out, _ in outs]
    fronts = [l.split("frontier=")[1] for l in lines]
    assert fronts[0] == fronts[1] and fronts[0] != "[]"
