"""The port's checkpoints (``utils/checkpoint.py``), on the CPU.

Parity with the JAX package on the same seeded inputs: flat-encoded
populations equal bit for bit, ``parse_equation`` rebuilds the same trees,
a snapshot the JAX package wrote loads in the port (through the class
mapping, without importing the JAX package) with equal trees, losses, RNG
state and counters, a corrupted snapshot names the same invariant, and a
hall-of-fame CSV written by either package loads in the other.

The port on its own (``device="cpu"``): a lockstep search killed at
iteration 2 and resumed is bit-exact against the uninterrupted run; the
``ckpt_crash``, ``disk_full`` and ``nan_flood`` faults; retention; the
device engine's snapshots resume without losing their frontier, on the
event leg and on the block's plain version; ``SRRegressor.from_file``.
"""

import os
import pickle
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
import symbolicregression_jl_tpu_torch.models.device_search as tds
from symbolicregression_jl_tpu.utils import checkpoint as jck
from symbolicregression_jl_tpu.utils import faults as jf
from symbolicregression_jl_tpu_torch.utils import checkpoint as tck
from symbolicregression_jl_tpu_torch.utils import faults as tf

ROOT = Path(__file__).resolve().parents[1]
BIN = ["+", "-", "*", "/", "max"]
UNA = ["cos", "exp", "neg"]
OPS = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"])


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """Keep JAX in 32-bit mode (a test module run earlier in this process
    may have enabled x64) and torch on one thread (sums split by thread
    count would make results depend on the machine)."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_x64", x64)


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    tf.install(None)  # never leak an armed injector into other tests
    jf.install(None)


def _problem(n=80, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0]).astype(np.float32)
    return X, y


def _opts(tmp_path, **kw):
    base = dict(OPS, populations=2, population_size=12, ncycles_per_iteration=8, maxsize=12,
                seed=0, scheduler="lockstep", save_to_file=False, progress=False,
                checkpoint_file=str(tmp_path / "ck.pkl"))
    base.update(kw)
    return T.Options(device="cpu", **base)


def _engine_opts(tmp_path, **kw):
    base = dict(populations=4, population_size=16, ncycles_per_iteration=30, maxsize=14,
                scheduler="device", checkpoint_file=str(tmp_path / "dev.pkl"))
    base.update(kw)
    return _opts(tmp_path, **base)


def _frontier_str(res, options):
    return ";".join(
        f"{m.get_complexity(options)}:{m.loss:.17g}:{m.tree.string_tree(options.operators)}"
        for m in sorted(res.hall_of_fame.pareto_frontier(),
                        key=lambda m: m.get_complexity(options)))


def _best(res):
    return min(m.loss for m in res.pareto_frontier)


# --------------------------------------------------------------------------
# Trees built alike in both packages
# --------------------------------------------------------------------------


def _tree_spec(rng, depth, n_bin, n_una, nfeat):
    """A nested-tuple tree drawn from numpy, materialized by either package."""
    r = rng.uniform()
    if depth == 0 or r < 0.25:
        if rng.uniform() < 0.5:
            return ("x", int(rng.integers(nfeat)))
        c = float(rng.choice([rng.normal(), rng.normal() * 1e6, -rng.uniform() * 1e-7,
                              float(rng.integers(-3, 4)), 0.5]))
        return ("c", c)
    if r < 0.45:
        return ("u", int(rng.integers(n_una)), _tree_spec(rng, depth - 1, n_bin, n_una, nfeat))
    return ("b", int(rng.integers(n_bin)), _tree_spec(rng, depth - 1, n_bin, n_una, nfeat),
            _tree_spec(rng, depth - 1, n_bin, n_una, nfeat))


def _build(mod, spec):
    tag = spec[0]
    if tag == "x":
        return mod.feature(spec[1])
    if tag == "c":
        return mod.constant(spec[1])
    if tag == "u":
        return mod.unary(spec[1], _build(mod, spec[2]))
    return mod.binary(spec[1], _build(mod, spec[2]), _build(mod, spec[3]))


def _populations(mod, seed, sizes=(5, 7, 3)):
    """Populations of seeded random members with their metadata set alike."""
    rng = np.random.default_rng(seed)
    pops = []
    k = 0
    for size in sizes:
        members = []
        for _ in range(size):
            tree = _build(mod, _tree_spec(rng, 4, len(BIN), len(UNA), 3))
            m = mod.PopMember(tree, float(rng.normal()), float(rng.uniform(0, 5)),
                              complexity=None if k % 3 == 0 else int(rng.integers(1, 20)),
                              ref=1000 + k, parent=k - 1)
            m.birth = int(rng.integers(0, 50))
            members.append(m)
            k += 1
        pops.append(mod.Population(members))
    return pops


def _member_key(m, opset):
    return (m.tree.string_tree(opset, precision=17), m.score, m.loss, m.birth,
            m.complexity, m.ref, m.parent)


def _jopset():
    return J.Options(binary_operators=BIN, unary_operators=UNA).operators


def _topset():
    return T.Options(binary_operators=BIN, unary_operators=UNA, device="cpu").operators


# --------------------------------------------------------------------------
# Parity with the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flatten_populations_equals_jax(seed):
    fp = (tuple(BIN), tuple(UNA), 20, 3, 5, 100, 0)
    got = tck.flatten_populations(_populations(T, seed), fp)
    want = jck.flatten_populations(_populations(J, seed), fp)
    for f in ("kind", "op", "lhs", "rhs", "feat", "val", "length", "score", "loss",
              "complexity", "ref", "parent", "birth"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert (got.pop_sizes, got.n_binary, got.n_unary) == (want.pop_sizes, want.n_binary,
                                                          want.n_unary)
    # and decodes back to the members it encoded
    back = tck.restore_populations(got)
    opset = _topset()
    assert [[_member_key(m, opset) for m in p.members] for p in back] == [
        [_member_key(m, opset) for m in p.members] for p in _populations(T, seed)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("precision", [3, 17])
def test_parse_equation_matches_jax(seed, precision):
    """100 seeded trees per case: each package renders the same string and
    parses it back to the same tree (at precision 17, the tree itself)."""
    rng = np.random.default_rng(100 + seed)
    jops, tops = _jopset(), _topset()
    names = None if seed % 2 else ["alpha", "b_2", "x9"]
    for _ in range(100):
        spec = _tree_spec(rng, 5, len(BIN), len(UNA), 3)
        jt, tt = _build(J, spec), _build(T, spec)
        s = tt.string_tree(tops, names, precision=precision)
        assert s == jt.string_tree(jops, names, precision=precision)
        got = tck.parse_equation(s, tops, names)
        want = jck.parse_equation(s, jops, names)
        ft = T.flatten_trees([got], 64, dtype=np.float64)
        fj = J.flatten_trees([want], 64, dtype=np.float64)
        for a, b in zip(ft, fj):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), s
        if precision == 17:
            assert got.string_tree(tops, names, precision=17) == s
            assert T.flatten_trees([tt], 64, dtype=np.float64).val.tobytes() == ft.val.tobytes()


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    """A lockstep snapshot the JAX package wrote after iteration 2 of 3."""
    d = tmp_path_factory.mktemp("jax_ck")
    X, y = _problem()
    opts = J.Options(**OPS, populations=2, population_size=12, ncycles_per_iteration=8,
                     maxsize=12, seed=0, save_to_file=False, progress=False,
                     checkpoint_every=1, checkpoint_file=str(d / "ck.pkl"))
    J.equation_search(X, y, options=opts, niterations=2, verbosity=0)
    return str(d / "ck.pkl")


def test_jax_snapshot_loads_in_the_port(jax_snapshot):
    want = J.load_checkpoint(jax_snapshot)
    got = T.load_checkpoint(jax_snapshot)
    assert isinstance(got, tck.SearchCheckpoint)
    assert isinstance(got.hall_of_fame, T.HallOfFame)
    assert want.exact and not got.exact  # a JAX snapshot resumes as a warm start
    for f in ("iteration", "niterations", "scheduler", "num_evals", "counters",
              "options_fingerprint", "out_j", "format_version", "wall_time"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.rng_state == want.rng_state
    assert np.array_equal(got.stats_frequencies, want.stats_frequencies)
    tops, jops = _topset(), _jopset()
    tops = T.Options(**OPS, device="cpu").operators
    jops = J.Options(**OPS).operators
    assert len(got.populations) == len(want.populations) == 2
    for pg, pw in zip(got.populations, want.populations):
        assert isinstance(pg, T.Population)
        assert [_member_key(m, tops) for m in pg.members] == [
            _member_key(m, jops) for m in pw.members]
        assert all(isinstance(m, T.PopMember) and isinstance(m.tree, T.Node)
                   for m in pg.members)
    hg, hw = got.hall_of_fame, want.hall_of_fame
    assert [m is None for m in hg.members] == [m is None for m in hw.members]
    assert [_member_key(m, tops) for m in hg.members if m is not None] == [
        _member_key(m, jops) for m in hw.members if m is not None]
    meta = tck.peek_checkpoint_meta(jax_snapshot)
    assert meta["iteration"] == 2 and meta["scheduler"] == "lockstep" and not meta["exact"]


def test_pickled_classes_keep_the_jax_attributes():
    """The class mapping rests on these classes carrying the same state in
    both packages."""
    from symbolicregression_jl_tpu.tree import Node as JNode

    assert T.Node.__slots__ == JNode.__slots__
    assert T.PopMember.__slots__ == J.PopMember.__slots__
    assert vars(T.HallOfFame(7)).keys() == vars(J.HallOfFame(7)).keys()
    assert vars(T.Population([])).keys() == vars(J.Population([])).keys()
    import dataclasses

    for cls in ("SearchCheckpoint", "FlatPopulations"):
        assert [f.name for f in dataclasses.fields(getattr(tck, cls))] == [
            f.name for f in dataclasses.fields(getattr(jck, cls))]
    assert tck.CHECKPOINT_FORMAT == jck.CHECKPOINT_FORMAT


def _snapshot_bytes(mod, ckmod):
    pops = _populations(mod, 5)
    hof = mod.HallOfFame(20)
    ck = ckmod.SearchCheckpoint(
        iteration=1, niterations=3, scheduler="lockstep", exact=True, populations=pops,
        hall_of_fame=hof, num_evals=10.0,
        options_fingerprint=(tuple(BIN), tuple(UNA), 20, 3, 5, 100, 0))
    return ckmod.dump_checkpoint_bytes(ck)


def _corrupt(flat, how):
    from symbolicregression_jl_tpu_torch.ops.flat import KIND_BINARY

    bin_rows, bin_slots = np.nonzero(flat.kind == KIND_BINARY)
    p, s = int(bin_rows[0]), int(bin_slots[0])
    if how == "lhs":
        flat.lhs[p, s] = s
    elif how == "kind":
        flat.kind[p, 0] = 9
    elif how == "op":
        flat.op[p, s] = len(BIN) + 3
    elif how == "length":
        flat.length[1] = 0
    elif how == "pad":
        short = int(np.argmin(flat.length))
        flat.kind[short, int(flat.length[short])] = 1
    elif how == "pop_sizes":
        flat.pop_sizes = [flat.pop_sizes[0] + 1] + flat.pop_sizes[1:]
    elif how == "rhs":
        flat.rhs[p, s] = s + 1


def _tag(exc):
    m = re.search(r"\[(\w+)\]", str(exc))
    return m.group(1) if m else str(exc)


@pytest.mark.parametrize("how", ["lhs", "rhs", "kind", "op", "length", "pad", "pop_sizes"])
def test_corrupt_snapshot_names_the_jax_invariant(how, tmp_path):
    """The same corruption of a JAX-written and a port-written snapshot:
    both packages raise CheckpointError naming the same invariant."""
    tags = []
    for mod, ckmod in ((J, jck), (T, tck)):
        ck = pickle.loads(_snapshot_bytes(mod, ckmod))
        _corrupt(ck.populations, how)
        data = pickle.dumps(ck)
        loaders = [tck.load_checkpoint_bytes]
        if mod is J:
            loaders.append(jck.load_checkpoint_bytes)
        for load in loaders:
            with pytest.raises(tck.CheckpointError if load is tck.load_checkpoint_bytes
                               else jck.CheckpointError) as e:
                load(data)
            tags.append(_tag(e.value))
        path = tmp_path / f"{mod.__name__}.pkl.000000"
        path.write_bytes(data)
        with pytest.raises(tck.CheckpointError, match=re.escape(str(path))):
            T.load_checkpoint(str(path))
    assert len(set(tags)) == 1 and tags[0] != "", tags


@pytest.mark.parametrize("how", ["truncated", "not_a_snapshot"])
def test_unreadable_snapshot_raises_in_both(how, tmp_path):
    data = _snapshot_bytes(J, jck)
    data = data[: len(data) // 2] if how == "truncated" else pickle.dumps({"iteration": 1})
    base = tmp_path / "ck.pkl"
    (tmp_path / "ck.pkl.000003").write_bytes(data)
    msg = "cannot unpickle" if how == "truncated" else "not a SearchCheckpoint"
    for load in (J.load_checkpoint, T.load_checkpoint):
        with pytest.raises(ValueError, match=msg):
            load(str(base))
    with pytest.raises(tck.CheckpointError, match=msg):
        tck.peek_checkpoint_meta(str(base))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        T.load_checkpoint(str(tmp_path / "other.pkl"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hall_of_fame_csv_crosses_both_ways(writer, tmp_path):
    """A CSV (with its .meta.json sidecar) written by either package loads
    in the other to the same frontier, member for member."""
    from symbolicregression_jl_tpu.utils.export_csv import save_hall_of_fame as jsave
    from symbolicregression_jl_tpu_torch.utils.export_csv import save_hall_of_fame as tsave

    jopt = J.Options(binary_operators=BIN, unary_operators=UNA, maxsize=30)
    topt = T.Options(binary_operators=BIN, unary_operators=UNA, maxsize=30, device="cpu")
    path = str(tmp_path / "hof.csv")
    mod, opt, save = (J, jopt, jsave) if writer == "jax" else (T, topt, tsave)
    hof = mod.HallOfFame(opt.maxsize)
    for pop in _populations(mod, 9, sizes=(30,)):
        for m in pop.members:
            m.complexity = None
            m.loss = 10.0 / m.tree.count_nodes() ** 2  # a long frontier
            hof.update(m, opt)
    save(path, hof, opt, ["a", "b", "c"], num_evals=1234.0)
    states = [J.load_saved_state(path, jopt, ["a", "b", "c"]),
              T.load_saved_state(path, topt, ["a", "b", "c"])]
    rows = [[(r["complexity"], r["loss"], r["equation"]) for r in s.report()] for s in states]
    assert rows[0] == rows[1] and len(rows[0]) >= 3
    assert states[0].num_evals == states[1].num_evals == 1234.0
    ops = [jopt.operators, topt.operators]
    frontier = [[m.tree.string_tree(o, precision=17) for m in s.pareto_frontier]
                for s, o in zip(states, ops)]
    assert frontier[0] == frontier[1]


def test_port_imports_with_jax_blocked(jax_snapshot):
    """Every module of the port imports (the stream package among them),
    and a JAX-written snapshot loads, in a process where importing jax or
    the JAX package fails."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "symbolicregression_jl_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import symbolicregression_jl_tpu_torch as T
        from symbolicregression_jl_tpu_torch.stream import multitarget_search
        assert T.multitarget_search is multitarget_search
        n = 0
        for info in pkgutil.walk_packages(T.__path__, T.__name__ + "."):
            importlib.import_module(info.name)
            n += 1
        ck = T.load_checkpoint({jax_snapshot!r})
        assert ck.iteration == 2 and not ck.exact and ck.populations
        assert not any(m == "jax" or m.startswith(("jax.", "symbolicregression_jl_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok", n)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok") and int(out.stdout.split()[1]) > 30


# --------------------------------------------------------------------------
# The port on its own: lockstep
# --------------------------------------------------------------------------


def test_lockstep_kill_and_resume_is_bit_exact(tmp_path):
    """A lockstep search killed at the start of iteration 2 and resumed from
    its snapshot gives a hall of fame identical to the uninterrupted run's."""
    X, y = _problem()
    full = T.equation_search(X, y, options=_opts(tmp_path), niterations=4, verbosity=0)
    killed = _opts(tmp_path, checkpoint_every=1, fault_spec="peer_death@2:mode=raise")
    with pytest.raises(tf.FaultInjected):
        T.equation_search(X, y, options=killed, niterations=4, verbosity=0)
    base = str(tmp_path / "ck.pkl")
    assert T.latest_checkpoint(base) is not None
    ck = T.load_checkpoint(base)
    assert ck.iteration == 2 and ck.exact and ck.scheduler == "lockstep"
    resumed = T.equation_search(X, y, options=_opts(tmp_path, checkpoint_every=1),
                                niterations=4, verbosity=0, resume_from=base)
    opts = _opts(tmp_path)
    assert _frontier_str(resumed, opts) == _frontier_str(full, opts)
    assert resumed.num_evals == full.num_evals
    # the resumed run went on writing snapshots after its ancestors'
    assert T.load_checkpoint(base).iteration == 4


def test_resume_from_and_saved_state_are_exclusive(tmp_path):
    X, y = _problem()
    with pytest.raises(ValueError, match="mutually exclusive"):
        T.equation_search(X, y, options=_opts(tmp_path), niterations=1, verbosity=0,
                          resume_from=str(tmp_path / "ck.pkl"), saved_state=object())


def test_resume_from_missing_checkpoint_raises(tmp_path):
    X, y = _problem()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        T.equation_search(X, y, options=_opts(tmp_path), niterations=1, verbosity=0,
                          resume_from=str(tmp_path / "nothing.pkl"))


def test_fingerprint_mismatch_warns_and_warm_starts(tmp_path):
    X, y = _problem()
    T.equation_search(X, y, options=_opts(tmp_path, checkpoint_every=1), niterations=2,
                      verbosity=0)
    with pytest.warns(UserWarning, match="different search options"):
        res = T.equation_search(X, y, options=_opts(tmp_path, maxsize=14), niterations=3,
                                verbosity=0, resume_from=str(tmp_path / "ck.pkl"))
    assert np.isfinite(_best(res))


def test_ckpt_crash_leaves_previous_snapshot_loadable(tmp_path):
    X, y = _problem()
    opts = _opts(tmp_path, checkpoint_every=1, fault_spec="ckpt_crash@1")
    with pytest.raises(tf.CheckpointWriteCrash):
        T.equation_search(X, y, options=opts, niterations=4, verbosity=0)
    base = str(tmp_path / "ck.pkl")
    assert T.load_checkpoint(base).iteration == 1  # snapshot 0 survived
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")], "no .tmp orphan"
    resumed = T.equation_search(X, y, options=_opts(tmp_path), niterations=4, verbosity=0,
                                resume_from=base)
    assert np.isfinite(_best(resumed))


def test_checkpoint_enospc_keeps_previous_snapshot_and_run_alive(tmp_path):
    X, y = _problem()
    opts = _opts(tmp_path, checkpoint_every=1, fault_spec="disk_full@3:path=ckpt")
    res = T.equation_search(X, y, options=opts, niterations=4, verbosity=0)
    assert np.isfinite(_best(res))
    assert T.load_checkpoint(str(tmp_path / "ck.pkl")).iteration == 3
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    # journal-only rules do not touch checkpoints
    (tmp_path / "b").mkdir()
    opts2 = _opts(tmp_path / "b", checkpoint_every=1, fault_spec="disk_full@0:path=journal")
    T.equation_search(X, y, options=opts2, niterations=2, verbosity=0)
    assert T.load_checkpoint(str(tmp_path / "b" / "ck.pkl")).iteration == 2


def test_checkpoint_retention_prunes_old_snapshots(tmp_path):
    X, y = _problem()
    opts = _opts(tmp_path, checkpoint_every=1, checkpoint_keep=2)
    T.equation_search(X, y, options=opts, niterations=5, verbosity=0)
    snaps = sorted(f for f in os.listdir(tmp_path)
                   if f.startswith("ck.pkl.") and f.split(".")[-1].isdigit())
    assert snaps == ["ck.pkl.000003", "ck.pkl.000004"]
    assert T.load_checkpoint(str(tmp_path / "ck.pkl")).iteration == 5


def test_checkpointer_cadence():
    ck = tck.SearchCheckpointer("/nonexistent/base", every_iterations=2)
    assert [ck.due(i) for i in range(5)] == [False, False, True, False, True]
    assert tck.SearchCheckpointer.from_options(T.Options(device="cpu"), "b") is None
    timed = tck.SearchCheckpointer("/nonexistent/base", every_seconds=1e-9)
    assert timed.due(1)


def test_nan_flood_quarantine_recovers_lockstep(tmp_path):
    X, y = _problem()
    opts = _opts(tmp_path, fault_spec="nan_flood@1:frac=0.9")
    res = T.equation_search(X, y, options=opts, niterations=3, verbosity=0)
    frontier = res.hall_of_fame.pareto_frontier()
    assert frontier and all(np.isfinite(m.loss) for m in frontier)
    finite = [np.isfinite(m.loss) for pop in res.populations for m in pop.members]
    assert np.mean(finite) > 0.5


def test_nan_flood_then_kill_then_resume(tmp_path):
    X, y = _problem()
    opts = _opts(tmp_path, checkpoint_every=1,
                 fault_spec="nan_flood@1:frac=0.9;peer_death@3:mode=raise")
    with pytest.raises(tf.FaultInjected):
        T.equation_search(X, y, options=opts, niterations=5, verbosity=0)
    base = str(tmp_path / "ck.pkl")
    ck = T.load_checkpoint(base)
    assert ck.iteration == 3
    assert np.mean([np.isfinite(m.loss) for p in ck.populations for m in p.members]) > 0.5
    resumed = T.equation_search(X, y, options=_opts(tmp_path), niterations=5, verbosity=0,
                                resume_from=base)
    frontier = resumed.hall_of_fame.pareto_frontier()
    assert frontier and all(np.isfinite(m.loss) for m in frontier)


def test_jax_snapshot_resumes_as_a_warm_start(jax_snapshot, tmp_path):
    X, y = _problem()
    ck = T.load_checkpoint(jax_snapshot)
    res = T.equation_search(X, y, options=_opts(tmp_path), niterations=3, verbosity=0,
                            resume_from=jax_snapshot)
    ck_best = min(m.loss for m in ck.pareto_frontier)
    assert _best(res) <= ck_best * (1 + 1e-5) + 1e-6
    assert res.num_evals > ck.num_evals


# --------------------------------------------------------------------------
# The port on its own: the device engine
# --------------------------------------------------------------------------


@pytest.fixture(params=["event", "block"])
def engine_leg(request, monkeypatch):
    """The engine's evolve leg on the CPU: the event leg, or the block's
    plain version (SR_ENGINE_BLOCK=1)."""
    if request.param == "block":
        monkeypatch.setenv("SR_ENGINE_BLOCK", "1")
    else:
        monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
    return request.param


def test_engine_snapshot_resume_keeps_its_frontier(tmp_path, engine_leg):
    X, y = _problem(n=100)
    r1 = T.equation_search(X, y, options=_engine_opts(tmp_path, checkpoint_every=2),
                           niterations=4, verbosity=0)
    assert r1.engine_stats["block"] == ("plain" if engine_leg == "block" else None)
    assert len(r1.engine_stats["checkpoint_seconds"]) == 2
    ck = T.load_checkpoint(str(tmp_path / "dev.pkl"))
    assert ck.scheduler == "device" and not ck.exact and ck.iteration == 4
    assert ck.num_evals > 0 and ck.populations and ck.pareto_frontier
    assert sum(p.n for p in ck.populations) == 4 * 16
    r2 = T.equation_search(X, y, options=_engine_opts(tmp_path, checkpoint_file=str(
        tmp_path / "d2.pkl")), niterations=ck.iteration + 1, verbosity=0,
        resume_from=str(tmp_path / "dev.pkl"))
    assert r2.engine_stats["iterations"] == 1
    ck_best = min(m.loss for m in ck.pareto_frontier)
    assert _best(r2) <= ck_best + 1e-5
    assert r2.num_evals > ck.num_evals


def test_engine_kill_and_resume(tmp_path, engine_leg):
    X, y = _problem(n=100)
    opts = _engine_opts(tmp_path, checkpoint_every=1, fault_spec="peer_death@2:mode=raise")
    with pytest.raises(tf.FaultInjected):
        T.equation_search(X, y, options=opts, niterations=4, verbosity=0)
    ck = T.load_checkpoint(str(tmp_path / "dev.pkl"))
    assert (ck.iteration, ck.exact, ck.scheduler) == (2, False, "device")
    res = T.equation_search(X, y, options=_engine_opts(tmp_path), niterations=4,
                            verbosity=0, resume_from=str(tmp_path / "dev.pkl"))
    assert res.engine_stats["iterations"] == 2
    assert _best(res) <= min(m.loss for m in ck.pareto_frontier) + 1e-5
    assert res.num_evals > ck.num_evals


def test_engine_nan_flood_recovers(tmp_path, engine_leg):
    X, y = _problem(n=100)
    opts = _engine_opts(tmp_path, fault_spec="nan_flood@1:frac=0.75")
    res = T.equation_search(X, y, options=opts, niterations=3, verbosity=0)
    assert res.engine_stats["nan_flooded_islands"] == 3
    frontier = res.hall_of_fame.pareto_frontier()
    assert frontier and all(np.isfinite(m.loss) for m in frontier)


def test_engine_const_opt_leaves_nan_members_alone(tmp_path, monkeypatch):
    """The const-opt leg on a population whose first two islands' losses
    are NaN: those members keep their constants and NaN losses, and every
    other island gets exactly what it gets without the flood."""
    checks = []
    real = tds.make_const_opt_fn

    def spy(options, cfg, scorer, ctx):
        fn = real(options, cfg, scorer, ctx)

        def wrapped(state, data):
            g = ctx.gen.get_state()
            clean = fn(state, data)
            ctx.gen.set_state(g)
            bad = (torch.arange(cfg.n_islands) < 2)[:, None]
            flooded = fn(state._replace(loss=torch.where(bad, torch.nan, state.loss)), data)
            checks.append((state, clean, flooded))
            return clean
        return wrapped

    monkeypatch.setattr(tds, "make_const_opt_fn", spy)
    X, y = _problem(n=100)
    T.equation_search(X, y, options=_engine_opts(tmp_path, optimizer_probability=0.5),
                      niterations=2, verbosity=0)
    assert len(checks) == 2
    for state, clean, flooded in checks:
        assert torch.equal(flooded.val[2:], clean.val[2:])
        assert torch.equal(flooded.loss[2:], clean.loss[2:])
        assert torch.equal(flooded.score[2:], clean.score[2:])
        assert torch.equal(flooded.val[:2], state.val[:2])
        assert bool(torch.isnan(flooded.loss[:2]).all())
        # the clean run did tune members of those islands
        assert not torch.equal(clean.val[:2], state.val[:2])


# --------------------------------------------------------------------------
# SRRegressor.from_file
# --------------------------------------------------------------------------


def _reg_kw(tmp_path, **kw):
    base = dict(OPS, populations=2, population_size=12, ncycles_per_iteration=20,
                maxsize=12, seed=0, progress=False, device="cpu",
                output_file=str(tmp_path / "hof.csv"))
    base.update(kw)
    return base


def test_regressor_from_file_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    Xs = rng.normal(size=(100, 2)).astype(np.float32)
    ys = (2 * np.cos(Xs[:, 1]) + Xs[:, 0] ** 2 - 2).astype(np.float32)
    kw = _reg_kw(tmp_path)
    m1 = T.SRRegressor(niterations=3, **kw)
    m1.fit(Xs, ys)
    best1 = min(r["loss"] for r in m1.equations_)
    m2 = T.SRRegressor.from_file(str(tmp_path / "hof.csv"), niterations=1, **kw)
    pred = m2.predict(Xs)  # before any fit
    assert pred.shape == ys.shape and np.isfinite(pred).all()
    assert [r["equation"] for r in m2.equations_] == [r["equation"] for r in m1.equations_]
    assert min(r["loss"] for r in m2.equations_) == pytest.approx(best1, rel=1e-6)
    assert m2.state_.num_evals == pytest.approx(m1.state_.num_evals)
    m2.set_params(ncycles_per_iteration=1)
    m2.fit(Xs, ys)  # warm start: no ground lost on the same data
    assert min(r["loss"] for r in m2.equations_) <= best1 + 1e-6


def test_multitarget_from_file_checks_its_paths(tmp_path):
    rng = np.random.default_rng(1)
    Xs = rng.normal(size=(60, 2)).astype(np.float32)
    Ys = np.stack([np.cos(Xs[:, 1]), Xs[:, 0] * 2.0], 1).astype(np.float32)
    kw = _reg_kw(tmp_path, niterations=1)
    kw.pop("niterations")
    T.MultitargetSRRegressor(niterations=1, **kw).fit(Xs, Ys)
    paths = [str(tmp_path / f"hof.csv.out{j}") for j in (1, 2)]
    model = T.MultitargetSRRegressor.from_file(paths, n_outputs=2, **kw)
    assert len(model.state_) == 2
    assert model.predict(Xs).shape == (60, 2)
    with pytest.raises(ValueError, match="n_outputs=3"):
        T.MultitargetSRRegressor.from_file(paths, n_outputs=3, **kw)
    with pytest.raises(ValueError, match="exactly one path"):
        T.SRRegressor.from_file(paths, **kw)
    with pytest.raises(ValueError, match="single-output"):
        T.SRRegressor.from_file(paths[0], n_outputs=2, **kw)
    with pytest.raises(ValueError, match="2 saved output state"):
        model.fit(Xs, np.concatenate([Ys, Ys[:, :1]], 1))
