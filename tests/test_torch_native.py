"""The port's C tree flattening (``native/srcore.c``) against its plain
Python version and the JAX package.

Everything here is host-side integer or bit work, so the bar is exact:
every int array equal and every constant equal as ``uint32`` bits, between
the port's C path (``flatten_trees`` on f32), its plain version
(``flatten_trees_plain``) and the JAX package's ``flatten_trees``; the same
for the packed slab (``FlatSlab``) against ``pack_programs_fused`` and the
JAX package's ``FlatSlab``. The one float comparison is B1 on a slab
(``make_packed_loss_fn``): bit for bit against ``fused_loss`` on the packed
batch, and within B1's tolerance (atol 1e-6 + rtol 1e-5) of the JAX
package's kernel in Pallas interpret mode. Also: the C path is taken exactly
where the JAX package takes its own (f32, at most 4096 slots, not
``SR_NO_NATIVE=1``), a lockstep search gives the same hall of fame on either
path, concurrent builds leave one library, a failing compiler raises, and
the loader imports no JAX.
"""

import math
import subprocess
import sys
import textwrap
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
from symbolicregression_jl_tpu.ops.flat import FlatSlab as JFlatSlab
from symbolicregression_jl_tpu.tree import Node as JNode
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu_torch import native
from symbolicregression_jl_tpu_torch.models.mutation_functions import (
    form_random_connection,
    gen_random_tree_fixed_size,
)
from symbolicregression_jl_tpu_torch.models.population import Population
from symbolicregression_jl_tpu_torch.ops import flat
from symbolicregression_jl_tpu_torch.ops.flat import FlatSlab, flatten_trees, flatten_trees_plain
from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
    fused_loss,
    make_packed_loss_fn,
    pack_programs_fused,
)
from symbolicregression_jl_tpu_torch.tree import binary, constant, feature, unary

ROOT = Path(__file__).resolve().parents[1]
OPSETS = {
    "config3": dict(binary_operators=["+", "-", "*", "/"],
                    unary_operators=["cos", "exp", "abs"]),
    "quick_start": dict(binary_operators=["+", "-", "*"], unary_operators=["cos"]),
}
MAXSIZE = 20
# f32 values at the edges of the cast: beyond the range (1e39, the rounding
# midpoint above FLT_MAX, and just under it), the non-finite ones, signed
# zero and the smallest subnormal
F32_MAX = float(np.finfo(np.float32).max)
SPECIAL = [1e39, -1e39, math.inf, -math.inf, math.nan, -0.0, 1e-45, -1e-45,
           F32_MAX + 2.0 ** 103, F32_MAX + 2.0 ** 102, -(F32_MAX + 2.0 ** 103), 1e-310, 0.1]


def _options(name):
    return T.Options(maxsize=MAXSIZE, save_to_file=False, device="cpu", **OPSETS[name])


def _trees(name, seed, per_size=4):
    """Seeded trees of every size 1..maxsize (fixed-size growth) and a
    population's random initial trees."""
    opts = _options(name)
    rng = np.random.default_rng(seed)
    trees = [gen_random_tree_fixed_size(s, opts.operators, 5, rng)
             for s in range(1, MAXSIZE + 1) for _ in range(per_size)]
    return trees + Population.random_trees(200, opts, 5, rng)


def _dags(name, seed, n=60):
    """Graph-node DAGs: random trees with shared subtrees."""
    opts = _options(name)
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        t = gen_random_tree_fixed_size(int(rng.integers(5, 16)), opts.operators, 5, rng)
        for _ in range(3):
            t = form_random_connection(t, rng)
        if len(t.postorder()) <= 24:
            out.append(t)
    return out


def _special_trees():
    """Every special constant at a leaf, in a tree, and shared in a DAG."""
    out = []
    for c in SPECIAL:
        leaf = constant(c)
        out.append(constant(c))
        out.append(binary(0, constant(c), feature(1)))
        out.append(unary(0, binary(2, leaf, leaf)))  # one node at two slots
    return out


def _to_jax(t, memo=None):
    """The same graph of the JAX package's Node, sharing kept."""
    memo = {} if memo is None else memo
    hit = memo.get(id(t))
    if hit is None:
        if t.degree == 0:
            hit = JNode(t.degree, is_const=t.is_const, val=t.val, feat=t.feat)
        elif t.degree == 1:
            hit = JNode(t.degree, op=t.op, l=_to_jax(t.l, memo))
        else:
            hit = JNode(t.degree, op=t.op, l=_to_jax(t.l, memo), r=_to_jax(t.r, memo))
        memo[id(t)] = hit
    return hit


def _plain(trees, max_nodes, dtype=np.float32):
    with warnings.catch_warnings():  # numpy warns where a cast overflows to inf
        warnings.simplefilter("ignore", RuntimeWarning)
        return flatten_trees_plain(trees, max_nodes, dtype)


def _jax_flatten(trees, max_nodes, dtype=np.float32):
    jt = [_to_jax(t) for t in trees]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return J.flatten_trees(jt, max_nodes, dtype=dtype)


def _assert_same(a, b):
    for name, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name  # val as its bits: NaN, -0.0 included


def _check_all_paths(trees, max_nodes):
    got = flatten_trees(trees, max_nodes)
    _assert_same(got, _plain(trees, max_nodes))
    _assert_same(got, _jax_flatten(trees, max_nodes))
    return got


@pytest.fixture
def counted_plain(monkeypatch):
    """Counts the calls of the plain flatten, which every non-C path takes."""
    calls = []

    def plain(*args, **kwargs):
        calls.append(args[1])
        return flatten_trees_plain(*args, **kwargs)

    monkeypatch.setattr(flat, "flatten_trees_plain", plain)
    return calls


# -- flatten_trees -----------------------------------------------------------


@pytest.mark.parametrize("width", ["24", "largest"])
@pytest.mark.parametrize("name", sorted(OPSETS))
def test_flatten_equals_plain_and_jax(name, width, counted_plain):
    trees = _trees(name, seed=len(name))
    sizes = [len(t.postorder()) for t in trees]
    assert set(range(1, MAXSIZE + 1)) <= set(sizes)
    max_nodes = 24 if width == "24" else max(sizes)
    got = _check_all_paths(trees, max_nodes)
    assert list(got.length) == sizes
    assert counted_plain == []  # flatten_trees took the C path


@pytest.mark.parametrize("name", sorted(OPSETS))
def test_flatten_dags_equal_plain_and_jax(name):
    trees = _dags(name, seed=3)
    assert any(len(t.postorder()) > len(list(t.iter_unique())) for t in trees)
    _check_all_paths(trees, 24)


def test_flatten_special_constants_bit_for_bit():
    got = _check_all_paths(_special_trees(), 8)
    bits = got.val[got.kind == flat.KIND_CONST].view(np.uint32)
    # +-inf beyond the rounding midpoint, FLT_MAX below it, NaN kept
    for v, want in ((1e39, 0x7F800000), (-1e39, 0xFF800000), (F32_MAX + 2.0 ** 102, 0x7F7FFFFF),
                    (F32_MAX + 2.0 ** 103, 0x7F800000), (-0.0, 0x80000000)):
        assert np.uint32(want) in bits, v
    assert np.isnan(got.val).any()


def test_flatten_numpy_scalar_attributes():
    """np.float32 val, np.int64 feat/op/degree, np.bool_ is_const."""
    trees = _trees("config3", seed=7, per_size=1)[:40] + _special_trees()
    for t in trees:
        for n in t.iter_unique():
            n.degree = np.int64(n.degree)
            n.op = np.int64(n.op)
            n.feat = np.int64(n.feat)
            n.is_const = np.bool_(n.is_const)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                n.val = np.float32(n.val)
    _check_all_paths(trees, 24)


@pytest.mark.parametrize("dag", [False, True])
def test_flatten_too_long_raises(dag):
    t = gen_random_tree_fixed_size(12, _options("config3").operators, 5,
                                   np.random.default_rng(0))
    if dag:  # 12 unique nodes, 26 slots
        t = binary(0, t, unary(0, t))
    trees = [feature(0), t]
    n = len(t.postorder())
    with pytest.raises(ValueError, match="tree 1 has"):
        flatten_trees(trees, n - 1)
    with pytest.raises(ValueError, match="tree 1 has"):
        flatten_trees_plain(trees, n - 1)
    assert flatten_trees(trees, n).length[1] == n
    slab = FlatSlab(2, n - 1, _options("config3").operators)
    with pytest.raises(ValueError):
        slab.set_trees(trees)
    with pytest.raises(ValueError):
        slab.set_tree(1, t)


@pytest.mark.parametrize("dtype,max_nodes", [(np.float64, 24), (np.complex64, 24),
                                             (np.float32, 4097)])
def test_plain_path_outside_the_rule(dtype, max_nodes, counted_plain):
    """f64, complex and rows wider than 4096 slots take the plain path, as
    in the JAX package, and agree with it."""
    trees = _trees("quick_start", seed=5, per_size=1)
    if np.dtype(dtype).kind == "c":
        trees.append(binary(0, constant(1.5 - 2j), feature(0)))
    got = flatten_trees(trees, max_nodes, dtype=dtype)
    assert counted_plain == [max_nodes]
    _assert_same(got, _jax_flatten(trees, max_nodes, dtype))


def test_sr_no_native_takes_the_plain_path(monkeypatch, counted_plain):
    trees = _trees("quick_start", seed=6, per_size=1)
    want = flatten_trees(trees, 24)
    assert counted_plain == []
    monkeypatch.setenv("SR_NO_NATIVE", "1")
    assert native.get_srcore() is None
    _assert_same(flatten_trees(trees, 24), want)
    assert counted_plain == [24]


def test_empty_batch():
    got = flatten_trees([], 24)
    assert got.kind.shape == (0, 24) and got.length.shape == (0,)
    _assert_same(got, _plain([], 24))


def test_threads_flatten_as_serial():
    """Eight threads each flattening their own batches, many times over,
    give the serial results (the scratch is per call)."""
    batches = [_trees("config3", seed=100 + k, per_size=1) + _dags("config3", 200 + k, 10)
               for k in range(8)]
    want = [flatten_trees(b, 24) for b in batches]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(lambda b: [flatten_trees(b, 24) for _ in range(20)], b)
                    for b in batches]
            got = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(switch)
    for outs, w in zip(got, want):
        for g in outs:
            _assert_same(g, w)


# -- FlatSlab ----------------------------------------------------------------


def _slab_pair(trees, name, capacity, start=0):
    opts = _options(name)
    N = opts.max_nodes
    slab = FlatSlab(capacity, N, opts.operators)
    slab.set_trees(trees, start)
    loop = FlatSlab(capacity, N, opts.operators)
    for k, t in enumerate(trees):
        loop.set_tree(start + k, t)
    return opts, slab, loop


@pytest.mark.parametrize("name", sorted(OPSETS))
def test_slab_equals_flatten_pack_and_jax(name):
    trees = _trees(name, seed=11) + _dags(name, seed=12, n=20)
    trees = [t for t in trees if len(t.postorder()) <= _options(name).max_nodes]
    opts, slab, loop = _slab_pair(trees, name, len(trees))
    N = opts.max_nodes
    assert slab.ints.shape == (len(trees), 4 * N + 1) and slab.vals.shape == (len(trees), N)
    assert slab.ints.tobytes() == loop.ints.tobytes()
    assert slab.vals.tobytes() == loop.vals.tobytes()
    prog, vals = pack_programs_fused(flatten_trees(trees, N), opts.operators)
    assert slab.ints.tobytes() == prog.tobytes() and slab.vals.tobytes() == vals.tobytes()
    jopts = J.Options(maxsize=MAXSIZE, save_to_file=False, **OPSETS[name])
    jslab = JFlatSlab(len(trees), N, jopts.operators)
    jslab.set_trees([_to_jax(t) for t in trees])
    assert jslab.ints[:, :4 * N + 1].tobytes() == slab.ints.tobytes()
    assert jslab.vals[:, :N].tobytes() == slab.vals.tobytes()


def test_slab_special_constants_and_numpy_scalars():
    trees = _special_trees()
    for n in trees[-1].iter_unique():
        n.val, n.degree = np.float32(n.val), np.int64(n.degree)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        opts, slab, loop = _slab_pair(trees, "config3", len(trees))
    assert slab.ints.tobytes() == loop.ints.tobytes()
    assert slab.vals.tobytes() == loop.vals.tobytes()


@pytest.mark.parametrize("start", [0, 1, 7, 30])
def test_slab_start_offsets_and_rewrite(start):
    """Rows outside [start, start + P) keep what they held; a member
    mutated and written again with ``set_tree`` equals a fresh flatten."""
    trees = _trees("config3", seed=start, per_size=1)[:10]
    first = _trees("config3", seed=99, per_size=1)[:40]
    opts, slab, loop = _slab_pair(first, "config3", 40)
    before = slab.ints.copy()
    slab.set_trees(trees, start)
    for k, t in enumerate(trees):
        loop.set_tree(start + k, t)
    assert slab.ints.tobytes() == loop.ints.tobytes()
    assert slab.vals.tobytes() == loop.vals.tobytes()
    rows = np.r_[0:start, start + len(trees):40]
    assert (slab.ints[rows] == before[rows]).all()
    t = trees[3]
    leaf = next(n for n in t.iter_unique() if n.degree == 0)
    leaf.is_const, leaf.val, leaf.feat = True, -3.25, 0
    slab.set_tree(start + 3, t)
    prog, vals = pack_programs_fused(flatten_trees([t], opts.max_nodes), opts.operators)
    assert (slab.ints[start + 3] == prog[0]).all()
    assert slab.vals[start + 3].tobytes() == vals[0].tobytes()


@pytest.mark.parametrize("start,n", [(38, 3), (-1, 1), (0, 41)])
def test_slab_overflow_raises_index_error(start, n):
    trees = [feature(0)] * n
    opts = _options("config3")
    jopts = J.Options(maxsize=MAXSIZE, save_to_file=False, **OPSETS["config3"])
    with pytest.raises(IndexError, match="exceeds capacity 40"):
        FlatSlab(40, opts.max_nodes, opts.operators).set_trees(trees, start)
    with pytest.raises(IndexError, match="exceeds capacity 40"):
        JFlatSlab(40, jopts.max_nodes, jopts.operators).set_trees(
            [_to_jax(t) for t in trees], start)


def test_srcore_checks_buffers():
    core = native.get_srcore()
    kind = np.zeros((2, 8), np.int32)
    bufs = [kind.copy() for _ in range(4)]
    val, length = np.zeros((2, 8), np.float32), np.zeros(2, np.int32)
    trees = [feature(0), feature(1)]
    core.flatten_batch(trees, kind, *bufs, val, length)
    assert list(length) == [1, 1]
    with pytest.raises(TypeError, match="val must be float32"):
        core.flatten_batch(trees, kind, *bufs, val.view(np.int32), length)
    with pytest.raises(ValueError, match="shape must match"):
        core.flatten_batch(trees, kind, *bufs[:3], np.zeros((2, 7), np.int32), val, length)
    with pytest.raises(ValueError, match="length buffer"):
        core.flatten_batch(trees, kind, *bufs, val, length[:1])
    with pytest.raises(ValueError, match="at most 4096"):
        wide = [np.zeros((2, 4097), np.int32) for _ in range(5)]
        core.flatten_batch(trees, *wide, np.zeros((2, 4097), np.float32), length)
    with pytest.raises(ValueError, match="bounds check"):
        core.slab_fill(trees, np.zeros((2, 32), np.int32), np.zeros((2, 8), np.float32), 0, 8, 5)


# -- B1 on the slab ----------------------------------------------------------


@pytest.fixture
def cpu_numerics():
    """Flush denormals, as the JAX side's CPU fast-math does, and keep JAX in
    32-bit mode (an earlier module of this process may have enabled x64)."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    jax.config.update("jax_enable_x64", x64)


def test_packed_loss_fn_matches_fused_loss_and_jax(monkeypatch, cpu_numerics):
    """The JAX package's own slab test (``tests/test_pallas.py``
    ``test_packed_slab_matches_flatten``): 64 random trees of its operator
    set on 3 x 500 rows, its kernel run in Pallas interpret mode."""
    monkeypatch.setenv("SR_PALLAS_INTERPRET", "1")
    from symbolicregression_jl_tpu.ops.interp_pallas import make_packed_loss_fn as j_make

    ops = dict(binary_operators=["+", "-", "*", "/", "pow"],
               unary_operators=["cos", "exp", "abs", "log", "sqrt"])
    jopts = J.Options(maxsize=20, save_to_file=False, **ops)
    topts = T.Options(maxsize=20, save_to_file=False, device="cpu", **ops)
    rng = np.random.default_rng(2)
    X = rng.normal(size=(3, 500)).astype(np.float32)
    y = (X[0] * X[1]).astype(np.float32)
    trees = Population.random_trees(64, topts, 3, rng)
    N = topts.max_nodes
    slab = FlatSlab(64, N, topts.operators)
    slab.set_trees(trees)
    got = make_packed_loss_fn(X, y, None, topts.operators, topts.loss, N, device="cpu")(
        slab.ints, slab.vals).numpy()
    prog, vals = pack_programs_fused(flatten_trees(trees, N), topts.operators)
    want = fused_loss(torch.from_numpy(prog), torch.from_numpy(vals), torch.from_numpy(X),
                      torch.from_numpy(y), None, topts.operators, topts.loss).numpy()
    assert got.tobytes() == want.tobytes()
    jslab = JFlatSlab(64, N, jopts.operators)
    jslab.set_trees([_to_jax(t) for t in trees])
    ref = np.asarray(j_make(X, y, None, jopts.operators, jopts.loss, N)(jslab.ints, jslab.vals))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin.sum() > 32
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-6)


def test_packed_loss_fn_weighted_on_a_row_window():
    """Weights, and the rows [10, 30) of a larger slab, against
    ``fused_loss`` on the same packed rows."""
    opts = _options("config3")
    rng = np.random.default_rng(4)
    X = rng.normal(size=(5, 300)).astype(np.float32)
    y = np.cos(X[0]).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 300).astype(np.float32)
    trees = _trees("config3", seed=4, per_size=1)[:40]
    slab = FlatSlab(40, opts.max_nodes, opts.operators)
    slab.set_trees(trees)
    fn = make_packed_loss_fn(X, y, w, opts.operators, opts.loss, opts.max_nodes, device="cpu")
    got = fn(slab.ints[10:30], slab.vals[10:30])
    want = fused_loss(torch.from_numpy(slab.ints[10:30].copy()),
                      torch.from_numpy(slab.vals[10:30].copy()), torch.from_numpy(X),
                      torch.from_numpy(y), torch.from_numpy(w), opts.operators, opts.loss)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    with pytest.raises(ValueError, match="packed rows"):
        fn(slab.ints[:, :-1], slab.vals)


# -- the search, the build, the loader ----------------------------------------


def test_lockstep_hall_of_fame_same_on_both_paths(monkeypatch, counted_plain):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 2)).astype(np.float32)
    y = (2 * np.cos(X[:, 1]) + X[:, 0] ** 2 - 2).astype(np.float32)
    opts = T.Options(binary_operators=["+", "-", "*"], unary_operators=["cos"],
                     populations=2, population_size=20, ncycles_per_iteration=12, maxsize=14,
                     seed=0, save_to_file=False, progress=False, device="cpu")

    def front():
        res = T.equation_search(X.T, y, options=opts, niterations=2, verbosity=0)
        return [(m.tree.string_tree(opts.operators), np.float32(m.loss).tobytes(),
                 np.float64(m.loss).tobytes()) for m in res.pareto_frontier]

    c_path = front()
    assert counted_plain == []  # every flatten of the f32 search went through C
    monkeypatch.setenv("SR_NO_NATIVE", "1")
    plain_path = front()
    assert counted_plain
    assert c_path == plain_path and len(c_path) > 2


def test_concurrent_builds_leave_one_library(tmp_path):
    """Four processes building at once into one empty directory: one
    library, no temporary file, and each process loads it and flattens."""
    build_dir = tmp_path / "_build"
    ready = tmp_path / "ready"
    ready.mkdir()
    code = textwrap.dedent(f"""
        import os, sys, time
        from pathlib import Path
        sys.path.insert(0, {str(ROOT)!r})
        from symbolicregression_jl_tpu_torch import native
        from symbolicregression_jl_tpu_torch.tree import binary, constant, feature
        import numpy as np
        native.BUILD_DIR = Path({str(build_dir)!r})
        Path({str(ready)!r}, str(os.getpid())).touch()
        deadline = time.time() + 120
        while len(os.listdir({str(ready)!r})) < 4 and time.time() < deadline:
            time.sleep(0.01)
        path = native.build()
        core = native._load(path)
        out = [np.zeros((1, 4), np.int32) for _ in range(5)]
        val, length = np.zeros((1, 4), np.float32), np.zeros(1, np.int32)
        core.flatten_batch([binary(0, constant(1.5), feature(2))], *out, val, length)
        assert int(length[0]) == 3 and float(val[0, 0]) == 1.5
        print(path, native.BUILD_INFO["built"])
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.split()[0] for out, _ in outs}
    assert len(paths) == 1
    files = sorted(f.name for f in build_dir.iterdir())
    assert files == [Path(paths.pop()).name]


def test_failing_compiler_raises_naming_it(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="srcore build failed: false exited 1"):
        native.build()
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="no-such-cc"):
        native.build()
    assert list(tmp_path.iterdir()) == []


def test_native_loader_imports_no_jax():
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "symbolicregression_jl_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        from symbolicregression_jl_tpu_torch import native
        from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees
        from symbolicregression_jl_tpu_torch.tree import binary, constant, feature
        assert native.get_srcore() is not None
        flat = flatten_trees([binary(0, constant(1.5), feature(2))], 4)
        assert list(flat.kind[0]) == [1, 2, 4, 0]
        assert not any(m == "jax" or m.startswith(("jax.", "symbolicregression_jl_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_threads_share_one_build(tmp_path, monkeypatch):
    """Threads asking for srcore first at once get one module."""
    monkeypatch.setattr(native, "_srcore", None)
    got = []
    threads = [threading.Thread(target=lambda: got.append(native.get_srcore()))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 6 and all(m is got[0] for m in got) and got[0] is not None
