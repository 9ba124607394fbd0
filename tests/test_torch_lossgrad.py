"""Kernel B2 (fused eval + loss + constant gradient) and the engine's
constant optimization, on the CPU.

- The CUDA sources' operator, loss and derivative functions
  (``csrc/sr_ops.cuh``) are plain ``__host__ __device__`` code: compiled for
  the host with the system C++ compiler they must give what torch autograd
  gives for the port's torch fns, including where autograd yields a
  non-finite gradient (rtol 1e-4: libm and torch's vectorized math differ
  in the last bits).
- B2's plain version against ``jax.value_and_grad`` of the JAX package's
  scan-interpreter loss (summed over rows, then divided by w_sum, as B2
  does), on 128 trees x 777 rows for every built-in loss,
  plain and weighted, on the trees whose predictions the two interpreters
  agree on (finite, below 1e3, to 1e-6 relative) and whose losses stay
  below 1e6. Losses at rtol 1e-4;
  constant gradients at rtol 1e-4 plus an atol of 1e-5 times the largest
  gradient of the same tree (the sides reduce over rows in f32 and f64 in
  different orders, so a gradient that cancels to near zero is held to its
  tree's scale).
- ``DiffLoss``: B1 forward, one B2 call per gradient.
- The const-opt leg recovers planted constants, and matches the JAX
  package's kernel const-opt (Pallas interpret mode) from one fixed member
  selection.
"""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu.models.mutation_functions import gen_random_tree
from symbolicregression_jl_tpu.ops import losses as jl
from symbolicregression_jl_tpu.ops.constant_opt import _eval_one
from symbolicregression_jl_tpu.ops.flat import flatten_trees
from symbolicregression_jl_tpu.ops.interp import _Structure
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.ops import interp_cuda as ic
from symbolicregression_jl_tpu_torch.ops import losses as tl
from symbolicregression_jl_tpu_torch.ops.operators import BUILTIN_BINARY, BUILTIN_UNARY

CSRC = Path(ic.__file__).resolve().parent.parent / "csrc"
BIN = ["add", "sub", "mult", "div", "pow", "max"]
UNA = ["cos", "exp", "sqrt", "log", "abs", "tanh"]
MARGIN = {"ZeroOneLoss", "PerceptronLoss", "L1HingeLoss", "L2HingeLoss", "ExpLoss",
          "SigmoidLoss", "L2MarginLoss", "ModifiedHuberLoss", "LogitMarginLoss",
          "SmoothedL1HingeLoss(0.5)", "DWDMarginLoss(2.0)"}
EXTRA = ("LPDistLoss(3.0)", "HuberLoss(0.5)", "QuantileLoss(0.9)", "SmoothedL1HingeLoss(0.5)",
         "DWDMarginLoss(2.0)", "PeriodicLoss(2.0)", "L2EpsilonInsLoss(0.3)")
LOSS_NAMES = sorted(set(tl.LOSSES) - {"HingeLoss", "EpsilonInsLoss"}) + list(EXTRA)


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """Flush denormals, as the JAX side's CPU fast-math does, and keep JAX in
    32-bit mode: a test module run earlier in this process may have enabled
    x64.

    One torch thread: tier-1 runs test files in parallel pytest-xdist
    workers, where per-process thread pools oversubscribe the cores, and
    CPU sums split by thread count would make the port's results depend
    on the machine."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    torch.set_flush_denormal(True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    torch.set_flush_denormal(False)
    jax.config.update("jax_enable_x64", x64)


# -- the device functions, compiled for the host --------------------------------

_HOST_SHIM = """
#define SR_HD inline
#include "sr_ops.cuh"
extern "C" {
void h_unary_grad(int id, const float* x, const float* g, int n, float* out) {
  for (int i = 0; i < n; ++i) out[i] = sr::unary_grad(id, x[i], g[i]);
}
void h_binary_grad(int id, const float* x, const float* y, const float* g, int n,
                   float* dx, float* dy) {
  for (int i = 0; i < n; ++i) sr::binary_grad(id, x[i], y[i], g[i], dx + i, dy + i);
}
void h_loss_grad(int id, const float* p, const float* t, const float* q, const float* g,
                 int n, float* out) {
  for (int i = 0; i < n; ++i) out[i] = sr::loss_grad(id, p[i], t[i], q, g[i]);
}
}
"""


@pytest.fixture(scope="module")
def host_ops(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    d = tmp_path_factory.mktemp("host_ops")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    lib = d / "libhostops.so"
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(d / "shim.cpp")], check=True)
    return ctypes.CDLL(str(lib))


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


SPECIAL = np.array([0., -0., 1., -1., 2., -2., 0.5, -0.5, 1e-30, -1e-30, 3., -3., 40., -40.,
                    -34.5, 35.5, 100., -100., np.inf, -np.inf, np.nan, 1e30, -1e30, 0.999999,
                    1.000001, -0.999999, 10., 2.5, -2.5], np.float32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([SPECIAL, rng.normal(size=400) * 3, rng.uniform(-1.2, 1.2, 200)])
    y = np.concatenate([np.repeat(SPECIAL, SPECIAL.size), x])
    x2 = np.concatenate([np.tile(SPECIAL, SPECIAL.size), rng.permutation(x)])
    x2[-50:] = np.round(x2[-50:])  # integer exponents for pow
    return (x.astype(np.float32), y.astype(np.float32), x2.astype(np.float32),
            rng.normal(size=y.size).astype(np.float32))


def _autograd(fn, xs, g):
    ts = [torch.from_numpy(x.copy()).requires_grad_(True) for x in xs]
    out = fn(*ts)
    if not out.requires_grad:
        return [np.zeros_like(x) for x in xs]
    gs = torch.autograd.grad(out, ts, torch.from_numpy(g), allow_unused=True)
    return [np.zeros_like(x) if v is None else v.numpy() for x, v in zip(xs, gs)]


def _assert_like_autograd(got, want, what):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-30, err_msg=what)


@pytest.mark.parametrize("zero_adjoint", [False, True], ids=["adjoint", "zero_adjoint"])
def test_device_derivatives_match_autograd(host_ops, zero_adjoint):
    x, xb, yb, gb = _inputs(0)
    g = gb[: x.size] if not zero_adjoint else np.zeros(x.size, np.float32)
    gb = gb if not zero_adjoint else np.zeros_like(gb)
    for k, op in enumerate(BUILTIN_UNARY):
        out = np.empty_like(x)
        host_ops.h_unary_grad(k, _p(x), _p(g), x.size, _p(out))
        _assert_like_autograd(out, _autograd(op.fn, [x], g)[0], op.name)
    for k, op in enumerate(BUILTIN_BINARY):
        dx, dy = np.empty_like(xb), np.empty_like(xb)
        host_ops.h_binary_grad(k, _p(xb), _p(yb), _p(gb), xb.size, _p(dx), _p(dy))
        want = _autograd(op.fn, [xb, yb], gb)
        _assert_like_autograd(dx, want[0], op.name + " dx")
        _assert_like_autograd(dy, want[1], op.name + " dy")
    rng = np.random.default_rng(1)
    t = np.where(rng.random(xb.size) < 0.5, yb, np.sign(rng.normal(size=xb.size)))
    t = t.astype(np.float32)
    w = np.abs(gb) if not zero_adjoint else gb
    for name in LOSS_NAMES:
        fn = tl.resolve_loss(name)
        lid, params = fn.kernel_spec
        q = np.zeros(4, np.float32)
        q[: len(params)] = params
        out = np.empty_like(xb)
        host_ops.h_loss_grad(lid, _p(xb), _p(t), _p(q), _p(w), xb.size, _p(out))
        want = _autograd(lambda p: fn(p, torch.from_numpy(t)), [xb], w)[0]
        _assert_like_autograd(out, want, name)


# -- B2's plain version against the JAX package ----------------------------------


def _problem(loss_name, weighted, seed=0, n_trees=128, n_rows=777):
    jops = J.ops.operators.resolve_operators(BIN, UNA)
    rng = np.random.default_rng(seed)
    trees = []
    while len(trees) < n_trees:
        t = gen_random_tree(int(rng.integers(1, 12)), jops, 3, rng)
        if t.count_nodes() <= 16:
            trees.append(t)
    flat = flatten_trees(trees, 16)
    X = rng.normal(size=(3, n_rows)).astype(np.float32)
    if loss_name in MARGIN:
        y = np.sign(rng.normal(size=n_rows)).astype(np.float32)
    else:
        y = (np.cos(X[0]) + 0.5 * X[1]).astype(np.float32)
    w = rng.uniform(0.1, 2.0, n_rows).astype(np.float32) if weighted else None
    return jops, flat, X, y, w


def _well_conditioned(jops, flat, X, opset):
    """Trees whose predictions the two packages agree on to 1e-6 relative,
    all finite and below 1e3 in magnitude. Elsewhere (pow of a large base,
    sin of 1e7) one ulp of difference in an operator moves the loss; that
    is the interpreters' business (tests/test_torch_scoring.py), not B2's."""
    from symbolicregression_jl_tpu.ops.interp import eval_trees as jeval
    from symbolicregression_jl_tpu_torch.ops.interp import eval_trees as teval

    pj = np.asarray(jeval(flat, jnp.asarray(X), jops), np.float64)
    pt = teval(convert.flat_trees(flat), torch.from_numpy(X), opset).double().numpy()
    with np.errstate(invalid="ignore"):
        close = np.abs(pj - pt) <= 1e-6 * np.maximum(np.abs(pj), 1e-3)
        return (np.isfinite(pj) & close & (np.abs(pj) < 1e3)).all(axis=1)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(loss_name, jops):
    """jit(vmap(value_and_grad)) of the row sum of w * loss through the JAX
    package's scan interpreter. B2's convention: the sum is differentiated
    and then divided by w_sum (a mean's 1/R inside the backward pass
    flushes tiny f32 adjoints to zero)."""
    jloss = jl.resolve_loss(loss_name)

    def total(v, s, X, y, w):
        return jnp.sum(jloss(_eval_one(jops, s, v, X), y) * w)

    return jax.jit(jax.vmap(jax.value_and_grad(total), in_axes=(0, 0, None, None, None)))


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("loss_name", LOSS_NAMES)
def test_plain_loss_grad_matches_jax(loss_name, weighted):
    jops, flat, X, y, w = _problem(loss_name, weighted)
    struct = _Structure(*(jnp.asarray(np.asarray(getattr(flat, f))) for f in
                          ("kind", "op", "lhs", "rhs", "feat", "length")))
    wj = jnp.asarray(w if weighted else np.ones_like(y))
    lj, gj = _jax_value_and_grad(loss_name, jops)(
        jnp.asarray(flat.val), struct, jnp.asarray(X), jnp.asarray(y), wj)
    wsum = float(np.sum(w, dtype=np.float64)) if weighted else float(len(y))
    lj, gj = np.asarray(lj) / wsum, np.asarray(gj) / wsum

    opset = T.Options(binary_operators=BIN, unary_operators=UNA, device="cpu").operators
    prog, vals = ic.pack_programs_fused(convert.flat_trees(flat), opset)
    lt, gt = ic.fused_loss_grad_reference(
        torch.from_numpy(prog), torch.from_numpy(vals), torch.from_numpy(X),
        torch.from_numpy(y), None if w is None else torch.from_numpy(w), opset,
        tl.resolve_loss(loss_name),
    )
    lt, gt = lt.numpy(), gt.numpy()
    const = np.asarray(flat.kind) == 1
    # B2's rule: gradients only on constant slots
    np.testing.assert_array_equal(gt[~const], 0.0)
    # losses of 1e34 (ExpLoss at a = -80) overflow f32 adjoints in either order
    sel = _well_conditioned(jops, flat, X, opset) & (np.abs(lj) < 1e6)
    assert sel.sum() > 40
    np.testing.assert_allclose(lt[sel], lj[sel], rtol=1e-4, atol=1e-6)
    both = const & sel[:, None] & np.isfinite(gt) & np.isfinite(gj)
    np.testing.assert_array_equal(both, const & sel[:, None])
    scale = np.max(np.where(both, np.abs(gj), 0.0), axis=1, keepdims=True)
    err = np.abs(gt - gj)
    lim = 1e-4 * np.abs(gj) + 1e-5 * scale
    assert not (both & (err > lim)).any(), np.max(np.where(both, err - lim, -np.inf))


def test_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    jops, flat, X, y, w = _problem("L2DistLoss", True, n_trees=32, n_rows=100)
    opset = T.Options(binary_operators=BIN, unary_operators=UNA, device="cpu").operators
    prog, vals = (torch.from_numpy(a) for a in
                  ic.pack_programs_fused(convert.flat_trees(flat), opset))
    args = (torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w), opset,
            tl.L2DistLoss)
    before = (ic.fused_loss.launches, ic.fused_loss_grad.launches)
    lk, gk = ic.fused_loss_grad(prog, vals, *args)
    lr, gr = ic.fused_loss_grad_reference(prog, vals, *args)
    torch.testing.assert_close(lk, lr, rtol=0, atol=0)
    torch.testing.assert_close(gk, gr, rtol=0, atol=0)
    # DiffLoss: B1 forward without a gradient, B2's gradients with one
    torch.testing.assert_close(ic.DiffLoss.apply(vals, prog, *args),
                               ic.fused_loss(prog, vals, *args), rtol=0, atol=0)
    v = vals.clone().requires_grad_(True)
    f = ic.DiffLoss.apply(v, prog, *args)
    ct = torch.linspace(0.5, 2.0, f.shape[0])
    (g,) = torch.autograd.grad(f, v, ct)
    torch.testing.assert_close(g, ct[:, None] * gr, rtol=0, atol=0)
    # the CPU path launches nothing
    assert (ic.fused_loss.launches, ic.fused_loss_grad.launches) == before


# -- the const-opt leg ---------------------------------------------------------------


def test_const_opt_recovers_planted_constants():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 200)).astype(np.float32)
    y = (3.25 * X[0] + 1.5).astype(np.float32)
    opts = T.Options(binary_operators=["+", "*"], populations=6, population_size=24,
                     ncycles_per_iteration=120, maxsize=8, save_to_file=False, seed=0,
                     scheduler="device", optimizer_probability=0.5, device="cpu",
                     progress=False)
    res = T.equation_search(X, y, options=opts, niterations=3, verbosity=0)
    assert min(m.loss for m in res.pareto_frontier) < 1e-4


def test_const_opt_matches_jax_kernel_const_opt(monkeypatch):
    """One fixed selection and restart set, fed to the JAX package's kernel
    const-opt (``_make_const_opt_fn_pallas``, Pallas interpret mode) and to
    the port's: the accepted losses agree at rtol 1e-3 (two f32 BFGS runs
    through different reduction orders), and so do acceptance decisions
    wherever the improvement is clear."""
    from symbolicregression_jl_tpu.models import device_search as jds
    from symbolicregression_jl_tpu.ops import evolve as je
    from symbolicregression_jl_tpu_torch.models import device_search as tds
    from symbolicregression_jl_tpu_torch.ops import evolve as te

    monkeypatch.setenv("SR_PALLAS_INTERPRET", "1")
    kw = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=2,
              population_size=8, maxsize=10, save_to_file=False, scheduler="device",
              optimizer_probability=0.5)
    jo = J.Options(**kw)
    to = T.Options(device="cpu", **kw)
    rng = np.random.default_rng(3)
    X = rng.normal(size=(2, 64)).astype(np.float32)
    y = (2.5 * np.cos(X[1]) + X[0] * 0.7 - 1.25).astype(np.float32)
    args = dict(n_features=2, baseline_loss=1.0, use_baseline=True, niterations=1)
    jc, tc = jds.build_evo_config(jo, **args), tds.build_evo_config(to, **args)
    I, P, N = jc.n_islands, jc.pop_size, jc.n_slots
    trees = []
    while len(trees) < I * P:
        t = gen_random_tree(int(rng.integers(3, 9)), jo.operators, 2, rng)
        if t.count_nodes() <= N and any(n.degree == 0 and n.is_const for n in _nodes(t)):
            trees.append(t)
    flat = flatten_trees(trees, N)
    data_t = tds.ScoreData(torch.from_numpy(X), torch.from_numpy(y), None, torch.tensor(1.0))
    scorer = tds.EngineScorer(to, use_kernel=True)
    losses = scorer.losses(convert_tree(flat), data_t.X, data_t.y, None).numpy()
    js = je.init_state(flat, losses, jc, 0)
    ts = convert.evo_state_from_arrays(js)

    K = max(1, int(round(0.5 * I * P)))
    S = 1 + jo.optimizer_nrestarts
    ii = np.arange(K) // P
    pp = np.arange(K) % P
    val0 = np.asarray(flat.val).reshape(I, P, N)[ii, pp]
    mask = np.asarray(flat.kind).reshape(I, P, N)[ii, pp] == 1
    jitter = 1.0 + 0.5 * rng.normal(size=(K, S - 1, N)).astype(np.float32)
    starts = np.concatenate([val0[:, None], val0[:, None] * jitter], 1).astype(np.float32)

    monkeypatch.setattr(jds, "_select_and_jitter", lambda state, *a, **k: (
        state.key, jnp.asarray(ii), jnp.asarray(pp), jnp.asarray(val0), jnp.asarray(mask),
        jnp.asarray(starts)))
    monkeypatch.setattr(tds, "_select_and_jitter", lambda *a, **k: (
        torch.from_numpy(ii), torch.from_numpy(pp), torch.from_numpy(val0),
        torch.from_numpy(mask), torch.from_numpy(starts)))
    jdata = jds._make_score_data(X, y, None, use_pallas=True, norm=1.0)
    jout = jds._make_const_opt_fn_pallas(jo, jc, 64, False, jit=False)(js, jdata)
    ctx = te.EvoContext(tc, "cpu", torch.Generator().manual_seed(0), scorer.losses)
    tout = tds.make_const_opt_fn(to, tc, scorer, ctx)(ts, data_t)

    lj = np.asarray(jout.loss)[ii, pp]
    lt = tout.loss[ii, pp].numpy()
    l0 = losses.reshape(I, P)[ii, pp]
    assert (lt < l0).sum() >= K // 2
    np.testing.assert_allclose(lt, lj, rtol=1e-3, atol=1e-6)
    # untouched members stay as they were
    rest = np.ones((I, P), bool)
    rest[ii, pp] = False
    np.testing.assert_array_equal(tout.loss.numpy()[rest], losses.reshape(I, P)[rest])


def _nodes(tree):
    stack = [tree]
    while stack:
        n = stack.pop()
        yield n
        stack.extend(c for c in (getattr(n, "l", None), getattr(n, "r", None)) if c is not None)


def convert_tree(flat):
    from symbolicregression_jl_tpu_torch.ops.treeops import Tree

    return Tree(*(torch.from_numpy(np.array(getattr(flat, f))) for f in Tree._fields))
