"""Complex dtypes (``Options(dtype=np.complex64)``) in the PyTorch port
against the JAX package (``tests/test_complex.py``, and the complex restart
jitter and complex-X predict of ``tests/test_round5_fixes.py``; the
reference's test_abstract_numbers.jl).

The port evaluates complex searches on the plain interpreter, in complex64
on the caller's device (the card by default; ``device="cpu"`` here), where
the JAX package commits them to its CPU backend. Tolerances: complex64
values against the JAX package's ``eval_trees`` and numpy at rtol 2e-4,
atol 1e-5 (the JAX test's: torch's and XLA's complex cos / exp round
differently in the last bits); losses and 2N-view gradients at rtol 1e-4;
searches as a per-seed quality band (the port's best loss below the JAX
test's 1e-2 bar, or within a factor of 3 of the JAX package's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu import tree as jt
from symbolicregression_jl_tpu.dataset import Dataset as JDataset
from symbolicregression_jl_tpu.models.device_search import (
    device_mode_supported as j_device_mode_supported,
)
from symbolicregression_jl_tpu.models.scorer import BatchScorer as JScorer
from symbolicregression_jl_tpu.ops.constant_opt import optimize_constants_batched as j_opt
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.dataset import Dataset
from symbolicregression_jl_tpu_torch.models.device_search import device_mode_supported
from symbolicregression_jl_tpu_torch.models.scorer import BatchScorer
from symbolicregression_jl_tpu_torch.ops.constant_opt import optimize_constants_batched
from symbolicregression_jl_tpu_torch.tree import binary, constant, feature, unary

RTOL, ATOL = 2e-4, 1e-5
BAR = 1e-2  # the JAX test's (and the reference's) recovery bar


@pytest.fixture(autouse=True, scope="module")
def _f32_jax():
    """Keep JAX in 32-bit mode: a test module run earlier in this process
    may have enabled x64."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", x64)


def _planted(n=100, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(1, n)) + 1j * rng.normal(size=(1, n))).astype(np.complex64)
    y = ((2 - 0.5j) * np.cos((1 + 1j) * X[0])).astype(np.complex64)
    return X, y


def _opts(pkg, **kw):
    if pkg is T:
        kw.setdefault("device", "cpu")
    return pkg.Options(save_to_file=False, **kw)


def _planted_tree(mod, ops, c0=2 - 0.5j, c1=1 + 1j, inner="*"):
    return mod.binary(ops.binary_index("*"), mod.constant(c0),
                      mod.unary(ops.unary_index("cos"),
                                mod.binary(ops.binary_index(inner), mod.constant(c1),
                                           mod.feature(0))))


class _port:
    binary, unary, constant, feature = (staticmethod(binary), staticmethod(unary),
                                        staticmethod(constant), staticmethod(feature))


def test_complex_operator_set_and_loss_resolution():
    kw = dict(binary_operators=["+", "*"], unary_operators=["cos", "log"], dtype=np.complex64)
    opts, jopts = _opts(T, **kw), _opts(J, **kw)
    d = opts.loss(torch.tensor([1 + 1j]), torch.tensor([0j]))
    assert not d.is_complex() and float(d[0]) == pytest.approx(2.0)
    assert float(jopts.loss(jnp.asarray([1 + 1j]), jnp.asarray([0j]))[0]) == float(d[0])
    # log is the raw complex log (total on the complex plane off 0)
    v = opts.operators.unary[1].fn(torch.tensor([-1.0 + 0j]))
    assert torch.isfinite(v).all()
    np.testing.assert_allclose(v.numpy(), np.asarray(jopts.operators.unary[1].fn(
        np.asarray([-1.0 + 0j]))), rtol=1e-6)
    for pkg in (T, J):
        with pytest.raises(ValueError, match="no complex implementation"):
            _opts(pkg, binary_operators=["+"], unary_operators=["abs"], dtype=np.complex64)
    # an explicit elementwise loss is kept
    assert _opts(T, elementwise_loss="L1DistLoss", dtype=np.complex64).loss is T.ops.losses.LOSSES[
        "L1DistLoss"]


def test_every_complex_operator_matches_jax():
    """Each operator of the complex table on one complex grid, against the
    JAX package's complex implementation (rtol 1e-5 where both are finite,
    equal non-finite positions)."""
    from symbolicregression_jl_tpu.ops.operators import _COMPLEX_IMPLS as JC
    from symbolicregression_jl_tpu_torch.ops.operators import COMPLEX_IMPLS as TC

    assert set(TC) == set(JC)
    rng = np.random.default_rng(0)
    a = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
    b = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
    for name, fn in TC.items():
        args = (a, b) if name in ("add", "sub", "mult", "div", "pow") else (a,)
        got = fn(*(torch.from_numpy(x) for x in args)).numpy()
        want = np.asarray(JC[name](*(jnp.asarray(x) for x in args)))
        assert got.dtype == np.complex64, name
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)


def test_complex_eval_matches_numpy_and_jax():
    kw = dict(binary_operators=["+", "*"], unary_operators=["cos"], dtype=np.complex64)
    opts, jopts = _opts(T, **kw), _opts(J, **kw)
    t = _planted_tree(_port, opts.operators)
    jtree = _planted_tree(jt, jopts.operators)
    X, _ = _planted(64)
    flat = T.ops.flatten_trees([t], 16, dtype=np.complex64)
    preds, ok = T.ops.eval_trees_with_ok(flat, X, opts.operators)
    jpreds, jok = J.ops.eval_trees_with_ok(J.ops.flatten_trees([jtree], 16, dtype=np.complex64),
                                           X, jopts.operators)
    want = (2 - 0.5j) * np.cos((1 + 1j) * X[0])
    assert preds.dtype == torch.complex64 and bool(ok[0]) and bool(jok[0])
    np.testing.assert_allclose(preds.numpy()[0], want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(preds.numpy()[0], np.asarray(jpreds)[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.eval_np(X, opts.operators), jtree.eval_np(X, jopts.operators),
                               rtol=RTOL, atol=ATOL)


def test_complex_loss_and_2n_view_gradient_match_jax():
    """The lockstep const-opt objective on the real 2N view: its value and
    gradient against the JAX package's ``remat_tree_loss(complex_n=N)``
    and ``jax.grad`` on the same constants (rtol 1e-4)."""
    from symbolicregression_jl_tpu.ops.constant_opt import remat_tree_loss
    from symbolicregression_jl_tpu.ops.interp import _Structure
    from symbolicregression_jl_tpu_torch.ops.constant_opt import _Objective

    kw = dict(binary_operators=["+", "*"], unary_operators=["cos"], dtype=np.complex64)
    opts, jopts = _opts(T, **kw), _opts(J, **kw)
    X, y = _planted(100)
    trees = [_planted_tree(jt, jopts.operators, c0, c1) for c0, c1 in
             ((1.5 + 0.5j, 0.8 + 1.2j), (2 - 0.5j, 1 + 1j), (0.3 - 1j, -0.4 + 0.2j))]
    jflat = J.flatten_trees(trees, 16, dtype=np.complex64)
    N = jflat.kind.shape[1]
    v = np.concatenate([jflat.val.real, jflat.val.imag], -1).astype(np.float32)
    loss_fn = remat_tree_loss(jopts.operators, jopts.loss, jnp.asarray(X), jnp.asarray(y),
                              jnp.zeros(()), False, complex_n=N)
    struct = _Structure(*(jnp.asarray(np.asarray(getattr(jflat, f))) for f in
                          ("kind", "op", "lhs", "rhs", "feat", "length")))
    jf, jg = jax.vmap(jax.value_and_grad(lambda vv, s: loss_fn(vv, s, None, None, None, None)))(
        jnp.asarray(v), struct)
    flat = convert.flat_trees(jflat, dtype=np.complex64)
    obj = _Objective(flat, torch.from_numpy(X), torch.from_numpy(y), None, opts.operators,
                     opts.loss, complex_n=N)
    f, g = obj.value_and_grad(torch.from_numpy(v))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5 * float(np.abs(jg).max()))


def test_complex_constant_optimization_recovers_constants():
    """BFGS through the real 2N view recovers planted complex constants on
    the right structure, in both packages from one numpy stream."""
    kw = dict(binary_operators=["+", "*"], unary_operators=["cos"], dtype=np.complex64,
              optimizer_iterations=30, optimizer_nrestarts=4)
    opts, jopts = _opts(T, **kw), _opts(J, **kw)
    X, y = _planted(100)
    res_t = optimize_constants_batched(
        [_planted_tree(_port, opts.operators, 1.5 + 0.5j, 0.8 + 1.2j)],
        BatchScorer(Dataset(X, y), opts), opts, np.random.default_rng(0))
    res_j = j_opt([_planted_tree(jt, jopts.operators, 1.5 + 0.5j, 0.8 + 1.2j)],
                  JScorer(JDataset(X, y), jopts), jopts, np.random.default_rng(0))
    for new_trees, losses, improved in (res_t, res_j):
        assert improved[0] and losses[0] < 1e-3, losses
    np.testing.assert_allclose(res_t[0][0].get_constants(), [2 - 0.5j, 1 + 1j], atol=1e-3)


class _RecordingRNG:
    """Delegates to a real Generator, recording standard_normal shapes."""

    def __init__(self, seed=0):
        self.inner = np.random.default_rng(seed)
        self.calls = []

    def standard_normal(self, size=None):
        self.calls.append(size)
        return self.inner.standard_normal(size=size)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_complex_restart_jitter_draws_complex_noise():
    """Restarts perturb phase as well as magnitude: two same-shape draws
    (real and imaginary parts), as the JAX package draws them."""
    rng0 = np.random.default_rng(0)
    X = rng0.normal(size=(1, 32)).astype(np.complex64)
    y = ((1 + 2j) * X[0] + (0.5 - 1j)).astype(np.complex64)
    kw = dict(binary_operators=["+", "*"], unary_operators=[], dtype=np.complex64,
              optimizer_iterations=8, optimizer_nrestarts=2)
    opts, jopts = _opts(T, **kw), _opts(J, **kw)
    calls = {}
    for name, opt_fn, o, mod, Ds, Sc in (
            ("port", optimize_constants_batched, opts, _port, Dataset, BatchScorer),
            ("jax", j_opt, jopts, jt, JDataset, JScorer)):
        ops = o.operators
        t = mod.binary(ops.binary_index("+"),
                       mod.binary(ops.binary_index("*"), mod.constant(1.0 + 0j), mod.feature(0)),
                       mod.constant(1.0 + 0j))
        rec = _RecordingRNG(0)
        _, losses, improved = opt_fn([t], Sc(Ds(X, y), o), o, rec)
        assert improved[0] and losses[0] < 1e-3
        calls[name] = [c for c in rec.calls if c is not None and len(c) == 3]
    assert len(calls["port"]) == 2 and calls["port"][0] == calls["port"][1]
    assert calls["port"] == calls["jax"]


def test_complex_dataset_keeps_complex_avg_and_real_weights():
    X, y = _planted(50)
    w = np.linspace(0.5, 2.0, 50).astype(np.float32)
    ds, jds = Dataset(X, y, weights=w), JDataset(X, y, weights=w)
    assert isinstance(ds.avg_y, complex) and ds.avg_y == pytest.approx(jds.avg_y)
    Xt, yt, wt = ds.device_arrays(np.complex64, "cpu")
    assert Xt.dtype == yt.dtype == torch.complex64 and wt.dtype == torch.float32


@pytest.mark.parametrize("seed", [1, 2])
def test_complex_search_in_band_with_jax(seed):
    """The planted search on lockstep in both packages, one seed each: each
    best loss is a real float and beats the constant predictor, and the
    port's reaches the JAX test's 1e-2 bar or lies within a factor of 3 of
    the JAX package's; the rendered equation carries complex literals or x1.
    (The JAX test's budget, 10 x 33 for up to 40 iterations, is cut to 5 x
    20 for up to 6 iterations with the same early stop.)"""
    X, y = _planted()
    kw = dict(binary_operators=["+", "*", "-", "/"], unary_operators=["cos"],
              dtype=np.complex64, populations=5, population_size=20,
              ncycles_per_iteration=50, maxsize=15, seed=seed, early_stop_condition=BAR)
    best = {}
    for name, pkg in (("port", T), ("jax", J)):
        o = _opts(pkg, **kw)
        res = pkg.equation_search(X, y, options=o, niterations=6, verbosity=0)
        m = min(res.pareto_frontier, key=lambda m: m.loss)
        assert isinstance(m.loss, float)
        best[name] = m.loss
        if pkg is T:
            s = m.tree.string_tree(o.operators)
            assert "im" in s or "x1" in s
    base = float(np.mean(np.abs(y - y.mean()) ** 2))
    assert max(best.values()) < base
    assert best["port"] <= max(BAR, 3 * best["jax"]), best


def test_complex_regressor_fit_predict():
    rng = np.random.default_rng(0)
    Xs = (rng.normal(size=(80, 1)) + 1j * rng.normal(size=(80, 1))).astype(np.complex64)
    ys = ((1 + 2j) * Xs[:, 0] + (0.5 - 1j)).astype(np.complex64)
    m = T.SRRegressor(niterations=6, binary_operators=["+", "*"], unary_operators=[],
                      dtype=np.complex64, populations=4, population_size=16,
                      ncycles_per_iteration=40, maxsize=8, seed=0, save_to_file=False,
                      early_stop_condition=1e-4, device="cpu")
    m.fit(Xs, ys)
    pred = m.predict(Xs)
    assert pred.dtype.kind == "c"
    assert np.mean(np.abs(pred - ys) ** 2) < 0.3


def test_predict_complex_x_on_real_fit(tmp_path):
    """Analytic continuation of a real fit on a complex X: allowed when the
    selected equation's operators all have complex versions, else JAX's
    error naming them."""
    X = np.ones((4, 1), np.float64)
    p = tmp_path / "hof_abs.csv"
    p.write_text("Complexity,Loss,Equation\n2,1.0,abs(x0)\n")
    m = T.SRRegressor.from_file(str(p), binary_operators=["+"], unary_operators=["abs"],
                                device="cpu")
    assert np.all(np.isfinite(m.predict(X)))
    with pytest.raises(ValueError, match="abs"):
        m.predict(X.astype(np.complex128))
    p2 = tmp_path / "hof_plain.csv"
    p2.write_text("Complexity,Loss,Equation\n1,1.0,x0\n")
    m2 = T.SRRegressor.from_file(str(p2), binary_operators=["+"], unary_operators=["abs"],
                                 device="cpu")
    np.testing.assert_allclose(m2.predict((X + 0.5j).astype(np.complex128)), X[:, 0] + 0.5j)


def test_complex_constant_parse_round_trip():
    """string_tree's '(Re±Imim)' literals parse back exactly, in the port as
    in the JAX package, and the two render one string."""
    from symbolicregression_jl_tpu.utils.checkpoint import parse_equation as j_parse
    from symbolicregression_jl_tpu_torch.utils.checkpoint import parse_equation

    kw = dict(binary_operators=["+", "*"], unary_operators=["cos"], dtype=np.complex64)
    opts, jopts = _opts(T, **kw), _opts(J, **kw)
    t = _planted_tree(_port, opts.operators, 2 - 0.5j, -1.5e-3 + 1j, inner="+")
    jtree = _planted_tree(jt, jopts.operators, 2 - 0.5j, -1.5e-3 + 1j, inner="+")
    s = t.string_tree(opts.operators, precision=17)
    assert s == jtree.string_tree(jopts.operators, precision=17)
    assert t.same_structure(parse_equation(s, opts.operators))
    assert jtree.same_structure(j_parse(s, jopts.operators))


def test_device_scheduler_refuses_complex_with_jax_reason():
    for dt in (np.complex64, np.complex128):
        opts = _opts(T, dtype=dt, scheduler="device")
        reason = device_mode_supported(opts)
        assert reason == j_device_mode_supported(_opts(J, dtype=dt, scheduler="device"))
        assert reason == f"unsupported engine dtype {np.dtype(dt).name}"
    X, y = _planted(30)
    with pytest.raises(ValueError, match="unsupported engine dtype complex64"):
        T.equation_search(X, y, options=_opts(T, dtype=np.complex64, scheduler="device"),
                          niterations=1, verbosity=0)


def test_complex_snapshot_resume_and_csv_round_trip(tmp_path):
    """Complex constants through a snapshot and the hall-of-fame CSV: a
    lockstep run resumed from its iteration-2 snapshot ends on the
    uninterrupted run's frontier string for string (the lockstep resume is
    exact), and the CSV it writes restores a model whose complex
    predictions are its best tree's."""
    from symbolicregression_jl_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint

    X, y = _planted(60)
    base, out = str(tmp_path / "c.pkl"), str(tmp_path / "hof.csv")
    kw = dict(binary_operators=["+", "*"], unary_operators=["cos"], dtype=np.complex64,
              populations=2, population_size=12, ncycles_per_iteration=10, maxsize=10,
              seed=0, device="cpu")

    def front(res, o):
        return [(m.loss, m.tree.string_tree(o.operators, precision=17))
                for m in res.pareto_frontier]

    full_o = T.Options(save_to_file=False, **kw)
    full = T.equation_search(X, y, options=full_o, niterations=3, verbosity=0)
    o = T.Options(save_to_file=True, output_file=out, checkpoint_every=1, checkpoint_file=base,
                  **kw)
    T.equation_search(X, y, options=o, niterations=2, verbosity=0)
    ck = load_checkpoint(latest_checkpoint(base))
    consts = [c for pop in ck.populations for m in pop.members for c in m.tree.get_constants()]
    assert any(isinstance(c, complex) or np.iscomplexobj(c) for c in consts)
    resumed = T.equation_search(X, y, options=o, niterations=3, verbosity=0, resume_from=base)
    assert front(resumed, o) == front(full, full_o)
    model = T.SRRegressor.from_file(out, binary_operators=["+", "*"], unary_operators=["cos"],
                                    dtype=np.complex64, device="cpu")
    pred = model.predict(X.T)
    assert pred.dtype.kind == "c" and np.all(np.isfinite(pred))
    # the model's selected equation is one of the frontier's, parsed back
    # from the CSV's 17-digit complex literals
    assert any(np.allclose(pred, m.tree.eval_np(X.astype(np.complex128), o.operators),
                           rtol=RTOL, atol=ATOL) for m in resumed.pareto_frontier)
