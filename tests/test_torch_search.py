"""PyTorch port vs JAX package: the lockstep search as a whole.

Lockstep proposals are drawn from numpy in both packages, so the two make
the same proposals until a loss tie flips between their f32 reductions;
after that the searches diverge. Whole-search parity is therefore a per-seed
quality band: on the README's planted equation, each seed's best loss in the
port lies within a factor of 3 of the JAX package's (or both are below
1e-6), and both beat the mean predictor.
"""

import jax
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
import symbolicregression_jl_tpu_torch.models.scorer as scorer_mod

BAND = 3.0
BUDGET = dict(populations=4, population_size=20, ncycles_per_iteration=30,
              save_to_file=False, progress=False)
OPS = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"])


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """Flush denormals, as the JAX side's CPU fast-math does, and keep JAX in
    32-bit mode: a test module run earlier in this process may have enabled
    x64, under which the JAX package computes in another precision."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    jax.config.update("jax_enable_x64", x64)


def _planted(n=200, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((2, n)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    return X, y


def _best(res):
    return min(m.loss for m in res.pareto_frontier)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lockstep_search_in_band_with_jax(seed, monkeypatch):
    X, y = _planted()
    baseline = float(np.mean((y - y.mean()) ** 2))
    rj = J.equation_search(X, y, options=J.Options(seed=seed, **OPS, **BUDGET),
                           niterations=4, verbosity=0)
    calls = []
    wrapped = scorer_mod.fused_loss

    def counting(*args, **kwargs):
        calls.append(args[0].shape[0])
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(scorer_mod, "fused_loss", counting)
    rt = T.equation_search(X, y, options=T.Options(seed=seed, device="cpu", **OPS, **BUDGET),
                           niterations=4, verbosity=0)
    # every scoring dispatch of the main path went through the kernel wrapper
    assert rt.use_kernel and len(calls) == rt.scoring_dispatches > 0
    bj, bt = _best(rj), _best(rt)
    assert np.isfinite(bt) and bt < baseline and bj < baseline
    assert (bj < 1e-6 and bt < 1e-6) or bj / BAND <= bt <= bj * BAND, (bj, bt)
    assert all(np.isfinite(m.loss) for m in rt.pareto_frontier)


def test_regressor_fit_predict():
    X, y = _planted(seed=1)
    model = T.SRRegressor(niterations=3, seed=0, device="cpu", **OPS, **BUDGET)
    model.fit(X.T, y)
    rows = model.equations_
    assert rows and all(np.isfinite(r["loss"]) for r in rows)
    pred = model.predict(X.T)
    assert pred.shape == y.shape and np.all(np.isfinite(pred))
    baseline = float(np.mean((y - y.mean()) ** 2))
    mse = float(np.mean((pred - y) ** 2))
    assert mse < baseline
    best = model.get_best()
    # predict evaluates the selected equation (in f64): its mse is that
    # member's f32 loss
    assert mse == pytest.approx(best.loss, rel=1e-4)
    assert model.score(X.T, y) == pytest.approx(1 - mse / baseline, rel=1e-4)
