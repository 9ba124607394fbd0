"""The device engine on the evolve block (``SR_ENGINE_BLOCK``), on the CPU.

Which leg runs where (the JAX package's gate), determinism of the port's
block engine, and search quality against the JAX engine's reference block
backend as a per-seed band. Both engines run the same counter-hash block,
but their initial populations, migration and constant optimization draw
from different generators, so quality, not trajectory, is compared. Running
this file as a script prints the wide seed sweep behind the band
(``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_block_engine.py
FIRST END`` from the repo root).
"""

import os

import jax
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu.ops.evolve import EvoConfig as JEvoConfig
from symbolicregression_jl_tpu_torch.analysis.ir_verify import verify_flat_trees
from symbolicregression_jl_tpu_torch.models import device_search as tds
from symbolicregression_jl_tpu_torch.ops import evolve_block as tb
from symbolicregression_jl_tpu_torch.ops.evolve import EvoConfig as TEvoConfig
from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """JAX in 32-bit mode and one torch thread (see
    tests/test_torch_engine.py)."""
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


OPS = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"])
BUDGET = dict(populations=4, population_size=16, ncycles_per_iteration=80, maxsize=14,
              save_to_file=False, progress=False, scheduler="device")


def _planted(n=100, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(2, n)).astype(np.float32)
    return X, (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)


def _frontier(res):
    return [(m.get_complexity(res.options), m.loss, m.tree.string_tree(res.options.operators))
            for m in res.pareto_frontier]


def _search(monkeypatch, env, seed=0, niterations=2, **kw):
    if env is None:
        monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
    else:
        monkeypatch.setenv("SR_ENGINE_BLOCK", env)
    X, y = _planted()
    opts = T.Options(device="cpu", seed=seed, **dict(OPS, **dict(BUDGET, **kw)))
    return T.equation_search(X, y, options=opts, niterations=niterations, verbosity=0)


def test_engine_block_on_the_cpu_is_deterministic(monkeypatch):
    calls = []
    monkeypatch.setattr(tds, "run_block_iteration",
                        lambda *a, **k: calls.append(1) or tb.run_block_iteration(*a, **k))
    r1 = _search(monkeypatch, "1", seed=3, ncycles_per_iteration=20)
    r2 = _search(monkeypatch, "1", seed=3, ncycles_per_iteration=20)
    assert calls == [1] * 4
    assert _frontier(r1) == _frontier(r2)
    assert r1.engine_stats["block"] == "plain"
    assert all(np.isfinite(m.loss) for m in r1.pareto_frontier)
    # the population the block leaves is stack-sound
    verify_flat_trees(flatten_trees([m.tree for p in r1.populations for m in p.members], 16),
                      r1.options.operators)


@pytest.mark.parametrize("env", [None, "0"], ids=["auto", "off"])
def test_engine_block_auto_and_off_keep_the_event_leg_on_the_cpu(monkeypatch, env):
    monkeypatch.setattr(tds, "run_block_iteration",
                        lambda *a, **k: pytest.fail("the block ran"))
    res = _search(monkeypatch, env, ncycles_per_iteration=10)
    assert res.engine_stats["block"] is None


def test_engine_block_mode_rules(monkeypatch):
    from symbolicregression_jl_tpu_torch.models.device_search import _block_mode

    _, cfg = _cfgs()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for env, dev, kernel, rows, want in [
        (None, cuda, True, 10_000, "kernel"), (None, cuda, True, 10_241, None),
        (None, cuda, False, 100, None), (None, cpu, True, 100, None),
        ("0", cuda, True, 100, None), ("1", cuda, True, 10_241, None),
        ("1", cuda, False, 100, "plain"), ("1", cpu, True, 100, "plain"),
    ]:
        if env is None:
            monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
        else:
            monkeypatch.setenv("SR_ENGINE_BLOCK", env)
        assert _block_mode(cfg, dev, kernel, rows) == want, (env, dev, kernel, rows)
    monkeypatch.setenv("SR_ENGINE_BLOCK", "1")
    _, ineligible = _cfgs(mutation_attempts=2)
    assert _block_mode(ineligible, cuda, True, 100) is None


def _best_of_both(X, y, seed, niterations=4):
    """(port, JAX) best losses of one seed, both engines forced onto the
    block (the JAX package's reference backend on the CPU)."""
    prev = os.environ.get("SR_ENGINE_BLOCK")
    os.environ["SR_ENGINE_BLOCK"] = "1"
    try:
        kw = dict(OPS, **dict(BUDGET, optimizer_probability=0.25))
        rt = T.equation_search(X, y, options=T.Options(device="cpu", seed=seed, **kw),
                               niterations=niterations, verbosity=0)
        rj = J.equation_search(X, y, options=J.Options(seed=seed, **kw),
                               niterations=niterations, verbosity=0)
    finally:
        if prev is None:
            del os.environ["SR_ENGINE_BLOCK"]
        else:
            os.environ["SR_ENGINE_BLOCK"] = prev
    return min(m.loss for m in rt.pareto_frontier), min(m.loss for m in rj.pareto_frontier)


def test_engine_block_in_band_with_jax():
    """Search quality against the JAX engine's reference block backend on
    the planted quick-start equation, per seed: the band of
    tests/test_torch_engine.py (every best under 0.7x the mean predictor's
    loss, geometric means within 10x); the script run of this module prints
    the wide sweep behind it."""
    X, y = _planted()
    baseline = float(np.mean((y - y.mean()) ** 2))
    both = np.array([_best_of_both(X, y, seed) for seed in (0, 1)])
    assert both.max() < 0.7 * baseline, both
    gt, gj = np.exp(np.mean(np.log(np.maximum(both, 1e-2)), axis=0))
    assert gj / 10 <= gt <= gj * 10, both


if __name__ == "__main__":
    # the distributions behind the band: best loss per seed of both engines
    # on the block, their medians, and the share of seeds on the plateau
    import sys

    torch.set_num_threads(1)
    jax.config.update("jax_enable_x64", False)
    X, y = _planted()
    baseline = float(np.mean((y - y.mean()) ** 2))
    seeds = range(int(sys.argv[1]), int(sys.argv[2]))
    both = np.array([_best_of_both(X, y, seed) for seed in seeds])
    for k, name in enumerate(("port", "jax")):
        b = both[:, k]
        print(f"{name}: seeds {seeds.start}-{seeds.stop - 1}, best losses "
              f"{np.round(b, 4).tolist()}, median {np.median(b):.4f}, plateau share "
              f"{np.mean(b >= baseline / 2):.3f} (mean predictor {baseline:.4f})")
