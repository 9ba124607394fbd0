"""PyTorch port vs JAX package: row- and population-sharded scoring
(``parallel/mesh.py``, ``parallel/sharding.py``) and the scorer's
``data_sharding="rows"``.

The port's ``make_sharded_loss`` over meshes of the CPU named 8 times is
held to the JAX package's over the 8 virtual CPU devices ``tests/conftest.py``
provides, on the same trees and rows, weighted and not, within f32
tolerance: each port block is B1's plain version, whose per-tree mean is
rounded to f32 before the f64 combination, where JAX's psum adds raw sums.
Trees with non-finite predictions score inf in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
from symbolicregression_jl_tpu.ops.flat import FlatTrees as JFlat
from symbolicregression_jl_tpu.parallel.mesh import make_mesh as j_make_mesh
from symbolicregression_jl_tpu.parallel.sharding import (
    make_sharded_loss as j_make_sharded_loss,
    shard_dataset as j_shard_dataset,
    shard_population as j_shard_population,
)
from symbolicregression_jl_tpu_torch import Options, equation_search
from symbolicregression_jl_tpu_torch.models.population import Population
from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees
from symbolicregression_jl_tpu_torch.ops.interp_cuda import fused_loss, pack_programs_fused
from symbolicregression_jl_tpu_torch.parallel.mesh import make_mesh
from symbolicregression_jl_tpu_torch.parallel.sharding import (
    make_sharded_loss, shard_dataset, shard_population,
)
from symbolicregression_jl_tpu_torch.tree import binary, constant, feature, unary

CPU8 = [torch.device("cpu")] * 8
OPS = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "log"], maxsize=16,
           save_to_file=False)


@pytest.fixture(autouse=True, scope="module")
def _f32_jax():
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", x64)


@pytest.fixture(scope="module")
def problem():
    """32 trees (random ones and three whose predictions are not all
    finite on some rows: log of a negative, division by a feature that is
    0 on one row) over 64 rows."""
    opts = Options(device="cpu", **OPS)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3, 64)).astype(np.float32)
    X[2, 37] = 0.0
    y = (X[0] * X[1] + np.cos(X[2])).astype(np.float32)
    w = (np.abs(rng.normal(size=64)) + 0.1).astype(np.float32)
    trees = Population.random_trees(29, opts, 3, rng)
    trees += [unary(opts.operators.unary_index("log"), feature(0)),
              binary(opts.operators.binary_index("/"), constant(1.0), feature(2)),
              unary(opts.operators.unary_index("log"),
                    binary(opts.operators.binary_index("-"), feature(1), constant(5.0)))]
    flat = flatten_trees(trees, opts.max_nodes)
    return opts, X, y, w, flat


def _jax_losses(opts, X, y, w, flat, mesh_shape, weighted):
    jopts = J.Options(**OPS)
    mesh = j_make_mesh(*mesh_shape)
    fn = j_make_sharded_loss(mesh, jopts.operators, jopts.loss, has_weights=weighted)
    Xs, ys, ws = j_shard_dataset(mesh, X, y, w if weighted else None)
    jflat = JFlat(*(np.asarray(a) for a in flat))
    fs = j_shard_population(mesh, jflat)
    w_arg = ws if weighted else jnp.zeros((), jnp.float32)
    return np.asarray(fn(fs, Xs, ys, w_arg))


def _port_losses(opts, X, y, w, flat, mesh_shape, weighted):
    mesh = make_mesh(*mesh_shape, devices=CPU8[: mesh_shape[0] * mesh_shape[1]])
    fn = make_sharded_loss(mesh, opts.operators, opts.loss, has_weights=weighted)
    Xs, ys, ws = shard_dataset(mesh, X, y, w if weighted else None)
    return fn(shard_population(mesh, flat), Xs, ys, ws).numpy()


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (1, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_loss_matches_jax(problem, mesh_shape, weighted):
    opts, X, y, w, flat = problem
    want = _jax_losses(opts, X, y, w, flat, mesh_shape, weighted)
    got = _port_losses(opts, X, y, w, flat, mesh_shape, weighted)
    assert got.shape == want.shape == (32,)
    assert (np.isinf(got) == np.isinf(want)).all()
    assert np.isinf(got[-3:]).all()  # the non-finite trees, whichever shard they hit
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (1, 2), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_loss_matches_one_b1_call(problem, mesh_shape):
    """Against one call of B1 (its plain version here) over all rows."""
    opts, X, y, w, flat = problem
    prog, vals = (torch.from_numpy(a) for a in pack_programs_fused(flat, opts.operators))
    for weighted in (False, True):
        wt = torch.from_numpy(w) if weighted else None
        one = fused_loss(prog, vals, torch.from_numpy(X), torch.from_numpy(y), wt,
                         opts.operators, opts.loss).numpy()
        got = _port_losses(opts, X, y, w, flat, mesh_shape, weighted)
        assert (np.isfinite(got) == np.isfinite(one)).all()
        fin = np.isfinite(one)
        np.testing.assert_allclose(got[fin], one[fin], rtol=1e-6, atol=1e-7)
        if mesh_shape[1] == 1:
            np.testing.assert_array_equal(got, one)  # one row shard: B1's bits


def test_uneven_split_raises(problem):
    opts, X, y, w, flat = problem
    mesh = make_mesh(1, 3, devices=CPU8[:3])
    with pytest.raises(ValueError, match="divisible"):
        shard_dataset(mesh, X, y)
    with pytest.raises(ValueError, match="divisible"):
        shard_population(make_mesh(3, 1, devices=CPU8[:3]), flat)
    with pytest.raises(ValueError, match="mesh 3x2"):
        make_mesh(3, 2, devices=CPU8[:4])


def _search(data_sharding):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(2, 256)).astype(np.float32)
    y = (2 * X[0] + np.cos(X[1])).astype(np.float32)
    opts = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=3,
                   population_size=12, ncycles_per_iteration=8, maxsize=10, seed=0,
                   data_sharding=data_sharding, save_to_file=False, progress=False,
                   device="cpu")
    res = equation_search(X, y, options=opts, niterations=2, verbosity=0)
    return [(m.get_complexity(opts), m.loss, repr(m.tree)) for m in res.pareto_frontier], \
        res.num_evals


def test_rows_sharding_on_one_device_is_the_unsharded_search():
    """With one device the scorer returns at once (JAX's n_dev == 1): the
    lockstep search is bit for bit the unsharded one."""
    from symbolicregression_jl_tpu_torch.dataset import Dataset
    from symbolicregression_jl_tpu_torch.models.scorer import BatchScorer

    X = np.zeros((2, 16), np.float32)
    opts = Options(binary_operators=["+"], data_sharding="rows", save_to_file=False,
                   device="cpu")
    assert BatchScorer(Dataset(X, X[0]), opts)._sharded is None
    assert _search("rows") == _search(None)


def test_rows_sharding_over_two_devices(monkeypatch):
    """With two devices (the CPU named twice) the scorer routes full-data
    scoring through the sharded loss; rows the count does not divide warn
    JAX's warning and score on one device."""
    import symbolicregression_jl_tpu_torch.models.scorer as sc
    from symbolicregression_jl_tpu_torch.dataset import Dataset
    from symbolicregression_jl_tpu_torch.models.scorer import BatchScorer

    monkeypatch.setattr(sc, "_row_devices", lambda device: [device, device])
    rng = np.random.default_rng(3)
    X = rng.normal(size=(2, 64)).astype(np.float32)
    y = X[0] * 2
    opts = Options(binary_operators=["+", "*"], data_sharding="rows", save_to_file=False,
                   device="cpu")
    scorer = BatchScorer(Dataset(X, y), opts)
    assert scorer._sharded is not None
    trees = Population.random_trees(10, opts, 2, rng)
    plain = BatchScorer(Dataset(X, y), Options(binary_operators=["+", "*"],
                                               save_to_file=False, device="cpu"))
    np.testing.assert_allclose(scorer.loss_many(trees), plain.loss_many(trees), rtol=1e-6)
    with pytest.warns(UserWarning, match="divisible by device count"):
        odd = BatchScorer(Dataset(X[:, :63], y[:63]), opts)
    assert odd._sharded is None
    frontier, evals = _search("rows")
    assert np.isfinite([f[1] for f in frontier]).all() and evals > 0
