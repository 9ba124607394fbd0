"""The fused kernels on the card: wrapper checks, launch counts, agreement
with their plain versions at small shapes, and the device engine on the
card.

These tests need a CUDA card and ``nvcc`` and skip without them. They import
neither JAX nor the JAX package, so on a machine without JAX they run with
the repository's conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: kernel and plain version compute the same f32 elementwise values
and sum in f64 in different orders, so losses agree to rtol 1e-5 (atol 1e-6
for losses near zero) and their ok flags are equal. B2's constant
gradients: rtol 1e-4 plus 1e-6 times the largest gradient of the same tree,
with equal non-finite positions.
"""

import numpy as np
import pytest
import torch

from symbolicregression_jl_tpu_torch import Dataset, Options
from symbolicregression_jl_tpu_torch.models.mutation_functions import gen_random_tree
from symbolicregression_jl_tpu_torch.models.scorer import BatchScorer
from symbolicregression_jl_tpu_torch.ops.flat import flatten_trees
from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
    DiffLoss,
    fused_loss,
    fused_loss_grad,
    fused_loss_grad_reference,
    fused_loss_reference,
    pack_programs_fused,
)
from symbolicregression_jl_tpu_torch.ops.operators import BINARY_OPS, UNARY_OPS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (see the module docstring for the command)")
    return torch.device("cuda", 0)


def _trees(opset, n, nfeat, seed, max_nodes):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        t = gen_random_tree(int(rng.integers(1, 10)), opset, nfeat, rng)
        if t.count_nodes() <= max_nodes:
            out.append(t)
    return out


def _inputs(opts, n_trees, n_rows, seed, device):
    rng = np.random.default_rng(seed)
    trees = _trees(opts.operators, n_trees, 3, seed, opts.max_nodes)
    prog, vals = pack_programs_fused(flatten_trees(trees, opts.max_nodes), opts.operators)
    X = rng.normal(size=(3, n_rows)).astype(np.float32)
    y = np.cos(X[0]).astype(np.float32)
    w = rng.uniform(0.1, 2.0, n_rows).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (prog, vals, X, y, w)]


@pytest.mark.parametrize("n_rows", [1, 33, 1000])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_kernel_matches_plain_version(cuda, n_rows, weighted):
    opts = Options(binary_operators=list(BINARY_OPS), unary_operators=list(UNARY_OPS),
                   maxsize=20, device="cuda")
    prog, vals, X, y, w = _inputs(opts, 300, n_rows, seed=n_rows, device=cuda)
    w = w if weighted else None
    before = fused_loss.launches
    got = fused_loss(prog, vals, X, y, w, opts.operators, opts.loss)
    assert fused_loss.launches == before + 1
    want = fused_loss_reference(prog, vals, X, y, w, opts.operators, opts.loss)
    torch.cuda.synchronize()
    got, want = got.cpu().double().numpy(), want.cpu().double().numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    m = np.isfinite(want)
    assert m.sum() > 30
    np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    opts = Options(maxsize=20, device="cuda")
    prog, vals, X, y, w = _inputs(opts, 8, 64, seed=0, device=cuda)
    args = (opts.operators, opts.loss)
    before = fused_loss.launches
    with pytest.raises(ValueError, match="X must be contiguous"):
        fused_loss(prog, vals, X.t().contiguous().t(), y, None, *args)
    with pytest.raises(ValueError, match="vals must be contiguous"):
        fused_loss(prog, vals.double(), X, y, None, *args)
    with pytest.raises(ValueError, match="w must be"):
        fused_loss(prog, vals, X, y, w[:10], *args)
    with pytest.raises(ValueError, match="no kernel implementation"):
        fused_loss(prog, vals, X, y, None, opts.operators, lambda p, t: (p - t) ** 4)
    assert fused_loss.launches == before


def test_scorer_launches_once_per_dispatch(cuda):
    opts = Options(maxsize=20, batching=True, batch_size=50, device="cuda")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3, 500)).astype(np.float32)
    y = (X[0] * X[1]).astype(np.float32)
    scorer = BatchScorer(Dataset(X, y), opts)
    trees = _trees(opts.operators, 40, 3, 1, opts.max_nodes)
    before = fused_loss.launches
    full = scorer.loss_many(trees)
    mini = scorer.loss_many(trees, idx=scorer.batch_indices(rng))
    assert scorer.use_kernel
    assert fused_loss.launches - before == scorer.num_dispatches == 2
    assert full.shape == mini.shape == (40,)
    assert np.isfinite(full).sum() > 10


def assert_grads_close(got, want):
    got, want = got.cpu().double().numpy(), want.cpu().double().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    scale = np.max(np.where(fin, np.abs(want), 0.0), axis=1, keepdims=True)
    lim = 1e-4 * np.abs(want) + 1e-6 * scale
    assert not (fin & (np.abs(got - want) > lim)).any()


@pytest.mark.parametrize("n_rows", [1, 50, 1000])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_grad_kernel_matches_plain_version(cuda, n_rows, weighted):
    opts = Options(binary_operators=list(BINARY_OPS), unary_operators=list(UNARY_OPS),
                   maxsize=20, device="cuda")
    prog, vals, X, y, w = _inputs(opts, 300, n_rows, seed=n_rows + 1, device=cuda)
    w = w if weighted else None
    before = fused_loss_grad.launches
    lk, gk = fused_loss_grad(prog, vals, X, y, w, opts.operators, opts.loss)
    assert fused_loss_grad.launches == before + 1
    lr, gr = fused_loss_grad_reference(prog, vals, X, y, w, opts.operators, opts.loss)
    torch.cuda.synchronize()
    lk_, lr_ = lk.cpu().double().numpy(), lr.cpu().double().numpy()
    np.testing.assert_array_equal(np.isfinite(lk_), np.isfinite(lr_))
    m = np.isfinite(lr_)
    np.testing.assert_allclose(lk_[m], lr_[m], rtol=1e-5, atol=1e-6)
    # B2's losses are B1's
    torch.testing.assert_close(lk, fused_loss(prog, vals, X, y, w, opts.operators, opts.loss),
                               rtol=1e-6, atol=1e-7, equal_nan=True)
    assert_grads_close(gk, gr)


def test_diff_loss_launches(cuda):
    opts = Options(maxsize=20, device="cuda")
    prog, vals, X, y, w = _inputs(opts, 64, 200, seed=5, device=cuda)
    b1, b2 = fused_loss.launches, fused_loss_grad.launches
    DiffLoss.apply(vals, prog, X, y, w, opts.operators, opts.loss)
    assert (fused_loss.launches, fused_loss_grad.launches) == (b1 + 1, b2)
    v = vals.clone().requires_grad_(True)
    f = DiffLoss.apply(v, prog, X, y, w, opts.operators, opts.loss)
    (g,) = torch.autograd.grad(f.sum(), v)
    assert (fused_loss.launches, fused_loss_grad.launches) == (b1 + 1, b2 + 1)
    _, gr = fused_loss_grad_reference(prog, vals, X, y, w, opts.operators, opts.loss)
    assert_grads_close(g, gr)


def test_grad_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    opts = Options(maxsize=20, device="cuda")
    prog, vals, X, y, w = _inputs(opts, 8, 64, seed=0, device=cuda)
    before = fused_loss_grad.launches
    with pytest.raises(ValueError, match="prog must be contiguous"):
        fused_loss_grad(prog.long(), vals, X, y, None, opts.operators, opts.loss)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        fused_loss_grad(prog[:, :-1].contiguous(), vals, X, y, None, opts.operators, opts.loss)
    assert fused_loss_grad.launches == before


def test_device_engine_on_the_card(cuda):
    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch import equation_search

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 500)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    opts = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=4,
                   population_size=16, ncycles_per_iteration=20, maxsize=14, seed=0,
                   save_to_file=False, progress=False, scheduler="device", device="cuda")

    def no_sync_in_evolve(name):
        import contextlib

        @contextlib.contextmanager
        def guard():
            torch.cuda.set_sync_debug_mode("error" if name == "evolve" else 0)
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return guard()

    b1, b2 = fused_loss.launches, fused_loss_grad.launches
    saved = ds._LEG_WRAP
    ds._LEG_WRAP = no_sync_in_evolve
    try:
        res = equation_search(X, y, options=opts, niterations=2, verbosity=0)
    finally:
        ds._LEG_WRAP = saved
    st = res.engine_stats
    assert res.use_kernel
    assert fused_loss.launches - b1 == st["score_calls"] > 40
    assert fused_loss_grad.launches - b2 == st["grad_calls"] >= 2
    assert np.isfinite(min(m.loss for m in res.pareto_frontier))
    assert set(st["device_seconds"]) == {"evolve", "const_opt", "readback"}
