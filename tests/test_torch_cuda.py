"""The hand-written kernels on the card: wrapper checks, launch counts,
agreement with their plain versions at small shapes, and the device engine
on the card, on the event leg and on the evolve block.

These tests need a CUDA card and ``nvcc`` and skip without them. They import
neither JAX nor the JAX package, so on a machine without JAX they run with
the repository's conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: kernel and plain version compute the same f32 elementwise values
and sum in f64 in different orders, so losses agree to rtol 1e-5 (atol 1e-6
for losses near zero) and their ok flags are equal. B2's constant
gradients: rtol 1e-4 plus 1e-6 times the largest gradient of the same tree,
with equal non-finite positions. B3 (the evolve block) against its plain
version: every integer output equal, float outputs to the same rtol. B4
(the prediction matrix): predictions to rtol 1e-5 on every operator, and
each operator alone equal to the plain version on every row. B2 and B4
evaluate on the postfix stack: a row that is not stack-sound scores inf
with zero gradients (B2) or predicts NaN (B4); two B2 launches on the same
inputs give identical bits. B2's seeded mode (``preds_vjp``) against its
plain version: B2's gradient tolerance, and two launches give identical
bits; a full objective on B4's predictions against B1: rtol 1e-5; complex
operators on the card against the CPU: rtol 1e-4 (two libms).
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
    eval_preds,
    eval_trees_kernel,
    fused_loss,
    fused_loss_grad,
    fused_loss_grad_reference,
    fused_loss_reference,
    grad_geometry,
    optab_tensor,
    pack_programs_fused,
    preds_geometry,
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


def test_held_operator_table_gives_the_same_bits(cuda):
    """A scorer's operator table (``optab_tensor``, uploaded once) gives B1,
    B2 and B4 the bits of a launch that uploads its own; a table of another
    length, dtype or device is refused before any launch."""
    opts = Options(binary_operators=list(BINARY_OPS), unary_operators=list(UNARY_OPS),
                   maxsize=20, device="cuda")
    prog, vals, X, y, w = _inputs(opts, 64, 300, seed=5, device=cuda)
    ops, loss = opts.operators, opts.loss
    tab = optab_tensor(ops, cuda)

    def same_bits(a, b):  # NaN predictions compare by their bits
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    assert same_bits(fused_loss(prog, vals, X, y, w, ops, loss, tab),
                     fused_loss(prog, vals, X, y, w, ops, loss))
    for a, b in zip(fused_loss_grad(prog, vals, X, y, w, ops, loss, tab),
                    fused_loss_grad(prog, vals, X, y, w, ops, loss)):
        assert same_bits(a, b)
    assert same_bits(eval_preds(prog, vals, X, ops, tab), eval_preds(prog, vals, X, ops))
    before = fused_loss.launches, fused_loss_grad.launches
    for bad in (tab[:-1], tab.long(), tab.cpu()):
        with pytest.raises(ValueError, match="table must be"):
            fused_loss(prog, vals, X, y, w, ops, loss, bad)
        with pytest.raises(ValueError, match="table must be"):
            fused_loss_grad(prog, vals, X, y, w, ops, loss, bad)
    assert (fused_loss.launches, fused_loss_grad.launches) == before


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


def test_device_engine_on_the_card(cuda, monkeypatch):
    """The event leg (``SR_ENGINE_BLOCK=0``): B1 scores every cycle."""
    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch import equation_search

    monkeypatch.setenv("SR_ENGINE_BLOCK", "0")
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
    assert st["block"] is None


def _block_inputs(device, ncycles, weighted, populations=6, population_size=20, maxsize=14,
                  trees=None, seed=None):
    import dataclasses

    from symbolicregression_jl_tpu_torch.models.device_search import build_evo_config
    from symbolicregression_jl_tpu_torch.ops.evolve_block import pack_state_words
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import unpack_programs_fused

    opts = Options(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                   populations=populations, population_size=population_size, maxsize=maxsize,
                   device="cuda")
    rng = np.random.default_rng(ncycles if seed is None else seed)
    X = torch.from_numpy(rng.normal(size=(3, 300)).astype(np.float32)).to(device)
    y = torch.cos(X[0]) * 2 + X[1]
    w = torch.from_numpy(rng.uniform(0.5, 2.0, 300).astype(np.float32)).to(device)
    w = w if weighted else None
    cfg = dataclasses.replace(
        build_evo_config(opts, 3, 1.0, True, 1, n_rows=300), ncycles=ncycles)
    I, P, N = cfg.n_islands, cfg.pop_size, cfg.n_slots
    if trees is None:
        trees = _trees(opts.operators, I * P, 3, ncycles if seed is None else seed, N)
    prog, vals = pack_programs_fused(flatten_trees(trees, N), opts.operators)
    flat = unpack_programs_fused(prog, vals, opts.operators)
    words, consts = pack_state_words(*(torch.from_numpy(np.asarray(a)).to(device)
                                       for a in (flat.kind, flat.op, flat.feat, flat.val)))
    loss = fused_loss(torch.from_numpy(prog).to(device), torch.from_numpy(vals).to(device),
                      X, y, w, opts.operators, opts.loss).reshape(I, P)
    length = torch.from_numpy(np.asarray(flat.length)).to(device).reshape(I, P)
    norm = torch.tensor(1.5, device=device)
    pop = (words.reshape(I, P, N).contiguous(), consts.reshape(I, P, N).contiguous(), length,
           loss.contiguous(), (loss / norm + length.float() * cfg.parsimony).contiguous(),
           torch.from_numpy(rng.integers(0, 8, (I, P)).astype(np.int32)).to(device))
    fnorm = torch.from_numpy(rng.dirichlet(np.ones(cfg.maxsize + 1)).astype(np.float32))
    scal = (fnorm.to(device), torch.tensor(12345, dtype=torch.int64, device=device),
            torch.tensor(P, dtype=torch.int32, device=device),
            torch.tensor(cfg.maxsize, dtype=torch.int32, device=device), norm)
    return (*pop, *scal, X, y, w, cfg, opts.operators, opts.loss)


@pytest.mark.parametrize("ncycles, weighted, size", [
    (1, False, 20), (8, False, 20), (1, True, 20), (8, True, 20), (2, False, 1100),
], ids=["1-plain", "8-plain", "1-weighted", "8-weighted", "population-in-device-memory"])
def test_block_kernel_matches_plain_version(cuda, ncycles, weighted, size):
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import (
        _launch_config, evolve_block, evolve_block_reference,
    )
    from symbolicregression_jl_tpu_torch.ops.losses import kernel_loss_spec

    args = _block_inputs(cuda, ncycles, weighted, 2 if size > 100 else 6, size)
    cfg, X = args[-3], args[11]
    c, _, _ = _launch_config(cfg, args[-2], kernel_loss_spec(args[-1]), X.shape[0], X.shape[1],
                             X.stride(0))
    # 1100 members do not fit in shared memory beside the lanes: the kernel
    # keeps that island in the output arrays
    assert c.use_smem == (1 if size < 100 else 0)
    before = evolve_block.launches
    got = evolve_block(*args)
    assert evolve_block.launches == before + 1
    want = evolve_block_reference(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        g, r = g.cpu(), r.cpu()
        if not r.dtype.is_floating_point:
            assert torch.equal(g, r)
        else:
            g, r = g.double().numpy(), r.double().numpy()
            np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
            np.testing.assert_array_equal(np.isinf(g), np.isinf(r))
            m = np.isfinite(r)
            np.testing.assert_allclose(g[m], r[m], rtol=1e-5, atol=1e-6)
    # one seed, one result
    again = evolve_block(*args)
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)


def test_block_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block

    args = list(_block_inputs(cuda, 1, False))
    before = evolve_block.launches
    bad = list(args)
    bad[0] = args[0].long()
    with pytest.raises(ValueError, match="words must be"):
        evolve_block(*bad)
    bad = list(args)
    bad[7] = 12345
    with pytest.raises(ValueError, match="seed must be"):
        evolve_block(*bad)
    assert evolve_block.launches == before


def test_preds_kernel_matches_plain_version(cuda):
    from symbolicregression_jl_tpu_torch.ops.interp import eval_trees
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import unpack_programs_fused

    opts = Options(binary_operators=list(BINARY_OPS), unary_operators=list(UNARY_OPS),
                   maxsize=20, device="cuda")
    prog, vals, X, _, _ = _inputs(opts, 300, 777, seed=3, device=cuda)
    flat = unpack_programs_fused(prog.cpu().numpy(), vals.cpu().numpy(), opts.operators)
    before = eval_trees_kernel.launches
    got = eval_trees_kernel(flat, X, opts.operators)
    assert eval_trees_kernel.launches == before + 1
    want = eval_trees(flat, X, opts.operators)
    torch.cuda.synchronize()
    got, want = got.cpu().double().numpy(), want.cpu().double().numpy()
    assert got.shape == (300, 777)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    m = np.isfinite(want)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("span", [2.0, 20.0])
def test_every_operator_alone_equals_plain_version(cuda, span):
    """One tree per built-in operator, on rows from U(-span, span), through
    B4 and its plain version: equal on every row, NaN where NaN. (gamma's
    reflection once differed by an ulp: PyTorch evaluates the plain
    version's ``pi / den`` as ``reciprocal(den) * pi``.)"""
    from symbolicregression_jl_tpu_torch.ops.flat import FlatTrees
    from symbolicregression_jl_tpu_torch.ops.interp import eval_trees
    from symbolicregression_jl_tpu_torch.ops.operators import resolve_operators

    ops = resolve_operators(list(BINARY_OPS), list(UNARY_OPS))
    nu, nb = ops.n_unary, ops.n_binary
    P, N = nu + nb, 3
    kind, op, lhs, rhs, feat = (np.zeros((P, N), np.int32) for _ in range(5))
    kind[:, 0] = 2
    kind[:nu, 1], op[:nu, 1] = 3, np.arange(nu)
    kind[nu:, 1], feat[nu:, 1] = 2, 1
    kind[nu:, 2], op[nu:, 2], lhs[nu:, 2], rhs[nu:, 2] = 4, np.arange(nb), 0, 1
    length = np.where(np.arange(P) < nu, 2, 3).astype(np.int32)
    flat = FlatTrees(kind, op, lhs, rhs, feat, np.zeros((P, N), np.float32), length)
    X = torch.from_numpy(np.random.default_rng(2).uniform(-span, span, (2, 4096))
                         .astype(np.float32)).to(cuda)
    got = eval_trees_kernel(flat, X, ops).cpu()
    want = eval_trees(flat, X, ops).cpu()
    same = (got == want) | (got.isnan() & want.isnan())
    names = [o.name for o in ops.unary] + [o.name for o in ops.binary]
    assert [names[k] for k in torch.nonzero(~same.all(1)).flatten().tolist()] == []


def test_device_engine_on_the_block(cuda, monkeypatch):
    """The default evolve leg on the card: one B3 launch per iteration, no
    host sync inside it, B1 and B2 counted against the engine's calls."""
    import contextlib

    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch import equation_search
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block

    monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 500)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    opts = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=4,
                   population_size=16, ncycles_per_iteration=50, maxsize=14, seed=0,
                   save_to_file=False, progress=False, scheduler="device", device="cuda")

    @contextlib.contextmanager
    def guard(name):
        torch.cuda.set_sync_debug_mode("error" if name == "evolve" else 0)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    b1, b2, b3 = fused_loss.launches, fused_loss_grad.launches, evolve_block.launches
    monkeypatch.setattr(ds, "_LEG_WRAP", guard)
    res = equation_search(X, y, options=opts, niterations=2, verbosity=0)
    st = res.engine_stats
    assert st["block"] == "kernel"
    assert evolve_block.launches - b3 == st["iterations"] == 2
    assert fused_loss.launches - b1 == st["score_calls"]
    assert fused_loss_grad.launches - b2 == st["grad_calls"] >= 2
    assert np.isfinite(min(m.loss for m in res.pareto_frontier))


def _close(got, want):
    got, want = got.cpu().double().numpy(), want.cpu().double().numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    m = np.isfinite(want)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-6)


def test_kernel_matches_plain_version_at_the_engine_shape(cuda):
    """B1 at the device engine's constant-optimization shape: 4,200 trees x
    10k rows, unweighted and weighted."""
    opts = Options(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp", "abs"],
                   maxsize=20, device="cuda")
    prog, vals, X, y, w = _inputs(opts, 4200, 10_000, seed=42, device=cuda)
    for wt in (None, w):
        before = fused_loss.launches
        got = fused_loss(prog, vals, X, y, wt, opts.operators, opts.loss)
        assert fused_loss.launches == before + 1
        _close(got, fused_loss_reference(prog, vals, X, y, wt, opts.operators, opts.loss))


@pytest.mark.parametrize("n_rows", [50, 2047, 4099])
def test_kernel_matches_plain_version_on_odd_minibatches(cuda, n_rows):
    """Minibatch widths whose rows (X's leading dimension) are odd, gathered
    from a larger X as the scorer does: no row load is aligned."""
    opts = Options(binary_operators=list(BINARY_OPS), unary_operators=list(UNARY_OPS),
                   maxsize=20, device="cuda")
    prog, vals, X, y, w = _inputs(opts, 500, 10_000, seed=n_rows, device=cuda)
    idx = torch.from_numpy(np.random.default_rng(n_rows).integers(0, 10_000, n_rows)).to(cuda)
    Xb, yb, wb = X[:, idx].contiguous(), y[idx].contiguous(), w[idx].contiguous()
    assert Xb.stride(0) == n_rows
    for wt in (None, wb):
        _close(fused_loss(prog, vals, Xb, yb, wt, opts.operators, opts.loss),
               fused_loss_reference(prog, vals, Xb, yb, wt, opts.operators, opts.loss))


def _deepest_stack_trees(n, max_nodes):
    """x + (c + (x + ...)) chains of 2k + 1 <= max_nodes slots: the postorder
    pushes every leaf before the first operator, the largest stack height a
    program of its length can reach."""
    from symbolicregression_jl_tpu_torch import tree as TR

    out = []
    for j in range(n):
        k = (max_nodes - 1) // 2 - j % 3
        t = TR.feature(k % 3)
        for i in range(k - 1, -1, -1):
            leaf = TR.feature(i % 3) if i % 2 else TR.constant(0.5 + i)
            t = TR.binary(j % 2, leaf, t)
        out.append(t)
    return out


def _assert_block_equal(got, want):
    for g, r in zip(got, want):
        g, r = g.cpu(), r.cpu()
        if not r.dtype.is_floating_point:
            assert torch.equal(g, r)
        else:
            g, r = g.double().numpy(), r.double().numpy()
            np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
            np.testing.assert_array_equal(np.isinf(g), np.isinf(r))
            m = np.isfinite(r)
            np.testing.assert_allclose(g[m], r[m], rtol=1e-5, atol=1e-6)


def test_kernels_at_the_maximum_stack_depth(cuda):
    """Programs that push every leaf before their first operator, in B1, B2,
    B4 and in B3's scoring: equal to the plain versions."""
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import (
        evolve_block, evolve_block_reference,
    )

    opts = Options(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                   maxsize=14, device="cuda")
    N = opts.max_nodes
    trees = _deepest_stack_trees(120, N)
    prog, vals = pack_programs_fused(flatten_trees(trees, N), opts.operators)
    assert prog[:, 4 * N].max() >= N - 1
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(3, 1000)).astype(np.float32)).to(cuda)
    y = torch.cos(X[0])
    p, v = torch.from_numpy(prog).to(cuda), torch.from_numpy(vals).to(cuda)
    _close(fused_loss(p, v, X, y, None, opts.operators, opts.loss),
           fused_loss_reference(p, v, X, y, None, opts.operators, opts.loss))
    lk, gk = fused_loss_grad(p, v, X, y, None, opts.operators, opts.loss)
    lr, gr = fused_loss_grad_reference(p, v, X, y, None, opts.operators, opts.loss)
    _close(lk, lr)
    assert_grads_close(gk, gr)
    _close(eval_preds(p, v, X, opts.operators), _plain_preds(p, v, X, opts.operators))
    args = _block_inputs(cuda, 4, False, populations=6, population_size=20, trees=trees)
    _assert_block_equal(evolve_block(*args), evolve_block_reference(*args))


@pytest.mark.parametrize("population_size, maxsize", [(20, 40), (400, 14)],
                         ids=["N>32", "E>32"])
def test_block_kernel_wide_programs_and_many_lanes(cuda, population_size, maxsize):
    """B3 with more than 32 slots per program, and with more than 32 event
    lanes per cycle (more lanes than the block has warps): every integer
    output equal to the plain version's, two launches bit-identical."""
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import (
        _launch_config, evolve_block, evolve_block_reference,
    )
    from symbolicregression_jl_tpu_torch.ops.losses import kernel_loss_spec

    args = _block_inputs(cuda, 3, True, populations=2, population_size=population_size,
                         maxsize=maxsize)
    cfg, X = args[-3], args[11]
    _, threads, _ = _launch_config(cfg, args[-2], kernel_loss_spec(args[-1]), X.shape[0],
                                   X.shape[1], X.stride(0))
    if maxsize == 40:
        assert cfg.n_slots > 32
    else:
        assert cfg.events_per_cycle > 32 and cfg.events_per_cycle > threads // 32
    got = evolve_block(*args)
    _assert_block_equal(got, evolve_block_reference(*args))
    again = evolve_block(*args)
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)


def _plain_preds(prog, vals, X, opset):
    """B4's plain version on X's device (on the card, torch's CUDA math, which
    each operator of the kernel equals)."""
    from symbolicregression_jl_tpu_torch.ops.interp import eval_trees
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import unpack_programs_fused

    flat = unpack_programs_fused(prog.cpu().numpy(), vals.cpu().numpy(), opset)
    return eval_trees(flat, X, opset)


def _unsound(prog, opset):
    """A copy of prog with two rows made not stack-sound (their binary
    root's children swapped; a binary root cut off) and those rows."""
    p = prog.clone()
    N = (p.shape[1] - 1) // 4
    length = p[:, 4 * N]
    root = p[torch.arange(len(p), device=p.device), (length - 1).clamp_min(0)]
    rows = torch.nonzero((length > 1) & (root >= 2 + opset.n_unary)).flatten()[:2].tolist()
    a, b = rows
    i = int(length[a]) - 1
    p[a, N + i], p[a, 2 * N + i] = prog[a, 2 * N + i], prog[a, N + i]
    p[b, 4 * N] = length[b] - 1
    return p, rows


@pytest.mark.parametrize("n_rows", [50, 10_000])
def test_grad_kernel_is_deterministic(cuda, n_rows):
    """Two B2 launches on the same inputs give identical bits: several trees
    per block at 50 rows, row chunks summed by the finalize kernel at 10k."""
    opts = Options(binary_operators=list(BINARY_OPS), unary_operators=list(UNARY_OPS),
                   maxsize=20, device="cuda")
    prog, vals, X, y, w = _inputs(opts, 300, n_rows, seed=7, device=cuda)
    geom = grad_geometry(300, opts.max_nodes, n_rows)
    assert (geom[2] > 1) if n_rows == 50 else (geom[4] > 1)
    first = fused_loss_grad(prog, vals, X, y, w, opts.operators, opts.loss)
    again = fused_loss_grad(prog, vals, X, y, w, opts.operators, opts.loss)
    for a, b in zip(first, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_grad_kernel_unsound_rows(cuda):
    """B2 evaluates on the postfix stack: a row that is not stack-sound
    scores inf with zero gradients; the batch's other rows keep the plain
    version's values."""
    opts = Options(maxsize=20, device="cuda")
    prog, vals, X, y, w = _inputs(opts, 64, 300, seed=9, device=cuda)
    bad, rows = _unsound(prog, opts.operators)
    lk, gk = fused_loss_grad(bad, vals, X, y, w, opts.operators, opts.loss)
    lr, gr = fused_loss_grad_reference(prog, vals, X, y, w, opts.operators, opts.loss)
    torch.cuda.synchronize()
    keep = torch.ones(64, dtype=torch.bool)
    keep[rows] = False
    assert torch.isinf(lk[rows]).all() and (gk[rows] == 0).all()
    _close(lk.cpu()[keep], lr.cpu()[keep])
    assert_grads_close(gk.cpu()[keep], gr.cpu()[keep])


@pytest.mark.parametrize("n_rows", [1, 33, 50])
def test_kernels_several_trees_per_block(cuda, n_rows):
    """Minibatch widths, where B2 and B4 pack several trees per block: equal
    to the plain versions, weighted and unweighted."""
    opts = Options(binary_operators=list(BINARY_OPS), unary_operators=list(UNARY_OPS),
                   maxsize=20, device="cuda")
    prog, vals, X, y, w = _inputs(opts, 301, n_rows, seed=n_rows + 3, device=cuda)
    N = opts.max_nodes
    assert grad_geometry(301, N, n_rows)[2] > 1 and preds_geometry(301, N, n_rows)[2] > 1
    for wt in (None, w):
        lk, gk = fused_loss_grad(prog, vals, X, y, wt, opts.operators, opts.loss)
        lr, gr = fused_loss_grad_reference(prog, vals, X, y, wt, opts.operators, opts.loss)
        _close(lk, lr)
        assert_grads_close(gk, gr)
    got = eval_preds(prog, vals, X, opts.operators).cpu().double().numpy()
    want = _plain_preds(prog, vals, X, opts.operators).cpu().double().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    m = np.isfinite(want)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-6)


def test_preds_kernel_empty_and_unsound_programs(cuda):
    """B4 writes 0 for an empty program on every row, as the plain version
    does, and NaN for a row that is not stack-sound, which B1 scores inf."""
    opts = Options(maxsize=20, device="cuda")
    prog, vals, X, _, _ = _inputs(opts, 64, 777, seed=11, device=cuda)
    N = opts.max_nodes
    bad, rows = _unsound(prog, opts.operators)
    empty = min(set(range(64)) - set(rows))
    bad[empty, 4 * N] = 0
    got = eval_preds(bad, vals, X, opts.operators).cpu()
    assert (got[empty] == 0).all()
    assert torch.isnan(got[rows]).all()
    keep = torch.ones(64, dtype=torch.bool)
    keep[rows + [empty]] = False
    _close(got[keep], _plain_preds(prog, vals, X, opts.operators).cpu()[keep])


def _frontier(res):
    o = res.options
    return [(m.get_complexity(o), m.loss, m.tree.string_tree(o.operators, precision=17))
            for m in res.pareto_frontier]


def test_lockstep_kill_and_resume_on_the_card(cuda, tmp_path):
    """A lockstep search on the card killed at iteration 2 and resumed from
    its snapshot: the same frontier, string for string, and the same
    evaluation count as the uninterrupted run (which repeats itself)."""
    from symbolicregression_jl_tpu_torch import equation_search
    from symbolicregression_jl_tpu_torch.utils.faults import FaultInjected

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 200)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)

    def opts(**kw):
        return Options(binary_operators=["+", "-", "*"], unary_operators=["cos"],
                       populations=3, population_size=16, ncycles_per_iteration=10,
                       seed=0, save_to_file=False, progress=False, device="cuda",
                       checkpoint_file=str(tmp_path / "ck.pkl"), **kw)

    full = [equation_search(X, y, options=opts(), niterations=4, verbosity=0)
            for _ in range(2)]
    assert _frontier(full[0]) == _frontier(full[1])
    with pytest.raises(FaultInjected):
        equation_search(X, y, options=opts(checkpoint_every=1,
                                           fault_spec="peer_death@2:mode=raise"),
                        niterations=4, verbosity=0)
    resumed = equation_search(X, y, options=opts(), niterations=4, verbosity=0,
                              resume_from=str(tmp_path / "ck.pkl"))
    assert _frontier(resumed) == _frontier(full[0])
    assert resumed.num_evals == full[0].num_evals


def test_device_engine_kill_and_resume_on_the_block(cuda, tmp_path, monkeypatch):
    """The engine on the block, killed at iteration 2: its snapshot resumes
    on the block without losing the frontier; nan_flood leaves a finite
    frontier."""
    from symbolicregression_jl_tpu_torch import equation_search, load_checkpoint
    from symbolicregression_jl_tpu_torch.utils.faults import FaultInjected

    monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 500)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)

    def opts(**kw):
        return Options(binary_operators=["+", "-", "*"], unary_operators=["cos"],
                       populations=4, population_size=16, ncycles_per_iteration=50,
                       maxsize=14, seed=0, save_to_file=False, progress=False,
                       scheduler="device", device="cuda",
                       checkpoint_file=str(tmp_path / "dev.pkl"), **kw)

    with pytest.raises(FaultInjected):
        equation_search(X, y, options=opts(checkpoint_every=1,
                                           fault_spec="peer_death@2:mode=raise"),
                        niterations=4, verbosity=0)
    ck = load_checkpoint(str(tmp_path / "dev.pkl"))
    assert (ck.iteration, ck.exact, ck.scheduler) == (2, False, "device")
    res = equation_search(X, y, options=opts(), niterations=4, verbosity=0,
                          resume_from=str(tmp_path / "dev.pkl"))
    st = res.engine_stats
    assert st["block"] == "kernel" and st["iterations"] == 2
    assert min(m.loss for m in res.pareto_frontier) <= min(
        m.loss for m in ck.pareto_frontier) + 1e-5
    assert res.num_evals > ck.num_evals
    flooded = equation_search(X, y, options=opts(fault_spec="nan_flood@1:frac=0.75"),
                              niterations=3, verbosity=0)
    assert flooded.engine_stats["nan_flooded_islands"] == 3
    assert all(np.isfinite(m.loss) for m in flooded.pareto_frontier)


def _quick_engine(device="cuda", **kw):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 500)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    base = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=4,
                population_size=16, ncycles_per_iteration=20, maxsize=14, seed=0,
                save_to_file=False, progress=False, scheduler="device", device=device)
    base.update(kw)
    return X, y, Options(**base)


def _frontier(res):
    o = res.options
    return [(m.get_complexity(o), m.loss, m.tree.string_tree(o.operators, precision=17))
            for m in res.pareto_frontier]


def test_engine_profile_on_the_card(cuda, monkeypatch):
    """profile=True on the block: every iteration profiled, top-level
    fractions summing to 1, the frontier of the unprofiled synchronous run."""
    from symbolicregression_jl_tpu_torch import equation_search

    monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
    X, y, opts = _quick_engine(profile=True)
    res = equation_search(X, y, options=opts, niterations=3, verbosity=0)
    prof = res.engine_profile
    assert prof["iterations"] == 3 and res.engine_stats["block"] == "kernel"
    total = sum(v["fraction"] for k, v in prof["stages"].items() if "/" not in k)
    assert 0.99 <= total <= 1.01
    _, _, plain = _quick_engine(async_readback=False)
    assert _frontier(res) == _frontier(equation_search(X, y, options=plain, niterations=3,
                                                       verbosity=0))


def test_engine_neldermead_on_the_card(cuda, monkeypatch):
    """NelderMead in the engine: B1 only, no B2 launch."""
    from symbolicregression_jl_tpu_torch import equation_search

    monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
    X, y, opts = _quick_engine(optimizer_algorithm="NelderMead")
    b1, b2 = fused_loss.launches, fused_loss_grad.launches
    res = equation_search(X, y, options=opts, niterations=2, verbosity=0)
    st = res.engine_stats
    assert fused_loss_grad.launches == b2 and st["grad_calls"] == 0
    assert fused_loss.launches - b1 == st["score_calls"] > 0
    assert np.isfinite(min(m.loss for m in res.pareto_frontier))


def test_engine_recorder_and_units_on_the_card(cuda, monkeypatch, tmp_path):
    """The recorder and units leave the block for the event leg; its evolve
    leg stays free of host syncs with the event log and the dimension
    check, and the record holds every mutation event."""
    import contextlib
    import json

    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch import equation_search
    from symbolicregression_jl_tpu_torch.dimensional_analysis import (
        violates_dimensional_constraints,
    )

    @contextlib.contextmanager
    def guard(name):
        torch.cuda.set_sync_debug_mode("error" if name == "evolve" else 0)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
    monkeypatch.setattr(ds, "_LEG_WRAP", guard)
    rec = tmp_path / "r.json"
    X, y, opts = _quick_engine(use_recorder=True, crossover_probability=0.0,
                               recorder_file=str(rec))
    res = equation_search(X, y, options=opts, niterations=2, verbosity=0)
    assert res.engine_stats["block"] is None
    events = [e for m in json.loads(rec.read_text())["mutations"].values() for e in m["events"]]
    assert sum(e["type"] == "mutate" for e in events) == 4 * 2 * 20 * 2
    rng = np.random.default_rng(1)
    Xu = rng.uniform(1, 5, size=(3, 500)).astype(np.float32)
    yu = (Xu[0] * Xu[1] ** 2 / Xu[2]).astype(np.float32)
    _, _, uopts = _quick_engine(binary_operators=["+", "-", "*", "/"],
                                unary_operators=["sqrt", "cos"])
    res = equation_search(Xu, yu, options=uopts, niterations=2, verbosity=0,
                          X_units=["kg", "m/s", "m"], y_units="N")
    assert res.engine_stats["block"] is None
    for m in res.pareto_frontier:
        if violates_dimensional_constraints(m.tree, res.dataset, uopts):
            assert m.loss >= 1000.0


# --------------------------------------------------------------------------
# The lane axis (the fleet)
# --------------------------------------------------------------------------


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("P_lane", [4200, 64])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_lane_axis_loss_kernels_equal_solo_launches(cuda, P_lane, weighted):
    """B1 and B2 on the lane axis (3 lanes, one y and w each, 10k rows): one
    launch each, within tolerance of the plain versions, and bit for bit the
    three solo launches. At 4,200 programs a lane the solo launch cuts each
    program's rows into 2 chunks, where a shape taken from all 12,600 would
    take 1: the geometry comes from one lane."""
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import loss_geometry

    L, R = 3, 10_000
    opts = Options(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp", "abs"],
                   maxsize=20, device="cuda")
    prog, vals, X, y, w = _inputs(opts, L * P_lane, R, seed=P_lane, device=cuda)
    if P_lane == 4200:
        assert loss_geometry(P_lane, opts.max_nodes, R)[4] == 2
        assert loss_geometry(L * P_lane, opts.max_nodes, R)[4] == 1
    Xl = X.expand(L, -1, -1).contiguous()
    Y = torch.stack([y * (l + 1) for l in range(L)])
    W = torch.stack([w.roll(l) for l in range(L)]) if weighted else None
    ops, loss = opts.operators, opts.loss
    b1, b2 = fused_loss.launches, fused_loss_grad.launches
    got = fused_loss(prog, vals, Xl, Y, W, ops, loss)
    gl, gg = fused_loss_grad(prog, vals, Xl, Y, W, ops, loss)
    assert (fused_loss.launches, fused_loss_grad.launches) == (b1 + 1, b2 + 1)
    P = P_lane
    solo = [fused_loss(prog[l * P:(l + 1) * P], vals[l * P:(l + 1) * P], X, Y[l],
                       None if W is None else W[l], ops, loss) for l in range(L)]
    solo_g = [fused_loss_grad(prog[l * P:(l + 1) * P], vals[l * P:(l + 1) * P], X, Y[l],
                              None if W is None else W[l], ops, loss) for l in range(L)]
    assert torch.equal(_bits(got), _bits(torch.cat(solo)))
    assert torch.equal(_bits(gl), _bits(torch.cat([s[0] for s in solo_g])))
    assert torch.equal(_bits(gg), _bits(torch.cat([s[1] for s in solo_g])))
    _close(got, fused_loss_reference(prog, vals, Xl, Y, W, ops, loss))
    rl, rg = fused_loss_grad_reference(prog, vals, Xl, Y, W, ops, loss)
    _close(gl, rl)
    assert_grads_close(gg, rg)


def test_lane_axis_block_kernel_equals_solo_launches(cuda):
    """B3 on the lane axis: 3 lanes, each its own population, data and
    scalars, in one launch of 3 x 6 blocks: bit for bit the solo launches,
    integers equal to the plain version."""
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import (
        evolve_block, evolve_block_reference,
    )

    lanes = [_block_inputs(cuda, 4, True, seed=10 + l) for l in range(3)]
    cfg, ops, loss = lanes[0][-3:]
    stacked = tuple(torch.cat([a[k] for a in lanes]) for k in range(6))
    scal = tuple(torch.stack([a[k] for a in lanes]) for k in range(6, 11))
    data = tuple(torch.stack([a[k] for a in lanes]) for k in range(11, 14))
    before = evolve_block.launches
    got = evolve_block(*stacked, *scal, *data, cfg, ops, loss)
    assert evolve_block.launches == before + 1
    solo = [evolve_block(*a) for a in lanes]
    for k, g in enumerate(got):
        assert torch.equal(_bits(g), _bits(torch.cat([s[k] for s in solo]))), k
    ref = evolve_block_reference(*stacked, *scal, *data, cfg, ops, loss)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        if not r.dtype.is_floating_point:
            assert torch.equal(g.cpu(), r.cpu())


@pytest.mark.parametrize("block", [True, False], ids=["block", "event"])
def test_fleet_on_the_card(cuda, monkeypatch, block):
    """Two lanes of the quick engine on the card equal their solo runs; on
    the block one B3 launch per iteration for both, with no host sync in the
    evolve leg."""
    import contextlib

    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch import equation_search
    from symbolicregression_jl_tpu_torch.models.device_search import FleetLaneSpec, fleet_search
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block

    if block:
        monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
    else:
        monkeypatch.setenv("SR_ENGINE_BLOCK", "0")

    @contextlib.contextmanager
    def guard(name):
        torch.cuda.set_sync_debug_mode("error" if name == "evolve" else 0)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    X, y, opts = _quick_engine()
    y2 = (X[0] * X[1] + 1).astype(np.float32)
    _, _, opts2 = _quick_engine(seed=1)
    b3 = evolve_block.launches
    monkeypatch.setattr(ds, "_LEG_WRAP", guard)
    res = fleet_search([FleetLaneSpec(X=X, y=y, options=opts, niterations=2),
                        FleetLaneSpec(X=X, y=y2, options=opts2, niterations=2)])
    assert evolve_block.launches - b3 == (2 if block else 0)
    monkeypatch.setattr(ds, "_LEG_WRAP", None)
    for r, yy, o in ((res[0], y, opts), (res[1], y2, opts2)):
        solo = equation_search(X, yy, options=o, niterations=2, verbosity=0)
        assert r.engine_stats["block"] == solo.engine_stats["block"]
        assert _frontier(r) == _frontier(solo) and r.num_evals == solo.num_evals


@pytest.mark.parametrize("block", [True, False], ids=["block", "event"])
def test_stream_session_on_the_card(cuda, monkeypatch, block):
    """A stream session on the card, a step at a time: an identical
    ``replace_rows`` changes no bit of the frontier; a push in the bucket
    is written into the lane's tensors (same pointers, the rows read back
    equal to the padded host rows), with B3 once per iteration on the block
    and no host sync in any evolve leg."""
    import contextlib
    import dataclasses
    import threading

    import symbolicregression_jl_tpu_torch.models.device_search as ds
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block
    from symbolicregression_jl_tpu_torch.ops.scoring import pad_rows_np
    from symbolicregression_jl_tpu_torch.stream import StreamSession

    if block:
        monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
    else:
        monkeypatch.setenv("SR_ENGINE_BLOCK", "0")

    @contextlib.contextmanager
    def guard(name):
        torch.cuda.set_sync_debug_mode("error" if name == "evolve" else 0)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(ds, "_LEG_WRAP", guard)
    X, y, opts = _quick_engine()

    def run(touch):
        arrived, release = threading.Semaphore(0), threading.Semaphore(0)

        def cb(report):
            arrived.release()
            release.acquire()

        def step():
            release.release()
            assert arrived.acquire(timeout=300), sess.error

        sess = StreamSession(X[:, :400], y[:400], dataclasses.replace(opts, iteration_callback=cb),
                             row_bucket=512)
        b3 = evolve_block.launches
        sess.start()
        assert arrived.acquire(timeout=300), sess.error
        ptrs = tuple(t.data_ptr() for t in sess._lane.data)
        if touch:
            sess.replace_rows(X[:, :400], y[:400])
        step()
        sess.push_rows(X[:, 400:], y[400:])
        step()
        assert tuple(t.data_ptr() for t in sess._lane.data) == ptrs
        _, yp, wp = pad_rows_np(X, y, None, 512)
        assert torch.equal(sess._lane.data.y.cpu(), torch.from_numpy(yp))
        assert torch.equal(sess._lane.data.w.cpu(), torch.from_numpy(wp))
        sess.request_stop()
        release.release()
        assert sess.wait(timeout=300), sess.error
        res = sess.stop()
        assert sess.error is None and res.stop_reason == "callback"
        assert sess.stats.updates_applied == 1 + int(touch)
        assert evolve_block.launches - b3 == (3 if block else 0)
        return _frontier(res)

    assert run(False) == run(True)


@pytest.mark.parametrize("block", [True, False], ids=["block", "event"])
def test_server_coalesced_fleet_on_the_card(cuda, monkeypatch, block):
    """Two same-bucket jobs through ``SearchServer(fleet=True)`` on the
    card run as one fleet: each equals its direct run bit for bit, streams
    one frame per iteration and the final one, and on the block the fleet
    launches B3 once per iteration for both."""
    from symbolicregression_jl_tpu_torch import equation_search
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block
    from symbolicregression_jl_tpu_torch.serve import DONE, JobSpec, SearchServer

    if block:
        monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
    else:
        monkeypatch.setenv("SR_ENGINE_BLOCK", "0")
    X, y, opts = _quick_engine()
    _, _, opts2 = _quick_engine(seed=1)
    want = [equation_search(X, y, options=o, niterations=2, verbosity=0) for o in (opts, opts2)]
    b3 = evolve_block.launches
    with SearchServer(max_concurrency=2, fleet=True) as srv:
        srv.pause_admission()
        ids = [srv.submit(JobSpec(X, y, options=o, niterations=2)) for o in (opts, opts2)]
        srv.resume_admission()
        jobs = [srv.wait(i, timeout=300) for i in ids]
        assert all(j.state == DONE for j in jobs), [j.summary() for j in jobs]
        assert srv.stats()["fleet"]["batches"] == 1
        assert all(len(srv.frames(j.id)) == 3 for j in jobs)
    assert evolve_block.launches - b3 == (2 if block else 0)
    for job, w in zip(jobs, want):
        assert job.result.engine_stats["fleet"]["lanes"] == 2
        assert _frontier(job.result) == _frontier(w) and job.result.num_evals == w.num_evals


@pytest.mark.parametrize("block", [True, False], ids=["block", "event"])
def test_wire_job_on_the_card(cuda, monkeypatch, block):
    """A job submitted and streamed through ``NetServer`` and ``SRClient``
    runs on the card: its last pushed frame holds the frontier and num_evals
    of its direct run bit for bit, the pushed frames equal the pulled ones,
    and on the block B3 runs once per iteration."""
    from symbolicregression_jl_tpu_torch import equation_search
    from symbolicregression_jl_tpu_torch.complexity import compute_complexity
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block
    from symbolicregression_jl_tpu_torch.serve import JobSpec, NetServer, SearchServer, SRClient

    if block:
        monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
    else:
        monkeypatch.setenv("SR_ENGINE_BLOCK", "0")
    X, y, opts = _quick_engine()
    want = equation_search(X, y, options=opts, niterations=2, verbosity=0)
    b3 = evolve_block.launches
    with SearchServer(max_concurrency=1) as srv, NetServer(srv, port=0) as net, \
            SRClient("127.0.0.1", net.port) as cli:
        jid = cli.submit(JobSpec(X, y, options=opts, niterations=2))
        frames = list(cli.iter_frames(jid, timeout=300))
        assert cli.wait(jid, timeout=300)["state"] == "done"
        assert cli.frames(jid) == frames and len(frames) == 3
        assert srv.job(jid).result.engine_stats["block"] == ("kernel" if block else None)
    assert evolve_block.launches - b3 == (2 if block else 0)
    last = cli.decode_frame(frames[-1])
    got = [(compute_complexity(m.tree, opts), m.loss,
            m.tree.string_tree(opts.operators, precision=17)) for m in last.members]
    assert got == _frontier(want) and last.num_evals == want.num_evals


# -- slice 2 on the card: objectives (B4, the seeded sweep), DAGs, complex ----------


def _mse_objective(preds, y, w):
    err = (preds - y[None, :]) ** 2
    if w is None:
        return err.mean(-1)
    return (err * w[None, :]).sum(-1) / w.sum()


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_objective_through_b4_matches_b1(cuda, weighted):
    """A weighted-MSE objective on B4's predictions gives B1's losses (the
    same elementwise values; the sums' order differs: rtol 1e-5), with inf
    on the same trees; one B4 launch, no B1 launch."""
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import objective_losses

    opts = Options(binary_operators=list(BINARY_OPS), unary_operators=list(UNARY_OPS),
                   maxsize=20, device="cuda")
    prog, vals, X, y, w = _inputs(opts, 300, 1000, seed=21, device=cuda)
    w = w if weighted else None
    b1, b4 = fused_loss.launches, eval_trees_kernel.launches
    got = objective_losses(prog, vals, X, y, w, opts.operators, _mse_objective)
    assert fused_loss.launches == b1 and eval_trees_kernel.launches == b4 + 1
    want = fused_loss(prog, vals, X, y, w, opts.operators, opts.loss)
    torch.cuda.synchronize()
    got, want = got.cpu().double().numpy(), want.cpu().double().numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    m = np.isfinite(want) & (np.abs(want) < 1e30)
    assert m.sum() > 30
    np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_rows", [1, 50, 1000, 10_000])
def test_seeded_sweep_matches_plain_version(cuda, n_rows):
    """``preds_vjp`` (B2's seeded mode) against ``preds_vjp_reference`` on a
    random seed (B2's gradient tolerance; equal non-finite positions), one
    launch counted on ``preds_vjp.launches`` and none on B2's;
    two launches give identical bits; ``DiffPreds`` is one B4 launch forward
    and one seeded launch backward."""
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import (
        DiffPreds, preds_vjp, preds_vjp_reference,
    )

    opts = Options(binary_operators=list(BINARY_OPS), unary_operators=list(UNARY_OPS),
                   maxsize=20, device="cuda")
    prog, vals, X, y, w = _inputs(opts, 256, n_rows, seed=n_rows + 3, device=cuda)
    seed = torch.randn((256, n_rows), generator=torch.Generator().manual_seed(n_rows)).to(cuda)
    b2, v0 = fused_loss_grad.launches, preds_vjp.launches
    got = preds_vjp(prog, vals, X, seed, opts.operators)
    again = preds_vjp(prog, vals, X, seed, opts.operators)
    assert preds_vjp.launches == v0 + 2 and fused_loss_grad.launches == b2
    want = preds_vjp_reference(prog, vals, X, seed, opts.operators)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    # NaN only where the plain version has it (an inf - inf in a tree's sum)
    assert_grads_close(got, want)
    v = vals.clone().requires_grad_(True)
    b4 = eval_trees_kernel.launches
    preds = DiffPreds.apply(v, prog, X, opts.operators)
    (gd,) = torch.autograd.grad(preds, v, seed)
    assert eval_trees_kernel.launches == b4 + 1 and preds_vjp.launches == v0 + 3
    ok = torch.isfinite(preds.detach()).all(-1)
    assert torch.equal(gd[ok].view(torch.int32), got[ok].view(torch.int32))
    assert bool((gd[~ok] == 0).all())


def test_repointed_dag_batches_in_b1(cuda):
    """Graph-node DAGs: B1 on the raw flattening scores the trees that are
    not stack-sound inf; on ``stack_sound_pointers``' programs every tree
    equals the plain version on the raw programs (rtol 1e-5)."""
    from symbolicregression_jl_tpu_torch.models.mutation_functions import form_random_connection
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import stack_sound_pointers

    opts = Options(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                   maxsize=20, graph_nodes=True, device="cuda")
    rng = np.random.default_rng(4)
    trees = []
    while len(trees) < 256:
        t = gen_random_tree(int(rng.integers(2, 8)), opts.operators, 3, rng)
        for _ in range(int(rng.integers(1, 4))):
            t = form_random_connection(t, rng)
        if t.count_nodes() <= opts.max_nodes:
            trees.append(t)
    flat = flatten_trees(trees, opts.max_nodes)
    X = torch.from_numpy(rng.normal(size=(3, 1000)).astype(np.float32)).to(cuda)
    y = torch.cos(X[0]).contiguous()
    raw = [torch.from_numpy(a).to(cuda) for a in pack_programs_fused(flat, opts.operators)]
    rep = [torch.from_numpy(a).to(cuda) for a in
           pack_programs_fused(stack_sound_pointers(flat), opts.operators)]
    got_raw = fused_loss(*raw, X, y, None, opts.operators, opts.loss)
    got = fused_loss(*rep, X, y, None, opts.operators, opts.loss)
    want = fused_loss_reference(*raw, X, y, None, opts.operators, opts.loss)
    torch.cuda.synchronize()
    lost = torch.isinf(got_raw) & torch.isfinite(want)
    assert int(lost.sum()) >= 10
    g, r = got.cpu().double().numpy(), want.cpu().double().numpy()
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(r))
    m = np.isfinite(r)
    np.testing.assert_allclose(g[m], r[m], rtol=1e-5, atol=1e-6)


def test_complex_operators_and_search_on_the_card(cuda):
    """Every operator of the complex table runs on the card in complex64 and
    agrees with the CPU (rtol 1e-4: the two libms); a complex lockstep
    search runs on the card to a finite real loss."""
    from symbolicregression_jl_tpu_torch import equation_search
    from symbolicregression_jl_tpu_torch.ops.operators import COMPLEX_IMPLS

    rng = np.random.default_rng(0)
    a = (rng.normal(size=4096) + 1j * rng.normal(size=4096)).astype(np.complex64)
    b = (rng.normal(size=4096) + 1j * rng.normal(size=4096)).astype(np.complex64)
    for name, fn in COMPLEX_IMPLS.items():
        args = (a, b) if name in ("add", "sub", "mult", "div", "pow") else (a,)
        got = fn(*(torch.from_numpy(x).to(cuda) for x in args)).cpu().numpy()
        want = fn(*(torch.from_numpy(x) for x in args)).numpy()
        assert got.dtype == np.complex64
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=name)
    X = a[None, :200]
    y = ((2 - 0.5j) * np.cos((1 + 1j) * X[0])).astype(np.complex64)
    opts = Options(binary_operators=["+", "*"], unary_operators=["cos"], dtype=np.complex64,
                   populations=3, population_size=16, ncycles_per_iteration=20, maxsize=10,
                   seed=0, save_to_file=False)
    res = equation_search(X, y, options=opts, niterations=2, verbosity=0)
    best = min(m.loss for m in res.pareto_frontier)
    assert isinstance(best, float) and np.isfinite(best)


def test_device_engine_under_an_objective_on_the_card(cuda, monkeypatch):
    """The engine under an objective on the card: the event leg (the block
    off), B4 launches equal to its scoring calls plus its gradient calls
    (each gradient's forward), seeded sweeps equal to its gradient calls,
    no B1, B2 or B3 launch; every frontier loss is the MSE of its tree
    (rtol 2e-4, atol 1e-6: a planted fit's loss is near 0)."""
    from symbolicregression_jl_tpu_torch import equation_search
    from symbolicregression_jl_tpu_torch.ops.evolve_block_cuda import evolve_block
    from symbolicregression_jl_tpu_torch.ops.interp_cuda import preds_vjp

    monkeypatch.delenv("SR_ENGINE_BLOCK", raising=False)
    rng = np.random.default_rng(1)
    X = rng.normal(size=(2, 500)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    opts = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"],
                   loss_function_jit=_mse_objective, populations=4, population_size=20,
                   ncycles_per_iteration=10, maxsize=12, seed=0, scheduler="device",
                   save_to_file=False)
    counts = [w.launches for w in (fused_loss, fused_loss_grad, evolve_block,
                                   eval_trees_kernel, preds_vjp)]
    res = equation_search(X, y, options=opts, niterations=2, verbosity=0)
    torch.cuda.synchronize()
    d = [w.launches - c for w, c in zip((fused_loss, fused_loss_grad, evolve_block,
                                        eval_trees_kernel, preds_vjp), counts)]
    st = res.engine_stats
    assert st["block"] is None and d[:3] == [0, 0, 0]
    assert st["score_calls"] > 0 and d[4] == st["grad_calls"] > 0
    assert d[3] == st["score_calls"] + st["grad_calls"]
    for m in res.pareto_frontier:
        want = float(np.mean((m.tree.eval_np(X, opts.operators) - y) ** 2))
        np.testing.assert_allclose(m.loss, want, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_row_sharded_loss_over_one_card_twice(cuda, weighted):
    """``make_sharded_loss`` over [cuda:0, cuda:0] (rows in two shards, one
    B1 launch each) agrees with one B1 launch over all rows to rtol 1e-5,
    with equal ok flags; two launches are counted."""
    from symbolicregression_jl_tpu_torch.parallel.mesh import make_mesh
    from symbolicregression_jl_tpu_torch.parallel.sharding import (
        make_sharded_loss, shard_dataset, shard_population,
    )

    opts = Options(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                   maxsize=16, device="cuda")
    rng = np.random.default_rng(7)
    Xn = rng.normal(size=(3, 4096)).astype(np.float32)
    yn = (Xn[0] * Xn[1] + np.cos(Xn[2])).astype(np.float32)
    wn = rng.uniform(0.5, 1.5, size=4096).astype(np.float32) if weighted else None
    flat = flatten_trees([gen_random_tree(int(rng.integers(1, 8)), opts.operators, 3, rng)
                          for _ in range(64)], opts.max_nodes)
    prog, vals = (torch.from_numpy(a).to(cuda) for a in pack_programs_fused(flat, opts.operators))
    X, y = torch.from_numpy(Xn).to(cuda), torch.from_numpy(yn).to(cuda)
    w = None if wn is None else torch.from_numpy(wn).to(cuda)
    one = fused_loss(prog, vals, X, y, w, opts.operators, opts.loss).cpu().numpy()
    mesh = make_mesh(1, 2, devices=[cuda, cuda])
    fn = make_sharded_loss(mesh, opts.operators, opts.loss, has_weights=weighted)
    Xs, ys, ws = shard_dataset(mesh, X, y, w)
    before = fused_loss.launches
    got = fn(shard_population(mesh, flat), Xs, ys, ws).cpu().numpy()
    assert fused_loss.launches - before == 2
    assert (np.isfinite(got) == np.isfinite(one)).all()
    fin = np.isfinite(one)
    np.testing.assert_allclose(got[fin], one[fin], rtol=1e-5, atol=1e-6)


def test_world_of_two_on_the_card(cuda, tmp_path):
    """Two processes joined by ``initialize`` (TCPStore on 127.0.0.1, gloo)
    share the card, each the device engine on 8 of 16 islands at the quick
    start's size (16 islands, not 15, so that they split in two): both end
    with identical halls of fame, and each launched B1 for every scoring
    call."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    script = tmp_path / "worker.py"
    script.write_text(f"""
import sys
sys.path.insert(0, {repo!r})
rank = int(sys.argv[1])
from symbolicregression_jl_tpu_torch.parallel.distributed import initialize
initialize(coordinator_address="127.0.0.1:{port}", num_processes=2, process_id=rank)
import numpy as np
from symbolicregression_jl_tpu_torch import Options, equation_search
from symbolicregression_jl_tpu_torch.ops.interp_cuda import fused_loss
rng = np.random.default_rng(0)
X = rng.normal(size=(2, 200)).astype(np.float32)
y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
o = Options(binary_operators=["+", "-", "*"], unary_operators=["cos"], populations=16,
            population_size=33, ncycles_per_iteration=100, maxsize=16, seed=0,
            scheduler="device", save_to_file=False, device="cuda")
res = equation_search(X, y, options=o, niterations=3, verbosity=0)
assert fused_loss.launches == res.engine_stats["score_calls"] > 0
front = ";".join(f"{{m.get_complexity(o)}}:{{m.loss!r}}" for m in res.pareto_frontier)
print("RESULT", front, flush=True)
""")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("SR_", "WORLD_SIZE"))}
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    fronts = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        fronts.append(next(ln for ln in out.splitlines() if ln.startswith("RESULT")))
    assert fronts[0] == fronts[1]
