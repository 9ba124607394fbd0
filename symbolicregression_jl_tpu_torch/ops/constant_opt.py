"""Batched constant optimization: BFGS, Newton and Nelder–Mead in PyTorch.

Counterpart of ``symbolicregression_jl_tpu/ops/constant_opt.py`` (the
reference's Optim.jl inner loop, SymbolicRegression.jl
src/ConstantOptimization.jl:11-83: BFGS with backtracking, 8 iterations,
2 random restarts). Every (tree, restart) pair of a call is one row of a
batch: the loss of all rows is one interpreter sweep, and gradients come from
the reverse-sweep VJP of ops/interp.py (``_EvalTrees``). The JAX package
vmaps a ``lax.while_loop`` per row; here the loops run over the whole batch
with per-row masks, which gives each row exactly the iterates its own loop
would produce (a finished row is carried unchanged).

Trees with exactly one constant use Newton with backtracking, the
reference's special case (src/ConstantOptimization.jl:22-41); its curvature
is a Hessian-vector product through the autograd-recorded interpreter.
Constants are kept only if the loss improved (src/ConstantOptimization.jl:
70-78).

Complex constants are optimized through the real 2N view v = [re; im] (the
JAX package's ``complex_n``; the reference drives Optim's BFGS for complex
T the equivalent way, src/ConstantOptimization.jl:27): torch's gradient of a
real loss with respect to a complex tensor is d/d re + i d/d im, which
``torch.complex(v[:, :N], v[:, N:])`` hands back to the two halves. A full
objective (``Options.loss_function_jit``) replaces the elementwise loss in
the optimizer as in the scorer. Under ``graph_nodes`` the trees that share
a subtree pass through unchanged and rescored (the JAX package's rule: a
shared constant would expand into independent parameters and the writeback
would unshare the DAG).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .flat import (
    KIND_CONST,
    FlatTrees,
    batch_bucket,
    flatten_trees,
    length_buckets,
    length_buckets_enabled,
    slice_nodes,
)
from .interp import eval_plan, eval_plan_autograd, make_plan
from .operators import OperatorSet

__all__ = ["optimize_constants_batched"]


def _clamped_chunk(
    chunk: int, S_r: int, N_slots: int, R_rows: int, dtype, complex_vals: bool,
    budget: float = 2e9,
) -> int:
    """Row-aware chunk clamp: each tree holds ~[S_r, N_slots, R] interpreter
    registers; keep one chunk's buffer under ``budget`` bytes."""
    itemsize = np.dtype(dtype).itemsize
    if complex_vals and np.dtype(dtype).kind != "c":
        itemsize *= 2
    per_instance = max(1, S_r * N_slots * R_rows * itemsize)
    return max(1, min(chunk, int(budget // per_instance)))


class _Objective:
    """Loss of a batch of (tree, constants) rows: f(v [B, N]) -> [B]; under
    ``complex_n`` v is the real view [B, 2N] of complex constants, and under
    ``objective`` the loss is the full objective of the predictions."""

    def __init__(self, flat: FlatTrees, X, y, w, opset: OperatorSet, loss_elem,
                 complex_n: int | None = None, objective=None):
        self.flat = flat
        self.X, self.y, self.w = X, y, w
        self.opset = opset
        self.loss_elem = loss_elem
        self.complex_n = complex_n
        self.objective = objective
        self._plans: dict[int, object] = {}

    def plan(self, repeat: int = 1):
        """Plan of the batch with every row repeated ``repeat`` times."""
        if repeat not in self._plans:
            flat = self.flat
            if repeat > 1:
                flat = FlatTrees(*(np.repeat(np.asarray(a), repeat, axis=0) for a in flat))
            self._plans[repeat] = make_plan(flat, self.opset, self.X.device)
        return self._plans[repeat]

    def _loss(self, pred):
        if self.objective is not None:
            return self.objective(pred, self.y, self.w)
        elem = self.loss_elem(pred, self.y[None, :])
        if self.w is not None:
            return (elem * self.w[None, :]).sum(-1) / self.w.sum()
        return elem.mean(-1)

    def _vals(self, v):
        """The constants the interpreter takes: v itself, or the complex
        values of its real 2N view."""
        if self.complex_n is None:
            return v
        n = self.complex_n
        return torch.complex(v[:, :n], v[:, n:])

    def value(self, v, repeat: int = 1):
        with torch.no_grad():
            return self._loss(eval_plan(self.plan(repeat), self._vals(v), self.X))

    def value_and_grad(self, v):
        v = v.detach().requires_grad_(True)
        with torch.enable_grad():
            f = self._loss(eval_plan(self.plan(), self._vals(v), self.X))
            (g,) = torch.autograd.grad(f.sum(), v)
        return f.detach(), g

    def curvature(self, v, e):
        """e . H(v) e per row, through the autograd-recorded interpreter."""
        v = v.detach().requires_grad_(True)
        with torch.enable_grad():
            f = self._loss(eval_plan_autograd(self.plan(), v, self.X))
            (g,) = torch.autograd.grad(f.sum(), v, create_graph=True)
            gd = (g * e).sum()
            if not gd.requires_grad:
                return torch.zeros(v.shape[0], dtype=v.dtype, device=v.device)
            (hv,) = torch.autograd.grad(gd, v, allow_unused=True)
        if hv is None:
            return torch.zeros(v.shape[0], dtype=v.dtype, device=v.device)
        return (hv * e).sum(-1)


def _rows(m):
    return m[:, None]


def _bfgs(obj: _Objective, v0, mask, iters: int, g_tol: float):
    """Convergence-gated BFGS with Armijo backtracking (c1=1e-4, halving,
    <= 12 steps) on every row; ``mask`` marks the free slots. A row stops
    once its masked gradient's inf-norm drops below ``g_tol`` (0 disables
    the gate). Returns (v, f)."""
    B, N = v0.shape
    eye = torch.eye(N, dtype=v0.dtype, device=v0.device).expand(B, N, N)
    f, g = obj.value_and_grad(v0)
    g = torch.where(mask, g, 0.0)
    x, H = v0.clone(), eye.clone()
    active = torch.ones(B, dtype=torch.bool, device=v0.device)
    for _ in range(iters):
        active = active & ~(g.abs().amax(-1) < g_tol)
        if not bool(active.any()):
            break
        d = -(H @ g[..., None])[..., 0]
        d = torch.where(mask, d, 0.0)
        gtd = (g * d).sum(-1)
        bad_dir = gtd >= 0  # not a descent direction: steepest descent
        d = torch.where(_rows(bad_dir), -g, d)
        gtd = torch.where(bad_dir, -(g * g).sum(-1), gtd)

        alpha = torch.ones_like(f)
        f_new = obj.value(x + d)
        searching = ~(f_new <= f + 1e-4 * alpha * gtd)
        for _ in range(12):
            if not bool((searching & active).any()):
                break
            alpha = torch.where(searching, alpha * 0.5, alpha)
            f_try = obj.value(x + _rows(alpha) * d)
            f_new = torch.where(searching, f_try, f_new)
            searching = searching & ~(f_new <= f + 1e-4 * alpha * gtd)

        ok = torch.isfinite(f_new) & (f_new < f)
        x_new = torch.where(_rows(ok), x + _rows(alpha) * d, x)
        f_next = torch.where(ok, f_new, f)
        _, g_new = obj.value_and_grad(x_new)
        g_new = torch.where(mask, g_new, 0.0)

        s = x_new - x
        yk = g_new - g
        sy = (s * yk).sum(-1)
        upd = sy > 1e-10
        rho = torch.where(upd, 1.0 / torch.where(upd, sy, 1.0), 0.0)
        I_rsy = eye - rho[:, None, None] * (s[:, :, None] * yk[:, None, :])
        H_new = I_rsy @ H @ I_rsy.transpose(1, 2) + rho[:, None, None] * (
            s[:, :, None] * s[:, None, :]
        )
        H_next = torch.where(upd[:, None, None], H_new, H)

        x = torch.where(_rows(active), x_new, x)
        f = torch.where(active, f_next, f)
        g = torch.where(_rows(active), g_new, g)
        H = torch.where(active[:, None, None], H_next, H)
    return x, f


def _newton(obj: _Objective, v0, mask, iters: int, g_tol: float):
    """Newton + backtracking (<= 8 halvings) along the single masked
    constant of each row. Returns (v, f)."""
    e = mask.to(v0.dtype)

    def proj_grad(v):
        return (obj.value_and_grad(v)[1] * e).sum(-1)

    x = v0.clone()
    fx = obj.value(x)
    g = proj_grad(x)
    active = torch.ones(v0.shape[0], dtype=torch.bool, device=v0.device)
    for _ in range(iters):
        active = active & ~(g.abs() < g_tol)
        if not bool(active.any()):
            break
        h = obj.curvature(x, e)
        step = torch.where(h.abs() > 1e-30, -g / h, -g)
        step = torch.where(torch.isfinite(step), step, 0.0)
        alpha = torch.ones_like(fx)
        f_new = obj.value(x + _rows(step) * e)
        searching = ~(f_new < fx)
        for _ in range(8):
            if not bool((searching & active).any()):
                break
            alpha = torch.where(searching, alpha * 0.5, alpha)
            f_try = obj.value(x + _rows(alpha * step) * e)
            f_new = torch.where(searching, f_try, f_new)
            searching = searching & ~(f_new < fx)
        ok = torch.isfinite(f_new) & (f_new < fx)
        x_new = torch.where(_rows(ok), x + _rows(alpha * step) * e, x)
        fx_new = torch.where(ok, f_new, fx)
        g_new = proj_grad(x_new)
        x = torch.where(_rows(active), x_new, x)
        fx = torch.where(active, fx_new, fx)
        g = torch.where(active, g_new, g)
    return x, fx


def _neldermead(obj: _Objective, v0, mask, iters: int, g_tol: float):
    """Masked Nelder–Mead simplex on every row (the reference's configurable
    alternative, src/Options.jl:522-532); derivative-free, so ``g_tol`` is
    unused. Returns (v, f)."""
    B, N = v0.shape
    mf = mask.to(v0.dtype)
    n_v = N + 1

    def f_many(verts):  # [B, n_v, N] -> [B, n_v]
        return obj.value(verts.reshape(B * n_v, N), repeat=n_v).reshape(B, n_v)

    def inf_if_bad(f):
        return torch.where(torch.isfinite(f), f, torch.inf)

    steps = torch.where(v0 != 0, 0.05 * v0, 0.00025) * mf
    verts = torch.cat([v0[:, None], v0[:, None] + torch.diag_embed(steps)], dim=1)
    fvals = inf_if_bad(f_many(verts))
    ar = torch.arange(B, device=v0.device)
    for _ in range(iters):
        order = torch.argsort(fvals, dim=1, stable=True)
        verts = verts[ar[:, None], order]
        fvals = fvals[ar[:, None], order]
        best, worst = verts[:, 0], verts[:, -1]
        centroid = verts[:, :-1].mean(dim=1)
        refl = centroid + (centroid - worst) * mf
        exp_ = centroid + 2.0 * (centroid - worst) * mf
        cont = centroid - 0.5 * (centroid - worst) * mf
        f_r, f_e, f_c = obj.value(refl), obj.value(exp_), obj.value(cont)

        use_exp = (f_r < fvals[:, 0]) & (f_e < f_r)
        use_refl = (f_r < fvals[:, -2]) & ~use_exp
        use_cont = (~use_exp) & (~use_refl) & (f_c < fvals[:, -1])
        new_v = torch.where(
            _rows(use_exp), exp_,
            torch.where(_rows(use_refl), refl, torch.where(_rows(use_cont), cont, worst)),
        )
        new_f = torch.where(
            use_exp, f_e, torch.where(use_refl, f_r, torch.where(use_cont, f_c, fvals[:, -1]))
        )
        shrink = (~use_exp) & (~use_refl) & (~use_cont)
        verts2 = verts.clone()
        verts2[:, -1] = new_v
        fvals2 = fvals.clone()
        fvals2[:, -1] = new_f
        sv = best[:, None] + 0.5 * (verts - best[:, None]) * mf[:, None]
        sf = f_many(sv)
        verts = torch.where(shrink[:, None, None], sv, verts2)
        fvals = torch.where(_rows(shrink), inf_if_bad(sf), fvals2)
    k = torch.argmin(fvals, dim=1)
    return verts[ar, k], fvals[ar, k]


def _optimize_batch(flat, X, y, w, starts, opset, loss_elem, iters, algorithm="BFGS",
                    g_tol=0.0, objective=None):
    """starts: numpy [P, S, N] initial constant vectors (S = 1 + nrestarts).
    Returns the best (val [P, N], loss [P]) over restarts per tree, numpy.

    Trees with exactly one constant use Newton; the others the configured
    algorithm. The batch runs in chunks of trees sized by ``_clamped_chunk``
    (``SR_CONSTOPT_CHUNK`` caps the request; default: the whole batch).
    Complex constants (a complex X) run through the real 2N view, where
    the mask doubles, so a tree with one complex constant has two free
    parameters and takes the configured algorithm, as in the JAX package."""
    P, S, N = starts.shape
    R = X.shape[1]
    complex_vals = X.is_complex()
    chunk = int(os.environ.get("SR_CONSTOPT_CHUNK", P))
    s_r = S * (N + 1) if algorithm == "NelderMead" else S
    chunk = max(1, min(_clamped_chunk(chunk, s_r, N, R, np.float32, complex_vals), P))
    main = _bfgs if algorithm == "BFGS" else _neldermead
    real_dt = X.real.dtype if complex_vals else X.dtype
    vals_out = np.empty((P, N), dtype=np.asarray(flat.val).dtype)
    fs_out = np.empty((P,), dtype=np.float64)
    for c0 in range(0, P, chunk):
        c1 = min(P, c0 + chunk)
        n = c1 - c0
        inst = FlatTrees(*(np.repeat(np.asarray(a)[c0:c1], S, axis=0) for a in flat))
        v0 = starts[c0:c1].reshape(n * S, N)
        mask_np = np.asarray(inst.kind) == KIND_CONST
        if complex_vals:  # the real 2N view [re; im]
            v0 = np.concatenate([v0.real, v0.imag], axis=-1)
            mask_np = np.concatenate([mask_np, mask_np], axis=-1)
        one_const = mask_np.sum(-1) == 1
        v_best = np.empty(v0.shape, dtype=v0.dtype)
        f_best = np.empty((n * S,), dtype=np.float64)
        for sel, fn in ((np.nonzero(~one_const)[0], main), (np.nonzero(one_const)[0], _newton)):
            if sel.size == 0:
                continue
            sub = FlatTrees(*(np.asarray(a)[sel] for a in inst))
            obj = _Objective(sub, X, y, w, opset, loss_elem,
                             complex_n=N if complex_vals else None, objective=objective)
            v_sel = torch.from_numpy(np.ascontiguousarray(v0[sel])).to(X.device, real_dt)
            m_sel = torch.from_numpy(mask_np[sel]).to(X.device)
            v, f = fn(obj, v_sel, m_sel, iters, g_tol)
            v_best[sel] = v.detach().cpu().numpy()
            f_best[sel] = f.detach().double().cpu().numpy()
        if complex_vals:
            v_best = v_best[:, :N] + 1j * v_best[:, N:]
        f_best = np.where(np.isfinite(f_best), f_best, np.inf).reshape(n, S)
        k = np.argmin(f_best, axis=1)
        vals_out[c0:c1] = v_best.reshape(n, S, N)[np.arange(n), k]
        fs_out[c0:c1] = f_best[np.arange(n), k]
    return vals_out, fs_out


def _optimize_constants_custom_objective(trees, scorer, options, rng):
    """Host Nelder–Mead over each tree's constants against the user's full
    ``loss_function`` (which sees the raw tree; the reference drives Optim
    with the same host objective, src/ConstantOptimization.jl:50)."""
    fn = options.loss_function
    ds = scorer.dataset
    n_iters = max(20, 10 * int(options.optimizer_iterations))
    new_trees, losses, improved = [], [], []
    for tree in trees:
        c0 = tree.get_constants()
        if c0.size == 0:
            loss0 = float(fn(tree, ds, options))
            new_trees.append(tree)
            losses.append(loss0)
            improved.append(False)
            continue
        work = tree.copy()

        def obj(c):
            work.set_constants(c)
            try:
                v = float(fn(work, ds, options))
            except Exception:  # noqa: BLE001
                return np.inf
            return v if np.isfinite(v) else np.inf

        best_c, best_f = _host_neldermead(obj, c0, n_iters)
        with scorer._evals_lock:
            scorer.num_evals += n_iters * (len(c0) + 1)
        f0 = obj(c0)
        if best_f < f0:
            out = tree.copy()
            out.set_constants(best_c)
            new_trees.append(out)
            losses.append(best_f)
            improved.append(True)
        else:
            new_trees.append(tree)
            losses.append(f0)
            improved.append(False)
    return new_trees, np.asarray(losses), np.asarray(improved)


def _pass_shared_through(trees, shared, scorer, options, rng, idx):
    """Graph-node batches (the JAX package's rule): optimize only the trees
    without shared subtrees; the others keep their constants and are
    rescored. Returns the results in the input order."""
    plain = [t for t, s in zip(trees, shared) if not s]
    if plain:
        p_trees, p_losses, p_improved = optimize_constants_batched(
            plain, scorer, options, rng, idx=idx
        )
    else:
        p_trees, p_losses, p_improved = [], np.zeros(0), np.zeros(0, bool)
    shared_trees = [t for t, s in zip(trees, shared) if s]
    shared_losses = scorer.loss_many(shared_trees, idx=idx)
    out_t, out_l, out_i = [], [], []
    pi = si = 0
    for s in shared:
        if s:
            out_t.append(shared_trees[si])
            out_l.append(float(shared_losses[si]))
            out_i.append(False)
            si += 1
        else:
            out_t.append(p_trees[pi])
            out_l.append(float(p_losses[pi]))
            out_i.append(bool(p_improved[pi]))
            pi += 1
    return out_t, np.asarray(out_l), np.asarray(out_i)


def _host_neldermead(obj, x0: np.ndarray, iters: int):
    """Minimal dependency-free Nelder–Mead."""
    n = len(x0)
    verts = [np.asarray(x0, dtype=np.float64)]
    for i in range(n):
        v = verts[0].copy()
        v[i] += 0.05 * v[i] if v[i] != 0 else 0.00025
        verts.append(v)
    fvals = [obj(v) for v in verts]
    for _ in range(iters):
        order = np.argsort(fvals)
        verts = [verts[k] for k in order]
        fvals = [fvals[k] for k in order]
        centroid = np.mean(verts[:-1], axis=0)
        refl = centroid + (centroid - verts[-1])
        f_r = obj(refl)
        if f_r < fvals[0]:
            exp_ = centroid + 2 * (centroid - verts[-1])
            f_e = obj(exp_)
            verts[-1], fvals[-1] = (exp_, f_e) if f_e < f_r else (refl, f_r)
        elif f_r < fvals[-2]:
            verts[-1], fvals[-1] = refl, f_r
        else:
            cont = centroid - 0.5 * (centroid - verts[-1])
            f_c = obj(cont)
            if f_c < fvals[-1]:
                verts[-1], fvals[-1] = cont, f_c
            else:
                verts = [verts[0]] + [
                    verts[0] + 0.5 * (v - verts[0]) for v in verts[1:]
                ]
                fvals = [fvals[0]] + [obj(v) for v in verts[1:]]
    k = int(np.argmin(fvals))
    return verts[k], fvals[k]


def optimize_constants_batched(
    trees,
    scorer,
    options,
    rng: np.random.Generator,
    idx: np.ndarray | None = None,
):
    """Optimize the constants of ``trees`` as one batch.

    Returns (new_trees, losses, improved_mask); trees without constants pass
    through. Constants are kept only when the loss improved
    (src/ConstantOptimization.jl:70-78)."""
    if not trees:
        return [], np.zeros((0,)), np.zeros((0,), dtype=bool)
    if options.loss_function is not None:
        return _optimize_constants_custom_objective(trees, scorer, options, rng)
    if options.graph_nodes:
        shared = [t.count_unique_nodes() != t.count_nodes() for t in trees]
        if any(shared):
            return _pass_shared_through(trees, shared, scorer, options, rng, idx)

    n_real = len(trees)
    dtype = scorer.dtype
    max_nodes = scorer.max_nodes
    S = 1 + options.optimizer_nrestarts
    # the restart jitter is drawn over the power-of-two batch bucket, as the
    # JAX package draws it, so both consume the same numpy stream
    P = batch_bucket(n_real)
    flat = flatten_trees(trees, max_nodes, dtype=dtype)
    N = flat.kind.shape[1]

    # restart jitter x(1 + sigma/2 * randn), sigma=1 like the reference's
    # perturbed re-starts (src/ConstantOptimization.jl:53-68)
    base = flat.val[:, None, :].repeat(S, axis=1).astype(dtype)  # [n_real,S,N]
    if np.dtype(dtype).kind == "c":
        # complex noise: restarts must perturb PHASE as well as magnitude
        # (the reference's T-typed perturbation draws complex noise; a
        # real-only jitter can never escape a wrong-phase basin)
        noise = (
            rng.standard_normal(size=(P, S - 1, N))
            + 1j * rng.standard_normal(size=(P, S - 1, N))
        ) / np.sqrt(2.0)
        jitter = 1.0 + 0.5 * noise.astype(dtype)
    else:
        jitter = 1.0 + 0.5 * rng.standard_normal(size=(P, S - 1, N)).astype(dtype)
    base[:, 1:, :] *= jitter[:n_real]

    X, y, w = scorer.rows(idx)

    iters = int(options.optimizer_iterations)
    if options.optimizer_f_calls_limit:
        # ~4 objective evaluations per iteration per restart (value+grad +
        # line search); the reference passes f_calls_limit to Optim.Options
        iters = max(1, min(iters, int(options.optimizer_f_calls_limit) // (4 * S)))
    g_tol = float(options.optimizer_g_tol)

    def run_batch(flat_b, starts_b):
        return _optimize_batch(
            flat_b, X, y, w, starts_b, scorer.opset, scorer.loss_elem, iters,
            algorithm=options.optimizer_algorithm, g_tol=g_tol,
            objective=options.loss_function_jit,
        )

    # length-bucketed dispatch: each bucket runs at its own node count
    parts = length_buckets(np.asarray(flat.length), N)
    if length_buckets_enabled() and not (len(parts) == 1 and parts[0][0] == N):
        vals = np.array(flat.val, dtype=dtype)
        fs = np.empty((n_real,), dtype=np.float64)
        for n_b, sel in parts:
            sub = FlatTrees(*(np.asarray(a)[sel] for a in flat))
            vals_b, fs_b = run_batch(slice_nodes(sub, n_b), base[sel][:, :, :n_b])
            vals[sel, :n_b] = vals_b
            fs[sel] = fs_b
    else:
        vals, fs = run_batch(flat, base)

    # eval accounting: ~2 evals (value+grad) per iteration per restart
    n_rows = scorer.dataset.n if idx is None else len(idx)
    with scorer._evals_lock:
        scorer.num_evals += n_real * S * 2 * iters * (n_rows / scorer.dataset.n)

    orig_losses = scorer.loss_many(trees, idx=idx)
    # the optimizer's objective sums in another order than the scorer, so a
    # tree without constants could otherwise "improve" by rounding alone
    has_consts = np.array([t.has_constants() for t in trees])
    improved = (fs < orig_losses) & has_consts
    new_trees = []
    for p, tree in enumerate(trees):
        if improved[p]:
            new = tree.copy()
            consts = vals[p][np.asarray(flat.kind[p]) == KIND_CONST]
            new.set_constants(consts)
            new_trees.append(new)
        else:
            new_trees.append(tree)
    final_losses = np.where(improved, fs, orig_losses)
    return new_trees, final_losses, improved
