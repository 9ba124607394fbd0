"""The fused tree kernels: CUDA kernels, plain versions, build, launch counts.

Three hand-written CUDA kernels, each with a wrapper, a plain PyTorch version
and a launch count (``<wrapper>.launches``):

- B1, ``fused_loss`` (``csrc/fused_loss.cu``), replaces the TPU kernel
  ``symbolicregression_jl_tpu/ops/interp_pallas.py:258``
  (``_make_loss_kernel`` via ``_loss_pallas``). Per tree it evaluates the
  packed postorder program on every row, applies the elementwise loss, and
  reduces to ``loss_sum / w_sum`` — or ``inf`` when any real row's
  prediction is non-finite or ``w_sum == 0``.
- B2, ``fused_loss_grad`` (``csrc/fused_loss_grad.cu``), replaces
  ``interp_pallas.py:725`` (``_make_loss_grad_kernel`` via
  ``_loss_grad_pallas``): B1's losses plus the gradient of each loss with
  respect to every constant slot, from a reverse adjoint sweep (0 where the
  loss is not ok). ``DiffLoss`` is the counterpart of the JAX package's
  ``pallas_diff_loss`` custom VJP: its forward is B1, and a call that needs
  the gradient makes one B2 launch instead, whose gradients the backward
  returns.
- B4, ``eval_trees_kernel`` (``csrc/eval_preds.cu``), replaces
  ``interp_pallas.py:73`` (``_make_kernel`` via ``_eval_pallas``): B1's
  forward pass writing the prediction matrix [P, R] instead of a loss. Its
  plain version is ``ops/interp.eval_trees``; ``eval_preds`` launches it on
  packed programs already on the card. As in the JAX package, only tests
  (and ``chip_smoke.py``) call it.

All four kernels of the repo, these three and the evolve block, evaluate on
one multi-row interpreter core, ``csrc/sr_interp.cuh``; they take
stack-sound programs, as every postorder flattening of a tree is, and score
any other program inf (B2: with zero gradients; B4 predicts NaN). The source
files' headers say what bounds each kernel on the H100 and what its design
does about that. A tensor on the CPU takes the plain version (the
interpreter of ops/interp.py plus the same loss and reduction, and for B2
its reverse sweep and autograd of the loss); a CUDA tensor launches the
kernel or raises. Each source is built with ``nvcc`` into a shared library
with a plain C interface, at first use, under ``_build/`` beside the package
(listed in .gitignore), and bound with ``ctypes``.

The evolve block B3 (``csrc/evolve_block.cu``) is built here with the others;
its wrapper is ``ops/evolve_block_cuda.evolve_block``.

Unlike the TPU kernels, rows are masked by index (no 10240-row padding, no
(8, C) sublane layout) and any batch size P is accepted.

B1 and B2 take a lane axis, the counterpart of ``jax.vmap`` over the
``pallas_call`` in the JAX package's fleet (``ops/evolve.py``
``_run_fleet_iteration_fused_impl``): X [L, F, R], y [L, R] and w [L, R]
hold L datasets, the P programs are L lanes of P / L, lane-major, and
program p is scored on lane p // (P / L). The launch shape is taken from the
lane's P / L programs, so each program's rows are cut into the chunks of its
solo launch and its loss and gradient have the solo's bits. A solo call
(X [F, R]) is the one-lane case of the same entry point. The plain versions
run lane by lane (``over_lanes``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .flat import KIND_BINARY, KIND_CONST, KIND_UNARY, KIND_VAR, FlatTrees
from .interp import _forward, _reverse_sweep, eval_trees, make_plan
from .losses import kernel_loss_spec
from .operators import OperatorSet, kernel_op_table

__all__ = [
    "fused_loss",
    "fused_loss_reference",
    "fused_loss_grad",
    "fused_loss_grad_reference",
    "plain_losses",
    "eval_trees_kernel",
    "eval_preds",
    "DiffLoss",
    "pack_programs_fused",
    "unpack_programs_fused",
    "loss_kernel_eligible",
    "over_lanes",
    "build",
    "build_all",
    "BUILD_INFO",
    "work_counts",
    "grad_work_counts",
    "preds_work_counts",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
#: kernel name -> CUDA source; every source includes the shared header
SOURCES = {
    "fused_loss": CSRC / "fused_loss.cu",
    "fused_loss_grad": CSRC / "fused_loss_grad.cu",
    "evolve_block": CSRC / "evolve_block.cu",
    "eval_preds": CSRC / "eval_preds.cu",
}
#: the shared headers: operators and losses; the multi-row interpreter core
HEADERS = (CSRC / "sr_ops.cuh", CSRC / "sr_interp.cuh")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: per kernel name, what its build did: library path, seconds, ptxas report
BUILD_INFO: dict = {}
_LIBS: dict = {}
_SIGNED: set = set()
_SMEM_LIMIT = 227 * 1024
#: each kernel's block shape on the shared core, threads and rows per thread
#: (RPT; 1, 2 or 4), chosen by measurement on the H100 (PERF.md), and the
#: number of blocks the row chunks aim for (the card's 132 SMs hold several
#: blocks each)
B1_THREADS, B1_RPT = 128, 4
B2_THREADS, B2_RPT = 256, 4
B4_THREADS, B4_RPT = 128, 4
TARGET_BLOCKS = 132 * 32


def loss_kernel_eligible(opset: OperatorSet, loss_elem, dtype) -> bool:
    """The kernel runs f32 with built-in operators and a built-in real loss;
    anything else (user callables, f64) takes the plain interpreter. Decided
    from names and identities only — nothing is probed."""
    return (
        np.dtype(dtype) == np.float32
        and kernel_op_table(opset) is not None
        and kernel_loss_spec(loss_elem) is not None
    )


# -- packing -----------------------------------------------------------------


def pack_programs_fused(flat: FlatTrees, opset: OperatorSet):
    """FlatTrees -> (prog int32 [P, 4N+1], vals f32 [P, N]).

    prog rows are code | lhs | rhs | feat | length with code = 0 const,
    1 var, 2+op unary, 2+n_unary+op binary — the TPU kernel's packed layout
    (``pack_flat_fused``) without its 128-lane padding. Pad slots carry
    code 0 and are never read."""
    kind = np.asarray(flat.kind)
    op = np.asarray(flat.op)
    P, N = kind.shape
    code = np.zeros((P, N), np.int32)
    code[kind == KIND_VAR] = 1
    m = kind == KIND_UNARY
    code[m] = 2 + op[m]
    m = kind == KIND_BINARY
    code[m] = 2 + opset.n_unary + op[m]
    prog = np.concatenate(
        [
            code,
            np.asarray(flat.lhs, np.int32),
            np.asarray(flat.rhs, np.int32),
            np.asarray(flat.feat, np.int32),
            np.asarray(flat.length, np.int32)[:, None],
        ],
        axis=1,
    )
    return np.ascontiguousarray(prog), np.ascontiguousarray(np.asarray(flat.val, np.float32))


def unpack_programs_fused(prog: np.ndarray, vals: np.ndarray, opset: OperatorSet) -> FlatTrees:
    """Inverse of pack_programs_fused (pad slots come back as KIND_PAD)."""
    prog = np.asarray(prog)
    P, L = prog.shape
    N = (L - 1) // 4
    code = prog[:, :N]
    length = prog[:, 4 * N].astype(np.int32)
    live = np.arange(N)[None, :] < length[:, None]
    nu = opset.n_unary
    kind = np.where(
        code == 1, KIND_VAR,
        np.where(code >= 2 + nu, KIND_BINARY, np.where(code >= 2, KIND_UNARY, KIND_CONST)),
    )
    kind = np.where(live, kind, 0).astype(np.int32)
    op = np.where(kind == KIND_UNARY, code - 2, np.where(kind == KIND_BINARY, code - 2 - nu, 0))
    return FlatTrees(
        kind,
        op.astype(np.int32),
        np.where(live, prog[:, N:2 * N], 0).astype(np.int32),
        np.where(live, prog[:, 2 * N:3 * N], 0).astype(np.int32),
        np.where(live, prog[:, 3 * N:4 * N], 0).astype(np.int32),
        np.where(kind == KIND_CONST, np.asarray(vals), 0).astype(np.float32),
        length,
    )


# -- plain version -------------------------------------------------------------


def plain_losses(flat: FlatTrees, vals: torch.Tensor, X, y, w, opset: OperatorSet,
                 loss_elem, with_grad: bool = False):
    """Both kernels' function in plain PyTorch, on X's device and dtype:
    losses [P] (``loss_sum / w_sum``, inf where not ok) and, ``with_grad``,
    their gradients [P, N] with respect to ``vals``. ``flat`` (numpy) gives
    the tree structure; ``vals`` [P, N] the constants.

    The interpreter of ops/interp.py fills the value buffer; each row's
    root adjoint is autograd of the loss times the row's weight; the
    interpreter's reverse sweep gives the per-row constant adjoints. Sums
    over rows are f64; gradients are divided by w_sum and 0 where the loss
    is not ok."""
    plan = make_plan(flat, opset, X.device)
    with torch.no_grad():
        pred, buf = _forward(plan, vals.to(X.dtype), X)
    with torch.enable_grad():
        p = pred.detach().requires_grad_(with_grad)
        elem = loss_elem(p, y[None, :])
        if w is not None:
            elem = elem * w[None, :]
        ct = None
        if with_grad:
            if elem.requires_grad:
                (ct,) = torch.autograd.grad(elem.sum(), p)
            else:
                ct = torch.zeros_like(p)
    with torch.no_grad():
        if w is not None:
            wsum = w.double().sum()
        else:
            wsum = torch.tensor(float(y.shape[0]), dtype=torch.float64, device=y.device)
        ok = torch.isfinite(pred).all(dim=-1) & (wsum > 0)
        losses = torch.where(
            ok, (elem.detach().double().sum(-1) / wsum).to(X.dtype), torch.inf
        )
        if not with_grad:
            return losses
        gval, _ = _reverse_sweep(plan, buf, ct, X.shape[0], True, False)
        grads = torch.where(ok[:, None], (gval.double().sum(-1) / wsum).to(X.dtype), 0.0)
    return losses, grads


def over_lanes(fn, prog, vals, X, y, w):
    """``fn(prog, vals, X, y, w)`` on each lane of a lane-major batch (X
    [L, F, R], y and w [L, R], the programs L lanes of P / L), its results
    concatenated in lane order (each part of a tuple result on its own); on
    one dataset (X [F, R]) just ``fn``. The plain versions' lane axis."""
    if X.dim() == 2:
        return fn(prog, vals, X, y, w)
    L = X.shape[0]
    P_lane = _lanes(prog.shape[0], L)
    outs = [fn(prog[l * P_lane:(l + 1) * P_lane], vals[l * P_lane:(l + 1) * P_lane], X[l],
               y[l], None if w is None else w[l]) for l in range(L)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _lanes(P: int, L: int) -> int:
    """Programs per lane of a lane-major batch of P programs over L lanes."""
    if L < 1 or P % L:
        raise ValueError(f"{P} programs do not split into {L} lanes")
    return P // L


def fused_loss_reference(prog, vals, X, y, w, opset: OperatorSet, loss_elem) -> torch.Tensor:
    """The plain PyTorch version of B1: same inputs, same function
    (``plain_losses``: loss in f32, w*loss and w summed in f64, the ok
    rule), lane by lane on a lane axis."""

    def one(prog, vals, X, y, w):
        flat = unpack_programs_fused(prog.cpu().numpy(), vals.cpu().numpy(), opset)
        return plain_losses(flat, vals, X, y, w, opset, loss_elem)

    return over_lanes(one, prog, vals, X, y, w)


# -- build and launch ------------------------------------------------------------


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused loss kernel cannot be built")


def _bind(name: str, lib: ctypes.CDLL) -> None:
    """What every kernel library shares: the entry point's return type and
    the error string. Each wrapper gives its own argument types through
    ``build``."""
    getattr(lib, f"sr_{name}").restype = ctypes.c_int
    lib.sr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sr_cuda_error_string.restype = ctypes.c_char_p


_vp, _ci, _cf, _cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_cs = ctypes.c_size_t
#: the entry points' argtypes. B1: prog, prog_ld, vals, optab, n_ops, X,
#: ldx, lsx (X's lane stride), y, w, lsy (y's and w's), P, P_lane, N, R,
#: threads, rpt, tpb, rows_per_chunk, n_chunks, smem bytes (``loss_smem``),
#: loss_id, q0..q3, partials, out, stream. B2: the same with smem bytes from
#: ``grad_smem`` and grads after out. B4: prog, prog_ld, vals, optab, n_ops,
#: X, ldx, P, N, R, threads, rpt, tpb, rows_per_chunk, n_chunks, smem bytes
#: (``preds_smem``), preds, stream.
_SIGNATURES = {
    "fused_loss": ([_vp, _ci, _vp, _vp, _ci, _vp, _cl, _cl, _vp, _vp, _cl] + [_ci] * 9
                   + [_cs, _ci] + [_cf] * 4 + [_vp, _vp, _vp]),
    "fused_loss_grad": ([_vp, _ci, _vp, _vp, _ci, _vp, _cl, _cl, _vp, _vp, _cl] + [_ci] * 9
                        + [_cs, _ci] + [_cf] * 4 + [_vp, _vp, _vp, _vp]),
    "eval_preds": [_vp, _ci, _vp, _vp, _ci, _vp, _cl] + [_ci] * 8 + [_cs, _vp, _vp],
}


def _lib_path(name: str) -> Path:
    src = SOURCES[name].read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsr_{name}_{tag}.so"


def build_all(names=tuple(SOURCES)) -> dict:
    """Compile the named kernels' sources for sm_90a (once per source
    content; one ``nvcc`` per source, all started together) and load them.
    Returns {name: library}. Raises if any nvcc fails."""
    import time

    t0 = time.perf_counter()
    jobs = {}
    for name in names:
        if name in _LIBS:
            continue
        lib_path = _lib_path(name)
        if lib_path.exists():
            jobs[name] = (lib_path, None, None)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs[name] = (lib_path, tmp, proc)
    for name, (lib_path, tmp, proc) in jobs.items():
        log_path = lib_path.with_suffix(".log")
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{log}")
            log_path.write_text(log)
            os.replace(tmp, lib_path)
        else:  # built earlier: its ptxas report was kept beside it
            log = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(lib_path))
        _bind(name, lib)
        BUILD_INFO[name] = dict(
            library=str(lib_path), seconds=time.perf_counter() - t0, log=log
        )
        _LIBS[name] = lib
    return {name: _LIBS[name] for name in names}


def build(name: str = "fused_loss", argtypes=None) -> ctypes.CDLL:
    """The loaded library of one kernel, built at first use. ``argtypes``
    are set on its entry point the first time they are given."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = build_all((name,))[name]
    if argtypes is not None and name not in _SIGNED:
        getattr(lib, f"sr_{name}").argtypes = argtypes
        _SIGNED.add(name)
    return lib


def _staged(N: int, tpb: int, n_ops: int) -> int:
    """Bytes of what every core kernel stages per block beside its buffers:
    ``tpb`` trees' decoded instructions (16 bytes a slot), programs,
    constants and slot stacks, the operator table and the lengths."""
    D = N // 2 + 2
    return tpb * N * 16 + 4 * (tpb * (4 * N + 1) + tpb * N + tpb * D + n_ops + tpb)


def loss_smem(N: int, threads: int, tpb: int, rpt: int, n_ops: int) -> int:
    """B1's dynamic shared memory per block in bytes, as its kernel carves
    it (csrc/fused_loss.cu), passed to the launch: the reduction slots, the
    value buffer of D = N // 2 + 2 stack positions x threads x RPT f32, and
    what ``_staged`` counts."""
    D = N // 2 + 2
    return 3 * 8 * 8 + D * threads * rpt * 4 + _staged(N, tpb, n_ops)


def grad_smem(N: int, threads: int, tpb: int, rpt: int, n_ops: int) -> int:
    """B2's dynamic shared memory per block in bytes, as its kernel carves
    it (csrc/fused_loss_grad.cu): the reduction slots, the tape of N slots x
    threads x RPT f32, the [slot][warp] f64 gradient sums, and what
    ``_staged`` counts."""
    return (3 * 8 * 8 + N * threads * rpt * 4 + N * (threads // 32) * 8
            + _staged(N, tpb, n_ops))


def preds_smem(N: int, threads: int, tpb: int, rpt: int, n_ops: int) -> int:
    """B4's dynamic shared memory per block in bytes, as its kernel carves
    it (csrc/eval_preds.cu): B1's without the reduction slots."""
    return loss_smem(N, threads, tpb, rpt, n_ops) - 3 * 8 * 8


def _core_geometry(P: int, N: int, R: int, smem, threads: int, rpt: int):
    """A core kernel's launch shape for P trees of N slots on R rows:
    (threads, rpt, tpb, rows_per_chunk, n_chunks); ``smem(threads, tpb,
    rpt)`` is its shared memory per block.

    A thread evaluates ``rpt`` rows per tile, so a tree's group of threads
    covers ``group x rpt`` rows per tile. The group is the fewest whole warps
    (a power of two, at most ``threads``) that cover R in one tile; when that
    leaves room, a block holds ``tpb = threads / group`` trees. Otherwise
    (one tree per block) the rows are cut into chunks of whole tiles, as few
    as give about TARGET_BLOCKS blocks in all, and the chunks of a tree
    get equal numbers of tiles. RPT and threads shrink while the buffers do
    not fit in shared memory."""
    while rpt > 1 and smem(threads, 1, rpt) > _SMEM_LIMIT:
        rpt //= 2
    while threads > 32 and smem(threads, 1, rpt) > _SMEM_LIMIT:
        threads //= 2
    if smem(threads, 1, rpt) > _SMEM_LIMIT:
        raise ValueError(f"programs of {N} slots do not fit in shared memory")
    group = 32
    while group < threads and group * rpt < R:
        group *= 2
    tpb = threads // group
    while tpb > 1 and smem(threads, tpb, rpt) > _SMEM_LIMIT:
        tpb //= 2
        group *= 2
    tile = group * rpt
    n_tiles = max(1, -(-R // tile))
    if tpb > 1 or n_tiles == 1:
        return threads, rpt, tpb, n_tiles * tile, 1
    n_chunks = min(n_tiles, max(1, -(-TARGET_BLOCKS // max(P, 1))))
    per_chunk = -(-n_tiles // n_chunks)
    n_chunks = -(-n_tiles // per_chunk)
    if n_chunks > 65535:
        raise ValueError(f"{R} rows need more than 65535 row chunks")
    return threads, rpt, tpb, per_chunk * tile, n_chunks


def loss_geometry(P: int, N: int, R: int, n_ops: int = 64):
    """B1's launch shape (``_core_geometry``) at B1_THREADS x B1_RPT."""
    return _core_geometry(P, N, R, lambda t, tpb, rpt: loss_smem(N, t, tpb, rpt, n_ops),
                          B1_THREADS, B1_RPT)


def grad_geometry(P: int, N: int, R: int, n_ops: int = 64):
    """B2's launch shape (``_core_geometry``) at B2_THREADS x B2_RPT."""
    return _core_geometry(P, N, R, lambda t, tpb, rpt: grad_smem(N, t, tpb, rpt, n_ops),
                          B2_THREADS, B2_RPT)


def preds_geometry(P: int, N: int, R: int, n_ops: int = 64):
    """B4's launch shape (``_core_geometry``) at B4_THREADS x B4_RPT."""
    return _core_geometry(P, N, R, lambda t, tpb, rpt: preds_smem(N, t, tpb, rpt, n_ops),
                          B4_THREADS, B4_RPT)


def _checked_launch_args(kernel: str, prog, vals, X, y, w, opset, loss_elem):
    """Validate a CUDA launch: (optab, loss spec, P, P_lane, N, R, prog_ld).
    X is [F, R] or, with a lane axis, [L, F, R] (y and w then [L, R]).
    Raises on whatever the kernel does not take."""
    if X.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {X.device}")
    optab = kernel_op_table(opset)
    spec = kernel_loss_spec(loss_elem)
    if optab is None or spec is None:
        raise ValueError(f"{kernel}: operator set or loss has no kernel implementation")
    P, prog_ld = prog.shape
    N = vals.shape[1]
    if X.dim() not in (2, 3):
        raise ValueError(f"{kernel}: X must be [F, R] or [L, F, R]")
    lanes = X.shape[:-2]
    R = X.shape[-1]
    dev = X.device
    for name, t, dt in (("prog", prog, torch.int32), ("vals", vals, torch.float32),
                        ("X", X, torch.float32), ("y", y, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous {dt} on {dev}")
    if prog_ld != 4 * N + 1 or vals.shape[0] != P or y.shape != (*lanes, R):
        raise ValueError(f"{kernel}: inconsistent shapes")
    if w is not None and (w.device != dev or w.dtype != torch.float32
                          or not w.is_contiguous() or w.shape != y.shape):
        raise ValueError(f"{kernel}: w must be contiguous float32 shaped as y on the same "
                         "device")
    P_lane = _lanes(P, lanes[0]) if lanes else P
    return optab, spec, P, P_lane, N, R, prog_ld


def _launch(kernel: str, prog, vals, X, y, w, optab, spec, P, P_lane, N, R, prog_ld, geometry,
            partials_shape, outs) -> None:
    """One launch of B1 or B2 on the current stream: ``geometry`` holds the
    launch-shape arguments the kernel takes after R, ``partials_shape`` the
    shape of its f64 scratch, ``outs`` its outputs. Raises if it fails."""
    lib = build(kernel, _SIGNATURES[kernel])
    dev = X.device
    partials = torch.empty(partials_shape, dtype=torch.float64, device=dev)
    q = list(spec[1]) + [0.0] * (4 - len(spec[1]))
    lane_axis = X.dim() == 3
    err = getattr(lib, f"sr_{kernel}")(
        prog.data_ptr(), prog_ld, vals.data_ptr(), _optab_tensor(optab, dev).data_ptr(),
        len(optab), X.data_ptr(), X.stride(-2), X.stride(0) if lane_axis else 0, y.data_ptr(),
        None if w is None else w.data_ptr(), y.stride(0) if lane_axis else 0, P, P_lane, N, R,
        *geometry, spec[0], *q,
        partials.data_ptr(), *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: {lib.sr_cuda_error_string(err).decode()}"
        )
    # tensors freed after this return are reused only by later work on the
    # same stream (PyTorch's caching allocator), so no keep-alive is needed


def eval_trees_kernel(flat: FlatTrees, X, opset: OperatorSet) -> torch.Tensor:
    """B4's entry point: predictions [P, R] f32 of a flat batch (numpy) on
    X [F, R].

    A CPU tensor takes the plain version, ``ops/interp.eval_trees``. On a
    CUDA tensor it packs the batch, copies it to X's device and runs
    ``eval_preds``."""
    if X.device.type == "cpu":
        return eval_trees(flat, X, opset)
    prog, vals = pack_programs_fused(flat, opset)
    return eval_preds(torch.from_numpy(prog).to(X.device), torch.from_numpy(vals).to(X.device),
                      X, opset)


def eval_preds(prog, vals, X, opset: OperatorSet) -> torch.Tensor:
    """B4 on packed programs (``pack_programs_fused``) already on X's
    device: predictions [P, R] f32. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel on the current stream (no
    synchronisation) or raises. Launches count on
    ``eval_trees_kernel.launches``."""
    if X.device.type == "cpu":
        flat = unpack_programs_fused(prog.numpy(), vals.numpy(), opset)
        return eval_trees(flat, X, opset)
    if X.device.type != "cuda":
        raise ValueError(f"eval_trees_kernel: unsupported device {X.device}")
    optab = kernel_op_table(opset)
    if optab is None:
        raise ValueError("eval_trees_kernel: the operator set has no kernel implementation")
    if X.dtype != torch.float32 or not X.is_contiguous() or X.dim() != 2:
        raise ValueError("eval_trees_kernel: X must be contiguous float32 [F, R]")
    dev = X.device
    P, prog_ld = prog.shape
    N = vals.shape[1]
    R = X.shape[1]
    for name, t, dt in (("prog", prog, torch.int32), ("vals", vals, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"eval_trees_kernel: {name} must be contiguous {dt} on {dev}")
    if prog_ld != 4 * N + 1 or vals.shape[0] != P:
        raise ValueError("eval_trees_kernel: inconsistent shapes")
    preds = torch.empty((P, R), dtype=torch.float32, device=dev)
    if P == 0 or R == 0:
        return preds
    lib = build("eval_preds", _SIGNATURES["eval_preds"])
    threads, rpt, tpb, rows_per_chunk, n_chunks = preds_geometry(P, N, R, len(optab))
    err = lib.sr_eval_preds(
        prog.data_ptr(), prog_ld, vals.data_ptr(), _optab_tensor(optab, dev).data_ptr(),
        len(optab), X.data_ptr(), X.stride(0), P, N, R, threads, rpt, tpb, rows_per_chunk,
        n_chunks, preds_smem(N, threads, tpb, rpt, len(optab)), preds.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"eval_preds kernel launch failed: "
                           f"{lib.sr_cuda_error_string(err).decode()}")
    eval_trees_kernel.launches += 1
    return preds


eval_trees_kernel.launches = 0


def fused_loss(prog, vals, X, y, w, opset: OperatorSet, loss_elem) -> torch.Tensor:
    """Per-tree losses [P] f32 of packed programs on (X [F, R], y [R], w),
    or on a lane axis (X [L, F, R], y and w [L, R]; program p on lane
    p // (P / L)).

    CPU tensors take ``fused_loss_reference``. CUDA tensors launch the kernel
    on the current stream (no synchronisation) or raise. The kernel evaluates
    on the postfix stack, so it takes stack-sound programs, as every
    postorder flattening of a tree is (``flatten_trees``, the device
    engine's packing): a program whose children are not the stack's top
    entries scores inf there."""
    if X.device.type == "cpu":
        return fused_loss_reference(prog, vals, X, y, w, opset, loss_elem)
    optab, spec, P, P_lane, N, R, prog_ld = _checked_launch_args(
        "fused_loss", prog, vals, X, y, w, opset, loss_elem
    )
    out = torch.empty((P,), dtype=torch.float32, device=X.device)
    if P == 0:
        return out
    if R == 0:
        return out.fill_(torch.inf)
    threads, rpt, tpb, rows_per_chunk, n_chunks = loss_geometry(P_lane, N, R, len(optab))
    smem = loss_smem(N, threads, tpb, rpt, len(optab))
    _launch("fused_loss", prog, vals, X, y, w, optab, spec, P, P_lane, N, R, prog_ld,
            (threads, rpt, tpb, rows_per_chunk, n_chunks, smem),
            (P, n_chunks, 3) if n_chunks > 1 else (1,), (out,))
    fused_loss.launches += 1
    return out


fused_loss.launches = 0


def fused_loss_grad(prog, vals, X, y, w, opset: OperatorSet, loss_elem):
    """(losses [P] f32, grads [P, N] f32): ``fused_loss``'s losses and their
    gradients with respect to every constant slot (0 on other slots, and on
    every slot of a tree whose loss is not ok). Takes ``fused_loss``'s lane
    axis.

    CPU tensors take ``fused_loss_grad_reference``. CUDA tensors launch the
    kernel on the current stream (no synchronisation) or raise. As
    ``fused_loss``, the kernel takes stack-sound programs: any other scores
    inf with zero gradients there."""
    if X.device.type == "cpu":
        return fused_loss_grad_reference(prog, vals, X, y, w, opset, loss_elem)
    optab, spec, P, P_lane, N, R, prog_ld = _checked_launch_args(
        "fused_loss_grad", prog, vals, X, y, w, opset, loss_elem
    )
    out = torch.empty((P,), dtype=torch.float32, device=X.device)
    grads = torch.empty((P, N), dtype=torch.float32, device=X.device)
    if P == 0:
        return out, grads
    if R == 0:
        return out.fill_(torch.inf), grads.zero_()
    threads, rpt, tpb, rows_per_chunk, n_chunks = grad_geometry(P_lane, N, R, len(optab))
    smem = grad_smem(N, threads, tpb, rpt, len(optab))
    _launch("fused_loss_grad", prog, vals, X, y, w, optab, spec, P, P_lane, N, R, prog_ld,
            (threads, rpt, tpb, rows_per_chunk, n_chunks, smem),
            (P, n_chunks, 3 + N) if n_chunks > 1 else (1,), (out, grads))
    fused_loss_grad.launches += 1
    return out, grads


fused_loss_grad.launches = 0


def fused_loss_grad_reference(prog, vals, X, y, w, opset: OperatorSet, loss_elem):
    """The plain PyTorch version of B2: ``plain_losses`` with gradients (the
    interpreter's reverse sweep and autograd of the loss), lane by lane on a
    lane axis."""

    def one(prog, vals, X, y, w):
        flat = unpack_programs_fused(prog.cpu().numpy(), vals.cpu().numpy(), opset)
        return plain_losses(flat, vals, X, y, w, opset, loss_elem, with_grad=True)

    return over_lanes(one, prog, vals, X, y, w)


class DiffLoss(torch.autograd.Function):
    """losses [P] = fused_loss(prog, vals, ...), differentiable in ``vals``
    (the counterpart of the JAX package's ``pallas_diff_loss``,
    ``interp_pallas.py:1026-1073``). The forward is B1; when the caller needs
    the gradient it is one B2 launch instead, and the backward scales B2's
    gradients by the incoming cotangent without launching anything.

    ``DiffLoss.apply(vals, prog, X, y, w, opset, loss_elem)``."""

    @staticmethod
    def forward(ctx, vals, prog, X, y, w, opset, loss_elem):
        if ctx.needs_input_grad[0]:
            losses, grads = fused_loss_grad(prog, vals, X, y, w, opset, loss_elem)
            ctx.save_for_backward(grads)
            return losses
        return fused_loss(prog, vals, X, y, w, opset, loss_elem)

    @staticmethod
    def backward(ctx, ct):
        (grads,) = ctx.saved_tensors
        return ct[:, None] * grads, None, None, None, None, None, None


_OPTAB_CACHE: dict = {}


def _optab_tensor(optab: np.ndarray, device) -> torch.Tensor:
    key = (optab.tobytes(), str(device))
    if key not in _OPTAB_CACHE:
        _OPTAB_CACHE[key] = torch.from_numpy(optab).to(device)
    return _OPTAB_CACHE[key]


def work_counts(prog: np.ndarray, R: int, F: int, weighted: bool, lanes: int = 1) -> dict:
    """Slot evaluations, operations and bytes one B1 call needs (the bound):
    each real slot of each tree once per row, plus the loss and the two sums
    per row; each input read once (``lanes`` datasets on a lane axis) and
    the output written once."""
    prog = np.asarray(prog)
    P, L = prog.shape
    N = (L - 1) // 4
    slot_evals = int(prog[:, 4 * N].astype(np.int64).sum()) * R
    ops = slot_evals + 4 * P * R
    data = lanes * (F * R * 4 + R * 4 * (2 if weighted else 1))
    bytes_ = prog.nbytes + P * N * 4 + data + P * 4
    return {"slot_evals": slot_evals, "operations": ops, "bytes": bytes_}


def grad_work_counts(prog: np.ndarray, R: int, F: int, weighted: bool, lanes: int = 1) -> dict:
    """The same for one B2 call: each real slot evaluated forward and once
    in reverse per row, plus per row the loss, its derivative, the two loss
    sums and one gradient sum per constant slot; each input read once, the
    losses and the [P, N] gradients written once."""
    prog = np.asarray(prog)
    P, L = prog.shape
    N = (L - 1) // 4
    live = np.arange(N)[None, :] < prog[:, 4 * N][:, None]
    n_const = int(((prog[:, :N] == 0) & live).sum())
    slot_evals = int(prog[:, 4 * N].astype(np.int64).sum()) * R
    ops = 2 * slot_evals + 4 * P * R + n_const * R
    data = lanes * (F * R * 4 + R * 4 * (2 if weighted else 1))
    bytes_ = prog.nbytes + P * N * 4 + data + P * 4 + P * N * 4
    return {"slot_evals": 2 * slot_evals, "operations": ops, "bytes": bytes_}


def preds_work_counts(prog: np.ndarray, R: int, F: int) -> dict:
    """The same for one B4 call: each real slot of each tree once per row;
    the inputs read once and the [P, R] predictions written once."""
    prog = np.asarray(prog)
    P, L = prog.shape
    N = (L - 1) // 4
    slot_evals = int(prog[:, 4 * N].astype(np.int64).sum()) * R
    bytes_ = prog.nbytes + P * N * 4 + F * R * 4 + P * R * 4
    return {"slot_evals": slot_evals, "operations": slot_evals, "bytes": bytes_}
