"""Fused eval + loss (kernel B1): CUDA kernel, plain version, build, launch count.

The hand-written CUDA kernel ``csrc/fused_loss.cu`` replaces the TPU kernel
``symbolicregression_jl_tpu/ops/interp_pallas.py:258`` (``_make_loss_kernel``
via ``_loss_pallas``). Per tree it evaluates the packed postorder program on
every row, applies the elementwise loss, and reduces to
``loss_sum / w_sum`` — or ``inf`` when any real row's prediction is
non-finite or ``w_sum == 0``. The source file's header says what bounds it
on the H100 and what its design does about that.

``fused_loss`` is the wrapper. A tensor on the CPU takes the plain PyTorch
version ``fused_loss_reference`` (the interpreter of ops/interp.py plus the
same loss and reduction); a CUDA tensor launches the kernel or raises. The
kernel is built with ``nvcc`` into a shared library with a plain C
interface, at first use, under ``_build/`` beside the package (listed in
.gitignore), and bound with ``ctypes``.

Unlike the TPU kernel, rows are masked by index (no 10240-row padding, no
(8, C) sublane layout) and any batch size P is accepted.
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
from .interp import eval_trees
from .losses import kernel_loss_spec
from .operators import OperatorSet, kernel_op_table

__all__ = [
    "fused_loss",
    "fused_loss_reference",
    "pack_programs_fused",
    "unpack_programs_fused",
    "loss_kernel_eligible",
    "build",
    "BUILD_INFO",
]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_loss.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: what the last build did: library path, seconds, ptxas report
BUILD_INFO: dict = {}
_LIB = None
_THREADS = 256
_SMEM_LIMIT = 227 * 1024


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


def fused_loss_reference(prog, vals, X, y, w, opset: OperatorSet, loss_elem) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same inputs, same function.
    Evaluates with the interpreter of ops/interp.py, applies the loss in f32,
    sums w*loss and w in f64 and applies the ok rule."""
    flat = unpack_programs_fused(prog.cpu().numpy(), vals.cpu().numpy(), opset)
    preds = eval_trees(flat, X, opset)
    elem = loss_elem(preds, y[None, :])
    if w is not None:
        elem = elem * w[None, :]
        wsum = w.double().sum()
    else:
        wsum = torch.tensor(float(y.shape[0]), dtype=torch.float64, device=y.device)
    lsum = elem.double().sum(dim=-1)
    ok = torch.isfinite(preds).all(dim=-1) & (wsum > 0)
    return torch.where(ok, (lsum / wsum).float(), torch.inf)


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


def build() -> ctypes.CDLL:
    """Compile csrc/fused_loss.cu for sm_90a (once per source content) and
    load it. Raises if nvcc fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    import time

    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libsr_fused_loss_{tag}.so"
    t0 = time.perf_counter()
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sr_fused_loss.argtypes = [
        vp, ci, vp, vp, ci, vp, ctypes.c_longlong, vp, vp, ci, ci, ci, ci, ci, ci,
        ci, cf, cf, cf, cf, vp, vp, vp,
    ]
    lib.sr_fused_loss.restype = ci
    lib.sr_fused_loss_smem.argtypes = [ci, ci, ci, ci]
    lib.sr_fused_loss_smem.restype = ctypes.c_size_t
    lib.sr_cuda_error_string.argtypes = [ci]
    lib.sr_cuda_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(
        library=str(lib_path), seconds=time.perf_counter() - t0, log=log
    )
    _LIB = lib
    return lib


def _geometry(lib, P: int, N: int, R: int, prog_ld: int, n_ops: int):
    """(threads, rows_per_block, n_chunks): 256 threads (fewer for tiny R
    or wide programs), 4 rows per thread unless that leaves the card with
    too few blocks."""
    threads = min(_THREADS, max(32, -(-R // 32) * 32))
    while threads > 32 and lib.sr_fused_loss_smem(N, threads, prog_ld, n_ops) > _SMEM_LIMIT:
        threads //= 2
    if lib.sr_fused_loss_smem(N, threads, prog_ld, n_ops) > _SMEM_LIMIT:
        raise ValueError(f"programs of {N} slots do not fit in shared memory")
    rows_per_block = threads * 4
    if P * -(-R // rows_per_block) < 4 * 132:
        rows_per_block = threads
    while -(-R // rows_per_block) > 65535:
        rows_per_block *= 2
    return threads, rows_per_block, max(1, -(-R // rows_per_block))


def fused_loss(prog, vals, X, y, w, opset: OperatorSet, loss_elem) -> torch.Tensor:
    """Per-tree losses [P] f32 of packed programs on (X [F, R], y [R], w).

    CPU tensors take ``fused_loss_reference``. CUDA tensors launch the kernel
    on the current stream (no synchronisation) or raise."""
    if X.device.type == "cpu":
        return fused_loss_reference(prog, vals, X, y, w, opset, loss_elem)
    if X.device.type != "cuda":
        raise ValueError(f"fused_loss: unsupported device {X.device}")
    optab = kernel_op_table(opset)
    spec = kernel_loss_spec(loss_elem)
    if optab is None or spec is None:
        raise ValueError("fused_loss: operator set or loss has no kernel implementation")
    P, prog_ld = prog.shape
    N = vals.shape[1]
    F, R = X.shape
    dev = X.device
    for name, t, dt in (("prog", prog, torch.int32), ("vals", vals, torch.float32),
                        ("X", X, torch.float32), ("y", y, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"fused_loss: {name} must be contiguous {dt} on {dev}")
    if prog_ld != 4 * N + 1 or vals.shape[0] != P or y.shape != (R,):
        raise ValueError("fused_loss: inconsistent shapes")
    if w is not None and (w.device != dev or w.dtype != torch.float32
                          or not w.is_contiguous() or w.shape != (R,)):
        raise ValueError("fused_loss: w must be contiguous float32 [R] on the same device")
    out = torch.empty((P,), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    if R == 0:
        return out.fill_(torch.inf)
    lib = build()
    n_ops = len(optab)
    threads, rows_per_block, n_chunks = _geometry(lib, P, N, R, prog_ld, n_ops)
    optab_t = _optab_tensor(optab, dev)
    partials = torch.empty((P, n_chunks, 3), dtype=torch.float64, device=dev)
    q = list(spec[1]) + [0.0] * (4 - len(spec[1]))
    err = lib.sr_fused_loss(
        prog.data_ptr(), prog_ld, vals.data_ptr(), optab_t.data_ptr(), n_ops,
        X.data_ptr(), X.stride(0), y.data_ptr(), None if w is None else w.data_ptr(),
        P, N, R, threads, rows_per_block, n_chunks, spec[0], *q,
        partials.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused_loss kernel launch failed: {lib.sr_cuda_error_string(err).decode()}"
        )
    fused_loss.launches += 1
    # tensors freed after this return are reused only by later work on the
    # same stream (PyTorch's caching allocator), so no keep-alive is needed
    return out


fused_loss.launches = 0

_OPTAB_CACHE: dict = {}


def _optab_tensor(optab: np.ndarray, device) -> torch.Tensor:
    key = (optab.tobytes(), str(device))
    if key not in _OPTAB_CACHE:
        _OPTAB_CACHE[key] = torch.from_numpy(optab).to(device)
    return _OPTAB_CACHE[key]


def work_counts(prog: np.ndarray, R: int, F: int, weighted: bool) -> dict:
    """Slot evaluations, operations and bytes one call needs (the bound):
    each real slot of each tree once per row, plus the loss and the two sums
    per row; each input read once and the output written once."""
    prog = np.asarray(prog)
    P, L = prog.shape
    N = (L - 1) // 4
    slot_evals = int(prog[:, 4 * N].astype(np.int64).sum()) * R
    ops = slot_evals + 4 * P * R
    bytes_ = prog.nbytes + P * N * 4 + F * R * 4 + R * 4 * (2 if weighted else 1) + P * 4
    return {"slot_evals": slot_evals, "operations": ops, "bytes": bytes_}
