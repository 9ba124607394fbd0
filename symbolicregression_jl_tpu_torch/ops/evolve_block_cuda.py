"""B3: the evolve block as a hand-written CUDA kernel, its wrapper and its
plain version.

``evolve_block`` runs a whole engine iteration's ``ncycles`` of the block
(ops/evolve_block.py) for every island in one launch of
``csrc/evolve_block.cu``, which replaces the TPU kernel
``symbolicregression_jl_tpu/ops/interp_pallas.py:1114``
(``_make_evolve_block_kernel`` via ``make_evolve_block_fn``). It returns the
11-tuple carry of the JAX package's ``kernel_fn``: the population (words,
consts, length, loss, score, birth), the per-island size-histogram delta and
the per-island best-seen carry (loss, words, consts, length).

A CPU tensor takes the plain version, ``evolve_block_reference``
(``evolve_block.run_block`` scoring through ``make_plain_eval``); a CUDA
tensor launches the kernel or raises. The scalars (seed, first birth step,
current maxsize, score normalization) stay on the device and reach the
kernel through a small device buffer, so the launch needs no host sync. The
static configuration travels by value in ``SrBlockCfg``. The kernel is built
with the others by ``interp_cuda.build_all``. ``evolve_block.launches``
counts its launches process-wide (summed over concurrent searches).

The lane axis (the JAX package's ``vmap`` of the block over a fleet, its
``ops/evolve.py`` ``_run_fleet_iteration_fused_impl``): with X [L, F, R] the
population holds L lanes of I islands, lane-major ([L * I, P, N] and so on),
and every per-search input has a leading [L] (fnorm [L, S+1], seed, step0,
curmaxsize and norm [L]); one launch runs ``L * I`` blocks, island ``b % I``
of lane ``b // I``, each lane on its own data and seed, so a lane's outputs
are its solo launch's. A solo call (X [F, R], 0-d scalars) is one lane.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .evolve import EvoConfig
from .evolve_block import (
    f32,
    make_plain_eval,
    mutation_weights_f32,
    run_block,
    tournament_thresholds,
)
from .interp_cuda import _SMEM_LIMIT, build, count_launch
from .losses import kernel_loss_spec
from .operators import OperatorSet, kernel_op_table

__all__ = ["evolve_block", "evolve_block_reference", "block_work_counts", "SrBlockCfg"]

_MAX_TOUR = 64
_MAX_OPS = 64
_INTS = ("I", "P", "N", "E", "S1", "maxsize", "maxdepth", "ncycles", "tour_n", "nfeatures",
         "n_unary", "n_binary", "annealing", "use_frequency", "use_freq_tour", "F", "R",
         "loss_id", "n_ops", "use_smem", "rpt", "L")
#: the (rows per thread, threads) shapes csrc/evolve_block.cu is built for
#: (SR_BLOCK_SHAPES), in the order ``_geometry`` tries them: the first is the
#: fastest at config3 on the H100 (PERF.md), the others take the wider
#: programs and larger populations it cannot hold
BLOCK_SHAPES = ((2, 512), (4, 256), (2, 256), (1, 256), (1, 64))
_FLOATS = ("pf", "pnc", "alpha", "aps", "parsimony", "bin_thr", "ncyc_den")


class SrBlockCfg(ctypes.Structure):
    """The kernel's static configuration (``SrBlockCfg`` in
    csrc/evolve_block.cu, field for field)."""

    _fields_ = (
        [("ldx", ctypes.c_longlong), ("lsx", ctypes.c_longlong), ("lsy", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in _INTS]
        + [(n, ctypes.c_float) for n in _FLOATS]
        + [("q", ctypes.c_float * 4), ("mut_w", ctypes.c_float * 8),
           ("tour_thr", ctypes.c_float * _MAX_TOUR), ("optab", ctypes.c_int * _MAX_OPS)]
    )


#: the entry point's argtypes: cfg, threads, smem bytes (``block_smem``),
#: the 6 population inputs, fnorm, iscal, fscal, X, y, w, the 11 outputs,
#: stream
_SIGNATURE = [SrBlockCfg, ctypes.c_int, ctypes.c_size_t] + [ctypes.c_void_p] * 24


def kernel_lib() -> ctypes.CDLL:
    """B3's library, built at first use, with its entry point typed."""
    return build("evolve_block", _SIGNATURE)


def _make_cfg(cfg: EvoConfig, opset: OperatorSet, spec, F: int, R: int, ldx: int,
              L: int = 1, lsx: int = 0, lsy: int = 0):
    """The kernel's SrBlockCfg; ``spec`` is the loss's ``kernel_loss_spec``;
    ``L`` lanes whose X and y, w lie ``lsx`` and ``lsy`` floats apart."""
    optab = kernel_op_table(opset)
    if optab is None or spec is None:
        raise ValueError("evolve_block: operator set or loss has no kernel implementation")
    if cfg.tournament_n > _MAX_TOUR or len(optab) > _MAX_OPS:
        raise ValueError(f"evolve_block: at most {_MAX_TOUR} tournament candidates and "
                         f"{_MAX_OPS} operators")
    c = SrBlockCfg()
    c.ldx, c.lsx, c.lsy = ldx, lsx, lsy
    vals = dict(
        I=cfg.n_islands, P=cfg.pop_size, N=cfg.n_slots, E=cfg.events_per_cycle,
        S1=cfg.maxsize + 1, maxsize=cfg.maxsize, maxdepth=cfg.maxdepth, ncycles=cfg.ncycles,
        tour_n=cfg.tournament_n, nfeatures=cfg.nfeatures, n_unary=cfg.n_unary,
        n_binary=cfg.n_binary, annealing=int(cfg.annealing), L=L,
        use_frequency=int(cfg.use_frequency),
        use_freq_tour=int(cfg.use_frequency_in_tournament), F=F, R=R, loss_id=spec[0],
        n_ops=len(optab),
        pf=f32(cfg.perturbation_factor), pnc=f32(cfg.probability_negate_constant),
        alpha=f32(cfg.alpha), aps=f32(cfg.adaptive_parsimony_scaling),
        parsimony=f32(cfg.parsimony),
        bin_thr=f32(cfg.n_binary / max(cfg.n_binary + cfg.n_unary, 1)),
        ncyc_den=float(max(cfg.ncycles - 1, 1)),
    )
    for k, v in vals.items():
        setattr(c, k, v)
    q = list(spec[1]) + [0.0] * (4 - len(spec[1]))
    c.q[:] = [f32(v) for v in q]
    c.mut_w[:] = [float(v) for v in mutation_weights_f32(cfg)]
    thr = tournament_thresholds(cfg)
    c.tour_thr[: len(thr)] = thr
    c.optab[: len(optab)] = [int(v) for v in optab]
    return c


def block_smem(c: SrBlockCfg, threads: int) -> int:
    """Dynamic shared memory of one island block in bytes, as the kernel
    carves it (csrc/evolve_block.cu), passed to the launch: the warps' decoded
    instructions (16 bytes a slot), the value buffer of D = N // 2 + 2 stack
    positions x threads x RPT f32, the scoring partials (3 f64 per candidate
    and warp) and the warps' first units, the lanes' scratch and, with
    ``use_smem``, the island's population and best-seen carry."""
    E, N, P, S1, n = c.E, c.N, c.P, c.S1, c.tour_n
    D, W = N // 2 + 2, threads // 32
    b = 16 * W * N + 4 * D * threads * c.rpt + 24 * (E + W) + 4 * (W + 1)
    b += 4 * (S1 + 8 + n + 4 * E + 2 * E * N + E * n)
    b += 4 * (c.n_ops + 3 * E + 2 * E * N + 5 * E * N + 3 * E * D + E * n + P)
    if c.use_smem:
        b += 4 * (2 * P * N + 4 * P + 3 * S1 + 2 * S1 * N)
    return b


def _geometry(c: SrBlockCfg) -> int:
    """Threads per island block: the first of BLOCK_SHAPES whose value buffer
    fits in shared memory beside the island's population, else beside the
    lane scratch alone (the population then stays in the output arrays); the
    event lanes loop over the threads when there are more. Sets ``rpt`` and
    ``use_smem`` on ``c``."""
    for use_smem in (1, 0):
        for rpt, threads in BLOCK_SHAPES:
            c.use_smem, c.rpt = use_smem, rpt
            if block_smem(c, threads) <= _SMEM_LIMIT:
                return threads
    raise ValueError(f"evolve_block: {c.E} event lanes of {c.N} slots do not fit one block")


@functools.lru_cache(maxsize=64)
def _launch_config(cfg: EvoConfig, opset: OperatorSet, spec, F: int, R: int, ldx: int,
                   L: int = 1, lsx: int = 0, lsy: int = 0):
    """(SrBlockCfg, threads, shared-memory bytes) of a launch, made once per
    configuration: each later launch of it only makes its tensors. The
    geometry does not depend on the lanes."""
    c = _make_cfg(cfg, opset, spec, F, R, ldx, L, lsx, lsy)
    threads = _geometry(c)
    return c, threads, block_smem(c, threads)


def evolve_block_reference(words, consts, length, loss, score, birth, fnorm, seed, step0,
                           curmaxsize, norm, X, y, w, cfg: EvoConfig, opset: OperatorSet,
                           loss_elem, counts: dict | None = None):
    """B3's plain version on the tensors' device: ``run_block`` scoring with
    the port's interpreter and B1's loss rule. ``counts``, when given,
    receives the candidates scored and their summed lengths (the kernel's
    work, for its bound).

    On a lane axis (X [L, F, R]) it is ``run_block`` on each lane's islands,
    data and scalars (``seed[l]`` and so on: a tensor [L] or a sequence of L
    per-lane values), the carries concatenated in lane order."""
    pop = (words, consts, length, loss, score, birth)
    if X.dim() == 3:
        I = cfg.n_islands
        carries = [
            evolve_block_reference(
                *(a[l * I:(l + 1) * I] for a in pop), fnorm[l], seed[l], step0[l],
                curmaxsize[l], norm[l], X[l], y[l], None if w is None else w[l], cfg, opset,
                loss_elem, counts,
            )
            for l in range(X.shape[0])
        ]
        return tuple(torch.cat(parts) for parts in zip(*carries))
    eval_fn = make_plain_eval(opset, loss_elem, X, y, w)
    if counts is not None:
        inner = eval_fn

        def eval_fn(vw, vc, vlen):
            counts["candidates"] = counts.get("candidates", 0) + int(vlen.numel())
            counts["slots"] = counts.get("slots", 0) + int(vlen.sum())
            return inner(vw, vc, vlen)

    return run_block(pop, seed, step0, curmaxsize, fnorm, norm, cfg, eval_fn)


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"evolve_block: {name} must be contiguous {dtype} {list(shape)} on {dev}")


def evolve_block(words, consts, length, loss, score, birth, fnorm, seed, step0, curmaxsize,
                 norm, X, y, w, cfg: EvoConfig, opset: OperatorSet, loss_elem):
    """One block of ``cfg.ncycles`` cycles over every island: the 11-tuple
    (words, consts, length, loss, score, birth, fd, bs_loss, bs_words,
    bs_consts, bs_length).

    ``words`` int32 / ``consts`` f32 [I, P, N]; ``length``, ``birth`` int32
    and ``loss``, ``score`` f32 [I, P]; ``fnorm`` f32 [S+1]; ``seed``
    (uint32 in int64), ``step0``, ``curmaxsize`` and ``norm`` 0-d tensors on
    the same device; X [F, R], y [R], w [R] or None. On a lane axis, X
    [L, F, R], y and w [L, R], the population [L * I, ...], fnorm [L, S+1]
    and the four scalars [L], and so are the outputs [L * I, ...]. CPU
    tensors take ``evolve_block_reference``; CUDA tensors launch the kernel
    on the current stream (no synchronisation) or raise."""
    if X.device.type == "cpu":
        return evolve_block_reference(words, consts, length, loss, score, birth, fnorm, seed,
                                      step0, curmaxsize, norm, X, y, w, cfg, opset, loss_elem)
    if X.device.type != "cuda":
        raise ValueError(f"evolve_block: unsupported device {X.device}")
    dev = X.device
    if X.dim() not in (2, 3):
        raise ValueError("evolve_block: X must be [F, R] or [L, F, R]")
    lane_axis = X.dim() == 3
    L = X.shape[0] if lane_axis else 1
    lanes = (L,) if lane_axis else ()
    I, P, N, S1 = L * cfg.n_islands, cfg.pop_size, cfg.n_slots, cfg.maxsize + 1
    F, R = X.shape[-2:]
    for name, t, dt, shape in (
        ("words", words, torch.int32, (I, P, N)), ("consts", consts, torch.float32, (I, P, N)),
        ("length", length, torch.int32, (I, P)), ("loss", loss, torch.float32, (I, P)),
        ("score", score, torch.float32, (I, P)), ("birth", birth, torch.int32, (I, P)),
        ("fnorm", fnorm, torch.float32, (*lanes, S1)), ("X", X, torch.float32, (*lanes, F, R)),
        ("y", y, torch.float32, (*lanes, R)),
    ):
        _check(name, t, dt, shape, dev)
    if w is not None:
        _check("w", w, torch.float32, (*lanes, R), dev)
    for name, t in (("seed", seed), ("step0", step0), ("curmaxsize", curmaxsize),
                    ("norm", norm)):
        if not torch.is_tensor(t) or t.device != dev or t.numel() != L:
            raise ValueError(f"evolve_block: {name} must be a tensor of {L} element(s) on "
                             f"{dev}")
    if R == 0:
        raise ValueError("evolve_block: no rows")
    lib = kernel_lib()
    c, threads, smem = _launch_config(
        cfg, opset, kernel_loss_spec(loss_elem), F, R, X.stride(-2), L,
        X.stride(0) if lane_axis else 0, y.stride(0) if lane_axis else 0,
    )
    iscal = torch.stack([seed.reshape(L).to(torch.int64), step0.reshape(L).to(torch.int64),
                         curmaxsize.reshape(L).to(torch.int64)], 1)
    fscal = norm.reshape(L).to(torch.float32)
    out = (
        torch.empty((I, P, N), dtype=torch.int32, device=dev),
        torch.empty((I, P, N), dtype=torch.float32, device=dev),
        torch.empty((I, P), dtype=torch.int32, device=dev),
        torch.empty((I, P), dtype=torch.float32, device=dev),
        torch.empty((I, P), dtype=torch.float32, device=dev),
        torch.empty((I, P), dtype=torch.int32, device=dev),
        torch.empty((I, S1), dtype=torch.float32, device=dev),
        torch.empty((I, S1), dtype=torch.float32, device=dev),
        torch.empty((I, S1, N), dtype=torch.int32, device=dev),
        torch.empty((I, S1, N), dtype=torch.float32, device=dev),
        torch.empty((I, S1), dtype=torch.int32, device=dev),
    )
    err = lib.sr_evolve_block(
        c, threads, smem, words.data_ptr(), consts.data_ptr(), length.data_ptr(), loss.data_ptr(),
        score.data_ptr(), birth.data_ptr(), fnorm.data_ptr(), iscal.data_ptr(),
        fscal.data_ptr(), X.data_ptr(), y.data_ptr(), None if w is None else w.data_ptr(),
        *(o.data_ptr() for o in out), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"evolve_block kernel launch failed: {lib.sr_cuda_error_string(err).decode()}"
        )
    count_launch(evolve_block)
    return out


evolve_block.launches = 0


def block_work_counts(cfg: EvoConfig, R: int, F: int, weighted: bool, n_candidates: int,
                      slots: int, lanes: int = 1) -> dict:
    """Operations and bytes of one block (its bound): B1's counting rule on
    the ``n_candidates`` programs the plain version scored in the same block
    (``slots`` real slots in all): one operation per real slot per row plus
    four per row for the loss and its sums; the population, fnorm and the
    rows read once, the population and the per-island carries written once.
    The mutation and replacement work is not counted. ``lanes``: a launch
    over that many lanes, each with its own data and population."""
    I, P, N, S1 = lanes * cfg.n_islands, cfg.pop_size, cfg.n_slots, cfg.maxsize + 1
    slot_evals = int(slots) * R
    ops = slot_evals + 4 * int(n_candidates) * R
    pop_bytes = I * P * N * 8 + I * P * 16
    carry_bytes = I * S1 * (12 + N * 8)
    bytes_ = 2 * pop_bytes + carry_bytes + lanes * (S1 * 4 + F * R * 4
                                                    + R * 4 * (2 if weighted else 1))
    return {"slot_evals": slot_evals, "operations": ops, "bytes": bytes_}
