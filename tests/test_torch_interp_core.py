"""The multi-row interpreter core of the kernels B1-B4
(``csrc/sr_interp.cuh``), compiled for the host, and the host-side launch
geometry of the kernels, on the CPU.

The core's decode (``decode_code`` for the packed programs of B1, B2 and B4,
on the stack or on B2's tape with each binary operator's left child;
``decode_words`` for B3's packed words: stack positions from the postfix
walk, unsound rows to a NaN constant), its row walk (``tile_loss``: RPT
interleaved rows per thread, rows ``r, r + g, ...`` for a group of g
threads, the loss applied once per RPT rows) and B2's (``tile_loss_grad``:
the forward on the tape, the loss's derivative, the reverse sweep handing
each constant slot's adjoint sum to a sink) are plain ``__host__
__device__`` code. Here they are
compiled with the system C++ compiler (``-ffp-contract=off``, as the kernels
are built with ``--fmad=false``) and driven the way a group of threads walks
the rows on the card, thread by thread, for RPT 1, 2 and 4 and row counts
that are not multiples of RPT or of the group (1, 33, 1000).

Tolerance: the core's predictions and losses are held to the JAX package's
interpreter and scoring (``eval_trees``, ``batched_loss_jit``) and to the
port's plain versions (``eval_trees``, ``fused_loss_reference``, B3's
``make_plain_eval``) at rtol 1e-4, atol 1e-5 on finite values, with equal
non-finite positions. The arithmetic is the kernels' own (sr_ops.cuh); only
the host's libm differs from torch's and XLA's vectorized math in the last
bits, and a composed tree (exp of a product, a quotient near a pole) can
carry such an ulp to ~1e-5 relative. The config3 corpus is held to the
port's plain version everywhere. Against JAX, and for the every-operator
corpus against both, only the trees and rows where the two references
themselves agree to 1e-5 and stay below 1e6 are compared: XLA's CPU cosine
loses accuracy at huge arguments (cos of an exp; 2% on a few config3
trees), and gamma, tan and pow amplify an ulp past any fixed rtol.

B2's losses and constant gradients are held to ``fused_loss_grad_reference``
and to ``jax.value_and_grad`` of the JAX package's interpreter in
tests/test_torch_lossgrad.py's convention (the row sum differentiated, then
divided by w_sum): losses as above; gradients with equal non-finite
positions and within rtol 1e-4 plus 1e-6 (plain version) or 1e-5 (JAX)
times the largest finite gradient of the same tree, on the trees whose
predictions the two packages agree on to 1e-6 relative, all finite and
below 1e3 (every tree of the config3 corpus against the plain version).

B1 and B2 evaluate on the postfix stack, so every batch a small lockstep,
event-leg and block search hands them is held to the core's stack-sound
rule.

The geometry tests need no compiler: every row of every tree is evaluated
exactly once, shared memory fits the H100's 227 KB, B3's warp split covers
every (candidate, tile) unit once with distinct partial slots, and E > warps,
N > 32 and the engine's P = 4,200 x 10k rows are taken.
"""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu as J
import symbolicregression_jl_tpu_torch as T
from symbolicregression_jl_tpu.models.mutation_functions import gen_random_tree as j_gen
from symbolicregression_jl_tpu.ops.interp import eval_trees as j_eval_trees
from symbolicregression_jl_tpu.ops.scoring import batched_loss_jit
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.ops import evolve_block_cuda as ebc
from symbolicregression_jl_tpu_torch.ops import interp_cuda as ic
from symbolicregression_jl_tpu_torch.ops.evolve_block import (
    make_plain_eval,
    pack_state_words,
)
from symbolicregression_jl_tpu_torch.ops.interp import eval_trees as t_eval_trees
from symbolicregression_jl_tpu_torch.ops.losses import kernel_loss_spec
from symbolicregression_jl_tpu_torch.ops.operators import (
    BINARY_OPS,
    UNARY_OPS,
    kernel_op_table,
)

CSRC = Path(ic.__file__).resolve().parent.parent / "csrc"
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_SCALE_ATOL = 1e-4, 1e-6
CONFIG3 = dict(binary_operators=["add", "sub", "mult", "div"],
               unary_operators=["cos", "exp", "abs"])
EVERY = dict(binary_operators=list(BINARY_OPS), unary_operators=list(UNARY_OPS))


@pytest.fixture(autouse=True, scope="module")
def _cpu_numerics():
    """Flush denormals, as the JAX side's CPU fast-math does, keep JAX in
    32-bit mode (an earlier test module in this process may have enabled
    x64) and use one torch thread."""
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", False)
    torch.set_flush_denormal(True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    torch.set_flush_denormal(False)
    jax.config.update("jax_enable_x64", x64)


# -- the core, compiled for the host ---------------------------------------------

_HOST_SHIM = r"""
#define SR_HD inline
#include "sr_interp.cuh"
#include <math.h>
#include <stdlib.h>
#include <vector>

namespace {

// A group of gs threads walks the rows as on the card: tile by tile, thread
// gt taking rows base + gt + k gs (k < RPT), each thread with its own column
// of the [position][thread][RPT] buffer; the threads' partial sums are added
// in thread order. preds (optional) receives every row's prediction.
template <int RPT, sr::Dispatch DISPATCH>
void walk(const sr::Instr* ins, int len, int gs, const float* X, long long ldx, const float* y,
          const float* w, int R, int loss_id, const float* q, float init, float* loss_out,
          float* preds, int N) {
  const int stride = gs * RPT;
  const size_t n_buf = (size_t)sr::stack_slots(N) * stride + 4;
  float* buf = static_cast<float*>(aligned_alloc(16, sizeof(float) * ((n_buf + 3) / 4 * 4)));
  std::vector<sr::Acc> acc(gs, sr::Acc{0.0, 0.0, 0.0});
  for (int base = 0; base < R; base += gs * RPT) {
    for (int gt = 0; gt < gs; ++gt) {
      float* col = buf + gt * RPT;
      sr::tile_loss<RPT, DISPATCH>(ins, len, col, X, ldx, y, w, base + gt, gs, R, R, loss_id,
                                   q[0], q[1], q[2], q[3], init, acc[gt]);
      if (preds) {
        int row[RPT];
        for (int k = 0; k < RPT; ++k) {
          const int rk = base + gt + k * gs;
          row[k] = rk < R ? rk : R - 1;
        }
        const sr::Vals<RPT> v = sr::eval_rows<RPT, DISPATCH>(ins, len, col, X, ldx, row, init);
        for (int k = 0; k < RPT; ++k)
          if (base + gt + k * gs < R) preds[base + gt + k * gs] = v.v[k];
      }
    }
  }
  double L = 0.0, W = 0.0, C = 0.0;
  for (int gt = 0; gt < gs; ++gt) {
    L += acc[gt].l;
    W += acc[gt].w;
    C += acc[gt].n;
  }
  *loss_out = sr::finish(L, W, C);
  free(buf);
}

template <int RPT>
void b1(const int* prog, int P, int N, const float* vals, const int* optab, const float* X,
        long long ldx, const float* y, const float* w, int R, int loss_id, const float* q,
        int gs, float* out, float* preds, int* lens) {
  std::vector<sr::Instr> ins(N > 0 ? N : 1);
  std::vector<int> st(sr::stack_slots(N));
  for (int p = 0; p < P; ++p) {
    const int len = sr::decode_code(prog + (long long)p * (4 * N + 1), N, optab,
                                    vals + (long long)p * N, gs * RPT, st.data(), ins.data());
    if (lens) lens[p] = len;
    walk<RPT, sr::kSwitch>(ins.data(), len, gs, X, ldx, y, w, R, loss_id, q, NAN, out + p,
              preds ? preds + (long long)p * R : nullptr, N);
  }
}

// B2 on the core: the tape-mode decode, then each thread's tiles through
// tile_loss_grad (forward on the tape, loss and its derivative, reverse
// sweep), each thread summing its constants' adjoints per slot in f64; the
// threads' sums are added in thread order. grads [P, N]: G / W where the
// tree is ok, else 0.
template <int RPT, sr::Dispatch DISPATCH>
void b2(const int* prog, int P, int N, const float* vals, const int* optab, const float* X,
        long long ldx, const float* y, const float* w, int R, int loss_id, const float* q,
        int gs, float* out, float* grads) {
  struct Sink {
    double* g;
    void operator()(int i, double s) { g[i] += s; }
  };
  const int stride = gs * RPT;
  std::vector<sr::Instr> ins(N > 0 ? N : 1);
  std::vector<int> st(sr::stack_slots(N));
  const size_t n_tape = (size_t)N * stride + 4;
  float* tape = static_cast<float*>(aligned_alloc(16, sizeof(float) * ((n_tape + 3) / 4 * 4)));
  for (int p = 0; p < P; ++p) {
    const int len = sr::decode_code(prog + (long long)p * (4 * N + 1), N, optab,
                                    vals + (long long)p * N, stride, st.data(), ins.data(), true);
    std::vector<sr::Acc> acc(gs, sr::Acc{0.0, 0.0, 0.0});
    std::vector<double> gsum((size_t)gs * N, 0.0);
    for (int base = 0; base < R; base += stride)
      for (int gt = 0; gt < gs; ++gt) {
        Sink sink{gsum.data() + (size_t)gt * N};
        sr::tile_loss_grad<RPT, DISPATCH>(ins.data(), len, tape + gt * RPT, stride, X, ldx, y, w,
                                          base + gt, gs, R, R, loss_id, q[0], q[1], q[2], q[3],
                                          acc[gt], sink);
      }
    double L = 0.0, W = 0.0, C = 0.0;
    for (int gt = 0; gt < gs; ++gt) {
      L += acc[gt].l;
      W += acc[gt].w;
      C += acc[gt].n;
    }
    out[p] = sr::finish(L, W, C);
    const bool ok = C == 0.0 && W > 0.0;
    for (int i = 0; i < N; ++i) {
      double G = 0.0;
      for (int gt = 0; gt < gs; ++gt) G += gsum[(size_t)gt * N + i];
      grads[(long long)p * N + i] = ok ? (float)(G / W) : 0.0f;
    }
  }
  free(tape);
}

// B2's seeded mode on the core: the tape-mode decode, then each thread's
// tiles through tile_seed_grad (forward on the tape, root adjoints from the
// tree's row of seed [P, R], reverse sweep), each thread summing its
// constants' adjoints per slot in f64; the threads' sums are added in thread
// order. grads [P, N]: the sum where every prediction of the tree is
// finite, else 0.
template <int RPT>
void b2v(const int* prog, int P, int N, const float* vals, const int* optab, const float* X,
         long long ldx, const float* seed, int R, int gs, float* grads) {
  struct Sink {
    double* g;
    void operator()(int i, double s) { g[i] += s; }
  };
  const int stride = gs * RPT;
  std::vector<sr::Instr> ins(N > 0 ? N : 1);
  std::vector<int> st(sr::stack_slots(N));
  const size_t n_tape = (size_t)N * stride + 4;
  float* tape = static_cast<float*>(aligned_alloc(16, sizeof(float) * ((n_tape + 3) / 4 * 4)));
  for (int p = 0; p < P; ++p) {
    const int len = sr::decode_code(prog + (long long)p * (4 * N + 1), N, optab,
                                    vals + (long long)p * N, stride, st.data(), ins.data(), true);
    std::vector<sr::Acc> acc(gs, sr::Acc{0.0, 0.0, 0.0});
    std::vector<double> gsum((size_t)gs * N, 0.0);
    for (int base = 0; base < R; base += stride)
      for (int gt = 0; gt < gs; ++gt) {
        Sink sink{gsum.data() + (size_t)gt * N};
        sr::tile_seed_grad<RPT, sr::kTree>(ins.data(), len, tape + gt * RPT, stride, X, ldx,
                                           seed + (long long)p * R, base + gt, gs, R, R,
                                           acc[gt], sink);
      }
    double C = 0.0;
    for (int gt = 0; gt < gs; ++gt) C += acc[gt].n;
    for (int i = 0; i < N; ++i) {
      double G = 0.0;
      for (int gt = 0; gt < gs; ++gt) G += gsum[(size_t)gt * N + i];
      grads[(long long)p * N + i] = C == 0.0 ? (float)G : 0.0f;
    }
  }
  free(tape);
}

template <int RPT>
void b3(const int* words, const float* consts, const int* length, int P, int N, int F,
        int n_unary, int n_binary, const int* optab, const float* X, long long ldx,
        const float* y, const float* w, int R, int loss_id, const float* q, int gs,
        float* out) {
  std::vector<sr::Instr> ins(N);
  for (int p = 0; p < P; ++p) {
    const long long o = (long long)p * N;
    const int len = sr::decode_words(words + o, consts + o, length[p], N, F, n_unary, n_binary,
                                     optab, gs * RPT, ins.data());
    walk<RPT, sr::kTree>(ins.data(), len, gs, X, ldx, y, w, R, loss_id, q, 0.0f, out + p,
                         nullptr, N);
  }
}

}  // namespace

extern "C" {

void h_b1(int rpt, const int* prog, int P, int N, const float* vals, const int* optab,
          const float* X, long long ldx, const float* y, const float* w, int R, int loss_id,
          const float* q, int gs, float* out, float* preds, int* lens) {
  if (rpt == 1) b1<1>(prog, P, N, vals, optab, X, ldx, y, w, R, loss_id, q, gs, out, preds, lens);
  if (rpt == 2) b1<2>(prog, P, N, vals, optab, X, ldx, y, w, R, loss_id, q, gs, out, preds, lens);
  if (rpt == 4) b1<4>(prog, P, N, vals, optab, X, ldx, y, w, R, loss_id, q, gs, out, preds, lens);
}

void h_b2(int rpt, int tree, const int* prog, int P, int N, const float* vals,
          const int* optab, const float* X, long long ldx, const float* y, const float* w, int R,
          int loss_id, const float* q, int gs, float* out, float* grads) {
#define SR_B2(r)                                                                           \
  if (rpt == r && tree)                                                                    \
    b2<r, sr::kTree>(prog, P, N, vals, optab, X, ldx, y, w, R, loss_id, q, gs, out, grads); \
  if (rpt == r && !tree)                                                                   \
    b2<r, sr::kSwitch>(prog, P, N, vals, optab, X, ldx, y, w, R, loss_id, q, gs, out, grads);
  SR_B2(1) SR_B2(2) SR_B2(4)
#undef SR_B2
}

void h_b2v(int rpt, const int* prog, int P, int N, const float* vals, const int* optab,
           const float* X, long long ldx, const float* seed, int R, int gs, float* grads) {
  if (rpt == 1) b2v<1>(prog, P, N, vals, optab, X, ldx, seed, R, gs, grads);
  if (rpt == 2) b2v<2>(prog, P, N, vals, optab, X, ldx, seed, R, gs, grads);
  if (rpt == 4) b2v<4>(prog, P, N, vals, optab, X, ldx, seed, R, gs, grads);
}

// The instructions decode_code gives one packed row, on the stack or on a
// tape (`tape`), with stride 1: ins [N, 4] (op, a, w, l); returns the count.
int h_decode(const int* prog, int N, const float* vals, const int* optab, int tape, int* ins) {
  std::vector<int> st(sr::stack_slots(N));
  return sr::decode_code(prog, N, optab, vals, 1, st.data(), reinterpret_cast<sr::Instr*>(ins),
                         tape != 0);
}

void h_b3(int rpt, const int* words, const float* consts, const int* length, int P, int N,
          int F, int n_unary, int n_binary, const int* optab, const float* X, long long ldx,
          const float* y, const float* w, int R, int loss_id, const float* q, int gs,
          float* out) {
  if (rpt == 1) b3<1>(words, consts, length, P, N, F, n_unary, n_binary, optab, X, ldx, y, w, R,
                      loss_id, q, gs, out);
  if (rpt == 2) b3<2>(words, consts, length, P, N, F, n_unary, n_binary, optab, X, ldx, y, w, R,
                      loss_id, q, gs, out);
  if (rpt == 4) b3<4>(words, consts, length, P, N, F, n_unary, n_binary, optab, X, ldx, y, w, R,
                      loss_id, q, gs, out);
}

// Whether each row of a B1 batch decodes stack-sound: decode_code gives back
// the row's length and, for a one-slot row, that slot is a leaf (an unsound
// row decodes to one NaN constant).
void h_sound(const int* prog, int P, int N, const float* vals, const int* optab, int* sound) {
  std::vector<sr::Instr> ins(N > 0 ? N : 1);
  std::vector<int> st(sr::stack_slots(N));
  for (int p = 0; p < P; ++p) {
    const int* row = prog + (long long)p * (4 * N + 1);
    const int len = row[4 * N];
    const int got = sr::decode_code(row, N, optab, vals + (long long)p * N, 1, st.data(),
                                    ins.data());
    sound[p] = got == len && (len != 1 || row[0] <= 1);
  }
}

// B3's warp split: each warp's first unit -> out [W + 1], and whether each
// warp's run holds units of each candidate -> has [W, E]
void h_split(const int* len, int E, int T, int W, int* out, int* has) {
  long long C = 0;
  for (int e = 0; e < E; ++e) C += sr::unit_cost(len[e]);
  for (int v = 0; v <= W; ++v) out[v] = sr::first_unit(len, E, T, C * T, v, W);
  for (int v = 0; v < W; ++v)
    for (int e = 0; e < E; ++e) has[v * E + e] = sr::run_has(out, v, e, T);
}

}  // extern "C"
"""


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    d = tmp_path_factory.mktemp("interp_core")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    lib = d / "libcore.so"
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(d / "shim.cpp")], check=True)
    return ctypes.CDLL(str(lib))


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def _case(ops: str, n_rows: int, maxsize: int = 20, n_trees: int = 96):
    """One seeded corpus in both packages: JAX trees, the port's packed
    programs, X [5, R], y, w (numpy)."""
    kw = dict(CONFIG3 if ops == "config3" else EVERY, maxsize=maxsize, save_to_file=False)
    jopts, topts = J.Options(**kw), T.Options(device="cpu", **kw)
    rng = np.random.default_rng(n_rows * 7 + maxsize)
    trees = []
    while len(trees) < n_trees:
        t = j_gen(int(rng.integers(1, maxsize // 2 + 1)), jopts.operators, 5, rng)
        if t.count_nodes() <= jopts.max_nodes:
            trees.append(t)
    jflat = J.flatten_trees(trees, jopts.max_nodes)
    prog, vals = ic.pack_programs_fused(convert.flat_trees(jflat), topts.operators)
    X = rng.normal(size=(5, n_rows)).astype(np.float32)
    y = np.cos(X[1]).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n_rows).astype(np.float32)
    return jopts, topts, jflat, prog, vals, X, y, w


def _core_b1(core, rpt, topts, prog, vals, X, y, w, gs=32, preds=False, lens=None):
    optab = kernel_op_table(topts.operators).astype(np.int32)
    loss_id, params = kernel_loss_spec(topts.loss)
    q = np.zeros(4, np.float32)
    q[: len(params)] = params
    P, L = prog.shape
    N, R = (L - 1) // 4, X.shape[1]
    out = np.zeros(P, np.float32)
    pr = np.zeros((P, R), np.float32) if preds else None
    Xc = np.ascontiguousarray(X)
    core.h_b1(ctypes.c_int(rpt), _p(np.ascontiguousarray(prog)), ctypes.c_int(P), ctypes.c_int(N),
              _p(vals), _p(optab), _p(Xc), ctypes.c_longlong(R), _p(y),
              None if w is None else _p(w), ctypes.c_int(R), ctypes.c_int(loss_id), _p(q),
              ctypes.c_int(gs), _p(out), None if pr is None else _p(pr),
              None if lens is None else _p(lens))
    return (out, pr) if preds else out


def _assert_close(got, want, mask=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def _trusted(a, b, lim=1e6):
    """Positions where the two references agree to 1e-5 (or are both NaN, or
    both the same inf) and stay below ``lim``: where the comparison tests the
    core and not the conditioning of a composed tree."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same_nonfin = (np.isnan(a) & np.isnan(b)) | (np.isinf(a) & (a == b))
    close = np.isfinite(a) & np.isfinite(b) & (np.abs(a) < lim) & (
        np.abs(a - b) <= 1e-5 * np.abs(b) + 1e-6)
    return same_nonfin | close


@pytest.mark.parametrize("ops", ["config3", "every"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("n_rows", [1, 33, 1000])
@pytest.mark.parametrize("rpt", [1, 2, 4])
def test_core_losses_match_jax_and_plain(core, rpt, n_rows, weighted, ops):
    """B1's decode and row walk: losses against the JAX package's scoring and
    the port's fused_loss_reference, one group of 32 threads."""
    jopts, topts, jflat, prog, vals, X, y, w = _case(ops, n_rows)
    wt = w if weighted else None
    got = _core_b1(core, rpt, topts, prog, vals, X, y, wt)
    plain = ic.fused_loss_reference(torch.from_numpy(prog), torch.from_numpy(vals),
                                    torch.from_numpy(X), torch.from_numpy(y),
                                    None if wt is None else torch.from_numpy(wt),
                                    topts.operators, topts.loss).numpy()
    want = np.asarray(batched_loss_jit(jflat, jnp.asarray(X), jnp.asarray(y),
                                       None if wt is None else jnp.asarray(wt),
                                       jopts.operators, jopts.loss))
    keep = _trusted(plain, want)
    assert keep.mean() > 0.85
    _assert_close(got, plain, None if ops == "config3" else keep)
    _assert_close(got, want, keep)
    assert np.isfinite(got[keep]).sum() >= 20


@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("rpt", [1, 2, 4])
def test_core_predictions_match_jax_and_plain(core, rpt, gs):
    """Every row's prediction from the RPT walk of a group of ``gs`` threads
    (33 and 1000 rows: neither a multiple of RPT nor of the group) on the
    every-operator corpus, against both packages' eval_trees."""
    for n_rows in (33, 1000):
        jopts, topts, jflat, prog, vals, X, y, _ = _case("every", n_rows)
        _, got = _core_b1(core, rpt, topts, prog, vals, X, y, None, gs=gs, preds=True)
        flat = convert.flat_trees(jflat)
        plain = t_eval_trees(flat, torch.from_numpy(X), topts.operators).numpy()
        want = np.asarray(j_eval_trees(jflat, jnp.asarray(X), jopts.operators))
        keep = _trusted(plain, want)
        assert keep.mean() > 0.9
        _assert_close(got, plain, keep)
        _assert_close(got, want, keep)


@pytest.mark.parametrize("rpt", [1, 2, 4])
def test_core_wide_programs(core, rpt):
    """N > 32 slots (maxsize 40): the decode's operand offsets and the walk
    hold for programs longer than a warp."""
    jopts, topts, jflat, prog, vals, X, y, w = _case("config3", 1000, maxsize=40, n_trees=48)
    N = (prog.shape[1] - 1) // 4
    assert N > 32 and prog[:, 4 * N].max() > 32
    got = _core_b1(core, rpt, topts, prog, vals, X, y, w, gs=64)
    plain = ic.fused_loss_reference(*(torch.from_numpy(a) for a in (prog, vals, X, y, w)),
                                    topts.operators, topts.loss).numpy()
    _assert_close(got, plain)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("rpt", [1, 2, 4])
def test_core_words_match_block_plain_eval(core, rpt, weighted):
    """B3's decode (packed words, children from the pointer pass; an empty
    program scores 0) through the same walk, against B3's plain evaluator."""
    jopts, topts, jflat, prog, vals, X, y, w = _case("config3", 33)
    flat = convert.flat_trees(jflat)
    words, consts = pack_state_words(*(torch.from_numpy(np.asarray(a)) for a in
                                       (flat.kind, flat.op, flat.feat, flat.val)))
    length = torch.from_numpy(np.asarray(flat.length, np.int32))
    wt = w if weighted else None
    want = make_plain_eval(topts.operators, topts.loss, torch.from_numpy(X), torch.from_numpy(y),
                           None if wt is None else torch.from_numpy(wt))(
        words, consts, length).numpy()
    opset = topts.operators
    optab = kernel_op_table(opset).astype(np.int32)
    q = np.zeros(4, np.float32)
    P, N = words.shape
    got = np.zeros(P, np.float32)
    arr = [np.ascontiguousarray(t.numpy().astype(dt)) for t, dt in
           ((words, np.int32), (consts, np.float32), (length, np.int32))]
    core.h_b3(ctypes.c_int(rpt), *(_p(a) for a in arr), ctypes.c_int(P), ctypes.c_int(N),
              ctypes.c_int(5), ctypes.c_int(opset.n_unary), ctypes.c_int(opset.n_binary),
              _p(optab), _p(X), ctypes.c_longlong(X.shape[1]), _p(y),
              None if wt is None else _p(wt), ctypes.c_int(X.shape[1]),
              ctypes.c_int(kernel_loss_spec(topts.loss)[0]), _p(q), ctypes.c_int(32), _p(got))
    _assert_close(got, want)


def test_core_decode_rejects_unsound_programs(core):
    """A row whose children are not the postfix stack's top entries (swapped
    children of its root) or whose stack ends with two entries (its binary
    root cut off) decodes to one NaN constant, so its loss is inf; the sound
    rows of the batch decode to their own lengths and keep their losses."""
    jopts, topts, jflat, prog, vals, X, y, w = _case("config3", 33)
    N = (prog.shape[1] - 1) // 4
    length = prog[:, 4 * N]
    root = prog[np.arange(len(prog)), length - 1]
    binary_root = np.nonzero((length > 1) & (root >= 2 + topts.operators.n_unary))[0]
    assert len(binary_root) >= 2
    swapped, cut = binary_root[:2]
    assert _sound(core, topts, prog, vals).all()
    bad = prog.copy()
    i = length[swapped] - 1
    bad[swapped, N + i], bad[swapped, 2 * N + i] = prog[swapped, 2 * N + i], prog[swapped, N + i]
    bad[cut, 4 * N] = length[cut] - 1
    lens = np.zeros(len(prog), np.int32)
    got = _core_b1(core, 2, topts, bad, vals, X, y, None, lens=lens)
    want = ic.fused_loss_reference(*(torch.from_numpy(a) for a in (prog, vals, X, y)), None,
                                   topts.operators, topts.loss).numpy()
    unsound = np.isin(np.arange(len(prog)), [swapped, cut])
    assert (lens[unsound] == 1).all() and np.isinf(got[unsound]).all()
    np.testing.assert_array_equal(_sound(core, topts, bad, vals), ~unsound)
    np.testing.assert_array_equal(lens[~unsound], length[~unsound])
    _assert_close(got[~unsound], want[~unsound])


def _core_b2(core, rpt, topts, prog, vals, X, y, w, gs=32, tree=False):
    """B2's walk on the core: (losses [P], grads [P, N])."""
    optab = kernel_op_table(topts.operators).astype(np.int32)
    loss_id, params = kernel_loss_spec(topts.loss)
    q = np.zeros(4, np.float32)
    q[: len(params)] = params
    P, L = prog.shape
    N, R = (L - 1) // 4, X.shape[1]
    out = np.zeros(P, np.float32)
    grads = np.full((P, N), np.nan, np.float32)
    core.h_b2(ctypes.c_int(rpt), ctypes.c_int(int(tree)), _p(np.ascontiguousarray(prog)),
              ctypes.c_int(P), ctypes.c_int(N), _p(vals), _p(optab), _p(np.ascontiguousarray(X)),
              ctypes.c_longlong(R), _p(y), None if w is None else _p(w), ctypes.c_int(R),
              ctypes.c_int(loss_id), _p(q), ctypes.c_int(gs), _p(out), _p(grads))
    return out, grads


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(ops: str):
    """jit(vmap(value_and_grad)) of the row sum of w * loss through the JAX
    package's scan interpreter, in tests/test_torch_lossgrad.py's convention
    (B2's: the sum is differentiated, then divided by w_sum)."""
    from symbolicregression_jl_tpu.ops.constant_opt import _eval_one

    jopts = _case(ops, 1)[0]

    def total(v, s, X, y, w):
        return jnp.sum(jopts.loss(_eval_one(jopts.operators, s, v, X), y) * w)

    return jax.jit(jax.vmap(jax.value_and_grad(total), in_axes=(0, 0, None, None, None)))


def _jax_loss_grad(ops, jflat, X, y, w):
    from symbolicregression_jl_tpu.ops.interp import _Structure

    struct = _Structure(*(jnp.asarray(np.asarray(getattr(jflat, f))) for f in
                          ("kind", "op", "lhs", "rhs", "feat", "length")))
    wj = np.ones_like(y) if w is None else w
    lj, gj = _jax_value_and_grad(ops)(jnp.asarray(jflat.val), struct, jnp.asarray(X),
                                      jnp.asarray(y), jnp.asarray(wj))
    wsum = float(np.sum(wj, dtype=np.float64))
    return np.asarray(lj) / wsum, np.asarray(gj) / wsum


def _well_conditioned(jopts, topts, jflat, X):
    """Trees whose predictions the JAX package and the port's plain
    interpreter agree on to 1e-6 relative, all finite and below 1e3: where
    a gradient comparison tests the sweep, not the conditioning of a
    composed tree (tests/test_torch_lossgrad.py's rule)."""
    pj = np.asarray(j_eval_trees(jflat, jnp.asarray(X), jopts.operators), np.float64)
    pt = t_eval_trees(convert.flat_trees(jflat), torch.from_numpy(X),
                      topts.operators).double().numpy()
    with np.errstate(invalid="ignore"):
        close = np.abs(pj - pt) <= 1e-6 * np.maximum(np.abs(pj), 1e-3)
        return (np.isfinite(pj) & close & (np.abs(pj) < 1e3)).all(axis=1)


def _assert_grads_close(got, want, trees, scale_atol):
    """Gradients of the selected trees: equal NaN and inf positions, and
    |got - want| <= GRAD_RTOL |want| + scale_atol x the tree's largest
    finite |want|."""
    got, want = np.asarray(got, np.float64)[trees], np.asarray(want, np.float64)[trees]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    scale = np.max(np.where(fin, np.abs(want), 0.0), axis=1, keepdims=True)
    err = np.where(fin, np.abs(got - want), 0.0)
    lim = GRAD_RTOL * np.abs(want) + scale_atol * scale
    assert not (fin & (err > lim)).any(), np.max(np.where(fin, err - lim, -np.inf))


@pytest.mark.parametrize("ops", ["config3", "every"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("n_rows", [1, 33, 1000])
@pytest.mark.parametrize("rpt", [1, 2, 4])
def test_core_grads_match_jax_and_plain(core, rpt, n_rows, weighted, ops):
    """B2's tape forward and reverse sweep: losses and constant gradients
    against fused_loss_grad_reference and against jax.value_and_grad of the
    JAX package's interpreter; gradients only on constant slots."""
    jopts, topts, jflat, prog, vals, X, y, w = _case(ops, n_rows)
    wt = w if weighted else None
    lk, gk = _core_b2(core, rpt, topts, prog, vals, X, y, wt)
    lr, gr = (a.numpy() for a in ic.fused_loss_grad_reference(
        *(torch.from_numpy(a) for a in (prog, vals, X, y)),
        None if wt is None else torch.from_numpy(wt), topts.operators, topts.loss))
    lj, gj = _jax_loss_grad(ops, jflat, X, y, wt)
    const = np.asarray(jflat.kind) == 1
    np.testing.assert_array_equal(gk[~const], 0.0)
    keep = _well_conditioned(jopts, topts, jflat, X) & (np.abs(lj) < 1e6)
    assert keep.sum() >= 20 and (gj[keep][const[keep]] != 0).sum() >= 10
    every = np.ones(len(prog), bool)
    _assert_close(lk, lr, None if ops == "config3" else keep)
    _assert_grads_close(gk, gr, every if ops == "config3" else keep, GRAD_SCALE_ATOL)
    _assert_close(lk, lj, keep)
    _assert_grads_close(np.where(const, gk, 0.0), gj, keep, 1e-5)


def _core_b2v(core, rpt, topts, prog, vals, X, seed, gs=32):
    """B2's seeded walk on the core: grads [P, N]."""
    optab = kernel_op_table(topts.operators).astype(np.int32)
    P, L = prog.shape
    N, R = (L - 1) // 4, X.shape[1]
    grads = np.full((P, N), np.nan, np.float32)
    core.h_b2v(ctypes.c_int(rpt), _p(np.ascontiguousarray(prog)), ctypes.c_int(P),
               ctypes.c_int(N), _p(vals), _p(optab), _p(np.ascontiguousarray(X)),
               ctypes.c_longlong(R), _p(np.ascontiguousarray(seed)), ctypes.c_int(R),
               ctypes.c_int(gs), _p(grads))
    return grads


@pytest.mark.parametrize("ops", ["config3", "every"])
@pytest.mark.parametrize("n_rows", [1, 33, 1000])
@pytest.mark.parametrize("rpt", [1, 2, 4])
def test_core_seeded_sweep_matches_autograd(core, rpt, n_rows, ops):
    """B2's seeded mode (``preds_vjp``): the tape forward and the reverse
    sweep from a random cotangent on the predictions, against
    ``preds_vjp_reference`` and against torch autograd of the plain
    interpreter (``eval_plan``, the differentiable ``eval_trees``) with that
    cotangent as ``grad_outputs``, over every built-in operator; gradients
    only on constant slots, zero on every slot of a tree with a non-finite
    prediction. Tolerance: the B2 gradient rule above (rtol 1e-4 plus 1e-6
    times the tree's largest finite gradient), every tree of the config3
    corpus, the well-conditioned trees of the every-operator one."""
    from symbolicregression_jl_tpu_torch.ops.interp import eval_plan, make_plan

    jopts, topts, jflat, prog, vals, X, y, w = _case(ops, n_rows)
    seed = np.random.default_rng(n_rows + rpt).normal(size=(len(prog), n_rows)).astype(
        np.float32)
    gk = _core_b2v(core, rpt, topts, prog, vals, X, seed)
    tp, tv, tX, ts = (torch.from_numpy(a) for a in (prog, vals, X, seed))
    gr = ic.preds_vjp_reference(tp, tv, tX, ts, topts.operators).numpy()
    flat = convert.flat_trees(jflat)
    v = tv.clone().requires_grad_(True)
    pred = eval_plan(make_plan(flat, topts.operators, "cpu"), v, tX)
    (ga,) = torch.autograd.grad(pred, v, ts)
    ok = torch.isfinite(pred.detach()).all(-1, keepdim=True)
    ga = torch.where(ok, ga, 0.0).numpy()
    const = np.asarray(jflat.kind) == 1
    np.testing.assert_array_equal(gk[~const], 0.0)
    np.testing.assert_array_equal(gk[~ok.numpy()[:, 0]], 0.0)
    keep = np.ones(len(prog), bool) if ops == "config3" else _well_conditioned(
        jopts, topts, jflat, X)
    assert keep.sum() >= 20 and (gk[keep][const[keep]] != 0).sum() >= 10
    _assert_grads_close(gk, gr, keep, GRAD_SCALE_ATOL)
    _assert_grads_close(gk, ga, keep, GRAD_SCALE_ATOL)


def test_core_seeded_sweep_unsound_rows(core):
    """A row that is not stack-sound gets zero gradients from the seeded
    sweep; the batch's other rows keep the plain version's."""
    jopts, topts, jflat, prog, vals, X, y, w = _case("config3", 33)
    N = (prog.shape[1] - 1) // 4
    length = prog[:, 4 * N]
    root = prog[np.arange(len(prog)), length - 1]
    swapped = np.nonzero((length > 1) & (root >= 2 + topts.operators.n_unary))[0][0]
    bad = prog.copy()
    i = length[swapped] - 1
    bad[swapped, N + i], bad[swapped, 2 * N + i] = prog[swapped, 2 * N + i], prog[swapped, N + i]
    seed = np.random.default_rng(3).normal(size=(len(prog), 33)).astype(np.float32)
    gk = _core_b2v(core, 4, topts, bad, vals, X, seed)
    gr = ic.preds_vjp_reference(*(torch.from_numpy(a) for a in (prog, vals, X, seed)),
                                topts.operators).numpy()
    assert (gk[swapped] == 0).all() and (gr[swapped] != 0).any()
    rest = np.arange(len(prog)) != swapped
    _assert_grads_close(gk, gr, rest, GRAD_SCALE_ATOL)


def test_core_grads_dispatch_tree_equals_switch(core):
    """The reverse sweep's two dispatches run the same derivatives: the tree
    and the switch give identical bits."""
    for ops in ("config3", "every"):
        jopts, topts, jflat, prog, vals, X, y, w = _case(ops, 1000)
        a = _core_b2(core, 4, topts, prog, vals, X, y, w, tree=False)
        b = _core_b2(core, 4, topts, prog, vals, X, y, w, tree=True)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u.view(np.int32), v.view(np.int32))


@pytest.mark.parametrize("ops, maxsize", [("config3", 20), ("every", 20), ("config3", 40)])
def test_core_decode_records_left_children(core, ops, maxsize):
    """decode_code on a tape (stride 1): each slot's values go to its own
    slot (a == i) and a binary operator's `l` is its left child's slot from
    the postfix walk, which is the program's lhs; on the stack a binary's
    result and left operand share its stack position `a`, and `l` is 0."""
    jopts, topts, jflat, prog, vals, X, y, w = _case(ops, 33, maxsize=maxsize,
                                                      n_trees=96 if maxsize == 20 else 48)
    P, L = prog.shape
    N = (L - 1) // 4
    nu = topts.operators.n_unary
    optab = kernel_op_table(topts.operators).astype(np.int32)
    binaries = 0
    for p in range(P):
        row = np.ascontiguousarray(prog[p])
        v = np.ascontiguousarray(vals[p])
        length = int(row[4 * N])
        tape = np.zeros((max(N, 1), 4), np.int32)
        stack = np.zeros((max(N, 1), 4), np.int32)
        assert core.h_decode(_p(row), ctypes.c_int(N), _p(v), _p(optab), ctypes.c_int(1),
                             _p(tape)) == length
        assert core.h_decode(_p(row), ctypes.c_int(N), _p(v), _p(optab), ctypes.c_int(0),
                             _p(stack)) == length
        walk, height = [], 0
        for i in range(length):
            code = int(row[i])
            binary = code >= 2 + nu
            if code >= 2:
                right = walk.pop()
                left = walk.pop() if binary else None
            assert tape[i, 1] == i
            if binary:
                binaries += 1
                assert tape[i, 3] == left == row[N + i] and right == row[2 * N + i]
                assert stack[i, 1] == height - 2 and stack[i, 3] == 0
            else:
                assert tape[i, 3] == 0 and stack[i, 3] == 0
            height += 1 if code <= 1 else (-1 if binary else 0)
            walk.append(i)
    assert binaries >= 50


def test_core_grads_unsound_rows(core):
    """A row that is not stack-sound scores inf with zero gradients in B2's
    walk; the batch's other rows keep the plain version's values."""
    jopts, topts, jflat, prog, vals, X, y, w = _case("config3", 33)
    N = (prog.shape[1] - 1) // 4
    length = prog[:, 4 * N]
    root = prog[np.arange(len(prog)), length - 1]
    swapped, cut = np.nonzero((length > 1) & (root >= 2 + topts.operators.n_unary))[0][:2]
    bad = prog.copy()
    i = length[swapped] - 1
    bad[swapped, N + i], bad[swapped, 2 * N + i] = prog[swapped, 2 * N + i], prog[swapped, N + i]
    bad[cut, 4 * N] = length[cut] - 1
    lk, gk = _core_b2(core, 4, topts, bad, vals, X, y, w)
    lr, gr = (a.numpy() for a in ic.fused_loss_grad_reference(
        *(torch.from_numpy(a) for a in (prog, vals, X, y, w)), topts.operators, topts.loss))
    unsound = np.isin(np.arange(len(prog)), [swapped, cut])
    assert np.isinf(lk[unsound]).all() and (gk[unsound] == 0).all()
    _assert_close(lk[~unsound], lr[~unsound])
    _assert_grads_close(gk, gr, ~unsound, GRAD_SCALE_ATOL)


def _sound(core, topts, prog, vals):
    """Per row of a packed B1 batch: whether the core decodes it stack-sound."""
    P, L = prog.shape
    optab = kernel_op_table(topts.operators).astype(np.int32)
    sound = np.zeros(P, np.int32)
    core.h_sound(_p(np.ascontiguousarray(prog, np.int32)), ctypes.c_int(P),
                 ctypes.c_int((L - 1) // 4), _p(np.ascontiguousarray(vals, np.float32)),
                 _p(optab), _p(sound))
    return sound.astype(bool)


@pytest.mark.parametrize("path", ["lockstep", "device-events", "device-block",
                                  "lockstep-graph"])
def test_main_path_batches_decode_sound(core, monkeypatch, path):
    """B1 and B2 evaluate on the postfix stack, so they score a program whose
    children are not the stack's top entries as inf (B2 with zero
    gradients), where the plain versions follow lhs/rhs. Every batch the
    main paths hand B1 or B2 on a small search must therefore decode
    stack-sound: lockstep scoring (``pack_programs_fused`` of
    ``flatten_trees``), and the device engine's ``pack_batch`` of its state
    (initial scoring, event-leg candidates, constant optimization's line
    searches and its gradients through ``DiffLoss``, simplify rescoring), on
    the event leg and on the block (its plain version here), and lockstep
    scoring of graph-node DAGs after ``stack_sound_pointers``."""
    import symbolicregression_jl_tpu_torch.models.device_search as ds
    import symbolicregression_jl_tpu_torch.models.scorer as scorer_mod

    seen, seen_grad = [], []
    for mod, name, into in ((ds, "fused_loss", seen), (scorer_mod, "fused_loss", seen),
                            (ic, "fused_loss_grad", seen_grad)):
        real = getattr(mod, name)

        def rec(prog, vals, *a, _real=real, _into=into, **k):
            _into.append((prog.cpu().numpy().copy(), vals.detach().cpu().numpy().copy()))
            return _real(prog, vals, *a, **k)

        monkeypatch.setattr(mod, name, rec)
    monkeypatch.setenv("SR_ENGINE_BLOCK", "1" if path == "device-block" else "0")
    rng = np.random.default_rng(1)
    X = rng.normal(size=(2, 64)).astype(np.float32)
    y = (2 * np.cos(X[1]) + X[0] ** 2 - 2).astype(np.float32)
    opts = T.Options(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
                     populations=2, population_size=16, ncycles_per_iteration=10, maxsize=14,
                     seed=1, save_to_file=False, progress=False, device="cpu",
                     graph_nodes=path == "lockstep-graph",
                     scheduler="device" if path.startswith("device") else "lockstep")
    T.equation_search(X, y, options=opts, niterations=2, verbosity=0)
    assert len(seen) >= 3
    # constant optimization's gradients: B2 on the device engine only
    assert (len(seen_grad) >= 2) == path.startswith("device")
    rows = 0
    for prog, vals in seen + seen_grad:
        sound = _sound(core, opts, prog, vals)
        assert sound.all(), prog[~sound][:3]
        rows += len(prog)
    assert rows >= 32


@pytest.mark.parametrize("E, T, W", [(9, 79, 16), (9, 313, 32), (40, 5, 8), (3, 1, 16),
                                     (100, 40, 16), (1, 7, 4), (400, 2, 16), (3, 5, 16),
                                     (4, 4, 16), (2, 3, 8)])
def test_block_warp_split_covers_every_unit_once(core, E, T, W):
    """B3's scoring split: the warps' runs [first_unit(w), first_unit(w + 1))
    tile the E x T units in order; a unit goes to the warp its cost prefix
    names (w C <= p W < (w + 1) C); run_has names exactly the warps whose
    runs hold a candidate's units, also when there are fewer units than
    warps and some runs are empty; those pairs (e, w) have distinct partial
    slots e + w < E + W - 1; and no warp's cost passes an even share by more
    than one unit's."""
    rng = np.random.default_rng(E * T + W)
    lens = rng.integers(0, 40, E).astype(np.int32)
    bounds = np.zeros(W + 1, np.int32)
    has = np.zeros((W, E), np.int32)
    core.h_split(_p(lens), ctypes.c_int(E), ctypes.c_int(T), ctypes.c_int(W), _p(bounds),
                 _p(has))
    assert bounds[0] == 0 and bounds[-1] == E * T and (np.diff(bounds) >= 0).all()
    cost = np.repeat(np.maximum(lens, 1) + 4, T).astype(np.int64)
    prefix = np.concatenate([[0], np.cumsum(cost)[:-1]])
    owner = np.searchsorted(bounds, np.arange(E * T), side="right") - 1
    np.testing.assert_array_equal(owner, prefix * W // cost.sum())
    want_has = np.zeros((W, E), np.int32)
    want_has[owner, np.arange(E * T) // T] = 1
    np.testing.assert_array_equal(has, want_has)
    slots = set()
    for v, e in zip(*np.nonzero(want_has)):
        assert e + v not in slots and e + v < E + W - 1
        slots.add(e + v)
    per_warp = np.bincount(owner, weights=cost, minlength=W)
    assert per_warp.max() <= cost.sum() / W + cost.max()


# -- host-side geometry ------------------------------------------------------------


def _rows_of_b1(geom, R):
    """Row -> count of (thread, RPT) evaluations that add it to one tree's
    sum, following the kernel's walk for the launch shape ``geom``."""
    threads, rpt, tpb, rows_per_chunk, n_chunks = geom
    group = threads // tpb
    hits = np.zeros(R, np.int64)
    for chunk in range(n_chunks):
        r0, r1 = chunk * rows_per_chunk, min(R, (chunk + 1) * rows_per_chunk)
        for base in range(r0, r1, group * rpt):
            rows = base + np.arange(group)[:, None] + np.arange(rpt)[None, :] * group
            np.add.at(hits, rows[rows < r1], 1)
    return hits


@pytest.mark.parametrize("P, N, R", [(1024, 24, 10_000), (4200, 24, 10_000), (1024, 24, 50),
                                     (300, 24, 1), (300, 24, 33), (7, 24, 1000),
                                     (1024, 24, 2048), (64, 44, 777), (16, 60, 10_000),
                                     (1, 255, 5), (4200, 24, 20_001)])
def test_b1_geometry_covers_every_row_once(P, N, R):
    geom = ic.loss_geometry(P, N, R)
    threads, rpt, tpb, rows_per_chunk, n_chunks = geom
    assert rpt in (1, 2, 4) and threads <= 256 and threads % 32 == 0
    assert tpb >= 1 and threads % (32 * tpb) == 0
    assert ic.loss_smem(N, threads, tpb, rpt, 64) <= 227 * 1024
    assert 1 <= n_chunks <= 65535 and n_chunks * rows_per_chunk >= R
    assert (n_chunks - 1) * rows_per_chunk < R  # no empty chunk
    assert (_rows_of_b1(geom, R) == 1).all()
    if R <= 32 * rpt:  # minibatches: one warp per tree, the block full of trees
        assert tpb == threads // 32 and n_chunks == 1


def test_b1_geometry_fills_the_card_at_the_engine_shapes():
    """At the lockstep (1024 x 10k) and constant-optimization (4,200 x 10k)
    shapes the chunks give some TARGET_BLOCKS blocks, with equal tiles per
    chunk."""
    for P in (1024, 4200):
        threads, rpt, tpb, rows_per_chunk, n_chunks = ic.loss_geometry(P, 24, 10_000)
        assert tpb == 1 and rows_per_chunk % (threads * rpt) == 0
        blocks = P * n_chunks
        assert ic.TARGET_BLOCKS <= blocks < ic.TARGET_BLOCKS + 2 * P


_CORE_GEOMETRY = {"b2": (lambda: ic.grad_geometry, lambda: ic.grad_smem),
                  "b4": (lambda: ic.preds_geometry, lambda: ic.preds_smem)}


@pytest.mark.parametrize("P, N, R", [(1024, 24, 10_000), (4200, 24, 10_000), (1024, 24, 50),
                                     (300, 24, 1), (300, 24, 33), (7, 24, 1000),
                                     (1024, 24, 2048), (64, 44, 777), (16, 60, 10_000),
                                     (1, 255, 5), (4200, 24, 20_001)])
@pytest.mark.parametrize("kernel", ["b2", "b4"])
def test_core_geometry_covers_every_row_once(kernel, P, N, R):
    """B2's and B4's launch shapes, B1's rule on their own shared memory:
    every row of every tree evaluated once, within the H100's 227 KB,
    minibatches packed several trees to a block."""
    geometry, smem = (f() for f in _CORE_GEOMETRY[kernel])
    geom = geometry(P, N, R)
    threads, rpt, tpb, rows_per_chunk, n_chunks = geom
    assert rpt in (1, 2, 4) and threads <= 256 and threads % 32 == 0
    assert tpb >= 1 and threads % (32 * tpb) == 0
    assert smem(N, threads, tpb, rpt, 64) <= 227 * 1024
    assert 1 <= n_chunks <= 65535 and n_chunks * rows_per_chunk >= R
    assert (n_chunks - 1) * rows_per_chunk < R  # no empty chunk
    assert (_rows_of_b1(geom, R) == 1).all()
    if R <= 32 * rpt:  # minibatches: one warp per tree, the block full of trees
        assert tpb == threads // 32 and n_chunks == 1


@pytest.mark.parametrize("kernel, P", [("b2", 4200), ("b4", 1024)])
def test_core_geometry_fills_the_card_at_the_engine_shapes(kernel, P):
    """B2 at constant optimization's 4,200 x 10k rows and B4 at 1024 x 10k:
    one tree per block, chunks of whole tiles, some TARGET_BLOCKS blocks."""
    geometry, _ = (f() for f in _CORE_GEOMETRY[kernel])
    threads, rpt, tpb, rows_per_chunk, n_chunks = geometry(P, 24, 10_000)
    assert tpb == 1 and rows_per_chunk % (threads * rpt) == 0
    assert ic.TARGET_BLOCKS <= P * n_chunks < ic.TARGET_BLOCKS + 2 * P


def _block_cfg(islands=100, pop=100, maxsize=20, n_rows=10_000, **kw):
    from symbolicregression_jl_tpu_torch.models.device_search import build_evo_config

    opts = T.Options(populations=islands, population_size=pop, maxsize=maxsize, device="cpu",
                     **CONFIG3, **kw)
    cfg = build_evo_config(opts, n_features=5, baseline_loss=1.0, use_baseline=True,
                           niterations=1, n_islands=islands, n_rows=n_rows)
    spec = kernel_loss_spec(opts.loss)
    return ebc._make_cfg(cfg, opts.operators, spec, 5, n_rows, n_rows), cfg


@pytest.mark.parametrize("pop, maxsize, expect_smem", [
    (100, 20, 1),    # config3: the island in shared memory
    (400, 20, 1),    # E > the block's warps
    (100, 60, 1),    # N > 32
    (1100, 20, 0),   # the population does not fit: it stays in the output arrays
])
def test_block_geometry_fits(pop, maxsize, expect_smem):
    c, cfg = _block_cfg(islands=4, pop=pop, maxsize=maxsize)
    threads = ebc._geometry(c)
    assert (c.rpt, threads) in ebc.BLOCK_SHAPES
    assert threads % 32 == 0
    assert ebc.block_smem(c, threads) <= 227 * 1024
    assert c.use_smem == expect_smem
    if pop == 400:
        assert c.E > threads // 32
    if maxsize == 60:
        assert c.N > 32


def test_block_geometry_config3_takes_the_first_shape():
    c, cfg = _block_cfg()
    threads = ebc._geometry(c)
    assert (c.rpt, threads) == ebc.BLOCK_SHAPES[0] and c.use_smem == 1
    assert (c.E, c.N) == (cfg.events_per_cycle, cfg.n_slots) == (9, 24)


def test_block_launch_config_made_once():
    """The wrapper's launch configuration is made once per configuration and
    is the geometry's: the first shape that fits, its shared memory."""
    c, cfg = _block_cfg()
    opts = T.Options(populations=100, population_size=100, maxsize=20, device="cpu", **CONFIG3)
    args = (cfg, opts.operators, kernel_loss_spec(opts.loss), 5, 10_000, 10_000)
    got = ebc._launch_config(*args)
    assert ebc._launch_config(*args) is got
    threads = ebc._geometry(c)
    assert got[1:] == (threads, ebc.block_smem(c, threads))
    assert bytes(got[0]) == bytes(c)


def test_block_geometry_smem_grows_with_rpt_and_threads():
    c, _ = _block_cfg()
    c.use_smem = 1
    sizes = {}
    for rpt, threads in ebc.BLOCK_SHAPES:
        c.rpt = rpt
        sizes[(rpt, threads)] = ebc.block_smem(c, threads)
    # the value buffer is (N // 2 + 2) stack positions x threads x RPT f32; the
    # warps' instructions, partials and bounds grow with the warps
    D = c.N // 2 + 2
    assert sizes[(2, 512)] - sizes[(2, 256)] == 4 * D * 256 * 2 + 16 * 8 * c.N + 24 * 8 + 4 * 8
