// The multi-row interpreter core shared by the four kernels: the fused loss
// B1 (fused_loss.cu), the fused loss + constant gradient B2
// (fused_loss_grad.cu), the evolve block B3 (evolve_block.cu) and the
// prediction matrix B4 (eval_preds.cu).
//
// A program is a postorder sequence of slots. The core evaluates it on
// several rows per thread at once:
//
//   * Decode once per program, not once per row. Walking the postfix stack,
//     each slot becomes one 16-byte instruction {op, a, w}: op is the kernel
//     operator id already looked up through the opset's table (0..30 unary,
//     31..42 binary; see sr_ops.cuh) or kConst / kVar; a is the offset of the
//     slot's stack position in the value buffer (position x stride), so no
//     index arithmetic is left for the row loop; w is the constant's bits or
//     the feature index. A slot then costs one broadcast shared-memory load,
//     where the one-row loop read code, the operator table, lhs, rhs and the
//     feature one by one. A row that is not stack-sound decodes to a NaN.
//   * The stack top stays in registers. In a postfix program a unary
//     operator's operand and a binary operator's right operand are always the
//     value just computed, so only a binary operator's left operand is read
//     from the buffer, and the buffer needs N / 2 + 2 stack positions, not N
//     slots.
//   * RPT rows per thread, interleaved. A thread evaluates rows r, r + step,
//     ..., r + (RPT-1) step as independent chains: one decode and one
//     warp-uniform dispatch serve RPT rows, the RPT operands come in
//     one vector load, and RPT libm calls are in flight together. Rows step
//     by the thread count, so X, y and w loads stay coalesced for any row
//     count and any leading dimension of X.
//   * The value buffer is [position][thread][RPT] f32: a thread's RPT values
//     of one position are contiguous (one 8- or 16-byte access), and
//     neighbouring threads touch neighbouring vectors.
//   * The loss is applied once per RPT rows: the switch on the loss id sits
//     outside the loop over the RPT rows, and the loss's parameters come as
//     scalars (no array in local memory).
//   * B2's gradient runs on a tape (so does its seeded mode, whose root
//     adjoints are a cotangent on the predictions): decoded in tape mode,
//     every slot's values are stored at the slot's own place
//     ([slot][thread][RPT] f32), and a
//     binary operator's instruction records where its left child's values
//     are. The reverse sweep then walks the slots backwards with the current
//     slot's adjoint in registers: a unary operator's operand, and a binary
//     operator's right operand, are the slot just before it; a binary
//     operator writes its left child's adjoint over that child's values,
//     which nothing reads again; after a leaf, the slot before it is a left
//     child, whose adjoint its parent wrote there. Every node has one parent,
//     so nothing is zeroed and nothing accumulates.
//
// Everything here is __host__ __device__, so the same source compiles for
// the host (tests/test_torch_interp_core.py drives the decode and the row
// walk through g++ and holds them to the JAX package and to the port's
// plain versions). The arithmetic is sr_ops.cuh's, unchanged, so every value
// of a sound program is the one the one-row loop computed.

#pragma once

#include <stdint.h>
#include <string.h>

#include "sr_ops.cuh"

namespace sr {

// instruction ops beyond the kernel operator ids
constexpr int kConst = 64;  // w: the constant's bits
constexpr int kVar = 65;    // w: the feature index

// One slot of a decoded program. `a` is the offset in the value buffer where
// the slot's values go: on the stack, its stack position x stride (a unary
// operator's operand is the stack top, which lives in registers, and its
// result goes back to the same position; a binary operator's result goes to
// its left operand's position, where that operand is read), on a tape the
// slot x stride. On a tape `l` is the offset of a binary operator's left
// child (its slot x stride), else 0. The right operand is the stack top in
// registers.
struct alignas(16) Instr {
  int op;
  int a;
  int w;  // constant bits or feature index
  int l;  // on a tape, a binary operator's left child; one 16-byte load per instruction
};

// Stack positions a program of N slots can need: its height never exceeds
// its leaves, at most (N + 1) / 2.
SR_HD int stack_slots(int N) { return N / 2 + 2; }

SR_HD int bits_of(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_int(f);
#else
  int i;
  memcpy(&i, &f, sizeof i);
  return i;
#endif
}

SR_HD float float_of(int i) {
#ifdef __CUDA_ARCH__
  return __int_as_float(i);
#else
  float f;
  memcpy(&f, &i, sizeof f);
  return f;
#endif
}

// The program every unsound row becomes: one NaN constant.
SR_HD int decode_unsound(Instr* ins) {
  ins[0] = {kConst, 0, bits_of(nan_()), 0};
  return 1;
}

// Decodes a packed program row of B1, B2 and B4 (code | lhs | rhs | feat |
// length; code 0 const, 1 var, 2+k operator k of the opset, whose kernel id
// is optab[k]) into `ins` and returns the number of instructions: onto the
// stack, or with `tape` onto a tape of N slots (B2). The row must be
// stack-sound, as every postorder flattening of a tree is: each operator's
// children are the stack's top entries (a unary's child and a binary's right
// child the slot just before it, a binary's left child the root of the
// subtree before that), the stack never underflows and ends with one entry.
// The check tracks the slots on the stack in `st` (stack_slots(N) ints); a
// row that fails it decodes to one NaN constant (its loss is inf).
SR_HD int decode_code(const int* prog, int N, const int* optab, const float* vals, int stride,
                      int* st, Instr* ins, bool tape = false) {
  const int len = prog[4 * N];
  const int D = stack_slots(N);
  int h = 0;
  for (int i = 0; i < len; ++i) {
    const int code = prog[i];
    if (code <= 1) {
      if (h >= D) return decode_unsound(ins);
      ins[i] = {code == 0 ? kConst : kVar, (tape ? i : h) * stride,
                code == 0 ? bits_of(vals[i]) : prog[3 * N + i], 0};
      st[h++] = i;
      continue;
    }
    const int op = optab[code - 2];
    if (op < kUnaryBuiltins) {
      if (h < 1 || prog[N + i] != st[h - 1]) return decode_unsound(ins);
      ins[i] = {op, (tape ? i : h - 1) * stride, 0, 0};
      st[h - 1] = i;
    } else {
      if (h < 2 || prog[N + i] != st[h - 2] || prog[2 * N + i] != st[h - 1])
        return decode_unsound(ins);
      ins[i] = {op, (tape ? i : h - 2) * stride, 0, tape ? st[h - 2] * stride : 0};
      st[h - 2] = i;
      --h;
    }
  }
  if (len > 0 && h != 1) return decode_unsound(ins);
  return len;
}

// One packed word of B3 (kind | payload << 3; kind 1 const, 2 var, 3 unary,
// 4 binary): what it does to the postfix stack (push +1 for a leaf, 0 for a
// unary, -1 for a binary operator), how many entries it takes, and whether
// it is a valid slot at all (a pad word, or an operator payload outside the
// opset, is not).
struct WordSlot {
  int kind, payload, push, arity;
  bool valid;
};

SR_HD WordSlot word_slot(int word, int n_unary, int n_binary) {
  const int k = word & 7, pl = word >> 3;
  if (k == 1 || k == 2) return {k, pl, 1, 0, true};
  if (k == 3) return {k, pl, 0, 1, pl >= 0 && pl < n_unary};
  if (k == 4) return {k, pl, -1, 2, pl >= 0 && pl < n_binary};
  return {k, pl, 0, 0, false};
}

// The instruction of a valid word slot whose stack height before it is h
// (a feature payload clamped to [0, F)).
SR_HD Instr word_instr(const WordSlot& ws, float c, int h, int F, int n_unary, const int* optab,
                       int stride) {
  const int a = (h - ws.arity) * stride;
  if (ws.kind == 1) return {kConst, a, bits_of(c), 0};
  if (ws.kind == 2) {
    const int f = ws.payload < 0 ? 0 : (ws.payload > F - 1 ? F - 1 : ws.payload);
    return {kVar, a, f, 0};
  }
  return {optab[ws.kind == 3 ? ws.payload : n_unary + ws.payload], a, 0, 0};
}

// Decodes `len` packed words of B3 with their constants into `ins`, returning
// the number of instructions. Children follow the postfix stack, as the
// block's pointer pass finds them; a row on which the stack underflows, that
// holds an invalid slot, that would pass stack_slots(N) entries or that ends
// with more than one entry is unsound and decodes to one NaN constant. The
// block makes only sound rows. (B3 runs the same rule one warp at a time,
// the heights from a warp scan: decode_words_warp in evolve_block.cu.)
SR_HD int decode_words(const int* words, const float* consts, int len, int N, int F,
                       int n_unary, int n_binary, const int* optab, int stride, Instr* ins) {
  const int D = stack_slots(N);
  int h = 0;
  for (int i = 0; i < len; ++i) {
    const WordSlot ws = word_slot(words[i], n_unary, n_binary);
    if (!ws.valid || h < ws.arity || h + ws.push > D) return decode_unsound(ins);
    ins[i] = word_instr(ws, consts[i], h, F, n_unary, optab, stride);
    h += ws.push;
  }
  if (len > 0 && h != 1) return decode_unsound(ins);
  return len;
}

template <int RPT>
struct alignas(4 * RPT) Vals {
  float v[RPT];
};

template <int RPT>
SR_HD Vals<RPT> load_vals(const float* p) {
  return *reinterpret_cast<const Vals<RPT>*>(p);
}

template <int RPT>
SR_HD void store_vals(float* p, const Vals<RPT>& x) {
  *reinterpret_cast<Vals<RPT>*>(p) = x;
}

// Operator ID (a kernel operator id, 0..42) on the stack top o; a binary
// operator's left operand is read at x_at.
template <int RPT, int ID>
SR_HD void apply(Vals<RPT>& o, const float* x_at) {
  if constexpr (ID < kUnaryBuiltins) {
    for (int k = 0; k < RPT; ++k) o.v[k] = unary(ID, o.v[k]);
  } else {
    const Vals<RPT> x = load_vals<RPT>(x_at);
    for (int k = 0; k < RPT; ++k) o.v[k] = binary(ID - kUnaryBuiltins, x.v[k], o.v[k]);
  }
}

// The forward step of one slot, for dispatch: apply<RPT, ID>, NaN for an id
// past the operators.
template <int RPT>
struct Forward {
  Vals<RPT>& o;
  const float* x_at;
  template <int ID>
  SR_HD void run() const { apply<RPT, ID>(o, x_at); }
  SR_HD void none() const {
    for (int k = 0; k < RPT; ++k) o.v[k] = nan_();
  }
};

// The reverse step of one slot of a tape, for dispatch: g holds the slot's
// adjoints and becomes its only or right child's; the child's values are at
// r_at (the slot before). A binary operator reads its left child's values at
// l_at and writes the left child's adjoints there. The derivatives are
// sr_ops.cuh's, which reproduce torch autograd of the plain version.
template <int RPT>
struct Reverse {
  Vals<RPT>& g;
  float* l_at;
  const float* r_at;
  template <int ID>
  SR_HD void run() const {
    const Vals<RPT> x = load_vals<RPT>(r_at);
    if constexpr (ID < kUnaryBuiltins) {
      for (int k = 0; k < RPT; ++k) g.v[k] = unary_grad(ID, x.v[k], g.v[k]);
    } else {
      const Vals<RPT> xl = load_vals<RPT>(l_at);
      Vals<RPT> dl;
      for (int k = 0; k < RPT; ++k)
        binary_grad(ID - kUnaryBuiltins, xl.v[k], x.v[k], g.v[k], &dl.v[k], &g.v[k]);
      store_vals<RPT>(l_at, dl);
    }
  }
  SR_HD void none() const {
    for (int k = 0; k < RPT; ++k) g.v[k] = nan_();
  }
};

constexpr int kOps = kUnaryBuiltins + 12;  // operator ids 0..42

// Dispatch of a step (Forward or Reverse) on a warp-uniform operator id by a
// binary tree of conditional branches over [LO, HI).
template <int LO, int HI, class Step>
SR_HD void dispatch_tree(int op, const Step& f) {
  if constexpr (HI - LO == 1) {
    f.template run<LO>();
  } else {
    constexpr int MID = (LO + HI) / 2;
    if (op < MID) {
      dispatch_tree<LO, MID>(op, f);
    } else {
      dispatch_tree<MID, HI>(op, f);
    }
  }
}

#define SR_CASE(id)        \
  case id:                 \
    f.template run<id>();  \
    break;

// Dispatch through a switch: one indirect branch through a jump table.
template <class Step>
SR_HD void dispatch_switch(int op, const Step& f) {
  switch (op) {
    SR_CASE(0) SR_CASE(1) SR_CASE(2) SR_CASE(3) SR_CASE(4) SR_CASE(5) SR_CASE(6) SR_CASE(7)
    SR_CASE(8) SR_CASE(9) SR_CASE(10) SR_CASE(11) SR_CASE(12) SR_CASE(13) SR_CASE(14)
    SR_CASE(15) SR_CASE(16) SR_CASE(17) SR_CASE(18) SR_CASE(19) SR_CASE(20) SR_CASE(21)
    SR_CASE(22) SR_CASE(23) SR_CASE(24) SR_CASE(25) SR_CASE(26) SR_CASE(27) SR_CASE(28)
    SR_CASE(29) SR_CASE(30) SR_CASE(31) SR_CASE(32) SR_CASE(33) SR_CASE(34) SR_CASE(35)
    SR_CASE(36) SR_CASE(37) SR_CASE(38) SR_CASE(39) SR_CASE(40) SR_CASE(41) SR_CASE(42)
    default:
      f.none();
  }
}

#undef SR_CASE

// How a kernel dispatches on the operator: each kernel takes the one that
// measured faster for it on the H100 (PERF.md): B1 and B4 the switch, B2 and
// B3 the tree.
enum Dispatch { kSwitch = 0, kTree = 1 };

// The four arithmetic operators, + - * /, sit in nearly every program, so
// they are tested first, two branches deep; every other operator goes
// through the kernel's dispatch.
template <Dispatch DISPATCH, class Step>
SR_HD void dispatch(int op, const Step& f) {
  if (op >= kUnaryBuiltins && op < kUnaryBuiltins + 4) {
    dispatch_tree<kUnaryBuiltins, kUnaryBuiltins + 4>(op, f);
  } else if constexpr (DISPATCH == kTree) {
    dispatch_tree<0, kOps>(op, f);
  } else {
    dispatch_switch(op, f);
  }
}

// Evaluates `len` decoded instructions on this thread's RPT rows (`row`,
// already clamped into X) and returns the root's values (`init` for an empty
// program). The stack top stays in registers (o); `col` is this thread's
// column of the value buffer: the stack, or with TAPE B2's tape.
template <int RPT, Dispatch DISPATCH, bool TAPE = false>
SR_HD Vals<RPT> eval_rows(const Instr* ins, int len, float* col, const float* X,
                          long long ldx, const int* row, float init) {
  Vals<RPT> o;
  for (int k = 0; k < RPT; ++k) o.v[k] = init;
  for (int i = 0; i < len; ++i) {
    const Instr in = ins[i];
    if (in.op == kConst) {
      const float c = float_of(in.w);
      for (int k = 0; k < RPT; ++k) o.v[k] = c;
    } else if (in.op == kVar) {
      const float* xp = X + (long long)in.w * ldx;
      for (int k = 0; k < RPT; ++k) o.v[k] = xp[row[k]];
    } else if (in.op < kOps) {
      dispatch<DISPATCH>(in.op, Forward<RPT>{o, col + (TAPE ? in.l : in.a)});
    } else {
      for (int k = 0; k < RPT; ++k) o.v[k] = nan_();
    }
    store_vals<RPT>(col + in.a, o);
  }
  return o;
}

// The reverse sweep over a tape that eval_rows filled from `len` tape-mode
// instructions (slots `stride` apart in this thread's column `col`): g holds
// the root's adjoints. At each constant slot i it calls sink(i, s) with s the
// f64 sum, in row order, of that slot's adjoints on the rows whose `valid` is
// set (its share of the gradient of the loss sum).
template <int RPT, Dispatch DISPATCH, class Sink>
SR_HD void reverse_rows(const Instr* ins, int len, float* col, int stride, Vals<RPT> g,
                        const bool* valid, Sink& sink) {
  for (int i = len - 1; i >= 0; --i) {
    const Instr in = ins[i];
    const float* prev = col + in.a - stride;  // the slot before: read only when i > 0
    if (in.op < kOps) {
      dispatch<DISPATCH>(in.op, Reverse<RPT>{g, col + in.l, prev});
    } else {  // a leaf
      if (in.op == kConst) {
        double s = 0.0;
        for (int k = 0; k < RPT; ++k)
          if (valid[k]) s += (double)g.v[k];
        sink(i, s);
      }
      if (i > 0) g = load_vals<RPT>(prev);  // a left child: its parent wrote its adjoints
    }
  }
}

// Per-thread partial sums of one program's loss: sum w*loss and sum w in
// f64, and the count of non-finite predictions.
struct Acc {
  double l, w, n;
};

#define SR_LOSS(id)                                                          \
  case id:                                                                   \
    for (int k = 0; k < RPT; ++k) {                                          \
      if (!valid[k]) continue;                                               \
      const float p = pred.v[k];                                             \
      const float wt = w ? w[row[k]] : 1.0f;                                 \
      const float t = y[row[k]];                                             \
      if (!isfinite_(p)) acc.n += 1.0;                                       \
      acc.l += (double)(loss(id, p, t, q) * wt);                             \
      acc.w += (double)wt;                                                   \
      if constexpr (GRAD) g.v[k] = loss_grad(id, p, t, q, wt);               \
    }                                                                        \
    break;

// Adds RPT rows' terms to `acc` (rows whose `valid` is false add nothing):
// loss_elem(pred, y) * w in f32, summed in f64, as the one-row loop did.
// With GRAD it returns the root's adjoints, w * dloss/dpred (0 on rows that
// are not valid).
template <int RPT, bool GRAD = false>
SR_HD Vals<RPT> accumulate(int loss_id, const Vals<RPT>& pred, const float* y, const float* w,
                           const int* row, const bool* valid, float q0, float q1, float q2,
                           float q3, Acc& acc) {
  const float q[4] = {q0, q1, q2, q3};
  Vals<RPT> g;
  for (int k = 0; k < RPT; ++k) g.v[k] = 0.0f;
  switch (loss_id) {
    SR_LOSS(0) SR_LOSS(1) SR_LOSS(2) SR_LOSS(3) SR_LOSS(4) SR_LOSS(5) SR_LOSS(6) SR_LOSS(7)
    SR_LOSS(8) SR_LOSS(9) SR_LOSS(10) SR_LOSS(11) SR_LOSS(12) SR_LOSS(13) SR_LOSS(14)
    SR_LOSS(15) SR_LOSS(16) SR_LOSS(17) SR_LOSS(18) SR_LOSS(19) SR_LOSS(20) SR_LOSS(21)
    default:
      for (int k = 0; k < RPT; ++k) {
        if (!valid[k]) continue;
        const float wt = w ? w[row[k]] : 1.0f;
        if (!isfinite_(pred.v[k])) acc.n += 1.0;
        acc.l += (double)(nan_() * wt);
        acc.w += (double)wt;
        if constexpr (GRAD) g.v[k] = nan_();
      }
  }
  return g;
}

#undef SR_LOSS

// One thread's rows of one tile: r, r + step, ..., r + (RPT-1) step, each
// valid below r_end and clamped into the R rows of X.
template <int RPT>
SR_HD void tile_rows(int r, int step, int r_end, int R, int* row, bool* valid) {
  for (int k = 0; k < RPT; ++k) {
    const int rk = r + k * step;
    valid[k] = rk < r_end;
    row[k] = rk < R ? rk : R - 1;
  }
}

// One thread's share of one tile: rows r, r + step, ..., r + (RPT-1) step
// below r_end (R rows in X), evaluated and added to `acc`. Rows past r_end
// are evaluated on a clamped row and not counted.
template <int RPT, Dispatch DISPATCH>
SR_HD void tile_loss(const Instr* ins, int len, float* col, const float* X, long long ldx,
                     const float* y, const float* w, int r, int step, int r_end, int R,
                     int loss_id, float q0, float q1, float q2, float q3, float init, Acc& acc) {
  int row[RPT];
  bool valid[RPT];
  tile_rows<RPT>(r, step, r_end, R, row, valid);
  const Vals<RPT> pred = eval_rows<RPT, DISPATCH>(ins, len, col, X, ldx, row, init);
  accumulate<RPT>(loss_id, pred, y, w, row, valid, q0, q1, q2, q3, acc);
}

// B2's share of one tile: tile_loss on a tape (tape-mode instructions, slots
// `stride` apart; an empty program predicts NaN), then the reverse sweep from
// the loss's derivative, handing each constant slot's adjoint sum to sink.
template <int RPT, Dispatch DISPATCH, class Sink>
SR_HD void tile_loss_grad(const Instr* ins, int len, float* col, int stride, const float* X,
                          long long ldx, const float* y, const float* w, int r, int step,
                          int r_end, int R, int loss_id, float q0, float q1, float q2, float q3,
                          Acc& acc, Sink& sink) {
  int row[RPT];
  bool valid[RPT];
  tile_rows<RPT>(r, step, r_end, R, row, valid);
  const Vals<RPT> pred = eval_rows<RPT, DISPATCH, true>(ins, len, col, X, ldx, row, nan_());
  const Vals<RPT> g =
      accumulate<RPT, true>(loss_id, pred, y, w, row, valid, q0, q1, q2, q3, acc);
  reverse_rows<RPT, DISPATCH>(ins, len, col, stride, g, valid, sink);
}

// B2's seeded share of one tile (its preds_vjp mode): the forward on the
// tape, then the reverse sweep from root adjoints read from `seed` (the
// tree's row of a cotangent on its predictions; 0 on rows that are not
// valid), handing each constant slot's adjoint sum to sink. No loss: each
// non-finite prediction adds 1 to acc.n, and the caller gives a tree with any
// a zero gradient, as B2 does for a loss that is not ok.
template <int RPT, Dispatch DISPATCH, class Sink>
SR_HD void tile_seed_grad(const Instr* ins, int len, float* col, int stride, const float* X,
                          long long ldx, const float* seed, int r, int step, int r_end, int R,
                          Acc& acc, Sink& sink) {
  int row[RPT];
  bool valid[RPT];
  tile_rows<RPT>(r, step, r_end, R, row, valid);
  const Vals<RPT> pred = eval_rows<RPT, DISPATCH, true>(ins, len, col, X, ldx, row, nan_());
  Vals<RPT> g;
  for (int k = 0; k < RPT; ++k) {
    g.v[k] = 0.0f;
    if (!valid[k]) continue;
    if (!isfinite_(pred.v[k])) acc.n += 1.0;
    g.v[k] = seed[row[k]];
  }
  reverse_rows<RPT, DISPATCH>(ins, len, col, stride, g, valid, sink);
}

// One lane's dataset in a lane-major batch (a fleet of searches): X
// [L, F, ldx] with lane stride lsx floats, y and w [L, R] with lane stride
// lsy (w may be null). A solo launch is lane 0 of one.
struct LaneData {
  const float* X;
  const float* y;
  const float* w;
};

SR_HD LaneData lane_data(const float* X, const float* y, const float* w, int lane,
                         long long lsx, long long lsy) {
  return {X + lane * lsx, y + lane * lsy, w ? w + lane * lsy : w};
}

// The ok rule of the loss kernels: loss_sum / w_sum, or +inf when a real row's
// prediction is non-finite or w_sum is not positive.
SR_HD float finish(double L, double W, double C) {
  return (C == 0.0 && W > 0.0) ? (float)(L / W) : INFINITY;
}

// B3's scoring split over a block's warps. Units are (candidate e, tile t),
// T tiles of 32 x RPT rows per candidate, numbered u = e T + t; a unit of a
// program of `len` slots costs unit_cost(len): its slots plus kLossCost for
// the loss, its sums and the loads of y and w. Warp w of W takes the units
// whose cost prefix p satisfies w C <= p W < (w + 1) C (C the total): a
// contiguous run of units [first_unit(w), first_unit(w + 1)) of nearly
// equal cost whatever the programs' lengths, so no warp idles while another
// has two units more. Because the runs are contiguous, the pairs (e, w) with
// units in common give distinct e + w < E + W - 1.
constexpr int kLossCost = 4;

SR_HD long long unit_cost(int len) { return (long long)(len > 1 ? len : 1) + kLossCost; }

// The first unit of warp w (E T when it has none); len holds the E programs'
// lengths and C the total cost, T x the sum of their unit costs.
SR_HD int first_unit(const int* len, int E, int T, long long C, int w, int W) {
  long long S = 0;  // cost prefix of candidate e's first unit
  for (int e = 0; e < E; ++e) {
    const long long c = unit_cost(len[e]);
    const long long need = (long long)w * C - S * W;  // > 0: still short of the boundary
    if ((S + (T - 1) * c) * W >= (long long)w * C) {
      const long long t = need <= 0 ? 0 : (need + c * W - 1) / (c * W);
      return e * T + (int)t;
    }
    S += c * T;
  }
  return E * T;
}

// Whether warp v's run [bound[v], bound[v + 1]) holds units of candidate e
// (T units each): the warps whose partial sums make e's loss.
SR_HD bool run_has(const int* bound, int v, int e, int T) {
  return bound[v] < bound[v + 1] && bound[v] < (e + 1) * T && bound[v + 1] > e * T;
}

}  // namespace sr
