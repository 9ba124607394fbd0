// The kernel-resident evolution block for Hopper (sm_90a): one launch runs a
// whole engine iteration's `ncycles` of tournament -> mutation of packed
// words -> size/depth check -> scoring -> annealing-gated replacement, for
// every island.
//
// Replaces the TPU kernel symbolicregression_jl_tpu/ops/interp_pallas.py:1114
// (_make_evolve_block_kernel, launched through make_evolve_block_fn at :1286),
// whose cycle is symbolicregression_jl_tpu/ops/evolve_block.py:598
// (_block_cycle). It computes what that cycle computes, not the Pallas body
// block by block: the one-hot masked sums Mosaic needs for dynamic indexing
// become plain indexed reads and writes here, with the same out-of-range rule
// (an index outside the row reads 0). Every draw is the same murmur3 counter
// hash of (seed, cycle, lane, draw id), in uint32, so the integer trajectory
// is the plain version's (ops/evolve_block.py) for one seed.
//
// Inputs (I islands, P members, N slots, S1 = maxsize + 1 sizes):
//   words int32 [I, P, N]  kind | payload << 3 (kind: 1 const, 2 var, 3 unary,
//                           4 binary, 0 pad), consts f32 [I, P, N]
//   length, birth int32 [I, P]; loss, score f32 [I, P]; fnorm f32 [S1]
//   iscal int64 [3]: seed (uint32), step0, curmaxsize; fscal f32 [1]: the
//                           score normalization
//   X f32 [F, ldx] feature-major rows, y f32 [R], w f32 [R] or null
// Outputs: the population after the block (same shapes), the per-island size
// histogram delta fd f32 [I, S1] and best-seen carry: loss f32 [I, S1],
// words int32 / consts f32 [I, S1, N], length int32 [I, S1].
// Lane axis (a fleet of L searches, models/device_search.fleet_search): the
// populations are L lanes of I islands, lane-major ([L * I, P, N] and so on,
// outputs too), each lane with its own fnorm [L, S1], iscal [L, 3], fscal
// [L] and data (X [L, F, ldx] with lane stride lsx, y and w [L, R] with lane
// stride lsy). Block b runs island b % I of lane b / I, and its draws hash
// (the lane's seed, cycle, island-in-lane * E + event, draw id), so a lane
// draws what its solo launch (L = 1) draws.
//
// What bounds it on this card: the scoring of each cycle's E candidates on
// every row (operations), and the dependency chain of cycles inside one block:
// a cycle's tournament reads the population the previous cycle replaced, so
// the cycles of an island run in sequence. The design:
//   * one block per island (grid L x I; islands are independent, as the TPU
//     grid's "arbitrary" island axis), looping over all cycles inside the
//     kernel, so an iteration is one launch and nothing leaves the card; at
//     one block per SM, a fleet's L x I blocks above the card's 132 SMs run
//     in waves;
//   * the island's population and best-seen carry live in shared memory when
//     they fit (config3: ~25 KB), else in the output arrays in device memory
//     (the same code through generic pointers);
//   * tournament, mutation, the pointer passes and the check are small
//     per-lane work: one thread per event lane (lanes loop over the threads
//     when there are more); replacement runs one thread per member,
//     best-seen and histogram one thread per size;
//   * scoring runs on the multi-row interpreter core shared with B1
//     (sr_interp.cuh): the units (candidate, tile of 32 x RPT rows) are split
//     over all the block's warps in contiguous runs of equal cost weighted by
//     program length (sr::first_unit), so no warp idles while another has
//     two units more; a warp decodes each candidate it meets once into 16-byte
//     instructions (stack heights by a warp scan; __syncwarp only), and
//     each lane evaluates RPT rows per tile as interleaved chains, one
//     warp-uniform dispatch per slot for all of them; the stack top stays in
//     registers and the value buffer holds N / 2 + 2 stack positions,
//     [position][thread][RPT] f32 in shared memory; operators and losses are
//     B1's (sr_ops.cuh);
//   * the block is built for a few (RPT, threads) shapes (SR_BLOCK_SHAPES);
//     the wrapper takes the first whose buffer fits beside the island, and
//     __launch_bounds__(threads, 1) lets 512 or 256 threads keep up to 128 or
//     255 registers, where the one-row design's 1024 threads spilled at 64;
//   * per-(candidate, warp) sums are f64, reduced by a fixed shuffle tree and
//     then over the warps in index order: no atomics, so one seed gives
//     bit-identical outputs on every launch.
// No fast math: built with --fmad=false, IEEE division, libm's expf/logf/cosf/
// powf/sqrtf (never the __ intrinsics), so temperature 0 on the last cycle
// gives -d/0 = -inf, +inf or NaN by IEEE rules, as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sr_interp.cuh"

namespace {

constexpr int kMaxTour = 64;
constexpr int kMaxOps = 64;

enum { K_PAD = 0, K_CONST = 1, K_VAR = 2, K_UNARY = 3, K_BINARY = 4 };
enum { M_CONST = 0, M_OPERATOR, M_SWAP, M_ADD, M_INSERT, M_DELETE, M_RANDOMIZE, M_NOTHING };
enum {
  D_RANK = 32, D_KIND, D_SITE, D_CHILD, D_ACCEPT, D_C_FACTOR, D_C_INV, D_C_NEG, D_OP_UN,
  D_OP_BIN, D_L1_CONST, D_L1_FEAT, D_L1_N1, D_L1_N2, D_L2_CONST, D_L2_FEAT, D_L2_N1, D_L2_N2,
  D_M_OPB, D_M_OPU
};

}  // namespace

// Static configuration, passed by value (mirrors the ctypes Structure in
// ops/evolve_block_cuda.py field for field).
struct SrBlockCfg {
  long long ldx, lsx, lsy;
  int I, P, N, E, S1, maxsize, maxdepth, ncycles, tour_n;
  int nfeatures, n_unary, n_binary, annealing, use_frequency, use_freq_tour;
  int F, R, loss_id, n_ops, use_smem, rpt, L;
  float pf, pnc, alpha, aps, parsimony, bin_thr, ncyc_den;
  float q[4];
  float mut_w[8];
  float tour_thr[kMaxTour];
  int optab[kMaxOps];
};

namespace {

__device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float draw(uint32_t seed, uint32_t cycle, uint32_t lane, uint32_t d) {
  uint32_t x = seed ^ (0x9E3779B9u * (cycle + 1u));
  x = fmix(x);
  x ^= 0x85EBCA6Bu * (lane + 1u);
  x = fmix(x);
  x ^= 0xC2B2AE35u * (d + 1u);
  return (float)(fmix(x) >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ int randint(float u, int n) {
  const int v = (int)(u * (float)n);
  return v < n - 1 ? v : n - 1;
}

__device__ __forceinline__ float box_muller(float u1, float u2) {
  const float r = sqrtf(-2.0f * logf(fmaxf(u1, 1e-12f)));
  return r * cosf(6.283185307179586f * u2);
}

__device__ __forceinline__ int take(const int* a, int idx, int V) {
  return (idx >= 0 && idx < V) ? a[idx] : 0;
}

__device__ __forceinline__ int word_of(int kind, int payload) { return kind | (payload << 3); }

// One postfix stack pass over the live slots of a packed row: child slots,
// subtree start and subtree depth per slot (0 at dead slots). Reads off the
// stack outside [0, D) give 0, as in the one-hot version.
__device__ void block_pointers(const int* w, int len, int N, int* lhs, int* rhs, int* start,
                               int* depth, int* st) {
  const int D = N / 2 + 2;
  int* st_slot = st;
  int* st_start = st + D;
  int* st_depth = st + 2 * D;
  for (int k = 0; k < D; ++k) st_slot[k] = st_start[k] = st_depth[k] = 0;
  int sp = 0;
  for (int i = 0; i < N; ++i) {
    if (i >= len) {
      lhs[i] = rhs[i] = start[i] = depth[i] = 0;
      continue;
    }
    const int k = w[i] & 7;
    const bool leaf = k == K_CONST || k == K_VAR;
    const bool un = k == K_UNARY;
    const bool bin = k == K_BINARY;
    const int t1 = max(sp - 1, 0), t2 = max(sp - 2, 0);
    const int s1 = take(st_slot, t1, D), s2 = take(st_slot, t2, D);
    const int a1 = take(st_start, t1, D), a2 = take(st_start, t2, D);
    const int d1 = take(st_depth, t1, D), d2 = take(st_depth, t2, D);
    lhs[i] = un ? s1 : (bin ? s2 : 0);
    rhs[i] = bin ? s1 : 0;
    const int si = leaf ? i : (un ? a1 : a2);
    const int di = leaf ? 1 : (un ? d1 + 1 : max(d1, d2) + 1);
    start[i] = si;
    depth[i] = di;
    const int nsp = sp + (leaf ? 1 : (bin ? -1 : 0));
    const int top = nsp - 1;
    if (top >= 0 && top < D) {
      st_slot[top] = i;
      st_start[top] = si;
      st_depth[top] = di;
    }
    sp = nsp;
  }
}

// The pick-th live slot where mask holds (pick uniform in [0, max(count, 1))),
// or N when there is none.
template <typename Pred>
__device__ int pick_ranked(int N, float u, int count, Pred mask) {
  const int pick = randint(u, count > 1 ? count : 1);
  int r = 0;
  for (int j = 0; j < N; ++j) {
    if (mask(j)) {
      if (r == pick) return j;
      ++r;
    }
  }
  return N;
}

struct Leaf {
  int word;
  float c;
};

__device__ Leaf leaf_draws(const SrBlockCfg& cfg, uint32_t seed, uint32_t cycle, uint32_t lane,
                           int d0) {
  const float u_c = draw(seed, cycle, lane, d0);
  const float u_f = draw(seed, cycle, lane, d0 + 1);
  const float u_n1 = draw(seed, cycle, lane, d0 + 2);
  const float u_n2 = draw(seed, cycle, lane, d0 + 3);
  const bool is_const = cfg.nfeatures <= 0 || u_c < 0.5f;
  const int feat = randint(u_f, cfg.nfeatures > 1 ? cfg.nfeatures : 1);
  const float n = box_muller(u_n1, u_n2);
  return {is_const ? K_CONST : word_of(K_VAR, feat), is_const ? n : 0.0f};
}

__device__ bool use_bin_draw(const SrBlockCfg& cfg, float u) {
  bool ub = u < cfg.bin_thr;
  if (cfg.n_unary == 0) ub = true;
  if (cfg.n_binary == 0) ub = false;
  return ub;
}

// Per-lane scratch in shared memory.
struct Lane {
  int* pw;     // parent words [N]
  float* pc;   // parent consts [N]
  int* cw;     // candidate words [N]
  float* cc;   // candidate consts [N]
  int* kind;   // live-masked parent kinds [N]
  int* lhs;    // pointer-pass scratch [N] x 4
  int* rhs;
  int* start;
  int* depth;
  int* stack;  // [3 * D]
  int* cand;   // tournament candidates [tour_n]
  float* sv;   // their adjusted scores [tour_n]
};

// Stages 1-2 of one lane: tournament, conditioned kind draw, the chosen
// mutation, tail canonicalization, pointer pass and size/depth check. Leaves
// the checked candidate (vw, vc) in cw/cc and returns its length; *ok_out is
// the check, parent fields go to the out pointers.
__device__ int lane_mutate(const SrBlockCfg& cfg, const Lane& ln, const int* words,
                           const float* consts, const int* length, const float* score,
                           const float* fnorm, const float* mut_w, const float* tour_thr,
                           uint32_t seed, int cycle, uint32_t lane, int curmaxsize, float temp,
                           int* parent_out, bool* ok_out) {
  const int N = cfg.N, P = cfg.P, n = cfg.tour_n;
  const uint32_t cy = (uint32_t)cycle;
  // ---- tournament: candidates with replacement, inverse-CDF rank ----
  for (int k = 0; k < n; ++k) {
    const int c = randint(draw(seed, cy, lane, k), P);
    float s = score[c];
    if (cfg.use_freq_tour) {
      const int sz = min(max(length[c], 0), cfg.maxsize);
      s = s * expf(cfg.aps * fnorm[sz]);
    }
    ln.cand[k] = c;
    ln.sv[k] = s;
  }
  const float ur = draw(seed, cy, lane, D_RANK);
  int rank = 0;
  for (int k = 0; k < n; ++k) rank += (ur >= tour_thr[k]) ? 1 : 0;
  rank = min(max(rank, 0), n - 1);
  int pos = n;
  for (int i = 0; i < n && pos == n; ++i) {
    int cr = 0;
    const float si = ln.sv[i];
    for (int j = 0; j < n; ++j) {
      const float sj = ln.sv[j];
      cr += (si > sj) ? 1 : 0;
      cr += (si == sj && j < i) ? 1 : 0;
    }
    if (cr == rank) pos = i;
  }
  const int winner = ln.cand[min(pos, n - 1)];
  *parent_out = winner;

  // ---- parent, pointers, conditioned mutation weights ----
  const int plen = length[winner];
  int n_const = 0, n_ops = 0, n_bin = 0, n_leaf = 0;
  for (int j = 0; j < N; ++j) {
    const int w = words[winner * N + j];
    ln.pw[j] = w;
    ln.pc[j] = consts[winner * N + j];
    const int k = j < plen ? (w & 7) : K_PAD;
    ln.kind[j] = k;
    n_const += k == K_CONST;
    n_ops += k >= K_UNARY;
    n_bin += k == K_BINARY;
    n_leaf += (k == K_CONST || k == K_VAR);
  }
  block_pointers(ln.pw, plen, N, ln.lhs, ln.rhs, ln.start, ln.depth, ln.stack);

  float wv[8];
  for (int m = 0; m < 8; ++m) wv[m] = mut_w[m];
  if (n_ops == 0) wv[M_OPERATOR] = 0.0f;
  if (n_bin == 0) wv[M_SWAP] = 0.0f;
  if (n_ops == 0) wv[M_DELETE] = 0.0f;
  wv[M_CONST] = n_const == 0 ? 0.0f : wv[M_CONST] * fminf(8.0f, (float)n_const) / 8.0f;
  if (plen >= curmaxsize) wv[M_ADD] = wv[M_INSERT] = 0.0f;
  float tot = 0.0f;
  for (int m = 0; m < 8; ++m) tot += wv[m];
  if (tot <= 0.0f) wv[M_NOTHING] += 1.0f;
  float cum[8];
  float acc = 0.0f;
  for (int m = 0; m < 8; ++m) {
    acc += wv[m];
    cum[m] = acc;
  }
  const float ut = draw(seed, cy, lane, D_KIND) * cum[7];
  int kidx = 0;
  for (int m = 0; m < 8; ++m) kidx += (ut >= cum[m]) ? 1 : 0;
  kidx = min(kidx, 7);

  const float u_site = draw(seed, cy, lane, D_SITE);
  const float u_child = draw(seed, cy, lane, D_CHILD);
  const int* pw = ln.pw;
  const float* pc = ln.pc;
  const int* kind = ln.kind;
  int* cw = ln.cw;
  float* cc = ln.cc;
  int clen = plen;
  for (int j = 0; j < N; ++j) {
    cw[j] = pw[j];
    cc[j] = pc[j];
  }

  if (kidx == M_CONST) {
    const int p = pick_ranked(N, u_site, n_const, [&](int j) { return kind[j] == K_CONST; });
    if (n_const > 0) {
      const float max_change = cfg.pf * temp + 1.0f + 0.1f;
      float factor = powf(max_change, draw(seed, cy, lane, D_C_FACTOR));
      factor = draw(seed, cy, lane, D_C_INV) < 0.5f ? factor : 1.0f / factor;
      const bool neg = draw(seed, cy, lane, D_C_NEG) < cfg.pnc;
      cc[p] = pc[p] * (factor * (neg ? -1.0f : 1.0f));
    }
  } else if (kidx == M_OPERATOR) {
    const int p = pick_ranked(N, u_site, n_ops, [&](int j) { return kind[j] >= K_UNARY; });
    const int new_un = randint(draw(seed, cy, lane, D_OP_UN), max(cfg.n_unary, 1));
    const int new_bin = randint(draw(seed, cy, lane, D_OP_BIN), max(cfg.n_binary, 1));
    if (n_ops > 0) cw[p] = word_of(kind[p], kind[p] == K_UNARY ? new_un : new_bin);
  } else if (kidx == M_SWAP) {
    const int p = pick_ranked(N, u_site, n_bin, [&](int j) { return kind[j] == K_BINARY; });
    if (n_bin > 0) {
      const int l_root = take(ln.lhs, p, N), r_root = take(ln.rhs, p, N);
      const int sizes_l = l_root - take(ln.start, l_root, N) + 1;
      const int sizes_r = r_root - take(ln.start, r_root, N) + 1;
      const int al = l_root - sizes_l + 1;
      for (int j = 0; j < N; ++j) {
        if (j >= al && j < p) {
          const int src = min(max(j < al + sizes_r ? j + sizes_l : j - sizes_r, 0), N - 1);
          cw[j] = pw[src];
          cc[j] = pc[src];
        }
      }
    }
  } else if (kidx == M_ADD) {
    const int p = pick_ranked(N, u_site, n_leaf,
                              [&](int j) { return kind[j] == K_CONST || kind[j] == K_VAR; });
    const bool ub = use_bin_draw(cfg, u_child);
    const Leaf l1 = leaf_draws(cfg, seed, cy, lane, D_L1_CONST);
    const Leaf l2 = leaf_draws(cfg, seed, cy, lane, D_L2_CONST);
    const int opb = randint(draw(seed, cy, lane, D_M_OPB), max(cfg.n_binary, 1));
    const int opu = randint(draw(seed, cy, lane, D_M_OPU), max(cfg.n_unary, 1));
    const int m_len = ub ? 3 : 2;
    const int new_len = plen + m_len - 1;
    if (n_leaf > 0 && new_len <= N) {
      for (int j = 0; j < N; ++j) {
        int nw = pw[j];
        float nc = pc[j];
        if (j >= p + m_len) {
          const int src = min(max(j - (m_len - 1), 0), N - 1);
          nw = pw[src];
          nc = pc[src];
        }
        if (j == p) {
          nw = l1.word;
          nc = l1.c;
        }
        if (j == p + 1) {
          nw = ub ? l2.word : word_of(K_UNARY, opu);
          nc = ub ? l2.c : 0.0f;
        }
        if (j == p + 2 && ub) {
          nw = word_of(K_BINARY, opb);
          nc = 0.0f;
        }
        cw[j] = nw;
        cc[j] = nc;
      }
      clen = new_len;
    }
  } else if (kidx == M_INSERT) {
    const int p = randint(u_site, max(plen, 1));
    const bool ub = use_bin_draw(cfg, u_child);
    const Leaf lf = leaf_draws(cfg, seed, cy, lane, D_L1_CONST);
    const int opb = randint(draw(seed, cy, lane, D_M_OPB), max(cfg.n_binary, 1));
    const int opu = randint(draw(seed, cy, lane, D_M_OPU), max(cfg.n_unary, 1));
    const int shift = ub ? 2 : 1;
    const int new_len = plen + shift;
    if (new_len <= N) {
      for (int j = 0; j < N; ++j) {
        int nw = pw[j];
        float nc = pc[j];
        if (j > p + shift) {
          const int src = min(max(j - shift, 0), N - 1);
          nw = pw[src];
          nc = pc[src];
        }
        if (j == p + 1 && ub) {
          nw = lf.word;
          nc = lf.c;
        }
        if (j == p + shift) {
          nw = ub ? word_of(K_BINARY, opb) : word_of(K_UNARY, opu);
          nc = 0.0f;
        }
        cw[j] = nw;
        cc[j] = nc;
      }
      clen = new_len;
    }
  } else if (kidx == M_DELETE) {
    const int p = pick_ranked(N, u_site, n_ops, [&](int j) { return kind[j] >= K_UNARY; });
    if (n_ops > 0) {
      const bool keep_right = take(kind, p, N) == K_BINARY && u_child < 0.5f;
      const int child = keep_right ? take(ln.rhs, p, N) : take(ln.lhs, p, N);
      const int ca = take(ln.start, child, N);
      const int chl = child - ca + 1;
      const int sub_a = take(ln.start, p, N);
      const int removed = (p - sub_a + 1) - chl;
      for (int j = 0; j < N; ++j) {
        if (j >= sub_a) {
          const bool in_child = j < sub_a + chl;
          const int src = min(max(in_child ? j - sub_a + ca : j + removed, 0), N - 1);
          cw[j] = pw[src];
          cc[j] = pc[src];
        }
      }
      clen = plen - removed;
    }
  }
  // pad canonicalization: slots >= length are exactly zero
  for (int j = 0; j < N; ++j) {
    if (j >= clen) {
      cw[j] = 0;
      cc[j] = 0.0f;
    }
  }

  // ---- stage 2: candidate pointer pass + size/depth check ----
  block_pointers(cw, clen, N, ln.lhs, ln.rhs, ln.start, ln.depth, ln.stack);
  const int root_depth = take(ln.depth, max(clen - 1, 0), N);
  const bool ok = clen <= curmaxsize && clen <= N && root_depth <= cfg.maxdepth;
  *ok_out = ok;
  if (!ok) {
    for (int j = 0; j < N; ++j) {
      cw[j] = pw[j];
      cc[j] = pc[j];
    }
    clen = plen;
  }
  return clen;
}

// sr::decode_words by one warp: lane j takes slots j, j + 32, ...; the stack
// heights come from a warp inclusive scan of the slots' pushes and soundness
// from a warp vote. Same instructions, same unsound rule.
__device__ int decode_words_warp(const int* words, const float* consts, int len, int N, int F,
                                 int n_unary, int n_binary, const int* optab, int stride,
                                 sr::Instr* ins, int lane) {
  const int D = sr::stack_slots(N);
  int carry = 0;  // stack height before this run of 32 slots
  bool ok = true;
  for (int base = 0; base < len; base += 32) {
    const int i = base + lane;
    const bool live = i < len;
    const sr::WordSlot ws = live ? sr::word_slot(words[i], n_unary, n_binary)
                                 : sr::WordSlot{0, 0, 0, 0, true};
    int incl = ws.push;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    const int h = carry + incl - ws.push;  // height before slot i
    const bool valid = ws.valid && h >= ws.arity && h + ws.push <= D;
    if (live && valid) ins[i] = sr::word_instr(ws, consts[i], h, F, n_unary, optab, stride);
    ok = __all_sync(0xffffffffu, ok && valid);
    carry = __shfl_sync(0xffffffffu, carry + incl, 31);
  }
  if (ok && (len == 0 || carry == 1)) return len;
  __syncwarp();
  if (lane == 0) sr::decode_unsound(ins);
  return 1;
}

template <int RPT, int NT>
__global__ void __launch_bounds__(NT, 1) sr_evolve_block_kernel(
    SrBlockCfg cfg, const int* __restrict__ words_in, const float* __restrict__ consts_in,
    const int* __restrict__ len_in, const float* __restrict__ loss_in,
    const float* __restrict__ score_in, const int* __restrict__ birth_in,
    const float* __restrict__ fnorm_in, const long long* __restrict__ iscal,
    const float* __restrict__ fscal, const float* __restrict__ X, const float* __restrict__ Y,
    const float* __restrict__ W, int* words_out, float* consts_out, int* len_out,
    float* loss_out, float* score_out, int* birth_out, float* fd_out, float* bsl_out,
    int* bsw_out, float* bsc_out, int* bslen_out) {
  extern __shared__ double smem_d[];
  const int b = blockIdx.x;  // island isl of the fleet's lane fl
  const int fl = b / cfg.I, isl = b % cfg.I;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane_id = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int P = cfg.P, N = cfg.N, E = cfg.E, S1 = cfg.S1, n = cfg.tour_n;
  const int D = N / 2 + 2;
  const int stride = nt * RPT;

  // ---- shared-memory carve-up (block_smem in ops/evolve_block_cuda.py counts it) ----
  sr::Instr* sins = reinterpret_cast<sr::Instr*>(smem_d);     // [nwarps * N]
  float* buf = reinterpret_cast<float*>(sins + nwarps * N);   // [D][nt][RPT]
  double* part = reinterpret_cast<double*>(buf + D * stride);  // [(E + nwarps) * 3]
  int* wbound = reinterpret_cast<int*>(part + 3 * (E + nwarps));  // [nwarps + 1]
  float* fbase = reinterpret_cast<float*>(wbound + nwarps + 1);
  float* fnorm = fbase;                                       // [S1]
  float* mut_w = fnorm + S1;                                  // [8]
  float* tour_thr = mut_w + 8;                                // [n]
  float* l_ploss = tour_thr + n;                              // [E]
  float* l_pscore = l_ploss + E;                              // [E]
  float* l_loss = l_pscore + E;                               // [E]
  float* l_score = l_loss + E;                                // [E]
  float* l_pc = l_score + E;                                  // [E * N]
  float* l_cc = l_pc + E * N;                                 // [E * N]
  float* l_sv = l_cc + E * N;                                 // [E * n]
  int* ibase = reinterpret_cast<int*>(l_sv + E * n);
  int* optab = ibase;                                         // [n_ops]
  int* l_plen = optab + cfg.n_ops;                            // [E]
  int* l_vlen = l_plen + E;                                   // [E]
  int* l_flags = l_vlen + E;                                  // [E] bit0 ok, bit1 accept
  int* l_pw = l_flags + E;                                    // [E * N]
  int* l_cw = l_pw + E * N;                                   // [E * N]
  int* l_scr = l_cw + E * N;                                  // [E * 5N]
  int* l_stack = l_scr + E * 5 * N;                           // [E * 3D]
  int* l_cand = l_stack + E * 3 * D;                          // [E * n]
  int* ev = l_cand + E * n;                                   // [P]
  float* pop_base = reinterpret_cast<float*>(ev + P);         // population, when in smem

  // ---- the island's storage: shared memory, or the output arrays ----
  const long long oPN = (long long)b * P * N, oP = (long long)b * P;
  const long long oS = (long long)b * S1, oSN = (long long)b * S1 * N;
  int* words;
  float* consts;
  int* length;
  float* loss;
  float* score;
  int* birth;
  float* fd;
  float* bs_loss;
  int* bs_w;
  float* bs_c;
  int* bs_len;
  if (cfg.use_smem) {
    consts = pop_base;
    loss = consts + P * N;
    score = loss + P;
    fd = score + P;
    bs_loss = fd + S1;
    bs_c = bs_loss + S1;
    words = reinterpret_cast<int*>(bs_c + S1 * N);
    length = words + P * N;
    birth = length + P;
    bs_w = birth + P;
    bs_len = bs_w + S1 * N;
  } else {
    words = words_out + oPN;
    consts = consts_out + oPN;
    length = len_out + oP;
    loss = loss_out + oP;
    score = score_out + oP;
    birth = birth_out + oP;
    fd = fd_out + oS;
    bs_loss = bsl_out + oS;
    bs_w = bsw_out + oSN;
    bs_c = bsc_out + oSN;
    bs_len = bslen_out + oS;
  }
  for (int k = tid; k < P * N; k += nt) {
    words[k] = words_in[oPN + k];
    consts[k] = consts_in[oPN + k];
  }
  for (int k = tid; k < P; k += nt) {
    length[k] = len_in[oP + k];
    loss[k] = loss_in[oP + k];
    score[k] = score_in[oP + k];
    birth[k] = birth_in[oP + k];
  }
  for (int k = tid; k < S1; k += nt) {
    fd[k] = 0.0f;
    bs_loss[k] = INFINITY;
    bs_len[k] = 0;
    fnorm[k] = fnorm_in[(long long)fl * S1 + k];
  }
  for (int k = tid; k < S1 * N; k += nt) {
    bs_w[k] = 0;
    bs_c[k] = 0.0f;
  }
  for (int k = tid; k < cfg.n_ops; k += nt) optab[k] = cfg.optab[k];
  for (int k = tid; k < n; k += nt) tour_thr[k] = cfg.tour_thr[k];
  if (tid < 8) mut_w[tid] = cfg.mut_w[tid];

  const uint32_t seed = (uint32_t)(iscal[3 * fl] & 0xFFFFFFFFll);
  const int step0 = (int)iscal[3 * fl + 1];
  const int curmaxsize = (int)iscal[3 * fl + 2];
  const float norm = fscal[fl];
  const sr::LaneData d = sr::lane_data(X, Y, W, fl, cfg.lsx, cfg.lsy);
  const int T = (cfg.R + 32 * RPT - 1) / (32 * RPT);  // row tiles per candidate
  float* col = buf + tid * RPT;
  sr::Instr* wins = sins + warp * N;
  __syncthreads();

  for (int cycle = 0; cycle < cfg.ncycles; ++cycle) {
    const float temp = cfg.annealing ? 1.0f - (float)cycle / cfg.ncyc_den : 1.0f;

    // ---- stages 1-2: one thread per lane; the replacement ranks beside ----
    for (int e = tid; e < E; e += nt) {  // lanes loop over the threads when E > nt
      Lane ln{l_pw + e * N,
              l_pc + e * N,
              l_cw + e * N,
              l_cc + e * N,
              l_scr + e * 5 * N,
              l_scr + e * 5 * N + N,
              l_scr + e * 5 * N + 2 * N,
              l_scr + e * 5 * N + 3 * N,
              l_scr + e * 5 * N + 4 * N,
              l_stack + e * 3 * D,
              l_cand + e * n,
              l_sv + e * n};
      int parent;
      bool ok;
      const int vlen = lane_mutate(cfg, ln, words, consts, length, score, fnorm, mut_w, tour_thr,
                                   seed, cycle, (uint32_t)(isl * E + e), curmaxsize, temp, &parent,
                                   &ok);
      l_plen[e] = length[parent];
      l_ploss[e] = loss[parent];
      l_pscore[e] = score[parent];
      l_vlen[e] = vlen;
      l_flags[e] = ok ? 1 : 0;
    }
    for (int p = tid; p < P; p += nt) {
      const int bp = birth[p];
      int r = 0;
      for (int q = 0; q < P; ++q) {
        const int bq = birth[q];
        r += (bq < bp || (bq == bp && q < p)) ? 1 : 0;
      }
      ev[p] = r < E ? r : E;
    }
    __syncthreads();

    // ---- stage 3: scoring; each warp a cost-balanced run of (candidate,
    // tile) units, decoding each candidate it meets once ----
    if (tid <= nwarps) {
      long long C_all = 0;
      for (int e = 0; e < E; ++e) C_all += sr::unit_cost(l_vlen[e]);
      wbound[tid] = sr::first_unit(l_vlen, E, T, C_all * T, tid, nwarps);
    }
    __syncthreads();
    for (int u = wbound[warp], u_end = wbound[warp + 1]; u < u_end;) {
      const int e = u / T;
      const int t_end = min(u_end, (e + 1) * T) - e * T;
      __syncwarp();  // the previous candidate's instructions are no longer read
      const int dlen = decode_words_warp(l_cw + e * N, l_cc + e * N, l_vlen[e], N, cfg.F,
                                         cfg.n_unary, cfg.n_binary, optab, stride, wins,
                                         lane_id);
      __syncwarp();
      sr::Acc acc{0.0, 0.0, 0.0};
      for (int t = u - e * T; t < t_end; ++t)  // an empty program reads 0
        sr::tile_loss<RPT, sr::kTree>(
            wins, dlen, col, d.X, cfg.ldx, d.y, d.w, t * 32 * RPT + lane_id, 32, cfg.R, cfg.R,
            cfg.loss_id, cfg.q[0], cfg.q[1], cfg.q[2], cfg.q[3], 0.0f, acc);
      for (int off = 16; off > 0; off >>= 1) {
        acc.l += __shfl_down_sync(0xffffffffu, acc.l, off);
        acc.w += __shfl_down_sync(0xffffffffu, acc.w, off);
        acc.n += __shfl_down_sync(0xffffffffu, acc.n, off);
      }
      if (lane_id == 0) {  // (e, warp) pairs of contiguous runs have distinct e + warp
        double* dst = part + 3 * (e + warp);
        dst[0] = acc.l;
        dst[1] = acc.w;
        dst[2] = acc.n;
      }
      u = e * T + t_end;
    }
    __syncthreads();

    // ---- stage 4a: loss, score and the annealing-gated accept per lane ----
    for (int e = tid; e < E; e += nt) {  // lanes loop over the threads when E > nt
      double L = 0.0, Wt = 0.0, C = 0.0;
      for (int v = 0; v < nwarps; ++v) {  // the warps' sums in index order
        if (!sr::run_has(wbound, v, e, T)) continue;
        const double* src = part + 3 * (e + v);
        L += src[0];
        Wt += src[1];
        C += src[2];
      }
      const float loss1 = sr::finish(L, Wt, C);
      const int vlen = l_vlen[e];
      const float score1 = loss1 / norm + (float)vlen * cfg.parsimony;
      const int sz_old = min(max(l_plen[e], 0), cfg.maxsize);
      const int sz_new = min(max(vlen, 0), cfg.maxsize);
      float prob = 1.0f;
      if (cfg.annealing) prob = prob * expf(-(score1 - l_pscore[e]) / (cfg.alpha * temp));
      if (cfg.use_frequency) {
        const float old_f = fmaxf(fnorm[sz_old], 1e-6f);
        const float new_f = fmaxf(fnorm[sz_new], 1e-6f);
        prob = prob * (old_f / new_f);
      }
      const float u_acc = draw(seed, (uint32_t)cycle, (uint32_t)(isl * E + e), D_ACCEPT);
      const bool ok = l_flags[e] & 1;
      const bool accept = !(prob < u_acc) && sr::isfinite_(loss1) && ok;
      l_loss[e] = loss1;
      l_score[e] = score1;
      l_flags[e] = (ok ? 1 : 0) | (accept ? 2 : 0);
    }
    __syncthreads();

    // ---- stage 4b: oldest-first replacement, histogram, best-seen ----
    for (int p = tid; p < P; p += nt) {
      const int e = ev[p];
      if (e >= E) continue;
      const bool acc = l_flags[e] & 2;
      const int* sw = acc ? l_cw + e * N : l_pw + e * N;
      const float* sc = acc ? l_cc + e * N : l_pc + e * N;
      for (int j = 0; j < N; ++j) {
        words[p * N + j] = sw[j];
        consts[p * N + j] = sc[j];
      }
      length[p] = acc ? l_vlen[e] : l_plen[e];
      loss[p] = acc ? l_loss[e] : l_ploss[e];
      score[p] = acc ? l_score[e] : l_pscore[e];
      birth[p] = step0 + cycle;
    }
    for (int s = tid; s < S1; s += nt) {
      int cnt = 0;
      float best = INFINITY;
      int e_star = 0;
      for (int e = 0; e < E; ++e) {
        const int sz = min(max(l_vlen[e], 0), cfg.maxsize);
        if (sz != s) continue;
        if (l_flags[e] & 2) ++cnt;
        const float le = l_loss[e];
        if ((l_flags[e] & 1) && sr::isfinite_(le) && le < best) {
          best = le;
          e_star = e;
        }
      }
      fd[s] = fd[s] + (float)cnt;
      if (best < bs_loss[s]) {
        bs_loss[s] = best;
        for (int j = 0; j < N; ++j) {
          bs_w[s * N + j] = l_cw[e_star * N + j];
          bs_c[s * N + j] = l_cc[e_star * N + j];
        }
        bs_len[s] = l_vlen[e_star];
      }
    }
    __syncthreads();
  }

  if (cfg.use_smem) {
    for (int k = tid; k < P * N; k += nt) {
      words_out[oPN + k] = words[k];
      consts_out[oPN + k] = consts[k];
    }
    for (int k = tid; k < P; k += nt) {
      len_out[oP + k] = length[k];
      loss_out[oP + k] = loss[k];
      score_out[oP + k] = score[k];
      birth_out[oP + k] = birth[k];
    }
    for (int k = tid; k < S1; k += nt) {
      fd_out[oS + k] = fd[k];
      bsl_out[oS + k] = bs_loss[k];
      bslen_out[oS + k] = bs_len[k];
    }
    for (int k = tid; k < S1 * N; k += nt) {
      bsw_out[oSN + k] = bs_w[k];
      bsc_out[oSN + k] = bs_c[k];
    }
  }
}

// The (rows per thread, threads) shapes the kernel is built for.
#define SR_BLOCK_SHAPES(X) X(2, 512) X(4, 256) X(2, 256) X(1, 256) X(1, 64)

template <int RPT, int NT>
int launch(const SrBlockCfg& cfg, size_t smem, cudaStream_t s, const int* words,
           const float* consts, const int* length, const float* loss, const float* score,
           const int* birth, const float* fnorm, const long long* iscal, const float* fscal,
           const float* X, const float* y, const float* w, int* words_out, float* consts_out,
           int* len_out, float* loss_out, float* score_out, int* birth_out, float* fd_out,
           float* bsl_out, int* bsw_out, float* bsc_out, int* bslen_out) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(sr_evolve_block_kernel<RPT, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sr_evolve_block_kernel<RPT, NT><<<cfg.L * cfg.I, NT, smem, s>>>(
      cfg, words, consts, length, loss, score, birth, fnorm, iscal, fscal, X, y, w, words_out,
      consts_out, len_out, loss_out, score_out, birth_out, fd_out, bsl_out, bsw_out, bsc_out,
      bslen_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the block on `stream`; returns the CUDA error code (0 = ok), or
// cudaErrorInvalidValue for a (cfg.rpt, threads) shape it is not built for.
// smem is the block's dynamic shared memory in bytes, as block_smem in
// ops/evolve_block_cuda.py computes it.
int sr_evolve_block(SrBlockCfg cfg, int threads, size_t smem, const int* words,
                    const float* consts, const int* length, const float* loss, const float* score,
                    const int* birth,
                    const float* fnorm, const long long* iscal, const float* fscal, const float* X,
                    const float* y, const float* w, int* words_out, float* consts_out,
                    int* len_out, float* loss_out, float* score_out, int* birth_out,
                    float* fd_out, float* bsl_out, int* bsw_out, float* bsc_out, int* bslen_out,
                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define SR_CASE(R_, T_)                                                                      \
  if (cfg.rpt == R_ && threads == T_)                                                        \
    return launch<R_, T_>(cfg, smem, s, words, consts, length, loss, score, birth, fnorm,    \
                          iscal, fscal, X, y, w, words_out, consts_out, len_out, loss_out,   \
                          score_out, birth_out, fd_out, bsl_out, bsw_out, bsc_out, bslen_out);
  SR_BLOCK_SHAPES(SR_CASE)
#undef SR_CASE
  return (int)cudaErrorInvalidValue;
}

const char* sr_cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
