// Fused eval + loss + constant-gradient kernel for Hopper (sm_90a): the
// gradient kernel of the device engine's constant optimization.
//
// Replaces the TPU kernel symbolicregression_jl_tpu/ops/interp_pallas.py:725
// (_make_loss_grad_kernel, launched by _loss_grad_pallas at :902). It
// computes the same function: for each tree, fused_loss.cu's forward pass
// and loss, then a reverse adjoint sweep over the same slots. The root's
// adjoint is w * dloss/dpred; a constant slot's gradient is the sum of its
// adjoint over the real rows, divided by w_sum, and 0 where the tree is not
// ok (a non-finite prediction, or w_sum == 0), as is every other slot's.
//
// Inputs as fused_loss.cu (prog int32 [P, 4N+1], vals f32 [P, N], optab,
// X f32 [F, ldx], y, w f32 [R]), with its lane axis: L lanes of P_lane
// trees, tree p on lane p / P_lane's X, y and w, the lane on the grid's z
// axis and the launch shape taken from P_lane, so that a lane's blocks, and
// each tree's chunks and sums, are its solo launch's.
// Outputs: losses f32 [P], grads f32 [P, N].
// Scratch: partials f64 [P, n_chunks, 3 + N] (unused when n_chunks is 1).
//
// A second entry point, sr_preds_vjp, is the same kernel in its seeded mode
// (SEED): the vector-Jacobian product of B4's prediction matrix with respect
// to the constants, for a full objective's gradient (Options.
// loss_function_jit), where the TPU's const-opt ran jax.vjp of the scan
// interpreter (symbolicregression_jl_tpu/ops/constant_opt.py:269-300). The
// root adjoint of row r of tree p is seed[p, r] (f32 [P, R], row stride R, in
// y's place; no w, no loss, no division by w_sum); grads[p] is the f64 sum
// over the real rows, or 0 where any prediction of tree p is not finite (an
// unsound tree too). One lane only. The loss path's code is unchanged: the
// flag is a template argument, and its seeded branches are `if constexpr`.
//
// What bounds it on this card: operations, and in practice the latency of
// each slot's dependent steps, forward and backward (instruction load,
// branch, operand load, libm; a derivative re-evaluates its operator's libm
// call where autograd uses the output, e.g. tan, tanh), so what counts is how
// many independent row chains an SM holds. The design is B1's, on the shared
// interpreter core (sr_interp.cuh):
//   * each block stages its trees' programs in shared memory and one thread
//     per tree decodes them once, in tape mode, into 16-byte instructions
//     that carry each binary operator's left child; a program that is not
//     stack-sound scores inf with zero gradients;
//   * every thread evaluates RPT rows as interleaved chains, forward with the
//     stack top in registers, storing each slot's values on a tape,
//     [slot][thread][RPT] f32 in shared memory; then backward with the
//     adjoint in registers, writing a left child's adjoint over its values on
//     the tape, so no other buffer is needed: 4 x N bytes a row, where
//     separate value and adjoint buffers and an f64 gradient accumulator per
//     slot would take 16 x N and a quarter of the chains an SM holds;
//   * the loss and its derivative are applied once per RPT rows;
//   * a constant slot's adjoints are summed in f64 per thread over its RPT
//     rows, then over the warp by a fixed shuffle tree, and added to a
//     [slot][warp] f64 sum in shared memory: only constant slots, no atomics
//     (per-thread f64 accumulators indexed by the constant's ordinal, summed
//     once after the rows, cost a quarter of the blocks per SM and measured
//     slower, PERF.md);
//   * the operator dispatch, forward and backward, is the tree of branches
//     (B3's), which measured faster here than the switch (PERF.md);
//   * a block holds `tpb` trees, one per group of whole warps, when the rows
//     are too few for one tree per block (minibatches), else the rows of a
//     tree are cut into chunks across blocks, as B1's;
//   * sums over the group's warps in index order, then (with several chunks)
//     a second small kernel over the chunks in index order: two launches on
//     the same inputs give identical bits.
// Operators, losses and their derivatives come from sr_ops.cuh; the
// derivatives reproduce torch autograd of the port's torch fns, which is
// what the plain version (ops/interp_cuda.fused_loss_grad_reference) runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sr_interp.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRedSlots = 3 * (kMaxThreads / 32);  // 3 loss partials per warp

// Where a constant slot's adjoint sum over one tile goes: reduced over the
// warp by a shuffle tree, then added to the [slot][warp] sums.
struct WarpSink {
  double* gsw;  // [slot][warp]
  int nw, warp, lane;
  __device__ void operator()(int i, double s) const {
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) gsw[i * nw + warp] += s;
  }
};

template <int RPT, bool SEED>
__global__ void __launch_bounds__(kMaxThreads) sr_grad_partials_kernel(
    const int* __restrict__ prog, int prog_ld, const float* __restrict__ vals,
    const int* __restrict__ optab, int n_ops, const float* __restrict__ X, long long ldx,
    long long lsx, const float* __restrict__ y, const float* __restrict__ w, long long lsy,
    int P_lane, int N, int R, int tpb, int rows_per_chunk, int n_chunks, int loss_id, float q0,
    float q1, float q2, float q3, double* __restrict__ partials, float* __restrict__ out,
    float* __restrict__ grads) {
  extern __shared__ double smem[];  // carved as grad_smem in ops/interp_cuda.py counts it
  const int nt = blockDim.x, tid = threadIdx.x, nw = nt / 32;
  const int D = sr::stack_slots(N);
  const int stride = nt * RPT;
  double* red = smem;                                               // [kRedSlots]
  sr::Instr* sins = reinterpret_cast<sr::Instr*>(red + kRedSlots);  // [tpb][N]
  float* tape = reinterpret_cast<float*>(sins + tpb * N);           // [N][nt][RPT]
  double* gsw = reinterpret_cast<double*>(tape + N * stride);       // [N][nw]
  int* sprog = reinterpret_cast<int*>(gsw + N * nw);                // [tpb][prog_ld]
  float* svals = reinterpret_cast<float*>(sprog + tpb * prog_ld);   // [tpb][N]
  int* sst = reinterpret_cast<int*>(svals + tpb * N);               // [tpb][D]
  int* sopt = sst + tpb * D;                                        // [n_ops]
  int* slen = sopt + n_ops;                                         // [tpb]

  const int gs = nt / tpb;  // threads per tree
  const int g = tid / gs, gt = tid % gs;
  // grid z is the fleet's lane fl: a lane's blocks are its solo launch's
  const int fl = blockIdx.z;
  const int p0 = fl * P_lane + blockIdx.x * tpb;  // the block's first tree
  const int p = p0 + g;
  const int chunk = blockIdx.y;
  const int n_live = min(tpb, (fl + 1) * P_lane - p0);
  const bool live = g < n_live;
  const int lane = tid & 31, warp = tid >> 5;
  // stage the block's programs, then one thread per tree decodes its own
  for (int k = tid; k < n_live * prog_ld; k += nt) sprog[k] = prog[(long long)p0 * prog_ld + k];
  for (int k = tid; k < n_live * N; k += nt) svals[k] = vals[(long long)p0 * N + k];
  for (int k = tid; k < n_ops; k += nt) sopt[k] = optab[k];
  for (int k = tid; k < N * nw; k += nt) gsw[k] = 0.0;
  __syncthreads();
  sr::Instr* ins = sins + g * N;
  if (live && gt == 0)
    slen[g] = sr::decode_code(sprog + g * prog_ld, N, sopt, svals + g * N, stride, sst + g * D,
                              ins, true);
  __syncthreads();

  sr::Acc acc{0.0, 0.0, 0.0};
  if (live) {
    const int length = slen[g];
    float* col = tape + tid * RPT;
    const int r0 = chunk * rows_per_chunk;
    const int r1 = min(R, r0 + rows_per_chunk);
    WarpSink sink{gsw, nw, warp, lane};
    const sr::LaneData d = sr::lane_data(X, y, w, fl, lsx, lsy);
    for (int base = r0; base < r1; base += gs * RPT) {
      if constexpr (SEED) {
        // y is the seed [P, R]: tree p's row of it
        sr::tile_seed_grad<RPT, sr::kTree>(ins, length, col, stride, d.X, ldx,
                                           y + (long long)p * R, base + gt, gs, r1, R, acc,
                                           sink);
      } else {
        sr::tile_loss_grad<RPT, sr::kTree>(ins, length, col, stride, d.X, ldx, d.y, d.w,
                                           base + gt, gs, r1, R, loss_id, q0, q1, q2, q3, acc,
                                           sink);
      }
    }
  }

  // fixed-order reductions: warp trees, then the group's warps in index order
  for (int off = 16; off > 0; off >>= 1) {
    acc.l += __shfl_down_sync(0xffffffffu, acc.l, off);
    acc.w += __shfl_down_sync(0xffffffffu, acc.w, off);
    acc.n += __shfl_down_sync(0xffffffffu, acc.n, off);
  }
  if (lane == 0) {
    red[3 * warp + 0] = acc.l;
    red[3 * warp + 1] = acc.w;
    red[3 * warp + 2] = acc.n;
  }
  __syncthreads();
  if (!live) return;
  const int w0 = g * (gs / 32);  // the group's first warp
  double L = 0.0, W = 0.0, Cn = 0.0;
  for (int k = w0; k < w0 + gs / 32; ++k) {
    L += red[3 * k + 0];
    W += red[3 * k + 1];
    Cn += red[3 * k + 2];
  }
  const bool ok = SEED ? Cn == 0.0 : Cn == 0.0 && W > 0.0;
  double* dst = partials + ((long long)p * n_chunks + chunk) * (3 + N);
  for (int i = gt; i < N; i += gs) {
    double G = 0.0;
    for (int k = w0; k < w0 + gs / 32; ++k) G += gsw[i * nw + k];
    if (n_chunks == 1) {
      grads[(long long)p * N + i] = ok ? (float)(SEED ? G : G / W) : 0.0f;
    } else {
      dst[3 + i] = G;
    }
  }
  if (gt == 0) {
    if (n_chunks == 1) {
      if constexpr (!SEED) out[p] = sr::finish(L, W, Cn);
    } else {
      dst[0] = L;
      dst[1] = W;
      dst[2] = Cn;
    }
  }
}

template <bool SEED>
__global__ void sr_grad_finalize_kernel(const double* __restrict__ partials, int P,
                                        int N, int n_chunks, float* __restrict__ out,
                                        float* __restrict__ grads) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const double* base = partials + (long long)p * n_chunks * (3 + N);
  double L = 0.0, W = 0.0, C = 0.0;
  for (int c = 0; c < n_chunks; ++c) {
    const double* src = base + (long long)c * (3 + N);
    L += src[0];
    W += src[1];
    C += src[2];
  }
  const bool ok = SEED ? C == 0.0 : C == 0.0 && W > 0.0;
  if constexpr (!SEED) out[p] = ok ? (float)(L / W) : INFINITY;
  for (int i = 0; i < N; ++i) {
    double G = 0.0;
    for (int c = 0; c < n_chunks; ++c) G += base[(long long)c * (3 + N) + 3 + i];
    grads[(long long)p * N + i] = ok ? (float)(SEED ? G : G / W) : 0.0f;
  }
}

template <int RPT, bool SEED = false>
int launch(const int* prog, int prog_ld, const float* vals, const int* optab, int n_ops,
           const float* X, long long ldx, long long lsx, const float* y, const float* w,
           long long lsy, int P, int P_lane, int N, int R, int threads, int tpb,
           int rows_per_chunk, int n_chunks, int loss_id, float q0, float q1, float q2, float q3,
           double* partials, float* out, float* grads, size_t smem, cudaStream_t s) {
  auto kernel = sr_grad_partials_kernel<RPT, SEED>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((P_lane + tpb - 1) / tpb), (unsigned)n_chunks, (unsigned)(P / P_lane));
  kernel<<<grid, threads, smem, s>>>(prog, prog_ld, vals, optab, n_ops, X, ldx, lsx, y, w, lsy,
                                     P_lane, N, R, tpb, rows_per_chunk, n_chunks, loss_id, q0,
                                     q1, q2, q3, partials, out, grads);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return (int)e;
  sr_grad_finalize_kernel<SEED>
      <<<(P + 127) / 128, 128, 0, s>>>(partials, P, N, n_chunks, out, grads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches B2 on `stream` (the finalize kernel too when n_chunks > 1);
// returns the CUDA error code (0 = ok). rpt is 1, 2 or 4; threads at most
// 256, a multiple of 32 * tpb; smem is the block's dynamic shared memory in
// bytes, as grad_smem in ops/interp_cuda.py computes it. P is L * P_lane
// trees; lsx and lsy are the lane strides of X and of y, w (0 for one lane).
int sr_fused_loss_grad(const int* prog, int prog_ld, const float* vals, const int* optab,
                       int n_ops, const float* X, long long ldx, long long lsx, const float* y,
                       const float* w, long long lsy, int P, int P_lane, int N, int R,
                       int threads, int rpt, int tpb, int rows_per_chunk, int n_chunks,
                       size_t smem, int loss_id, float q0, float q1, float q2, float q3,
                       double* partials, float* out, float* grads, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define SR_ARGS                                                                              \
  prog, prog_ld, vals, optab, n_ops, X, ldx, lsx, y, w, lsy, P, P_lane, N, R, threads, tpb,  \
      rows_per_chunk, n_chunks, loss_id, q0, q1, q2, q3, partials, out, grads, smem, s
  switch (rpt) {
    case 1: return launch<1>(SR_ARGS);
    case 2: return launch<2>(SR_ARGS);
    case 4: return launch<4>(SR_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SR_ARGS
}

// Launches the seeded mode on `stream` (see the header): seed f32 [P, R]
// (row stride R) in y's place, one lane, no loss, no w; grads f32 [P, N];
// partials as sr_fused_loss_grad's. Returns the CUDA error code.
int sr_preds_vjp(const int* prog, int prog_ld, const float* vals, const int* optab, int n_ops,
                 const float* X, long long ldx, const float* seed, int P, int N, int R,
                 int threads, int rpt, int tpb, int rows_per_chunk, int n_chunks, size_t smem,
                 double* partials, float* grads, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define SR_ARGS                                                                            \
  prog, prog_ld, vals, optab, n_ops, X, ldx, 0, seed, nullptr, 0, P, P, N, R, threads, tpb, \
      rows_per_chunk, n_chunks, 0, 0.0f, 0.0f, 0.0f, 0.0f, partials, nullptr, grads, smem, s
  switch (rpt) {
    case 1: return launch<1, true>(SR_ARGS);
    case 2: return launch<2, true>(SR_ARGS);
    case 4: return launch<4, true>(SR_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SR_ARGS
}

const char* sr_cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
