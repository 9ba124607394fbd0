// Fused eval + loss kernel for Hopper (sm_90a): the scoring kernel of the
// lockstep search and of the device engine's constant optimization.
//
// Replaces the TPU kernel symbolicregression_jl_tpu/ops/interp_pallas.py:258
// (_make_loss_kernel, launched by _loss_pallas at :407). It computes the same
// function: for each tree, a postorder evaluation over its real `length`
// slots on every row, then loss_elem(pred, y), a weighted sum over the rows
// and a count of non-finite predictions. The result per tree is
// loss_sum / w_sum, or +inf when any real row's prediction is non-finite or
// w_sum == 0.
//
// Inputs (one batch of P trees, N slots each):
//   prog  int32 [P, 4N+1]  code | lhs | rhs | feat | length, where code is
//                           0 const, 1 var, 2+k unary k, 2+n_unary+k binary k
//   vals  f32   [P, N]     constants
//   optab int32 [n_ops]    kernel id of each opset operator (unary ids
//                           0..30, binary ids 31+0..31+11; see SrUnary/SrBinary)
//   X     f32   [F, ldx]   feature-major rows; y, w f32 [R] (w may be null)
// Lane axis (a fleet of searches, models/device_search.fleet_search): the P
// trees are L lanes of P_lane trees, lane-major, and tree p reads lane
// p / P_lane's data: X [L, F, ldx] with lane stride lsx, y and w [L, R] with
// lane stride lsy. A solo launch is the L = 1 case (P_lane = P). The grid's
// z axis is the lane, and the caller takes the launch shape (tpb,
// rows_per_chunk, n_chunks) from P_lane, so a lane's blocks are its solo
// launch's: a tree's rows are cut into the chunks of its solo launch and
// its loss has the solo's bits.
// Output: out f32 [P]; scratch: partials f64 [P, n_chunks, 3] (unused when
// n_chunks is 1).
//
// What bounds it on this card: operations, and in practice the latency of
// each slot's dependent steps (instruction load, indirect branch, operand,
// libm), so what counts is how many independent row chains an SM holds. X is
// a few hundred KB and stays in L2; the program is a few hundred bytes per
// tree. The design (sr_interp.cuh):
//   * each block stages its trees' programs in shared memory and one thread
//     per tree decodes them once into 16-byte instructions (operator ids
//     already through optab, buffer offsets already scaled), walking the
//     postfix stack; a program that is not stack-sound scores inf;
//   * every thread evaluates RPT rows as interleaved chains (rows r, r + g,
//     ... with g the threads of its tree), so one broadcast instruction load
//     and one warp-uniform branch serve RPT rows;
//   * the stack top stays in registers, so a unary operator and a binary
//     operator's right operand read no memory; the value buffer holds the
//     N / 2 + 2 stack positions, not N slots, [position][thread][RPT] f32 in
//     shared memory, which leaves room for more chains per SM;
//   * a block holds `tpb` trees, one per group of warps, when the rows are too
//     few to give every thread RPT rows of one tree (minibatches), so that
//     threads are not left idle; a group always covers whole warps, so the
//     dispatch stays warp-uniform;
//   * per-thread partial sums (sum w*loss, sum w, non-finite count) are kept
//     in double, reduced by a fixed warp shuffle tree, then over the group's
//     warps in index order; with one row chunk per tree the block writes the
//     tree's loss itself, else a second small kernel reduces the chunks in
//     index order and applies the ok rule. No atomics: the result is
//     deterministic.
// Operators and losses come from sr_ops.cuh: each follows the semantics of
// its torch `fn` in ops/operators.py (IEEE f32 arithmetic, CUDA libm, built
// with --fmad=false), not the TPU kernel's Mosaic variants.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sr_interp.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRedSlots = 3 * (kMaxThreads / 32);  // 3 partials per warp

template <int RPT>
__global__ void __launch_bounds__(kMaxThreads) sr_loss_partials_kernel(
    const int* __restrict__ prog, int prog_ld, const float* __restrict__ vals,
    const int* __restrict__ optab, int n_ops, const float* __restrict__ X, long long ldx,
    long long lsx, const float* __restrict__ y, const float* __restrict__ w, long long lsy,
    int P_lane, int N, int R, int tpb, int rows_per_chunk, int n_chunks, int loss_id, float q0,
    float q1, float q2, float q3, double* __restrict__ partials, float* __restrict__ out) {
  extern __shared__ double smem[];  // carved as loss_smem in ops/interp_cuda.py counts it
  const int nt = blockDim.x, tid = threadIdx.x;
  const int D = sr::stack_slots(N);
  double* red = smem;                                               // [kRedSlots]
  sr::Instr* sins = reinterpret_cast<sr::Instr*>(red + kRedSlots);  // [tpb][N]
  float* buf = reinterpret_cast<float*>(sins + tpb * N);            // [D][nt][RPT]
  int* sprog = reinterpret_cast<int*>(buf + D * nt * RPT);          // [tpb][prog_ld]
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
  // stage the block's programs, then one thread per tree decodes its own
  for (int k = tid; k < n_live * prog_ld; k += nt) sprog[k] = prog[(long long)p0 * prog_ld + k];
  for (int k = tid; k < n_live * N; k += nt) svals[k] = vals[(long long)p0 * N + k];
  for (int k = tid; k < n_ops; k += nt) sopt[k] = optab[k];
  __syncthreads();
  sr::Instr* ins = sins + g * N;
  if (live && gt == 0)
    slen[g] = sr::decode_code(sprog + g * prog_ld, N, sopt, svals + g * N, nt * RPT,
                              sst + g * D, ins);
  __syncthreads();

  sr::Acc acc{0.0, 0.0, 0.0};
  if (live) {
    const int length = slen[g];
    float* col = buf + tid * RPT;
    const int r0 = chunk * rows_per_chunk;
    const int r1 = min(R, r0 + rows_per_chunk);
    const sr::LaneData d = sr::lane_data(X, y, w, fl, lsx, lsy);
    for (int base = r0; base < r1; base += gs * RPT)
      sr::tile_loss<RPT, sr::kSwitch>(ins, length, col, d.X, ldx, d.y, d.w, base + gt, gs, r1,
                                      R, loss_id, q0, q1, q2, q3, sr::nan_(), acc);
  }

  // fixed-order reduction: warp tree, then the group's warps in index order
  for (int off = 16; off > 0; off >>= 1) {
    acc.l += __shfl_down_sync(0xffffffffu, acc.l, off);
    acc.w += __shfl_down_sync(0xffffffffu, acc.w, off);
    acc.n += __shfl_down_sync(0xffffffffu, acc.n, off);
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    red[3 * warp + 0] = acc.l;
    red[3 * warp + 1] = acc.w;
    red[3 * warp + 2] = acc.n;
  }
  __syncthreads();
  if (gt == 0 && live) {
    double L = 0.0, W = 0.0, C = 0.0;
    for (int k = warp; k < warp + gs / 32; ++k) {
      L += red[3 * k + 0];
      W += red[3 * k + 1];
      C += red[3 * k + 2];
    }
    if (n_chunks == 1) {
      out[p] = sr::finish(L, W, C);
    } else {
      double* dst = partials + ((long long)p * n_chunks + chunk) * 3;
      dst[0] = L;
      dst[1] = W;
      dst[2] = C;
    }
  }
}

__global__ void sr_loss_finalize_kernel(const double* __restrict__ partials, int P,
                                        int n_chunks, float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  double L = 0.0, W = 0.0, C = 0.0;
  for (int c = 0; c < n_chunks; ++c) {
    const double* src = partials + ((long long)p * n_chunks + c) * 3;
    L += src[0];
    W += src[1];
    C += src[2];
  }
  out[p] = sr::finish(L, W, C);
}

template <int RPT>
int launch(const int* prog, int prog_ld, const float* vals, const int* optab, int n_ops,
           const float* X, long long ldx, long long lsx, const float* y, const float* w,
           long long lsy, int P, int P_lane, int N, int R, int threads, int tpb,
           int rows_per_chunk, int n_chunks, int loss_id, float q0, float q1, float q2, float q3,
           double* partials, float* out, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(sr_loss_partials_kernel<RPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((P_lane + tpb - 1) / tpb), (unsigned)n_chunks, (unsigned)(P / P_lane));
  sr_loss_partials_kernel<RPT><<<grid, threads, smem, s>>>(
      prog, prog_ld, vals, optab, n_ops, X, ldx, lsx, y, w, lsy, P_lane, N, R, tpb,
      rows_per_chunk, n_chunks, loss_id, q0, q1, q2, q3, partials, out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return (int)e;
  sr_loss_finalize_kernel<<<(P + 255) / 256, 256, 0, s>>>(partials, P, n_chunks, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches B1 on `stream` (the finalize kernel too when n_chunks > 1);
// returns the CUDA error code (0 = ok). rpt is 1, 2 or 4; threads at most
// 256, a multiple of 32 * tpb; smem is the block's dynamic shared memory in
// bytes, as loss_smem in ops/interp_cuda.py computes it. P is L * P_lane
// trees; lsx and lsy are the lane strides of X and of y, w (0 for one lane).
int sr_fused_loss(const int* prog, int prog_ld, const float* vals, const int* optab,
                  int n_ops, const float* X, long long ldx, long long lsx, const float* y,
                  const float* w, long long lsy, int P, int P_lane, int N, int R, int threads,
                  int rpt, int tpb, int rows_per_chunk, int n_chunks, size_t smem, int loss_id,
                  float q0, float q1, float q2, float q3, double* partials, float* out,
                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define SR_ARGS                                                                              \
  prog, prog_ld, vals, optab, n_ops, X, ldx, lsx, y, w, lsy, P, P_lane, N, R, threads, tpb,  \
      rows_per_chunk, n_chunks, loss_id, q0, q1, q2, q3, partials, out, smem, s
  switch (rpt) {
    case 1: return launch<1>(SR_ARGS);
    case 2: return launch<2>(SR_ARGS);
    case 4: return launch<4>(SR_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SR_ARGS
}

const char* sr_cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
