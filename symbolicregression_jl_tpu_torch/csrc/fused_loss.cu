// Fused eval + loss kernel for Hopper (sm_90a): the scoring kernel of the
// lockstep search.
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
// Output: out f32 [P]; scratch: partials f64 [P, n_chunks, 3].
//
// What bounds it on this card: operations. X is a few hundred KB and stays
// in L2; the program is a few hundred bytes per tree. Per (tree, row, slot)
// the kernel issues one opcode dispatch, one or two shared-memory reads and
// one write, and the operator's arithmetic (a libm call for transcendental
// operators). The design keeps intermediates out of device memory and keeps
// the dispatch warp-uniform:
//   * one block per (tree, row chunk); the block stages its tree's program in
//     shared memory, so every thread of the block runs the same opcode
//     sequence and the switch never diverges inside a warp;
//   * each thread evaluates its rows slot by slot into a value buffer in
//     shared memory laid out [slot][thread] (N x blockDim f32; 24 KB at
//     maxsize 20 and 256 threads), which is conflict-free;
//   * per-thread partial sums (sum w*loss, sum w, non-finite count) are kept
//     in double, reduced across the block in a fixed order, and a second
//     small kernel reduces the chunks of each tree in a fixed order and
//     applies the ok rule. No atomics: the result is deterministic.
// Operators and losses come from sr_ops.cuh: each follows the semantics of
// its torch `fn` in ops/operators.py (IEEE f32 arithmetic, CUDA libm), not
// the TPU kernel's Mosaic variants.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sr_ops.cuh"

namespace {

constexpr int kRedSlots = 3 * 32;  // 3 partials x up to 32 warps

__global__ void sr_loss_partials_kernel(
    const int* __restrict__ prog, int prog_ld, const float* __restrict__ vals,
    const int* __restrict__ optab, int n_ops, const float* __restrict__ X,
    long long ldx, const float* __restrict__ y, const float* __restrict__ w,
    int N, int R, int rows_per_block, int n_chunks, int loss_id, float q0,
    float q1, float q2, float q3, double* __restrict__ partials) {
  extern __shared__ double smem[];
  double* red = smem;                                   // [kRedSlots]
  float* buf = reinterpret_cast<float*>(red + kRedSlots);  // [N][blockDim]
  const int nt = blockDim.x;
  int* sprog = reinterpret_cast<int*>(buf + N * nt);    // [prog_ld]
  float* svals = reinterpret_cast<float*>(sprog + prog_ld);  // [N]
  int* sopt = reinterpret_cast<int*>(svals + N);        // [n_ops]

  const int p = blockIdx.x;
  const int chunk = blockIdx.y;
  const int tid = threadIdx.x;
  for (int k = tid; k < prog_ld; k += nt) sprog[k] = prog[(long long)p * prog_ld + k];
  for (int k = tid; k < N; k += nt) svals[k] = vals[(long long)p * N + k];
  for (int k = tid; k < n_ops; k += nt) sopt[k] = optab[k];
  __syncthreads();

  const float q[4] = {q0, q1, q2, q3};
  const int length = sprog[4 * N];
  const int r0 = chunk * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  double acc_l = 0.0, acc_w = 0.0, acc_n = 0.0;
  for (int r = r0 + tid; r < r1; r += nt) {
    float pred = sr::nan_();  // an empty program has no root
    for (int i = 0; i < length; ++i) {
      const int code = sprog[i];
      float v;
      if (code == 0) {
        v = svals[i];
      } else if (code == 1) {
        v = X[(long long)sprog[3 * N + i] * ldx + r];
      } else {
        const int b = sopt[code - 2];
        const float l = buf[sprog[N + i] * nt + tid];
        if (b < sr::kUnaryBuiltins) {
          v = sr::unary(b, l);
        } else {
          v = sr::binary(b - sr::kUnaryBuiltins, l, buf[sprog[2 * N + i] * nt + tid]);
        }
      }
      buf[i * nt + tid] = v;
      pred = v;  // the last slot written is the root, slot length-1
    }
    const float wt = w ? w[r] : 1.0f;
    if (!sr::isfinite_(pred)) acc_n += 1.0;
    acc_l += (double)(sr::loss(loss_id, pred, y[r], q) * wt);
    acc_w += (double)wt;
  }

  // fixed-order block reduction: warp tree, then warps in index order
  for (int off = 16; off > 0; off >>= 1) {
    acc_l += __shfl_down_sync(0xffffffffu, acc_l, off);
    acc_w += __shfl_down_sync(0xffffffffu, acc_w, off);
    acc_n += __shfl_down_sync(0xffffffffu, acc_n, off);
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    red[3 * warp + 0] = acc_l;
    red[3 * warp + 1] = acc_w;
    red[3 * warp + 2] = acc_n;
  }
  __syncthreads();
  if (tid == 0) {
    double L = 0.0, W = 0.0, C = 0.0;
    for (int k = 0; k < nt / 32; ++k) {
      L += red[3 * k + 0];
      W += red[3 * k + 1];
      C += red[3 * k + 2];
    }
    double* dst = partials + ((long long)p * n_chunks + chunk) * 3;
    dst[0] = L;
    dst[1] = W;
    dst[2] = C;
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
  out[p] = (C == 0.0 && W > 0.0) ? (float)(L / W) : INFINITY;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one partials block, in bytes.
size_t sr_fused_loss_smem(int N, int threads, int prog_ld, int n_ops) {
  return kRedSlots * sizeof(double) + (size_t)N * threads * sizeof(float) +
         (size_t)(prog_ld + N + n_ops) * 4;
}

// Launches both kernels on `stream`; returns the CUDA error code (0 = ok).
int sr_fused_loss(const int* prog, int prog_ld, const float* vals, const int* optab,
                  int n_ops, const float* X, long long ldx, const float* y,
                  const float* w, int P, int N, int R, int threads,
                  int rows_per_block, int n_chunks, int loss_id, float q0,
                  float q1, float q2, float q3, double* partials, float* out,
                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = sr_fused_loss_smem(N, threads, prog_ld, n_ops);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sr_loss_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)P, (unsigned)n_chunks);
  sr_loss_partials_kernel<<<grid, threads, smem, s>>>(
      prog, prog_ld, vals, optab, n_ops, X, ldx, y, w, N, R, rows_per_block,
      n_chunks, loss_id, q0, q1, q2, q3, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sr_loss_finalize_kernel<<<(P + 255) / 256, 256, 0, s>>>(partials, P, n_chunks, out);
  return (int)cudaGetLastError();
}

const char* sr_cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
