// Fused eval + loss + constant-gradient kernel for Hopper (sm_90a): the
// gradient kernel of the device engine's constant optimization.
//
// Replaces the TPU kernel symbolicregression_jl_tpu/ops/interp_pallas.py:725
// (_make_loss_grad_kernel, launched by _loss_grad_pallas at :902). It
// computes the same function: for each tree, fused_loss.cu's forward pass
// (postorder evaluation over the tree's real `length` slots, elementwise
// loss, weighted sum, non-finite count), then a reverse adjoint sweep over
// the same slots. Every node has exactly one parent, so the parent WRITES
// each child's adjoint before the sweep reaches the child: no zero-init, no
// accumulation. The root's adjoint is w * dloss/dpred. A constant slot's
// gradient is the sum of its adjoint over the real rows, divided by w_sum,
// and 0 where the tree is not ok (a non-finite prediction, or w_sum == 0).
//
// Inputs as fused_loss.cu (prog int32 [P, 4N+1], vals f32 [P, N], optab,
// X f32 [F, ldx], y, w f32 [R]). Outputs: losses f32 [P], grads f32 [P, N].
// Scratch: partials f64 [P, n_chunks, 3 + N].
//
// What bounds it on this card: operations, as for fused_loss.cu. Per
// (tree, row, slot) the kernel runs one forward operator and one derivative
// (a derivative re-evaluates the operator's libm call where autograd uses
// the output, e.g. tan, tanh); X and y stay in L2. The design keeps every
// per-row intermediate in shared memory and the dispatch warp-uniform:
//   * one block per (tree, row chunk); the block stages its tree's program in
//     shared memory, so every thread runs the same opcode sequence forward
//     and backward and the switch never diverges inside a warp;
//   * per thread, a value buffer and an adjoint buffer in shared memory,
//     both [slot][thread] f32 (conflict-free), and one f64 gradient
//     accumulator per slot, [slot][thread];
//   * after its rows, the block reduces the loss partials (warp tree, then
//     warps in order) and the gradient accumulators (shared-memory tree) in
//     a fixed order; a second small kernel sums the chunks of each tree in
//     index order and applies the ok rule. No atomics: deterministic.
// Operators, losses and their derivatives come from sr_ops.cuh; the
// derivatives reproduce torch autograd of the port's torch fns, which is
// what the plain version (ops/interp_cuda.fused_loss_grad_reference) runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sr_ops.cuh"

namespace {

constexpr int kRedSlots = 3 * 32;  // 3 loss partials x up to 32 warps

__global__ void sr_grad_partials_kernel(
    const int* __restrict__ prog, int prog_ld, const float* __restrict__ vals,
    const int* __restrict__ optab, int n_ops, const float* __restrict__ X,
    long long ldx, const float* __restrict__ y, const float* __restrict__ w,
    int N, int R, int rows_per_block, int n_chunks, int loss_id, float q0,
    float q1, float q2, float q3, double* __restrict__ partials) {
  extern __shared__ double smem[];
  const int nt = blockDim.x;
  double* red = smem;                                   // [kRedSlots]
  double* gacc = red + kRedSlots;                       // [N][nt]
  float* buf = reinterpret_cast<float*>(gacc + (size_t)N * nt);  // [N][nt]
  float* adj = buf + (size_t)N * nt;                    // [N][nt]
  int* sprog = reinterpret_cast<int*>(adj + (size_t)N * nt);  // [prog_ld]
  float* svals = reinterpret_cast<float*>(sprog + prog_ld);   // [N]
  int* sopt = reinterpret_cast<int*>(svals + N);        // [n_ops]

  const int p = blockIdx.x;
  const int chunk = blockIdx.y;
  const int tid = threadIdx.x;
  for (int k = tid; k < prog_ld; k += nt) sprog[k] = prog[(long long)p * prog_ld + k];
  for (int k = tid; k < N; k += nt) svals[k] = vals[(long long)p * N + k];
  for (int k = tid; k < n_ops; k += nt) sopt[k] = optab[k];
  for (int i = 0; i < N; ++i) gacc[i * nt + tid] = 0.0;
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
    const float yr = y[r];
    if (!sr::isfinite_(pred)) acc_n += 1.0;
    acc_l += (double)(sr::loss(loss_id, pred, yr, q) * wt);
    acc_w += (double)wt;
    if (length == 0) continue;

    // reverse sweep: parents before children; each child written once
    adj[(length - 1) * nt + tid] = sr::loss_grad(loss_id, pred, yr, q, wt);
    for (int i = length - 1; i >= 0; --i) {
      const int code = sprog[i];
      const float a = adj[i * nt + tid];
      if (code == 0) {
        gacc[i * nt + tid] += (double)a;
      } else if (code >= 2) {
        const int b = sopt[code - 2];
        const int li = sprog[N + i];
        const float l = buf[li * nt + tid];
        if (b < sr::kUnaryBuiltins) {
          adj[li * nt + tid] = sr::unary_grad(b, l, a);
        } else {
          const int ri = sprog[2 * N + i];
          float dl, dr;
          sr::binary_grad(b - sr::kUnaryBuiltins, l, buf[ri * nt + tid], a, &dl, &dr);
          adj[li * nt + tid] = dl;
          adj[ri * nt + tid] = dr;
        }
      }
    }
  }

  double* dst = partials + ((long long)p * n_chunks + chunk) * (3 + N);
  // loss partials: warp tree, then warps in index order
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
  // gradient accumulators: a shared-memory tree over threads (nt is a
  // power of two), every slot at once
  for (int s = nt / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (tid < s) {
      for (int i = 0; i < length; ++i) gacc[i * nt + tid] += gacc[i * nt + tid + s];
    }
  }
  __syncthreads();
  if (tid == 0) {
    double L = 0.0, W = 0.0, C = 0.0;
    for (int k = 0; k < nt / 32; ++k) {
      L += red[3 * k + 0];
      W += red[3 * k + 1];
      C += red[3 * k + 2];
    }
    dst[0] = L;
    dst[1] = W;
    dst[2] = C;
  }
  for (int i = tid; i < N; i += nt) dst[3 + i] = gacc[i * nt];
}

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
  const bool ok = C == 0.0 && W > 0.0;
  out[p] = ok ? (float)(L / W) : INFINITY;
  for (int i = 0; i < N; ++i) {
    double G = 0.0;
    for (int c = 0; c < n_chunks; ++c) G += base[(long long)c * (3 + N) + 3 + i];
    grads[(long long)p * N + i] = ok ? (float)(G / W) : 0.0f;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one partials block, in bytes.
size_t sr_fused_loss_grad_smem(int N, int threads, int prog_ld, int n_ops) {
  return kRedSlots * sizeof(double) + (size_t)N * threads * sizeof(double) +
         2 * (size_t)N * threads * sizeof(float) + (size_t)(prog_ld + N + n_ops) * 4;
}

// Launches both kernels on `stream`; returns the CUDA error code (0 = ok).
int sr_fused_loss_grad(const int* prog, int prog_ld, const float* vals, const int* optab,
                       int n_ops, const float* X, long long ldx, const float* y,
                       const float* w, int P, int N, int R, int threads,
                       int rows_per_block, int n_chunks, int loss_id, float q0,
                       float q1, float q2, float q3, double* partials, float* out,
                       float* grads, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = sr_fused_loss_grad_smem(N, threads, prog_ld, n_ops);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sr_grad_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)P, (unsigned)n_chunks);
  sr_grad_partials_kernel<<<grid, threads, smem, s>>>(
      prog, prog_ld, vals, optab, n_ops, X, ldx, y, w, N, R, rows_per_block,
      n_chunks, loss_id, q0, q1, q2, q3, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sr_grad_finalize_kernel<<<(P + 127) / 128, 128, 0, s>>>(partials, P, N, n_chunks, out,
                                                          grads);
  return (int)cudaGetLastError();
}

const char* sr_cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
