// Prediction-matrix kernel for Hopper (sm_90a): B1's forward pass, storing
// every (tree, row) prediction instead of reducing a loss.
//
// Replaces the TPU kernel symbolicregression_jl_tpu/ops/interp_pallas.py:73
// (_make_kernel, launched by _eval_pallas at :156; entry point
// eval_trees_pallas at :206). It computes the same function: for each tree, a
// postorder evaluation over its real `length` slots on every row, the root's
// value written to preds[tree, row]. An empty program writes 0, as the plain
// interpreter (ops/interp.py) reads its zeroed slot 0.
//
// Inputs are B1's (fused_loss.cu): prog int32 [P, 4N+1], vals f32 [P, N],
// optab int32 [n_ops], X f32 [F, ldx]. Output: preds f32 [P, R].
//
// What bounds it on this card: bytes. It writes P x R f32 predictions, one
// per (tree, row), against a few operations per slot; the design is B1's
// (one block per (tree, row chunk), the program staged in shared memory so
// the opcode switch is warp-uniform, the value buffer [slot][thread] in
// shared memory), with consecutive threads on consecutive rows so each warp
// stores 128 contiguous bytes. Any P and R: rows are masked by index, with
// no tile padding.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sr_ops.cuh"

namespace {

__global__ void sr_eval_preds_kernel(const int* __restrict__ prog, int prog_ld,
                                     const float* __restrict__ vals,
                                     const int* __restrict__ optab, int n_ops,
                                     const float* __restrict__ X, long long ldx, int N, int R,
                                     int rows_per_block, float* __restrict__ preds) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  float* buf = smem;                                         // [N][blockDim]
  int* sprog = reinterpret_cast<int*>(buf + N * nt);         // [prog_ld]
  float* svals = reinterpret_cast<float*>(sprog + prog_ld);  // [N]
  int* sopt = reinterpret_cast<int*>(svals + N);             // [n_ops]

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  for (int k = tid; k < prog_ld; k += nt) sprog[k] = prog[(long long)p * prog_ld + k];
  for (int k = tid; k < N; k += nt) svals[k] = vals[(long long)p * N + k];
  for (int k = tid; k < n_ops; k += nt) sopt[k] = optab[k];
  __syncthreads();

  const int length = sprog[4 * N];
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  for (int r = r0 + tid; r < r1; r += nt) {
    float pred = 0.0f;
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
      pred = v;
    }
    preds[(long long)p * R + r] = pred;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
size_t sr_eval_preds_smem(int N, int threads, int prog_ld, int n_ops) {
  return (size_t)N * threads * sizeof(float) + (size_t)(prog_ld + N + n_ops) * 4;
}

// Launches the kernel on `stream`; returns the CUDA error code (0 = ok).
int sr_eval_preds(const int* prog, int prog_ld, const float* vals, const int* optab, int n_ops,
                  const float* X, long long ldx, int P, int N, int R, int threads,
                  int rows_per_block, int n_chunks, float* preds, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = sr_eval_preds_smem(N, threads, prog_ld, n_ops);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sr_eval_preds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)P, (unsigned)n_chunks);
  sr_eval_preds_kernel<<<grid, threads, smem, s>>>(prog, prog_ld, vals, optab, n_ops, X, ldx, N,
                                                   R, rows_per_block, preds);
  return (int)cudaGetLastError();
}

const char* sr_cuda_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
