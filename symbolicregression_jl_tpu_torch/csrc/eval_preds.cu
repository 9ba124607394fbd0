// Prediction-matrix kernel for Hopper (sm_90a): B1's forward pass, storing
// every (tree, row) prediction instead of reducing a loss.
//
// Replaces the TPU kernel symbolicregression_jl_tpu/ops/interp_pallas.py:73
// (_make_kernel, launched by _eval_pallas at :156; entry point
// eval_trees_pallas at :206). It computes the same function: for each tree, a
// postorder evaluation over its real `length` slots on every row, the root's
// value written to preds[tree, row]. An empty program writes 0, as the plain
// interpreter (ops/interp.py) reads its zeroed slot 0; a program that is not
// stack-sound writes NaN, as B1 scores it inf.
//
// Inputs are B1's (fused_loss.cu): prog int32 [P, 4N+1], vals f32 [P, N],
// optab int32 [n_ops], X f32 [F, ldx]. Output: preds f32 [P, R].
//
// What bounds it on this card: in principle bytes (P x R f32 predictions
// against a few operations per slot), in practice, as for B1, the latency of
// each slot's dependent steps. The design is B1's, on the shared interpreter
// core (sr_interp.cuh): each block stages its trees' programs in shared
// memory and one thread per tree decodes them once onto the postfix stack;
// every thread evaluates RPT rows as interleaved chains (rows r, r + g, ...
// with g the threads of its tree), with the stack top in registers and N / 2
// + 2 stack positions [position][thread][RPT] f32 in shared memory; a block
// holds `tpb` trees, one per group of whole warps, when the rows are few, and
// the rows of a tree are cut into chunks across blocks when they are many.
// For each of its RPT rows a warp stores 32 consecutive floats: coalesced.
// Any P and R: rows are masked by index, with no tile padding.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sr_interp.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <int RPT>
__global__ void __launch_bounds__(kMaxThreads) sr_eval_preds_kernel(
    const int* __restrict__ prog, int prog_ld, const float* __restrict__ vals,
    const int* __restrict__ optab, int n_ops, const float* __restrict__ X, long long ldx, int P,
    int N, int R, int tpb, int rows_per_chunk, float* __restrict__ preds) {
  extern __shared__ float4 smem4[];  // carved as preds_smem in ops/interp_cuda.py counts it
  const int nt = blockDim.x, tid = threadIdx.x;
  const int D = sr::stack_slots(N);
  sr::Instr* sins = reinterpret_cast<sr::Instr*>(smem4);            // [tpb][N]
  float* buf = reinterpret_cast<float*>(sins + tpb * N);            // [D][nt][RPT]
  int* sprog = reinterpret_cast<int*>(buf + D * nt * RPT);          // [tpb][prog_ld]
  float* svals = reinterpret_cast<float*>(sprog + tpb * prog_ld);   // [tpb][N]
  int* sst = reinterpret_cast<int*>(svals + tpb * N);               // [tpb][D]
  int* sopt = sst + tpb * D;                                        // [n_ops]
  int* slen = sopt + n_ops;                                         // [tpb]

  const int gs = nt / tpb;  // threads per tree
  const int g = tid / gs, gt = tid % gs;
  const int p0 = blockIdx.x * tpb;
  const int p = p0 + g;
  const int n_live = min(tpb, P - p0);
  for (int k = tid; k < n_live * prog_ld; k += nt) sprog[k] = prog[(long long)p0 * prog_ld + k];
  for (int k = tid; k < n_live * N; k += nt) svals[k] = vals[(long long)p0 * N + k];
  for (int k = tid; k < n_ops; k += nt) sopt[k] = optab[k];
  __syncthreads();
  sr::Instr* ins = sins + g * N;
  if (p < P && gt == 0)
    slen[g] = sr::decode_code(sprog + g * prog_ld, N, sopt, svals + g * N, nt * RPT,
                              sst + g * D, ins);
  __syncthreads();
  if (p >= P) return;

  const int length = slen[g];
  float* col = buf + tid * RPT;
  float* dst = preds + (long long)p * R;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(R, r0 + rows_per_chunk);
  for (int base = r0; base < r1; base += gs * RPT) {
    int row[RPT];
    bool valid[RPT];
    sr::tile_rows<RPT>(base + gt, gs, r1, R, row, valid);
    const sr::Vals<RPT> v = sr::eval_rows<RPT, sr::kSwitch>(ins, length, col, X, ldx, row, 0.0f);
    for (int k = 0; k < RPT; ++k)
      if (valid[k]) dst[row[k]] = v.v[k];
  }
}

template <int RPT>
int launch(const int* prog, int prog_ld, const float* vals, const int* optab, int n_ops,
           const float* X, long long ldx, int P, int N, int R, int threads, int tpb,
           int rows_per_chunk, int n_chunks, size_t smem, float* preds, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(sr_eval_preds_kernel<RPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((P + tpb - 1) / tpb), (unsigned)n_chunks);
  sr_eval_preds_kernel<RPT><<<grid, threads, smem, s>>>(prog, prog_ld, vals, optab, n_ops, X,
                                                        ldx, P, N, R, tpb, rows_per_chunk, preds);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches B4 on `stream`; returns the CUDA error code (0 = ok). rpt is 1, 2
// or 4; threads at most 256, a multiple of 32 * tpb; smem is the block's
// dynamic shared memory in bytes, as preds_smem in ops/interp_cuda.py
// computes it.
int sr_eval_preds(const int* prog, int prog_ld, const float* vals, const int* optab, int n_ops,
                  const float* X, long long ldx, int P, int N, int R, int threads, int rpt,
                  int tpb, int rows_per_chunk, int n_chunks, size_t smem, float* preds,
                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define SR_ARGS \
  prog, prog_ld, vals, optab, n_ops, X, ldx, P, N, R, threads, tpb, rows_per_chunk, n_chunks, \
      smem, preds, s
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
