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
// Every operator follows the semantics of its torch `fn` in ops/operators.py
// (IEEE f32 arithmetic, CUDA libm), not the TPU kernel's Mosaic variants.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SR_HD __host__ __device__ __forceinline__

namespace {

constexpr int kUnaryBuiltins = 31;
constexpr int kRedSlots = 3 * 32;  // 3 partials x up to 32 warps
constexpr float kPi = 3.14159265358979323846f;
constexpr float kLog2 = 0.693147180559945309f;
constexpr float kLog4 = 1.38629436111989061f;

SR_HD bool sr_isnan(float x) { return x != x; }
SR_HD bool sr_isfinite(float x) { return (x - x) == 0.0f; }
SR_HD float sr_nan() { return NAN; }

// max(v, 0) propagating NaN, like torch.maximum / jnp.maximum
SR_HD float sr_relu0(float v) { return sr_isnan(v) ? v : (v > 0.0f ? v : 0.0f); }

// floored modulo with the sign of y (Julia mod, jnp.mod)
SR_HD float sr_mod(float x, float y) {
  float r = fmodf(x, y);
  if ((r < 0.0f) != (y < 0.0f) && r != 0.0f) r += y;
  return r;
}

SR_HD float sr_gamma(float x) {
  const float ax = x < 0.0f ? 1.0f - x : x;
  const float pos = expf(lgammaf(ax > 0.0f ? ax : 1.0f));
  const float sin_pix = sinf(kPi * x);
  const float refl = kPi / (sin_pix * pos);
  float out = x < 0.0f ? refl : expf(lgammaf(x > 0.0f ? x : 1.0f));
  if (x == floorf(x)) out = x > 0.0f ? out : sr_nan();
  if (sr_isnan(x)) out = sr_nan();
  return sr_isfinite(out) ? out : sr_nan();
}

SR_HD float sr_pow(float x, float y) {
  const float yi = rintf(y);
  const bool y_is_int = (y == yi);
  const bool invalid =
      y_is_int ? (yi < 0.0f && x == 0.0f) : (y > 0.0f ? x < 0.0f : x <= 0.0f);
  const float ax = fabsf(x);
  const float ax_safe = (invalid || ax == 0.0f) ? 1.0f : ax;
  const float mag = (ax == 0.0f) ? (y == 0.0f ? 1.0f : 0.0f) : powf(ax_safe, y);
  const bool odd = sr_mod(fabsf(yi), 2.0f) == 1.0f;
  const float s = (x < 0.0f && odd) ? -mag : mag;
  return invalid ? sr_nan() : s;
}

// ids follow BUILTIN_UNARY in ops/operators.py
SR_HD float sr_unary(int id, float x) {
  switch (id) {
    case 0: return -x;                                                   // neg
    case 1: return x * x;                                                // square
    case 2: return x * x * x;                                            // cube
    case 3: return expf(x);                                              // exp
    case 4: return fabsf(x);                                             // abs
    case 5: return x <= 0.0f ? sr_nan() : logf(x);                       // log
    case 6: return x <= 0.0f ? sr_nan() : log2f(x);                      // log2
    case 7: return x <= 0.0f ? sr_nan() : log10f(x);                     // log10
    case 8: return x <= -1.0f ? sr_nan() : log1pf(x);                    // log1p
    case 9: return x < 0.0f ? sr_nan() : sqrtf(x);                       // sqrt
    case 10: return sinf(x);                                             // sin
    case 11: return cosf(x);                                             // cos
    case 12: return tanf(x);                                             // tan
    case 13: return sinhf(x);                                            // sinh
    case 14: return coshf(x);                                            // cosh
    case 15: return tanhf(x);                                            // tanh
    case 16: return fabsf(x) > 1.0f ? sr_nan() : asinf(x);               // asin
    case 17: return fabsf(x) > 1.0f ? sr_nan() : acosf(x);               // acos
    case 18: return atanf(x);                                            // atan
    case 19: return asinhf(x);                                           // asinh
    case 20: return x < 1.0f ? sr_nan() : acoshf(x);                     // acosh
    case 21: return fabsf(x) >= 1.0f ? sr_nan() : atanhf(x);             // atanh
    case 22: {                                                           // atanh_clip
      const float wv = sr_mod(x + 1.0f, 2.0f) - 1.0f;
      return fabsf(wv) >= 1.0f ? sr_nan() : atanhf(wv);
    }
    case 23: return erff(x);                                             // erf
    case 24: return erfcf(x);                                            // erfc
    case 25: return sr_gamma(x);                                         // gamma
    case 26: return x > 0.0f ? x : 0.0f;                                 // relu
    case 27: return rintf(x);                                            // round
    case 28: return floorf(x);                                           // floor
    case 29: return ceilf(x);                                            // ceil
    case 30: return sr_isnan(x) ? x : (x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x));  // sign
    default: return sr_nan();
  }
}

// ids follow BUILTIN_BINARY in ops/operators.py
SR_HD float sr_binary(int id, float x, float y) {
  switch (id) {
    case 0: return x + y;                                                // add
    case 1: return x - y;                                                // sub
    case 2: return x * y;                                                // mult
    case 3: return x / y;                                                // div
    case 4: return sr_pow(x, y);                                         // pow
    case 5: return sr_mod(x, y);                                         // mod
    case 6: return x > y ? 1.0f : 0.0f;                                  // greater
    case 7: return x > 0.0f ? y : 0.0f;                                  // cond
    case 8: return (x > 0.0f || y > 0.0f) ? 1.0f : 0.0f;                 // logical_or
    case 9: return (x > 0.0f && y > 0.0f) ? 1.0f : 0.0f;                 // logical_and
    case 10: return (sr_isnan(x) || sr_isnan(y)) ? sr_nan() : fmaxf(x, y);  // max
    case 11: return (sr_isnan(x) || sr_isnan(y)) ? sr_nan() : fminf(x, y);  // min
    default: return sr_nan();
  }
}

// ids follow KERNEL_LOSS_IDS in ops/losses.py; q holds the loss's params
SR_HD float sr_loss(int id, float p, float t, const float* q) {
  const float a = p * t;  // margin-loss agreement
  switch (id) {
    case 0: { const float d = p - t; return d * d; }                     // L2Dist
    case 1: return fabsf(p - t);                                         // L1Dist
    case 2: return sr_relu0(p) - p * t + log1pf(expf(-fabsf(p)));        // Logistic
    case 3: { const float d = p - t; return -kLog4 - d + 2.0f * log1pf(expf(d)); }  // LogitDist
    case 4: { const float e = fabsf(p - t); return e + log1pf(expf(-2.0f * e)) - kLog2; }  // LogCosh
    case 5: return a < 0.0f ? 1.0f : 0.0f;                               // ZeroOne
    case 6: return sr_relu0(-a);                                         // Perceptron
    case 7: return sr_relu0(1.0f - a);                                   // L1Hinge
    case 8: { const float h = sr_relu0(1.0f - a); return h * h; }        // L2Hinge
    case 9: return expf(-a);                                             // Exp
    case 10: return 1.0f - tanhf(a);                                     // Sigmoid
    case 11: { const float h = 1.0f - a; return h * h; }                 // L2Margin
    case 12: { const float h = sr_relu0(1.0f - a); return a >= -1.0f ? h * h : -4.0f * a; }  // ModifiedHuber
    case 13: return log1pf(expf(-a));                                    // LogitMargin
    case 14: {                                                           // Huber(d): q = d, d/2
      const float e = fabsf(p - t);
      return e <= q[0] ? 0.5f * e * e : q[0] * (e - q[1]);
    }
    case 15: return sr_relu0(fabsf(p - t) - q[0]);                       // L1EpsilonIns(eps)
    case 16: { const float e = sr_relu0(fabsf(p - t) - q[0]); return e * e; }  // L2EpsilonIns(eps)
    case 17: { const float s = sinf(kPi * (p - t) / q[0]); return 2.0f * (s * s); }  // Periodic(c)
    case 18: { const float d = t - p; return d >= 0.0f ? q[0] * d : q[1] * d; }  // Quantile: tau, tau-1
    case 19: {                                                           // SmoothedL1Hinge: 1-g, 2g, 1-g/2
      const float h = sr_relu0(1.0f - a);
      return a >= q[0] ? (h * h) / q[1] : q[2] - a;
    }
    case 20:                                                             // DWDMargin: q, q/(q+1), const
      return a <= q[1] ? 1.0f - a : q[2] / powf(a > 0.0f ? a : 1.0f, q[0]);
    case 21: return powf(fabsf(p - t), q[0]);                            // LPDist(p)
    default: return sr_nan();
  }
}

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
    float pred = sr_nan();  // an empty program has no root
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
        if (b < kUnaryBuiltins) {
          v = sr_unary(b, l);
        } else {
          v = sr_binary(b - kUnaryBuiltins, l, buf[sprog[2 * N + i] * nt + tid]);
        }
      }
      buf[i * nt + tid] = v;
      pred = v;  // the last slot written is the root, slot length-1
    }
    const float wt = w ? w[r] : 1.0f;
    if (!sr_isfinite(pred)) acc_n += 1.0;
    acc_l += (double)(sr_loss(loss_id, pred, y[r], q) * wt);
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
