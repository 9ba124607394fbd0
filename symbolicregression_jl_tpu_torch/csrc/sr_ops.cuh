// Operators and losses of the fused kernels (fused_loss.cu, fused_loss_grad.cu),
// with their derivatives.
//
// Forward: every operator follows the semantics of its torch `fn` in
// ops/operators.py (IEEE f32 arithmetic, CUDA libm), and every loss the
// closure of the same name in ops/losses.py; not the TPU kernel's Mosaic
// variants.
//
// Derivatives: each *_grad function returns what torch autograd computes
// for the op's torch `fn` (or the loss closure) given the output adjoint g,
// node by node through the fn's own graph: masked `where` branches pass a
// zero adjoint that is still multiplied through their formulas, so where
// autograd yields 0 * inf = NaN (a guard's dead branch, gamma's reflection
// at large |x|) these do too, and non-finite gradients land on the same
// rows as in the plain version (ops/interp.py's reverse sweep).
//
// Everything here is __host__ __device__ so the same source also compiles
// as plain C++ for the host (tests/test_torch_lossgrad.py compares it with
// torch autograd on the CPU).

#pragma once

#include <math.h>

#ifndef SR_HD
#define SR_HD __host__ __device__ __forceinline__
#endif

namespace sr {

constexpr int kUnaryBuiltins = 31;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kLog2 = 0.693147180559945309f;
constexpr float kLog4 = 1.38629436111989061f;
constexpr float kLn10 = 2.30258509299404568f;
constexpr float kTwoOverSqrtPi = 1.12837916709551257f;

SR_HD bool isnan_(float x) { return x != x; }
SR_HD bool isfinite_(float x) { return (x - x) == 0.0f; }
SR_HD float nan_() { return NAN; }

// max(v, 0) propagating NaN, like torch.maximum / jnp.maximum
SR_HD float relu0(float v) { return isnan_(v) ? v : (v > 0.0f ? v : 0.0f); }

// torch.sign / sgn of a real: NaN -> 0
SR_HD float sgn(float x) { return (float)(0.0f < x) - (float)(x < 0.0f); }

// adjoint of v through torch.maximum(v, zeros): ties split, NaN passes
SR_HD float relu0_grad(float v, float g) {
  return v < 0.0f ? 0.0f : (v == 0.0f ? g / 2.0f : g);
}

// floored modulo with the sign of y (Julia mod, jnp.mod)
SR_HD float mod_(float x, float y) {
  float r = fmodf(x, y);
  if ((r < 0.0f) != (y < 0.0f) && r != 0.0f) r += y;
  return r;
}

SR_HD float gamma_(float x) {
  const float ax = x < 0.0f ? 1.0f - x : x;
  const float pos = expf(lgammaf(ax > 0.0f ? ax : 1.0f));
  const float sin_pix = sinf(kPi * x);
  // torch evaluates the plain version's `pi / den` as reciprocal(den) * pi
  // (Tensor.__rtruediv__); a true division would differ by an ulp
  const float refl = (1.0f / (sin_pix * pos)) * kPi;
  float out = x < 0.0f ? refl : expf(lgammaf(x > 0.0f ? x : 1.0f));
  if (x == floorf(x)) out = x > 0.0f ? out : nan_();
  if (isnan_(x)) out = nan_();
  return isfinite_(out) ? out : nan_();
}

// torch's float digamma (aten/src/ATen/native/Math.h calc_digamma), for the
// arguments gamma_grad passes: x > 0 or x == 0
SR_HD float digamma_(float x) {
  if (x == 0.0f) return copysignf(INFINITY, -x);
  float result = 0.0f;
  while (x < 10.0f) {
    result -= 1.0f / x;
    x += 1.0f;
  }
  if (x == 10.0f) return result + 2.25175258906672110764f;
  float y = 0.0f;
  if (x < 1.0e17f) {
    const float z = 1.0f / (x * x);
    float p = 0.0f;
    p = p * z + 8.33333333333333333333E-2f;
    p = p * z + -2.10927960927960927961E-2f;
    p = p * z + 7.57575757575757575758E-3f;
    p = p * z + -4.16666666666666666667E-3f;
    p = p * z + 3.96825396825396825397E-3f;
    p = p * z + -8.33333333333333333333E-3f;
    p = p * z + 8.33333333333333333333E-2f;
    y = z * p;
  }
  return result + logf(x) - (0.5f / x) - y;
}

SR_HD float pow_(float x, float y) {
  const float yi = rintf(y);
  const bool y_is_int = (y == yi);
  const bool invalid =
      y_is_int ? (yi < 0.0f && x == 0.0f) : (y > 0.0f ? x < 0.0f : x <= 0.0f);
  const float ax = fabsf(x);
  const float ax_safe = (invalid || ax == 0.0f) ? 1.0f : ax;
  const float mag = (ax == 0.0f) ? (y == 0.0f ? 1.0f : 0.0f) : powf(ax_safe, y);
  const bool odd = mod_(fabsf(yi), 2.0f) == 1.0f;
  const float s = (x < 0.0f && odd) ? -mag : mag;
  return invalid ? nan_() : s;
}

// ids follow BUILTIN_UNARY in ops/operators.py
SR_HD float unary(int id, float x) {
  switch (id) {
    case 0: return -x;                                                   // neg
    case 1: return x * x;                                                // square
    case 2: return x * x * x;                                            // cube
    case 3: return expf(x);                                              // exp
    case 4: return fabsf(x);                                             // abs
    case 5: return x <= 0.0f ? nan_() : logf(x);                         // log
    case 6: return x <= 0.0f ? nan_() : log2f(x);                        // log2
    case 7: return x <= 0.0f ? nan_() : log10f(x);                       // log10
    case 8: return x <= -1.0f ? nan_() : log1pf(x);                      // log1p
    case 9: return x < 0.0f ? nan_() : sqrtf(x);                         // sqrt
    case 10: return sinf(x);                                             // sin
    case 11: return cosf(x);                                             // cos
    case 12: return tanf(x);                                             // tan
    case 13: return sinhf(x);                                            // sinh
    case 14: return coshf(x);                                            // cosh
    case 15: return tanhf(x);                                            // tanh
    case 16: return fabsf(x) > 1.0f ? nan_() : asinf(x);                 // asin
    case 17: return fabsf(x) > 1.0f ? nan_() : acosf(x);                 // acos
    case 18: return atanf(x);                                            // atan
    case 19: return asinhf(x);                                           // asinh
    case 20: return x < 1.0f ? nan_() : acoshf(x);                       // acosh
    case 21: return fabsf(x) >= 1.0f ? nan_() : atanhf(x);               // atanh
    case 22: {                                                           // atanh_clip
      const float wv = mod_(x + 1.0f, 2.0f) - 1.0f;
      return fabsf(wv) >= 1.0f ? nan_() : atanhf(wv);
    }
    case 23: return erff(x);                                             // erf
    case 24: return erfcf(x);                                            // erfc
    case 25: return gamma_(x);                                           // gamma
    case 26: return x > 0.0f ? x : 0.0f;                                 // relu
    case 27: return rintf(x);                                            // round
    case 28: return floorf(x);                                           // floor
    case 29: return ceilf(x);                                            // ceil
    case 30: return isnan_(x) ? x : (x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x));  // sign
    default: return nan_();
  }
}

// ids follow BUILTIN_BINARY in ops/operators.py
SR_HD float binary(int id, float x, float y) {
  switch (id) {
    case 0: return x + y;                                                // add
    case 1: return x - y;                                                // sub
    case 2: return x * y;                                                // mult
    case 3: return x / y;                                                // div
    case 4: return pow_(x, y);                                           // pow
    case 5: return mod_(x, y);                                           // mod
    case 6: return x > y ? 1.0f : 0.0f;                                  // greater
    case 7: return x > 0.0f ? y : 0.0f;                                  // cond
    case 8: return (x > 0.0f || y > 0.0f) ? 1.0f : 0.0f;                 // logical_or
    case 9: return (x > 0.0f && y > 0.0f) ? 1.0f : 0.0f;                 // logical_and
    case 10: return (isnan_(x) || isnan_(y)) ? nan_() : fmaxf(x, y);     // max
    case 11: return (isnan_(x) || isnan_(y)) ? nan_() : fminf(x, y);     // min
    default: return nan_();
  }
}

// ids follow KERNEL_LOSS_IDS in ops/losses.py; q holds the loss's params
SR_HD float loss(int id, float p, float t, const float* q) {
  const float a = p * t;  // margin-loss agreement
  switch (id) {
    case 0: { const float d = p - t; return d * d; }                     // L2Dist
    case 1: return fabsf(p - t);                                         // L1Dist
    case 2: return relu0(p) - p * t + log1pf(expf(-fabsf(p)));           // Logistic
    case 3: { const float d = p - t; return -kLog4 - d + 2.0f * log1pf(expf(d)); }  // LogitDist
    case 4: { const float e = fabsf(p - t); return e + log1pf(expf(-2.0f * e)) - kLog2; }  // LogCosh
    case 5: return a < 0.0f ? 1.0f : 0.0f;                               // ZeroOne
    case 6: return relu0(-a);                                            // Perceptron
    case 7: return relu0(1.0f - a);                                      // L1Hinge
    case 8: { const float h = relu0(1.0f - a); return h * h; }           // L2Hinge
    case 9: return expf(-a);                                             // Exp
    case 10: return 1.0f - tanhf(a);                                     // Sigmoid
    case 11: { const float h = 1.0f - a; return h * h; }                 // L2Margin
    case 12: { const float h = relu0(1.0f - a); return a >= -1.0f ? h * h : -4.0f * a; }  // ModifiedHuber
    case 13: return log1pf(expf(-a));                                    // LogitMargin
    case 14: {                                                           // Huber(d): q = d, d/2
      const float e = fabsf(p - t);
      return e <= q[0] ? 0.5f * e * e : q[0] * (e - q[1]);
    }
    case 15: return relu0(fabsf(p - t) - q[0]);                          // L1EpsilonIns(eps)
    case 16: { const float e = relu0(fabsf(p - t) - q[0]); return e * e; }  // L2EpsilonIns(eps)
    case 17: { const float s = sinf(kPi * (p - t) / q[0]); return 2.0f * (s * s); }  // Periodic(c)
    case 18: { const float d = t - p; return d >= 0.0f ? q[0] * d : q[1] * d; }  // Quantile: tau, tau-1
    case 19: {                                                           // SmoothedL1Hinge: 1-g, 2g, 1-g/2
      const float h = relu0(1.0f - a);
      return a >= q[0] ? (h * h) / q[1] : q[2] - a;
    }
    case 20:                                                             // DWDMargin: q, q/(q+1), const
      return a <= q[1] ? 1.0f - a : q[2] / powf(a > 0.0f ? a : 1.0f, q[0]);
    case 21: return powf(fabsf(p - t), q[0]);                            // LPDist(p)
    default: return nan_();
  }
}

// -- derivatives ---------------------------------------------------------------

// gamma_full's graph (ops/operators.py), forward then backward node by node
SR_HD float gamma_grad(float x, float g) {
  const float ax = x < 0.0f ? 1.0f - x : x;
  const float u1 = ax > 0.0f ? ax : 1.0f;
  const float pos = expf(lgammaf(u1));
  const float pix = kPi * x;
  const float s = sinf(pix);
  const float rcp = 1.0f / (s * pos);  // pi / den is reciprocal(den) * pi
  const float refl = rcp * kPi;
  const float u2 = x > 0.0f ? x : 1.0f;
  const float e2 = expf(lgammaf(u2));
  const float o1 = x < 0.0f ? refl : e2;
  const bool is_int = x == floorf(x);
  const float o2 = is_int ? (x > 0.0f ? o1 : nan_()) : o1;
  const float o3 = isnan_(x) ? nan_() : o2;
  const float g2 = isnan_(x) ? 0.0f : (isfinite_(o3) ? g : 0.0f);
  const float go1 = is_int ? (x > 0.0f ? g2 : 0.0f) : g2;
  const float grefl = x < 0.0f ? go1 : 0.0f;
  const float ge2 = x < 0.0f ? 0.0f : go1;
  float gx = x > 0.0f ? (ge2 * e2) * digamma_(u2) : 0.0f;
  const float gden = -(grefl * kPi) * (rcp * rcp);
  gx += ((gden * pos) * cosf(pix)) * kPi;
  const float gu1 = ((gden * s) * pos) * digamma_(u1);
  const float gax = ax > 0.0f ? gu1 : 0.0f;
  gx += x < 0.0f ? -gax : gax;
  return gx;
}

// adjoint of x for unary op `id` at input x, output adjoint g
SR_HD float unary_grad(int id, float x, float g) {
  switch (id) {
    case 0: return -g;                                                   // neg
    case 1: return g * x + g * x;                                        // square: x * x
    case 2: {                                                            // cube: (x * x) * x
      const float gt = g * x;
      return g * (x * x) + (gt * x + gt * x);
    }
    case 3: return g * expf(x);                                          // exp
    case 4: return g * sgn(x);                                           // abs
    case 5: return x <= 0.0f ? 0.0f : g / x;                             // log
    case 6: return x <= 0.0f ? 0.0f : g / (x * kLog2);                   // log2
    case 7: return x <= 0.0f ? 0.0f : g / (x * kLn10);                   // log10
    case 8: return x <= -1.0f ? 0.0f : g / (x + 1.0f);                   // log1p
    case 9: return x < 0.0f ? 0.0f : g / (2.0f * sqrtf(x));              // sqrt
    case 10: return g * cosf(x);                                         // sin
    case 11: return g * -sinf(x);                                        // cos
    case 12: { const float r = tanf(x); return g * (1.0f + r * r); }     // tan
    case 13: return g * coshf(x);                                        // sinh
    case 14: return g * sinhf(x);                                        // cosh
    case 15: { const float r = tanhf(x); return g * (1.0f - r * r); }    // tanh
    case 16: return fabsf(x) > 1.0f ? 0.0f : g * (1.0f / sqrtf(-x * x + 1.0f));  // asin
    case 17: return fabsf(x) > 1.0f ? 0.0f : g * -(1.0f / sqrtf(-x * x + 1.0f));  // acos
    case 18: return g / (x * x + 1.0f);                                  // atan
    case 19: return g * (1.0f / sqrtf(x * x + 1.0f));                    // asinh
    case 20: return x < 1.0f ? 0.0f : g * (1.0f / sqrtf(x * x - 1.0f));  // acosh
    case 21: return fabsf(x) >= 1.0f ? 0.0f : (g * 1.0f) / (1.0f - x * x);  // atanh
    case 22: {                                                           // atanh_clip: d mod/dx = 1
      const float wv = mod_(x + 1.0f, 2.0f) - 1.0f;
      return fabsf(wv) >= 1.0f ? 0.0f : (g * 1.0f) / (1.0f - wv * wv);
    }
    case 23: return (kTwoOverSqrtPi * expf(-(x * x))) * g;               // erf
    case 24: return (-kTwoOverSqrtPi * expf(-(x * x))) * g;              // erfc
    case 25: return gamma_grad(x, g);                                    // gamma
    case 26: return x > 0.0f ? g : 0.0f;                                 // relu
    default: return 0.0f;                                                // round floor ceil sign
  }
}

// adjoints (dx, dy) of binary op `id` at (x, y), output adjoint g
SR_HD void binary_grad(int id, float x, float y, float g, float* dx, float* dy) {
  switch (id) {
    case 0: *dx = g; *dy = g; return;                                    // add
    case 1: *dx = g; *dy = -g; return;                                   // sub
    case 2: *dx = g * y; *dy = g * x; return;                            // mult
    case 3: *dx = g / y; *dy = -g * ((x / y) / y); return;               // div
    case 4: {                                                            // pow: safe_pow's graph
      const float yi = rintf(y);
      const bool invalid =
          (y == yi) ? (yi < 0.0f && x == 0.0f) : (y > 0.0f ? x < 0.0f : x <= 0.0f);
      const float ax = fabsf(x);
      const bool unsafe = invalid || ax == 0.0f;
      const float ax_safe = unsafe ? 1.0f : ax;
      const bool odd = mod_(fabsf(yi), 2.0f) == 1.0f;
      const float gs = invalid ? 0.0f : g;
      const float gmag = (x < 0.0f && odd) ? -gs : gs;
      const float gp = ax == 0.0f ? 0.0f : gmag;
      const float gbase = y == 0.0f ? 0.0f : gp * (y * powf(ax_safe, y - 1.0f));
      *dx = (unsafe ? 0.0f : gbase) * sgn(x);
      *dy = gp * (powf(ax_safe, y) * logf(ax_safe));
      return;
    }
    case 5: {                                                            // mod: where(shift, r + y, r)
      const float r = fmodf(x, y);
      const bool shift = ((r < 0.0f) != (y < 0.0f)) && r != 0.0f;
      *dx = g;
      *dy = (shift ? g : 0.0f) + -g * truncf(x / y);
      return;
    }
    case 7: *dx = 0.0f; *dy = x > 0.0f ? g : 0.0f; return;               // cond
    case 10: {                                                           // max
      const float h = x == y ? g / 2.0f : g;
      *dx = x < y ? 0.0f : h;
      *dy = x > y ? 0.0f : h;
      return;
    }
    case 11: {                                                           // min
      const float h = x == y ? g / 2.0f : g;
      *dx = x > y ? 0.0f : h;
      *dy = x < y ? 0.0f : h;
      return;
    }
    default: *dx = 0.0f; *dy = 0.0f; return;                             // greater, logical_*
  }
}

// adjoint of the prediction p for loss `id` at (p, t), output adjoint g
// (the row's weight)
SR_HD float loss_grad(int id, float p, float t, const float* q, float g) {
  const float a = p * t;
  switch (id) {
    case 0: { const float gd = g * (p - t); return gd + gd; }            // L2Dist: d * d
    case 1: return g * sgn(p - t);                                       // L1Dist
    case 2: {                                                            // Logistic
      const float e = expf(-fabsf(p));
      const float gc = -((g / (e + 1.0f)) * e) * sgn(p);
      return relu0_grad(p, g) + -g * t + gc;
    }
    case 3: {                                                            // LogitDist
      const float e = expf(p - t);
      return -g + ((g * 2.0f) / (e + 1.0f)) * e;
    }
    case 4: {                                                            // LogCosh
      const float d = p - t;
      const float e = expf(-2.0f * fabsf(d));
      return (g + ((g / (e + 1.0f)) * e) * -2.0f) * sgn(d);
    }
    case 6: return -relu0_grad(-a, g) * t;                               // Perceptron
    case 7: return -relu0_grad(1.0f - a, g) * t;                         // L1Hinge
    case 8: {                                                            // L2Hinge
      const float u = 1.0f - a;
      return -relu0_grad(u, g * (2.0f * relu0(u))) * t;
    }
    case 9: return -(g * expf(-a)) * t;                                  // Exp
    case 10: { const float r = tanhf(a); return (-g * (1.0f - r * r)) * t; }  // Sigmoid
    case 11: return -(g * (2.0f * (1.0f - a))) * t;                      // L2Margin
    case 12: {                                                           // ModifiedHuber
      const bool c = a >= -1.0f;
      const float u = 1.0f - a;
      const float ga = -relu0_grad(u, (c ? g : 0.0f) * (2.0f * relu0(u)));
      return (ga + (c ? 0.0f : g) * -4.0f) * t;
    }
    case 13: {                                                           // LogitMargin
      const float e = expf(-a);
      return -((g / (e + 1.0f)) * e) * t;
    }
    case 14: {                                                           // Huber
      const float d = p - t;
      const float e = fabsf(d);
      const bool c = e <= q[0];
      const float g1 = c ? g : 0.0f;
      const float m = 0.5f * e;
      return (g1 * m + (g1 * e) * 0.5f + (c ? 0.0f : g) * q[0]) * sgn(d);
    }
    case 15: { const float d = p - t; return relu0_grad(fabsf(d) - q[0], g) * sgn(d); }  // L1EpsilonIns
    case 16: {                                                           // L2EpsilonIns
      const float d = p - t;
      const float u = fabsf(d) - q[0];
      const float ge = g * relu0(u);
      return relu0_grad(u, ge + ge) * sgn(d);
    }
    case 17: {                                                           // Periodic
      const float u = kPi * (p - t) / q[0];
      const float gs = (g * 2.0f) * (2.0f * sinf(u));
      return ((gs * cosf(u)) / q[0]) * kPi;
    }
    case 18: {                                                           // Quantile
      const bool c = t - p >= 0.0f;
      return -((c ? g * q[0] : 0.0f) + (c ? 0.0f : g * q[1]));
    }
    case 19: {                                                           // SmoothedL1Hinge
      const bool c = a >= q[0];
      const float u = 1.0f - a;
      const float gh = ((c ? g : 0.0f) / q[1]) * (2.0f * relu0(u));
      return (-relu0_grad(u, gh) + -(c ? 0.0f : g)) * t;
    }
    case 20: {                                                           // DWDMargin
      const bool c = a <= q[1];
      const float safe = a > 0.0f ? a : 1.0f;
      const float rcp = 1.0f / powf(safe, q[0]);
      const float gS = -((c ? 0.0f : g) * q[2]) * (rcp * rcp);
      const float gsafe = q[0] == 0.0f ? 0.0f : gS * (q[0] * powf(safe, q[0] - 1.0f));
      return (-(c ? g : 0.0f) + (a > 0.0f ? gsafe : 0.0f)) * t;
    }
    case 21: {                                                           // LPDist
      const float d = p - t;
      const float ga = q[0] == 0.0f ? 0.0f : g * (q[0] * powf(fabsf(d), q[0] - 1.0f));
      return ga * sgn(d);
    }
    default: return 0.0f;                                                // ZeroOne
  }
}

}  // namespace sr
