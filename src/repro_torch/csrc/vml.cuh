// Vecmathlib (paper §5) per work-item in CUDA C: the functions that the
// cuda work-group target (repro_torch/core/targets/cuda_target.py) calls for
// exp, log, sin, cos, tanh, erf, sqrt and rsqrt when a program is built with
// use_vml=True.  They replace CUDA's libm (expf, sinf, ...) in the Hopper
// counterpart of src/repro/core/targets/pallas_target.py's
// PallasWGProgram.run_ndrange, whose kernel body computed the vml
// polynomials of src/repro/vml/core.py.
//
// Each function follows repro_torch/vml/core.py operation by operation, so
// on the same float32 inputs it gives the same bits as the torch vector
// target with use_vml=True on the card:
//   * the kernels are built with -fmad=false and IEEE division, so every
//     product, sum and quotient rounds once, as each torch operation does;
//   * constants are the float32 values the reference's Python floats round
//     to, written as hex literals;
//   * rounding is rintf (half to even, as jnp.round and torch.round);
//     floor division by 2 is an arithmetic shift and floor modulo by 2 and
//     4 a mask (a truncating % picks the wrong quadrant for x < -pi/4);
//   * float-to-int32 conversion saturates and maps NaN to 0 (wg_f2i), and
//     int32 arithmetic wraps (wg_iadd, wg_isub);
//   * clamps let NaN through, as torch.clamp and jnp.clip do;
//   * a NaN constant is 0x7fc00000, as torch.full_like(x, nan) makes it.
// What bounds a kernel that calls them: device-memory bytes (one float in,
// one out) for every function but sin and cos at large arguments, where the
// FP32 operations (some 40 a call, none fused) come close to it.
#pragma once

#include "wg_runtime.cuh"

#define VML_INF __int_as_float(0x7f800000)
#define VML_NAN __int_as_float(0x7fc00000)

// torch.clamp(x, lo, hi): NaN passes through unchanged
__device__ __forceinline__ float vml_clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// vml.poly.horner: coefficients highest first, one multiply and one add a
// step
template <int N>
__device__ __forceinline__ float vml_horner(float x, const float (&c)[N]) {
  float acc = c[0];
#pragma unroll
  for (int i = 1; i < N; ++i) acc = acc * x + c[i];
  return acc;
}

__device__ __forceinline__ float vml_fabs(float x) {
  return __int_as_float(__float_as_int(x) & 0x7FFFFFFF);
}

__device__ __forceinline__ float vml_copysign(float x, float s) {
  return __int_as_float((__float_as_int(x) & 0x7FFFFFFF) |
                        (__float_as_int(s) & (int)0x80000000));
}

// x * 2^k in two exponent-field steps (vml.core._ldexp_f32)
__device__ __forceinline__ float vml_ldexp(float x, int k) {
  const int k1 = k >> 1;  // floor division by 2
  const int k2 = wg_isub(k, k1);
  const float f1 = __int_as_float((int)((unsigned)wg_iadd(k1, 127) << 23));
  const float f2 = __int_as_float((int)((unsigned)wg_iadd(k2, 127) << 23));
  return x * f1 * f2;
}

__device__ __forceinline__ float vml_exp(float x) {
  const float c[6] = {0x1.a0d2cep-13f, 0x1.6e879cp-10f, 0x1.111210p-7f,
                      0x1.555382p-5f, 0x1.555554p-3f, 0x1.000000p-1f};
  const float xc = vml_clamp(x, -0x1.5d3334p+6f, 0x1.62e148p+6f);  // -87.3, 88.72
  const float k = rintf(xc * 0x1.715476p+0f);                       // 1/ln2
  const int ki = wg_f2i(k);
  // Cody–Waite: r = x - k*ln2 in two pieces
  float r = xc - k * 0x1.630000p-1f;
  r = r - k * -0x1.bd0106p-13f;
  const float p = vml_horner(r, c);
  const float er = 1.0f + r + r * r * p;
  float y = vml_ldexp(er, ki);
  y = x >= 0x1.62e148p+6f ? VML_INF : y;
  y = x <= -0x1.5d3334p+6f ? 0.0f : y;
  return x != x ? VML_NAN : y;
}

__device__ __forceinline__ float vml_log(float x) {
  const float c[5] = {0x1.c71c72p-4f, 0x1.24924ap-3f, 0x1.99999ap-3f,
                      0x1.555556p-2f, 1.0f};
  // frexp of max(x, 1e-45): mantissa in [sqrt(2)/2, sqrt(2)), exponent
  const float xm = x != x ? x : fmaxf(x, __int_as_float(1));
  const int bits = __float_as_int(xm);
  int e = ((bits >> 23) & 0xFF) - 127;
  float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  const bool big = m > 0x1.6a09e6p+0f;
  m = big ? m * 0.5f : m;
  e = e + (big ? 1 : 0);
  const float f = m - 1.0f;
  const float s = f / (2.0f + f);
  const float z = s * s;
  const float r = 2.0f * s * vml_horner(z, c);
  float y = r + (float)e * 0x1.62e430p-1f;  // ln2
  y = x > 0.0f ? y : (x == 0.0f ? -VML_INF : VML_NAN);
  return (isinf(x) && x > 0.0f) ? VML_INF : y;
}

__device__ __forceinline__ float vml_sin_core(float r) {
  const float c[3] = {-0x1.9943f2p-13f, 0x1.11073cp-7f, -0x1.555546p-3f};
  const float z = r * r;
  return r + r * z * vml_horner(z, c);
}

__device__ __forceinline__ float vml_cos_core(float r) {
  const float c[3] = {0x1.99eb9cp-16f, -0x1.6c0c34p-10f, 0x1.55554ap-5f};
  const float z = r * r;
  return 1.0f - 0.5f * z + z * z * vml_horner(z, c);
}

// r in [-pi/4, pi/4] and the quadrant q, Cody–Waite in three pieces
__device__ __forceinline__ float vml_sincos_reduce(float x, int* q) {
  const float qf = rintf(x * 0x1.45f306p-1f);  // 2/pi
  *q = wg_f2i(qf);
  float r = x - qf * 0x1.921f00p+0f;
  r = r - qf * 0x1.6a8886p-17f;
  return r - qf * 0x1.0b4600p-34f;
}

__device__ __forceinline__ float vml_sin(float x) {
  int q;
  const float r = vml_sincos_reduce(x, &q);
  const float sc = (q & 1) == 0 ? vml_sin_core(r) : vml_cos_core(r);
  const float sign = (q & 3) >= 2 ? -1.0f : 1.0f;
  return sign * sc;
}

__device__ __forceinline__ float vml_cos(float x) {
  int q;
  const float r = vml_sincos_reduce(x, &q);
  const float sc = (q & 1) == 0 ? vml_cos_core(r) : vml_sin_core(r);
  const float sign = (wg_iadd(q, 1) & 3) >= 2 ? -1.0f : 1.0f;
  return sign * sc;
}

__device__ __forceinline__ float vml_tanh(float x) {
  // tanh(x) = (e^{2x} - 1) / (e^{2x} + 1), |x| > 9 saturates in f32
  const float e2 = vml_exp(2.0f * vml_clamp(x, -9.0f, 9.0f));
  return (e2 - 1.0f) / (e2 + 1.0f);
}

__device__ __forceinline__ float vml_erf(float x) {
  // Abramowitz & Stegun 7.1.26
  const float c[5] = {0x1.0fb844p+0f, -0x1.7401c6p+0f, 0x1.6be1c6p+0f,
                      -0x1.23531cp-2f, 0x1.04f20cp-2f};
  const float a = vml_fabs(x);
  const float t = 1.0f / (1.0f + 0x1.4f740ap-2f * a);
  const float y = 1.0f - vml_horner(t, c) * t * vml_exp((-a) * a);
  return vml_copysign(y, x);
}

__device__ __forceinline__ float vml_sqrt(float x) {
  // halve the exponent with an integer shift, then three Newton steps
  float r = __int_as_float(wg_iadd(__float_as_int(x) >> 1, 0x1FC00000));
#pragma unroll
  for (int i = 0; i < 3; ++i) r = 0.5f * (r + x / r);
  r = x > 0.0f ? r : (x == 0.0f ? 0.0f : VML_NAN);
  return (isinf(x) && x > 0.0f) ? VML_INF : r;
}

__device__ __forceinline__ float vml_rsqrt(float x) {
  // the magic-constant guess, then three Newton steps
  float y = __int_as_float(wg_isub(0x5F3759DF, __float_as_int(x) >> 1));
#pragma unroll
  for (int i = 0; i < 3; ++i) y = y * (1.5f - 0.5f * x * y * y);
  y = x > 0.0f ? y : (x == 0.0f ? VML_INF : VML_NAN);
  return (isinf(x) && x > 0.0f) ? 0.0f : y;
}
