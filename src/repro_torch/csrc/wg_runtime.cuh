// Work-group runtime for the kernels that repro_torch/core/targets/cuda_target.py
// emits: clamped loads, dropped stores, and integer and conversion helpers that
// reproduce the reference targets' (XLA's) semantics where C leaves them
// undefined or differs.  One thread block is one OpenCL work-group; a thread
// runs one or more of its work-items.
#pragma once

#include <cuda_runtime.h>

// Loads clamp the index into [0, n-1], as jnp.take(mode="clip") does.
template <typename T>
__device__ __forceinline__ T wg_ld(const T* p, long long n, long long i) {
  i = i < 0 ? 0 : (i >= n ? n - 1 : i);
  return p[i];
}

// Stores wrap an index in [-n, -1] to i + n and drop every other index
// outside [0, n), as a jnp .at[].set() scatter does.
template <typename T>
__device__ __forceinline__ void wg_st(T* p, long long n, long long i, T v) {
  if (i < 0) i += n;
  if (i >= 0 && i < n) p[i] = v;
}

// int32 arithmetic wraps on overflow (signed overflow is undefined in C).
__device__ __forceinline__ int wg_iadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wg_isub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wg_imul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wg_ineg(int a) { return (int)(0u - (unsigned)a); }
__device__ __forceinline__ int wg_iabs(int a) { return a < 0 ? wg_ineg(a) : a; }

// Truncating division: x / 0 == -1, INT_MIN / -1 == INT_MIN.
__device__ __forceinline__ int wg_idiv(int a, int b) {
  if (b == 0) return -1;
  if (b == -1) return wg_ineg(a);
  return a / b;
}

// Remainder with the dividend's sign: x % 0 == x, x % -1 == 0.
__device__ __forceinline__ int wg_irem(int a, int b) {
  if (b == 0) return a;
  if (b == -1) return 0;
  return a % b;
}

// Shifts by an amount outside [0, 31] give 0 (shl) or the sign fill (shr).
__device__ __forceinline__ int wg_shl(int a, int b) {
  return (unsigned)b >= 32u ? 0 : (int)((unsigned)a << b);
}
__device__ __forceinline__ int wg_shr(int a, int b) {
  return (unsigned)b >= 32u ? (a < 0 ? -1 : 0) : (a >> b);
}

// Integer power by squaring; a negative exponent gives 0 unless |a| == 1.
__device__ __forceinline__ int wg_ipow(int a, int b) {
  if (b < 0) return a == 1 ? 1 : (a == -1 ? ((b & 1) ? -1 : 1) : 0);
  unsigned r = 1u, x = (unsigned)a;
  while (b) {
    if (b & 1) r *= x;
    x *= x;
    b >>= 1;
  }
  return (int)r;
}

// float -> int32 saturates and maps NaN to 0.
__device__ __forceinline__ int wg_f2i(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x < -2147483648.0f) return -2147483647 - 1;
  return (int)x;
}

// min / max propagate NaN, as jnp.minimum / jnp.maximum do.
__device__ __forceinline__ float wg_fmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float wg_fmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
