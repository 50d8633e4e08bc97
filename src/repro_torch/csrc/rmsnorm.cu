// RMSNorm with Vecmathlib's Newton rsqrt, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py: rmsnorm (:31) ->
// _rmsnorm_kernel (:21), the pl.pallas_call at :42 that tiled the rows over
// the grid.
//
// What it computes, for each row of x (rows, d) in bf16 or f32, with a
// weight w (d,) in bf16 or f32:
//   var = mean(x * x) in f32;
//   r   = vml_rsqrt(var + eps): the magic constant 0x5F3759DF minus the
//         bits shifted right by one, then three Newton steps
//         y * (1.5 - 0.5 * x * y * y) (src/repro/vml/core.py:156-166);
//   out = (x * r * w) rounded to x's dtype.
//
// What bounds it on the H100: device-memory bytes.  It reads x and w and
// writes out once each, rows * d * (2 reads + 2 writes in the working type)
// + d * sizeof(w), and does about four operations per element, far below
// the ~295 operations per byte where the card stops being memory-bound.
//
// Design: one warp per row, eight rows per 256-thread block.  Each lane
// loads 16 bytes at a time where d allows it (neighbouring lanes on
// neighbouring addresses), squares and sums in f32; the warp reduces with
// xor shuffles so every lane holds the sum, computes the Newton rsqrt in
// registers, then makes a second pass over its row (served from L1/L2) to
// scale and store 16 bytes at a time.  Built with -fmad=false, so each
// multiply and add rounds once, as the reference's jnp code does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// vml.rsqrt (src/repro/vml/core.py:156): same operations, same order.
__device__ __forceinline__ float vml_rsqrt(float x) {
  float y = __int_as_float(0x5F3759DF - (__float_as_int(x) >> 1));
  for (int i = 0; i < 3; ++i) y = y * (1.5f - 0.5f * x * y * y);
  if (!(x > 0.0f)) {
    y = (x == 0.0f) ? __int_as_float(0x7f800000)    // +inf
                    : __int_as_float(0x7fc00000);   // nan
  } else if (isinf(x)) {
    y = 0.0f;
  }
  return y;
}

template <typename TX, typename TW, bool kVec>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ y, long long rows, int d, float eps) {
  constexpr int V = 16 / sizeof(TX);     // elements per 16-byte vector
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;               // whole warps leave together
  const TX* xr = x + row * d;
  TX* yr = y + row * d;

  float ss = 0.0f;
  if (kVec) {
    for (int i = lane * V; i < d; i += 32 * V) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const TX* e = reinterpret_cast<const TX*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float f = to_f(e[k]);
        ss = ss + f * f;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      float f = to_f(xr[i]);
      ss = ss + f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss = ss + __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = vml_rsqrt(ss / (float)d + eps);

  if (kVec) {
    for (int i = lane * V; i < d; i += 32 * V) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const TX* e = reinterpret_cast<const TX*>(&raw);
      uint4 packed;
      TX* o = reinterpret_cast<TX*>(&packed);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = from_f<TX>(to_f(e[k]) * r * to_f(w[i + k]));
      *reinterpret_cast<uint4*>(yr + i) = packed;
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      yr[i] = from_f<TX>(to_f(xr[i]) * r * to_f(w[i]));
    }
  }
}

template <typename TX, typename TW>
void launch_typed(const void* x, const void* w, void* y, long long rows, int d,
                  float eps, cudaStream_t stream) {
  const bool vec = d % (16 / (int)sizeof(TX)) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
  const dim3 block(32 * kRowsPerBlock);
  if (vec) {
    rmsnorm_kernel<TX, TW, true><<<grid, block, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w),
        static_cast<TX*>(y), rows, d, eps);
  } else {
    rmsnorm_kernel<TX, TW, false><<<grid, block, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w),
        static_cast<TX*>(y), rows, d, eps);
  }
}

}  // namespace

// x, y: (rows, d) contiguous, dtype code xdt; w: (d,) contiguous, dtype code
// wdt (0 = float32, 1 = bfloat16).  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y,
                              long long rows, int d, float eps, int xdt,
                              int wdt, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if ((rows + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xdt == 0 && wdt == 0) launch_typed<float, float>(x, w, y, rows, d, eps, s);
  else if (xdt == 0 && wdt == 1) launch_typed<float, __nv_bfloat16>(x, w, y, rows, d, eps, s);
  else if (xdt == 1 && wdt == 0) launch_typed<__nv_bfloat16, float>(x, w, y, rows, d, eps, s);
  else if (xdt == 1 && wdt == 1) launch_typed<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
