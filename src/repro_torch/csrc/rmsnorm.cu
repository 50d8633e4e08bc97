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
// Design: one pass over device memory.  A row is taken by `lanes` lanes
// of a warp (a power of two up to 32, chosen from d: the largest that
// divides the row's 16-byte vectors, so d = 576 in bf16, 72 vectors, takes
// 8 lanes of 9 vectors and a warp holds 4 rows; d 1536 and 3072 take 32
// lanes of 6 and 12), and each lane holds its VPL vectors of the row in
// registers (VPL a template argument) from the first read to the store.
// Its slice of w is loaded into registers in the same breath, as whole
// 16-byte (or 8-byte) vectors, so the two reads' latencies overlap before
// the reduction waits on them.  Lanes of a row take neighbouring 16-byte
// vectors, so a warp's loads are coalesced.  The squares are summed in f32
// over the lane's elements, then over the row's lanes by xor shuffles
// (every lane of the row ends with the sum), the Newton rsqrt is computed
// in registers, and the row is scaled and stored 16 bytes at a time.  VPL
// is instantiated for the counts the models' widths give: 6, 9 and 12 (d
// 576, 1536 and 3072 in bf16; 576 and 1536 in f32).  Any other d, and a d
// that takes no 16-byte vector, goes to a scalar kernel: one warp per row,
// element by element, a second pass for the output.  Built with
// -fmad=false, so each multiply and add rounds once, as the reference's
// jnp code does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps per block
constexpr int kThreads = 32 * kWarps;

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

// the bytes of w that go with one 16-byte vector of x, as 32-bit words
template <int WORDS>
__device__ __forceinline__ void load_words(uint32_t (&dst)[WORDS],
                                           const void* src) {
  if constexpr (WORDS == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < WORDS / 4; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[q];
      dst[4 * q] = v.x;
      dst[4 * q + 1] = v.y;
      dst[4 * q + 2] = v.z;
      dst[4 * q + 3] = v.w;
    }
  }
}

template <typename TX, typename TW, int VPL>
__global__ void __launch_bounds__(kThreads)
rmsnorm_vec_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   TX* __restrict__ y, long long rows, int d, float eps,
                   int lanes_log2) {
  constexpr int V = 16 / sizeof(TX);             // x elements per vector
  constexpr int WORDS = V * sizeof(TW) / 4;      // w words per vector
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);             // lane within the row
  const long long warp_row0 =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) *
      (32 >> lanes_log2);
  if (warp_row0 >= rows) return;                 // whole warps leave together
  // a row past the end repeats the last one (its result is not stored),
  // so that every lane of the warp takes part in the shuffles
  const long long row = warp_row0 + (lane >> lanes_log2);
  const bool store = row < rows;
  const long long r = store ? row : rows - 1;
  const TX* xr = x + r * d;

  uint4 xv[VPL];
  uint32_t wv[VPL][WORDS];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = (k * lanes + sub) * V;
    xv[k] = *reinterpret_cast<const uint4*>(xr + i);
    load_words<WORDS>(wv[k], w + i);
  }
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const TX* e = reinterpret_cast<const TX*>(&xv[k]);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float f = to_f(e[q]);
      ss = ss + f * f;
    }
  }
  for (int o = lanes >> 1; o > 0; o >>= 1)
    ss = ss + __shfl_xor_sync(0xffffffffu, ss, o);
  const float rs = vml_rsqrt(ss / (float)d + eps);
  if (!store) return;
  TX* yr = y + r * d;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const TX* e = reinterpret_cast<const TX*>(&xv[k]);
    const TW* we = reinterpret_cast<const TW*>(wv[k]);
    uint4 packed;
    TX* o = reinterpret_cast<TX*>(&packed);
#pragma unroll
    for (int q = 0; q < V; ++q) o[q] = from_f<TX>(to_f(e[q]) * rs * to_f(we[q]));
    *reinterpret_cast<uint4*>(yr + (k * lanes + sub) * V) = packed;
  }
}

// any d: one warp per row, element by element
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_scalar_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                      TX* __restrict__ y, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;               // whole warps leave together
  const TX* xr = x + row * d;
  TX* yr = y + row * d;
  float ss = 0.0f;
  for (int i = lane; i < d; i += 32) {
    const float f = to_f(xr[i]);
    ss = ss + f * f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss = ss + __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = vml_rsqrt(ss / (float)d + eps);
  for (int i = lane; i < d; i += 32) yr[i] = from_f<TX>(to_f(xr[i]) * r * to_f(w[i]));
}

template <typename TX, typename TW, int VPL>
void launch_vec(const void* x, const void* w, void* y, long long rows, int d,
                float eps, int lanes_log2, cudaStream_t stream) {
  const long long per_block = (long long)kWarps * (32 >> lanes_log2);
  const dim3 grid((unsigned)((rows + per_block - 1) / per_block));
  rmsnorm_vec_kernel<TX, TW, VPL><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), rows, d, eps, lanes_log2);
}

template <typename TX, typename TW>
void launch_typed(const void* x, const void* w, void* y, long long rows, int d,
                  float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  constexpr int WBYTES = V * sizeof(TW);         // w bytes per x vector
  int vpl = 0, lanes_log2 = 0;
  if (d % V == 0 && ((reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(y)) % 16 == 0) &&
      reinterpret_cast<uintptr_t>(w) % (WBYTES < 16 ? WBYTES : 16) == 0) {
    const int nv = d / V;                        // vectors in a row
    while (lanes_log2 < 5 && nv % (2 << lanes_log2) == 0) ++lanes_log2;
    vpl = nv >> lanes_log2;
  }
  switch (vpl) {
    case 6: return launch_vec<TX, TW, 6>(x, w, y, rows, d, eps, lanes_log2, stream);
    case 9: return launch_vec<TX, TW, 9>(x, w, y, rows, d, eps, lanes_log2, stream);
    case 12: return launch_vec<TX, TW, 12>(x, w, y, rows, d, eps, lanes_log2, stream);
    default: {
      const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps));
      rmsnorm_scalar_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<TX*>(y), rows, d, eps);
    }
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
  if ((rows + kWarps - 1) / kWarps > 0x7fffffffLL)
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
