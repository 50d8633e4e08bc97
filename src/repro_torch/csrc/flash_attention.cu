// Causal (or full) GQA flash attention forward, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (:91) -> _fa_kernel (:35), the pl.pallas_call at :110.
// That kernel ran a grid (B*H, Sq/block_q, Sk/block_k) whose last axis was
// sequential: the online-softmax state m, l, acc lived in VMEM scratch from
// one k block to the next, and `Sq % block_q == 0`, `Sk % block_k == 0` were
// asserted (:102).  CUDA blocks run concurrently and in no order, so here
// the k axis is a loop inside the block, and ragged q and k tiles are masked.
//
// What it computes: q (B, H, Sq, D), k, v (B, Hkv, Sk, D), all f32 or all
// bf16 -> o (B, H, Sq, D) in q's dtype and lse (B, H, Sq) in f32.  Query head
// h reads KV head h / (H / Hkv) (GQA by index, no repeated K/V).  Scores
// (q * sm_scale) . k in f32, as the Pallas kernel upcasts q and k; with
// `causal`, row i sees keys j <= i + (Sk - Sq) (the query block aligned to
// the key tail).  Softmax online over 64-key tiles in f32; tiles wholly
// above the diagonal are skipped.  A masked score contributes p = 0, so a
// row with no valid key keeps l == 0 and returns zeros (the Pallas
// kernel's l == 0 -> 1, :82-84) with lse = m + log(1) = -1e30; every other
// row gets lse = m + log(l), the residual the blocked backward of
// src/repro/models/flash.py:77 reads.
//
// What bounds it on the H100: operations.  Causal, the two products take
// 2 * 2 * B * H * D * Sq (Sq + 1) / 2 flops (3.9e10 at the training shape
// 8 x 9 x 2048 x 64), against (Sq + 2 Sk) * D * B * H elements read and
// Sq * D written: hundreds of operations per byte.
//
// Design (simple and right; tensor cores come later): one 256-thread block
// per (b * H + h, 64-row q tile), heaviest (last) q tiles scheduled first.
// The q tile is scaled and kept in shared memory as f32; each 64-key K and V
// tile is staged through shared memory as f32, rows padded to D + 1 floats
// so the dot products read conflict-free.  Thread (ty, tx) of a 16 x 16
// grid owns rows 4 ty .. 4 ty + 3 and key columns tx + 16 j (j < 4) of the
// score tile, and output columns tx + 16 c of its four rows: scores and the
// output accumulator are FP32 FMAs from shared memory into registers.  The
// row max and sum reduce over the 16 lanes of a half-warp with xor
// shuffles (every lane ends with the same value), the probabilities go
// through shared memory to the P.V product.  Built with -fmad=false; the
// dot products use explicit fmaf.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per shared-memory tile
constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr int kRows = 4;           // rows per thread
constexpr int kCols = kBK / 16;    // score columns per thread
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

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

template <int D>
constexpr int smem_floats() {
  // Qs, Ks: kBQ/kBK x (D + 1); Vs: kBK x D; Ps: kBQ x (kBK + 1)
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

// Rows [row0, row0 + 64) of a (rows, D) matrix into shared memory as f32
// (times `scale`), rows at or past `rows` as zeros, row stride `ld` floats.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const T* __restrict__ src, int row0,
                                      int rows, float scale) {
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int g = row0 + r;
    dst[r * ld + c] =
        g < rows ? to_f(src[(long long)g * D + c]) * scale : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int H, int Hkv, int Sq,
                       int Sk, float sm_scale, int causal) {
  constexpr int kOut = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * (D + 1);
  float* Vs = Ks + kBK * (D + 1);
  float* Ps = Vs + kBK * D;

  const int bh = blockIdx.x;                      // b * H + h
  const int b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);
  const int qt = gridDim.y - 1 - blockIdx.y;      // heaviest tiles first
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int offset = Sk - Sq;                     // causal alignment

  const T* qb = q + (long long)bh * Sq * D;
  const T* kb = k + ((long long)b * Hkv + hkv) * Sk * D;
  const T* vb = v + ((long long)b * Hkv + hkv) * Sk * D;

  // keys this q tile can see: all of them, or up to its last row's diagonal
  int n_keys = Sk;
  if (causal) {
    const int last = q0 + kBQ - 1 + offset;       // last row's last key
    n_keys = last < 0 ? 0 : (last + 1 < Sk ? last + 1 : Sk);
  }
  const int n_tiles = (n_keys + kBK - 1) / kBK;

  stage<T, D>(Qs, D + 1, qb, q0, Sq, sm_scale);

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                 // the last tile's P.V is done
    stage<T, D>(Ks, D + 1, kb, k0, Sk, 1.0f);
    stage<T, D>(Vs, D, vb, k0, Sk, 1.0f);
    __syncthreads();

    // scores: rows 4 ty + i, keys tx + 16 j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty * kRows + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax, row by row; the row's 64 keys are spread over the 16
    // lanes of this half-warp
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int key = k0 + tx + 16 * j;
        ok[j] = key < Sk && (!causal || key <= row + offset);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        Ps[(ty * kRows + i) * (kBK + 1) + tx + 16 * j] = p;
        sum = sum + p;
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        sum = sum + __shfl_xor_sync(0xffffffffu, sum, o2);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] = acc[i][c] * alpha;
    }
    __syncthreads();                 // P of every row is in shared memory

    // acc += P V: rows 4 ty + i, output columns tx + 16 c
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < kOut; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Sq) continue;
    const float ls = l[i] == 0.0f ? 1.0f : l[i];
    T* orow = o + ((long long)bh * Sq + row) * D;
#pragma unroll
    for (int c = 0; c < kOut; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / ls);
    if (tx == 0) lse[(long long)bh * Sq + row] = m[i] + logf(ls);
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int H, int Hkv, int Sq, int Sk,
                 float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Hkv, Sq, Sk,
      sm_scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int Hkv, int Sq, int Sk, int D,
             float sm_scale, int causal, cudaStream_t s) {
  if (D == 64)
    return launch_typed<T, 64>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, sm_scale,
                               causal, s);
  if (D == 128)
    return launch_typed<T, 128>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, sm_scale,
                                causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o: (B, H, Sq, D); k, v: (B, Hkv, Sk, D), all contiguous and of dtype
// code dt (0 = float32, 1 = bfloat16); lse: (B, H, Sq) float32.  D is 64 or
// 128; H % Hkv == 0.  Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int H, int Hkv, int Sq, int Sk,
                                      int D, float sm_scale, int causal,
                                      int dt, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0 ||
      (Sq + kBQ - 1) / kBQ > 65535 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dt == 0)
    return launch_d<float>(q, k, v, o, l, B, H, Hkv, Sq, Sk, D, sm_scale,
                           causal, s);
  if (dt == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, l, B, H, Hkv, Sq, Sk, D,
                                   sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
