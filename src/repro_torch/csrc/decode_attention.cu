// Single-token decode attention over a KV cache, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (:68) -> _dec_kernel (:24), the pl.pallas_call at :104.
// That kernel ran a grid (B*H, S/block_k) whose second axis was sequential:
// the online-softmax state m, l, acc lived in VMEM scratch from one grid
// step to the next.  CUDA blocks run concurrently and in no order, so here
// that axis is a loop inside the block, and the `S % block_k == 0` assert
// (:77) becomes a ragged tail that is masked.
//
// What it computes: q (B, H, D), caches k, v (B, Hkv, S, D), lengths (B,)
// int32 -> out (B, H, D) in q's dtype.  Query head h reads KV head
// h / (H / Hkv) (GQA by index).  Scores q.k * sm_scale in f32, keys at or
// past lengths[b] masked, softmax online over tiles in f32, whole tiles past
// lengths[b] skipped.  A row with no valid key (lengths[b] <= 0) returns
// zeros, as the Pallas kernel does (l == 0 -> 1, :62).
//
// What bounds it on the H100: device-memory bytes.  Each valid key costs
// 2 * D cache elements read once (K and V) and ~4 * D operations per query
// head, a few operations per byte: the cache stream is the whole cost.
//
// Design: one block per (b, kv head), one warp per query head of its group,
// so the group's query heads share every K/V tile (at least four warps, the
// extra ones only load).  Tiles of 64 keys are loaded cooperatively into
// shared memory, 16 bytes a thread where D allows it and several loads in
// flight per thread, and converted to f32, rows padded to D + 1 floats so
// the per-key dot products read conflict-free.  Lane j scores keys j and j + 32
// of the tile, the warp reduces the tile's max and sum with shuffles, and
// each lane accumulates its own output dimensions over the tile's keys in
// registers.  The loop stops at lengths[b].  With B * Hkv blocks (24 at the
// serving shapes) the card's 132 SMs are mostly idle; splitting S across
// blocks (flash-decoding) is the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // keys per shared-memory tile
constexpr int kKeysPerLane = kTile / 32;
constexpr int kMaxD = 256;
constexpr int kBatch = 4;          // 16-byte loads of K (and of V) in flight
constexpr int kMinWarps = 4;       // warps per block, to load with
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

// rows [0, n) of the (n, D) K and V slabs -> smem rows of stride D + 1.
// Each thread issues up to kBatch 16-byte loads of K and of V before it
// stores any, so a tile costs a round trip or two to device memory, not
// one per load.
template <typename TC, bool kVec>
__device__ __forceinline__ void load_tiles(const TC* __restrict__ ks,
                                           const TC* __restrict__ vs,
                                           float* __restrict__ sK,
                                           float* __restrict__ sV, int n,
                                           int D) {
  const int ds = D + 1;
  if (kVec) {
    constexpr int V = 16 / sizeof(TC);
    const int nvec = n * D / V;
    const uint4* k4 = reinterpret_cast<const uint4*>(ks);
    const uint4* v4 = reinterpret_cast<const uint4*>(vs);
    for (int base = threadIdx.x; base < nvec; base += kBatch * blockDim.x) {
      uint4 rk[kBatch], rv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * blockDim.x;
        if (e < nvec) {
          rk[u] = k4[e];
          rv[u] = v4[e];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * blockDim.x;
        if (e < nvec) {
          const int flat = e * V, row = flat / D, col = flat - row * D;
          const TC* ek = reinterpret_cast<const TC*>(&rk[u]);
          const TC* ev = reinterpret_cast<const TC*>(&rv[u]);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            sK[row * ds + col + k] = to_f(ek[k]);
            sV[row * ds + col + k] = to_f(ev[k]);
          }
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
      const int row = e / D, col = e - row * D;
      sK[row * ds + col] = to_f(ks[e]);
      sV[row * ds + col] = to_f(vs[e]);
    }
  }
}

// kDPL: output dimensions per lane, D <= 32 * kDPL
template <typename TQ, typename TC, bool kVec, int kDPL>
__global__ void __launch_bounds__(1024)
decode_attention_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                        const TC* __restrict__ vc,
                        const int* __restrict__ lengths, TQ* __restrict__ out,
                        int H, int Hkv, int S, int D, float scale) {
  extern __shared__ float smem[];
  const int ds = D + 1;
  float* sK = smem;                      // kTile x (D + 1)
  float* sV = sK + kTile * ds;           // kTile x (D + 1)
  float* sQ = sV + kTile * ds;           // G x D, scaled queries
  const int G = H / Hkv;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x - b * Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool computes = warp < G;        // the other warps only load
  const int h = hk * G + warp;
  const int len = max(0, min(lengths[b], S));

  float* myq = sQ + warp * D;
  if (computes) {
    const TQ* qp = q + ((long long)b * H + h) * D;
    for (int d = lane; d < D; d += 32) myq[d] = to_f(qp[d]) * scale;
  }

  const long long slab = ((long long)b * Hkv + hk) * S * D;
  const TC* kb = kc + slab;
  const TC* vb = vc + slab;

  float m = kNegInf, l = 0.0f;
  float acc[kDPL];
#pragma unroll
  for (int i = 0; i < kDPL; ++i) acc[i] = 0.0f;

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);  // valid keys in this tile
    __syncthreads();                     // the previous tile is consumed
    load_tiles<TC, kVec>(kb + (long long)t0 * D, vb + (long long)t0 * D, sK,
                         sV, n, D);
    __syncthreads();
    if (!computes) continue;

    float s[kKeysPerLane];
    float tmax = kNegInf;
#pragma unroll
    for (int kk = 0; kk < kKeysPerLane; ++kk) {
      const int j = lane + 32 * kk;
      float dot = kNegInf;
      if (j < n) {
        const float* kr = sK + j * ds;
        dot = 0.0f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = dot + myq[d] * kr[d];
      }
      s[kk] = dot;
      tmax = fmaxf(tmax, dot);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m, tmax);
    float p[kKeysPerLane];
    float psum = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKeysPerLane; ++kk) {
      p[kk] = expf(s[kk] - m_new);
      psum = psum + p[kk];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      psum = psum + __shfl_xor_sync(0xffffffffu, psum, o);
    const float alpha = expf(m - m_new);
    l = alpha * l + psum;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[i] = acc[i] * alpha;
#pragma unroll
    for (int kk = 0; kk < kKeysPerLane; ++kk) {
      const int jend = min(32, n - 32 * kk);
      for (int jj = 0; jj < jend; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p[kk], jj);
        const float* vr = sV + (jj + 32 * kk) * ds;
#pragma unroll
        for (int i = 0; i < kDPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[i] = acc[i] + pj * vr[d];
        }
      }
    }
    m = m_new;
  }

  if (!computes) return;
  const float inv = (l == 0.0f) ? 1.0f : l;
  TQ* op = out + ((long long)b * H + h) * D;
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) op[d] = from_f<TQ>(acc[i] / inv);
  }
}

template <typename TQ, typename TC, bool kVec, int kDPL>
int launch_impl(const void* q, const void* k, const void* v,
                const void* lengths, void* out, int B, int H, int Hkv, int S,
                int D, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const int warps = G > kMinWarps ? G : kMinWarps;
  const size_t smem = sizeof(float) * (2 * kTile * (size_t)(D + 1) + G * D);
  auto kern = decode_attention_kernel<TQ, TC, kVec, kDPL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3((unsigned)(B * Hkv)), dim3(32 * warps), smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), static_cast<const int*>(lengths),
      static_cast<TQ*>(out), H, Hkv, S, D, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC, bool kVec>
int launch_dims(const void* q, const void* k, const void* v,
                const void* lengths, void* out, int B, int H, int Hkv, int S,
                int D, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch_impl<TQ, TC, kVec, 2>(q, k, v, lengths, out, B, H, Hkv, S,
                                        D, scale, stream);
  if (D <= 128)
    return launch_impl<TQ, TC, kVec, 4>(q, k, v, lengths, out, B, H, Hkv, S,
                                        D, scale, stream);
  return launch_impl<TQ, TC, kVec, 8>(q, k, v, lengths, out, B, H, Hkv, S, D,
                                      scale, stream);
}

template <typename TQ, typename TC>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* lengths, void* out, int B, int H, int Hkv, int S,
                 int D, float scale, cudaStream_t stream) {
  const bool vec = D % (16 / (int)sizeof(TC)) == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  return vec ? launch_dims<TQ, TC, true>(q, k, v, lengths, out, B, H, Hkv, S,
                                         D, scale, stream)
             : launch_dims<TQ, TC, false>(q, k, v, lengths, out, B, H, Hkv,
                                          S, D, scale, stream);
}

}  // namespace

// q, out: (B, H, D) contiguous, dtype code qdt; k, v: (B, Hkv, S, D)
// contiguous, dtype code cdt (0 = float32, 1 = bfloat16; a bfloat16 q
// takes a bfloat16 cache only, as the model's cache always is); lengths:
// (B,) int32.  H % Hkv == 0, H / Hkv <= 32, D <= 256.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int B, int H, int Hkv,
                                       int S, int D, float scale, int qdt,
                                       int cdt, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > 32 || D > kMaxD || S < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qdt == 0 && cdt == 0)
    return launch_typed<float, float>(q, k, v, lengths, out, B, H, Hkv, S, D, scale, s);
  if (qdt == 0 && cdt == 1)
    return launch_typed<float, __nv_bfloat16>(q, k, v, lengths, out, B, H, Hkv, S, D, scale, s);
  if (qdt == 1 && cdt == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(q, k, v, lengths, out, B, H, Hkv, S, D, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
