// Single-token decode attention over a KV cache, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (:68) -> _dec_kernel (:24), the pl.pallas_call at :104.
// That kernel ran a grid (B*H, S/block_k) whose second axis was sequential:
// the online-softmax state m, l, acc lived in VMEM scratch from one grid
// step to the next.  CUDA blocks run concurrently and in no order, so here
// that axis is split across blocks and their partial states are combined
// by a second kernel (flash-decoding), and the `S % block_k == 0` assert
// (:77) becomes a ragged tail that is masked.
//
// What it computes: q (B, H, D), caches k, v (B, Hkv, S, D), lengths (B,)
// int32 -> out (B, H, D) in q's dtype.  Query head h reads KV head
// h / (H / Hkv) (GQA by index).  Scores q.k * sm_scale in f32, keys at or
// past lengths[b] masked, softmax in f32.  A row with no valid key
// (lengths[b] <= 0) returns zeros, as the Pallas kernel does (l == 0 -> 1,
// :62).
//
// What bounds it on the H100: device-memory bytes.  Each valid key costs
// 2 * D cache elements read once (K and V) and ~4 * D operations per query
// head, a few operations per byte: the cache stream is the whole cost, and
// with one block per (b, kv head) (24 at the serving shapes) most of the
// card's 132 SMs would sit idle while it streams.
//
// Design: two kernels on the caller's stream.
//
// decode_split_kernel, grid (B * Hkv, n_split): the cache's S keys are cut
// into n_split splits of keys_per_split keys, a whole number of 64-key
// tiles (kernels/decode_attention.py split_plan, which gives at least
// 2 x 132 blocks at the serving shape).  A block whose split lies at or
// past lengths[b] writes an empty partial (m = -1e30, l = 0, acc = 0) and
// returns.  Otherwise its 4 warps stream the split's valid keys in 64-key
// tiles through a two-stage ring in shared memory (one stage where two do
// not fit), the K and V rows as they are in the cache, by 16-byte
// cp.async copies where D allows it, so the next tile loads while this
// one is used.  Every warp computes.  Scores: two threads per key, each
// over half of the row's 16-byte chunks, for all G query heads of the KV
// group (the G scaled queries in shared memory, read as float4s by every
// thread of a phase at once), so each K row is read once; one warp per
// head then takes the tile's max and sum with shuffles; each thread then
// accumulates its (head, dim pair) outputs over the tile's keys, four at
// a time.  The split's state (m, l, acc[D]) per query head goes to the
// f32 scratch part (B, H, n_split, D + 2) that the wrapper allocates.
//
// decode_combine_kernel, grid (B * H): M = max m_s, L = sum e^(m_s - M) l_s,
// o = sum e^(m_s - M) acc_s / (L == 0 ? 1 : L), so an empty row gives zeros.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // keys per shared-memory tile
constexpr int kThreads = 128;      // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kMaxG = 32;
constexpr int kMaxSplits = 4096;   // the combine's shared memory: 32 KB
constexpr int kSmemMax = 232448;   // what a block may opt into on sm_90
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

// The cache's element types as they sit in shared memory: a 16-byte chunk
// as floats (N of them), and two neighbouring elements as a float2.
template <typename TC> struct Raw;
template <> struct Raw<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void chunk(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static float2 pair(const unsigned char* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};
template <> struct Raw<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void chunk(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {         // a bf16 is the top of an f32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static float2 pair(const unsigned char* p) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
};

// The split kernel's shared memory for G heads of D dims of a TC cache:
// the scaled queries (G rows of dq floats, zero past D), a ring of
// `stages` K and V tiles (kTile rows of rb bytes each: the row's nc
// 16-byte chunks, then padding up to 2 chunks past a multiple of 8, so
// that the 8 lanes of a phase, reading chunk 2 i + h of rows r .. r + 3,
// h = 0, 1, hit 8 distinct bank groups), the scores or p of a tile
// (G x kTile floats), and m, l and alpha (G floats each).
struct Layout {
  int nc, dq, rb, stages;
  __host__ __device__ Layout(int D, int esize, int stages_)
      : stages(stages_) {
    nc = (D * esize + 15) / 16;
    dq = nc * 16 / esize;
    rb = 16 * (nc + (10 - nc % 8) % 8);
  }
  __host__ __device__ size_t bytes(int G) const {
    return sizeof(float) * ((size_t)G * dq + (size_t)G * kTile + 3 * G) +
           (size_t)2 * stages * kTile * rb;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, n) of the (n, D) K and V slabs into a stage, as they are:
// 16-byte cp.async copies (kVec: D * sizeof(TC) a multiple of 16 and the
// caches 16-byte aligned), else element by element
template <typename TC, bool kVec>
__device__ __forceinline__ void load_tile(const TC* __restrict__ ks,
                                          const TC* __restrict__ vs,
                                          unsigned char* sK, unsigned char* sV,
                                          int n, int D, const Layout& L) {
  if (kVec) {
    for (int c = threadIdx.x; c < n * L.nc; c += kThreads) {
      const int r = c / L.nc, ch = c - r * L.nc;
      const size_t off = (size_t)r * D * sizeof(TC) + ch * 16;
      cp_async16(sK + r * L.rb + ch * 16,
                 reinterpret_cast<const unsigned char*>(ks) + off);
      cp_async16(sV + r * L.rb + ch * 16,
                 reinterpret_cast<const unsigned char*>(vs) + off);
    }
    cp_async_commit();
  } else {
    for (int e = threadIdx.x; e < n * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      reinterpret_cast<TC*>(sK + r * L.rb)[c] = ks[e];
      reinterpret_cast<TC*>(sV + r * L.rb)[c] = vs[e];
    }
  }
}

// kG: query heads per KV group it holds scores for (G <= kG); kOut: the
// (head, dim pair) outputs per thread (G * ceil(D / 2) <= kThreads * kOut)
template <typename TQ, typename TC, bool kVec, int kG, int kOut>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                    const TC* __restrict__ vc,
                    const int* __restrict__ lengths, float* __restrict__ part,
                    int H, int Hkv, int S, int D, float scale,
                    int keys_per_split, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kC = Raw<TC>::N;         // elements per 16-byte chunk
  const int G = H / Hkv;
  const Layout L(D, sizeof(TC), stages);
  float* Qs = reinterpret_cast<float*>(smem);         // G x dq
  unsigned char* Kr = smem + sizeof(float) * G * L.dq;  // stages x kTile x rb
  unsigned char* Vr = Kr + (size_t)stages * kTile * L.rb;
  float* Ps = reinterpret_cast<float*>(Vr + (size_t)stages * kTile * L.rb);
  float* mS = Ps + G * kTile;            // G: running max
  float* lS = mS + G;                    // G: running sum
  float* aS = lS + G;                    // G: this tile's alpha
  const int b = blockIdx.x / Hkv, hk = blockIdx.x - b * Hkv;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = max(0, min(lengths[b], S));
  const int k_begin = split * keys_per_split;
  const int k_end = min(k_begin + keys_per_split, len);

  // the partial of query head hk * G + g: part[b, hk * G + g, split, :]
  const long long pstride = (long long)n_split * (D + 2);
  float* pb = part + ((long long)b * H + hk * G) * pstride +
              (long long)split * (D + 2);

  if (k_begin >= k_end) {                // an empty partial
    for (int e = threadIdx.x; e < G * (D + 2); e += kThreads) {
      const int g = e / (D + 2), c = e - g * (D + 2);
      pb[g * pstride + c] = c == D ? kNegInf : 0.0f;
    }
    return;
  }

  const long long slab = ((long long)b * Hkv + hk) * S * D;
  const TC* kb = kc + slab + (long long)k_begin * D;
  const TC* vb = vc + slab + (long long)k_begin * D;
  const int nt = (k_end - k_begin + kTile - 1) / kTile;
  load_tile<TC, kVec>(kb, vb, Kr, Vr, min(kTile, k_end - k_begin), D, L);

  // the scaled queries, and zeros past D in the queries and in every K and
  // V row (the loads never write there)
  const TQ* qb = q + ((long long)b * H + hk * G) * D;
  for (int e = threadIdx.x; e < G * L.dq; e += kThreads) {
    const int g = e / L.dq, d = e - g * L.dq;
    Qs[e] = d < D ? to_f(qb[g * D + d]) * scale : 0.0f;
  }
  const int pad = L.dq - D;
  for (int e = threadIdx.x; e < stages * kTile * pad; e += kThreads) {
    const int r = e / pad, c = D + e - r * pad;
    reinterpret_cast<TC*>(Kr + r * L.rb)[c] = TC(0.0f);
    reinterpret_cast<TC*>(Vr + r * L.rb)[c] = TC(0.0f);
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    mS[g] = kNegInf;
    lS[g] = 0.0f;
  }

  float acc[kOut][2];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i][0] = acc[i][1] = 0.0f;
  const int D2 = (D + 1) / 2;

  for (int t = 0; t < nt; ++t) {
    const int t0 = k_begin + t * kTile;
    const int n = min(kTile, k_end - t0);  // valid keys in this tile
    if (stages == 2 && t + 1 < nt) {       // the next tile, in flight
      const int st = (t + 1) & 1;
      load_tile<TC, kVec>(kb + (long long)(t + 1) * kTile * D,
                          vb + (long long)(t + 1) * kTile * D,
                          Kr + st * kTile * L.rb, Vr + st * kTile * L.rb,
                          min(kTile, k_end - t0 - kTile), D, L);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                     // this tile is in shared memory
    const int st = stages == 2 ? (t & 1) : 0;
    const unsigned char* Kt = Kr + st * kTile * L.rb;
    const unsigned char* Vt = Vr + st * kTile * L.rb;

    // scores: two threads per key, each a half of the row's chunks
    // (alternating, so the two read different banks), for every head of
    // the group; the halves meet by one shuffle
    {
      const int j = threadIdx.x >> 1, h = threadIdx.x & 1;
      float sg[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) sg[g] = 0.0f;
      if (j < n) {
        const unsigned char* kr = Kt + j * L.rb;
        for (int c = h; c < L.nc; c += 2) {
          float kf[kC];
          Raw<TC>::chunk(*reinterpret_cast<const uint4*>(kr + c * 16), kf);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g < G) {
              const float4* qv =
                  reinterpret_cast<const float4*>(Qs + g * L.dq + c * kC);
#pragma unroll
              for (int u = 0; u < kC / 4; ++u) {
                const float4 qq = qv[u];
                sg[g] = fmaf(qq.x, kf[4 * u], sg[g]);
                sg[g] = fmaf(qq.y, kf[4 * u + 1], sg[g]);
                sg[g] = fmaf(qq.z, kf[4 * u + 2], sg[g]);
                sg[g] = fmaf(qq.w, kf[4 * u + 3], sg[g]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g < G) {
          const float x = sg[g] + __shfl_xor_sync(0xffffffffu, sg[g], 1);
          if (h == 0) Ps[g * kTile + j] = j < n ? x : kNegInf;
        }
      }
    }
    __syncthreads();

    // the tile's max and sum, one warp per head; lane holds keys lane and
    // lane + 32
    for (int g = warp; g < G; g += kWarps) {
      float* pr = Ps + g * kTile;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float tmax = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = mS[g];
      const float m_new = fmaxf(m_old, tmax);
      const float p0 = lane < n ? expf(s0 - m_new) : 0.0f;
      const float p1 = lane + 32 < n ? expf(s1 - m_new) : 0.0f;
      float psum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum = psum + __shfl_xor_sync(0xffffffffu, psum, o);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      __syncwarp();                      // every lane has read mS[g]
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        lS[g] = alpha * lS[g] + psum;
        mS[g] = m_new;
        aS[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V for this thread's (head, dim pair)
    // outputs, four keys at a time into two partial sums
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int o = threadIdx.x + kThreads * i;
      if (o < G * D2) {
        const int g = o / D2, d = 2 * (o - g * D2);
        const float* pr = Ps + g * kTile;
        const unsigned char* vd = Vt + d * sizeof(TC);
        float a0 = 0.0f, a1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
        int j = 0;
        for (; j + 4 <= n; j += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pr + j);
          const float2 v0 = Raw<TC>::pair(vd + j * L.rb);
          const float2 v1 = Raw<TC>::pair(vd + (j + 1) * L.rb);
          const float2 v2 = Raw<TC>::pair(vd + (j + 2) * L.rb);
          const float2 v3 = Raw<TC>::pair(vd + (j + 3) * L.rb);
          a0 = fmaf(p4.x, v0.x, a0);
          a1 = fmaf(p4.x, v0.y, a1);
          b0 = fmaf(p4.y, v1.x, b0);
          b1 = fmaf(p4.y, v1.y, b1);
          a0 = fmaf(p4.z, v2.x, a0);
          a1 = fmaf(p4.z, v2.y, a1);
          b0 = fmaf(p4.w, v3.x, b0);
          b1 = fmaf(p4.w, v3.y, b1);
        }
        for (; j < n; ++j) {
          const float2 v = Raw<TC>::pair(vd + j * L.rb);
          a0 = fmaf(pr[j], v.x, a0);
          a1 = fmaf(pr[j], v.y, a1);
        }
        acc[i][0] = acc[i][0] * aS[g] + (a0 + b0);
        acc[i][1] = acc[i][1] * aS[g] + (a1 + b1);
      }
    }
    __syncthreads();                     // every thread is done with it
    if (stages == 1 && t + 1 < nt)
      load_tile<TC, kVec>(kb + (long long)(t + 1) * kTile * D,
                          vb + (long long)(t + 1) * kTile * D, Kr, Vr,
                          min(kTile, k_end - t0 - kTile), D, L);
  }

  // mS and lS were last written before the barrier ahead of the P.V loop
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int o = threadIdx.x + kThreads * i;
    if (o < G * D2) {
      const int g = o / D2, d = 2 * (o - g * D2);
      pb[g * pstride + d] = acc[i][0];
      if (d + 1 < D) pb[g * pstride + d + 1] = acc[i][1];
    }
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    pb[g * pstride + D] = mS[g];
    pb[g * pstride + D + 1] = lS[g];
  }
}

// one block per (b, h), one thread per output dimension; the splits' m
// and l, then their weights e^(m_s - M), go through shared memory
template <typename TQ>
__global__ void decode_combine_kernel(const float* __restrict__ part,
                                      TQ* __restrict__ out, int D,
                                      int n_split) {
  extern __shared__ float sc[];
  float* sm = sc;                        // n_split: m_s, then e^(m_s - M)
  float* sl = sc + n_split;              // n_split: l_s
  const float* pr = part + (long long)blockIdx.x * n_split * (D + 2);
  for (int s = threadIdx.x; s < n_split; s += blockDim.x) {
    sm[s] = pr[s * (D + 2) + D];
    sl[s] = pr[s * (D + 2) + D + 1];
  }
  __syncthreads();
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, sm[s]);
  __syncthreads();                       // every thread has M
  for (int s = threadIdx.x; s < n_split; s += blockDim.x)
    sm[s] = expf(sm[s] - M);
  __syncthreads();
  const int d = threadIdx.x;
  if (d >= D) return;
  float L = 0.0f, a = 0.0f;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    L = L + sm[s] * sl[s];
    a = a + sm[s] * pr[s * (D + 2) + d];
  }
  out[(long long)blockIdx.x * D + d] = from_f<TQ>(a / (L == 0.0f ? 1.0f : L));
}

template <typename TQ, typename TC, bool kVec, int kG, int kOut>
int launch_impl(const void* q, const void* k, const void* v,
                const void* lengths, void* out, float* part, int B, int H,
                int Hkv, int S, int D, float scale, int n_split,
                int keys_per_split, cudaStream_t stream) {
  const int G = H / Hkv;
  // two stages where they fit, else one
  int stages = 2;
  size_t smem = Layout(D, sizeof(TC), 2).bytes(G);
  if (smem > (size_t)kSmemMax) {
    stages = 1;
    smem = Layout(D, sizeof(TC), 1).bytes(G);
  }
  auto kern = decode_split_kernel<TQ, TC, kVec, kG, kOut>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3((unsigned)(B * Hkv), (unsigned)n_split), dim3(kThreads), smem,
         stream>>>(static_cast<const TQ*>(q), static_cast<const TC*>(k),
                   static_cast<const TC*>(v),
                   static_cast<const int*>(lengths), part, H, Hkv, S, D,
                   scale, keys_per_split, stages);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<TQ><<<dim3((unsigned)(B * H)),
                              dim3((unsigned)((D + 31) / 32 * 32)),
                              2 * sizeof(float) * n_split, stream>>>(
      part, static_cast<TQ*>(out), D, n_split);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC, bool kVec>
int launch_outs(const void* q, const void* k, const void* v,
                const void* lengths, void* out, float* part, int B, int H,
                int Hkv, int S, int D, float scale, int n_split, int kps,
                cudaStream_t stream) {
  // the serving shapes' small groups (G 3, D 64) in few registers, the
  // rest in as many as the largest group and head need
  const int G = H / Hkv, pairs = G * ((D + 1) / 2);
  if (G <= 4 && pairs <= kThreads)
    return launch_impl<TQ, TC, kVec, 4, 1>(q, k, v, lengths, out, part, B,
                                           H, Hkv, S, D, scale, n_split, kps,
                                           stream);
  return launch_impl<TQ, TC, kVec, kMaxG, kMaxG * kMaxD / 2 / kThreads>(
      q, k, v, lengths, out, part, B, H, Hkv, S, D, scale, n_split, kps,
      stream);
}

template <typename TQ, typename TC>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* lengths, void* out, float* part, int B, int H,
                 int Hkv, int S, int D, float scale, int n_split, int kps,
                 cudaStream_t stream) {
  const bool vec = (D * sizeof(TC)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  return vec ? launch_outs<TQ, TC, true>(q, k, v, lengths, out, part, B, H,
                                         Hkv, S, D, scale, n_split, kps,
                                         stream)
             : launch_outs<TQ, TC, false>(q, k, v, lengths, out, part, B, H,
                                          Hkv, S, D, scale, n_split, kps,
                                          stream);
}

}  // namespace

// q, out: (B, H, D) contiguous, dtype code qdt; k, v: (B, Hkv, S, D)
// contiguous, dtype code cdt (0 = float32, 1 = bfloat16; a bfloat16 q
// takes a bfloat16 cache only, as the model's cache always is); lengths:
// (B,) int32; part: (B, H, n_split, D + 2) float32 scratch.  H % Hkv == 0,
// H / Hkv <= 32, D <= 256; keys_per_split a multiple of 64 with
// n_split * keys_per_split >= S, n_split <= 4096.  Launches both kernels
// on `stream` and returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* part, int B, int H,
                                       int Hkv, int S, int D, float scale,
                                       int n_split, int keys_per_split,
                                       int qdt, int cdt, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || D > kMaxD || S < 0 ||
      n_split <= 0 || n_split > kMaxSplits || keys_per_split <= 0 ||
      keys_per_split % kTile != 0 ||
      (long long)n_split * keys_per_split < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (qdt == 0 && cdt == 0)
    return launch_typed<float, float>(q, k, v, lengths, out, p, B, H, Hkv, S,
                                      D, scale, n_split, keys_per_split, s);
  if (qdt == 0 && cdt == 1)
    return launch_typed<float, __nv_bfloat16>(q, k, v, lengths, out, p, B, H,
                                              Hkv, S, D, scale, n_split,
                                              keys_per_split, s);
  if (qdt == 1 && cdt == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, lengths, out, p, B, H, Hkv, S, D, scale, n_split,
        keys_per_split, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
