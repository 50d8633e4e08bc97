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
// q . k * sm_scale in f32; with `causal`, row i sees keys j <= i + (Sk - Sq)
// (the query block aligned to the key tail).  Softmax online over 64-key
// tiles in f32; tiles wholly above the diagonal are skipped.  A masked score
// contributes p = 0, so a row with no valid key keeps l == 0 and returns
// zeros (the Pallas kernel's l == 0 -> 1, :82-84) with lse = m + log(1) =
// -1e30; every other row gets lse = m + log(l), the residual the blocked
// backward of src/repro/models/flash.py:77 reads.
//
// What bounds it on the H100: operations.  Causal, the two products take
// 2 * 2 * B * H * D * Sq (Sq + 1) / 2 flops (3.9e10 at the training shape
// 8 x 9 x 2048 x 64), against (Sq + 2 Sk) * D * B * H elements read and
// Sq * D written: hundreds of operations per byte.
//
// Two designs, chosen by the inputs' dtype.
//
// bfloat16 (the training path): tensor cores.  Both products are
// mma.sync.m16n8k16 bf16 x bf16 -> f32, operands from shared memory by
// ldmatrix (.trans for V), in the FlashAttention-2 shape: one 128-thread
// block per (b * H + h, q tile of 4 warps x 16 MT rows; MT = 2 for D = 64,
// 1 for D = 112 and 128, what the registers allow), heaviest (last) q tiles
// first.  D = 112 (zamba2's shared attention) takes 7 k steps of Q K^T and
// 14 n tiles of the output, which ldmatrix.x4.trans reads in 7 pairs; its
// rows of D + 8 = 120 bf16 are 240 bytes, a multiple of 16, so every
// ldmatrix row and cp.async chunk stays 16-byte aligned and the 8 rows of
// an ldmatrix still fall on 8 different 16-byte bank groups.
// The q tile is copied once and held in registers as A fragments.  K and V
// tiles of 64 keys go through a two-stage ring in shared memory, filled by
// 16-byte cp.async copies with the rows past Sk zero-filled, so the next
// tile loads while this one is multiplied; rows are padded by 16 bytes so
// that ldmatrix reads are free of bank conflicts.  S = Q K^T stays in
// registers: sm_scale is applied in f32 after the product (1/sqrt(128) is
// not a power of two, so folding it into bf16 q would round q), the mask
// only on tiles that cross the diagonal or the Sk edge, the row max and sum
// reduce over the 4 lanes that hold a row with shuffles, and a warp whose
// rows all lie above a tile's keys skips it.  p = exp(s - m) is taken as
// 2^(s log2 e - m log2 e), one FFMA and one ex2.approx per score (relative
// error below 2^-21 where the reference's exp rounds once: at f32
// rounding's scale, far inside the tolerances, for a fraction of expf's
// instructions).  P never goes through shared memory: the accumulator
// fragment of Q K^T becomes the A fragment of P V.  The reference multiplies an f32 P by V; P rounded once to bf16 would move
// a bf16 output by several ulps where |o| is small, so P is split into
// hi = bf16(p) and lo = bf16(p - hi) and both are multiplied by V (exact in
// bf16) into the same f32 accumulator: each p keeps about 16 significant
// bits.  The mma is unaffected by -fmad=false.
//
// float32: the FP32 path (TF32 tensor cores would round q, k, p and v to
// 10-bit mantissas and change the function).
// One 256-thread block per (b * H + h, 64-row q tile), heaviest first.
// The q tile is scaled and kept in shared memory as f32; each 64-key K and V
// tile is staged through shared memory, rows padded to D + 1 floats so the
// dot products read conflict-free.  Thread (ty, tx) of a 16 x 16 grid owns
// rows 4 ty .. 4 ty + 3 and key columns tx + 16 j (j < 4) of the score
// tile, and output columns tx + 16 c of its four rows: scores and the
// output accumulator are FP32 FMAs from shared memory into registers.  The
// row max and sum reduce over the 16 lanes of a half-warp with xor
// shuffles (every lane ends with the same value), the probabilities go
// through shared memory to the P.V product.  Built with -fmad=false; the
// dot products use explicit fmaf.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBQ = 64;            // query rows per block (FP32 path)
constexpr int kBK = 64;            // keys per shared-memory tile
constexpr int kThreads = 256;      // a 16 x 16 grid of threads (FP32 path)
constexpr int kRows = 4;           // rows per thread
constexpr int kCols = kBK / 16;    // score columns per thread
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
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

// ---- the bfloat16 path: tensor cores ------------------------------------

constexpr int kWarps = 4;                 // warps per block
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kStages = 2;                // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// query rows per warp, in m16 tiles (what the registers allow), and
// per block
template <int D> struct MmaTiles {
  static constexpr int MT = D == 64 ? 2 : 1;
  static constexpr int BQ = kWarps * 16 * MT;
};

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q: BQ rows; K, V: kStages x kBK rows each; rows of D + 8 bf16
  return sizeof(__nv_bfloat16) * (D + 8) *
         (size_t)(MmaTiles<D>::BQ + 2 * kStages * kBK);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;               // 0: fill the 16 bytes with 0
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a b, one m16n8k16 tile: a row-major 16 x 16 bf16 (4 registers), b
// column-major 16 x 8 bf16 (2 registers), c 16 x 8 f32 (4 registers)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as a bf16 pair, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&h);
}
// 2^x by the SFU (ex2.approx.ftz: relative error below 2^-22, results
// under 2^-126 flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + ROWS) of a (rows, D) bf16 matrix into shared memory
// rows of stride D + 8, by 16-byte cp.async; rows at or past `rows` are
// zero-filled.  Row 0 always exists, so every source address is valid.
template <int ROWS, int D>
__device__ __forceinline__ void load_rows_async(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int row0,
    int rows) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, ch = c - r * kChunks;
    const int g = row0 + r;
    const bool valid = g < rows;
    cp_async16(dst + r * (D + 8) + ch * 8,
               src + (long long)(valid ? g : 0) * D + ch * 8, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int H, int Hkv, int Sq,
                           int Sk, float sm_scale, int causal) {
  constexpr int MT = MmaTiles<D>::MT;   // m16 tiles per warp
  constexpr int BQ = MmaTiles<D>::BQ;
  constexpr int LD = D + 8;             // shared-memory row, in bf16
  constexpr int KS = D / 16;            // k steps of Q K^T
  constexpr int ND = D / 8;             // n tiles of the output
  constexpr int NK = kBK / 8;           // n tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;                 // kStages x kBK x LD
  __nv_bfloat16* Vs = Ks + kStages * kBK * LD;      // kStages x kBK x LD

  const int bh = blockIdx.x;                        // b * H + h
  const int b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ; // heaviest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;          // fragment row, column
  const int offset = Sk - Sq;                       // causal alignment
  const int wrow0 = q0 + warp * 16 * MT;            // this warp's first row
  const int wrow1 = wrow0 + 16 * MT - 1;            // and its last

  const __nv_bfloat16* qb = q + (long long)bh * Sq * D;
  const __nv_bfloat16* kb = k + ((long long)b * Hkv + hkv) * Sk * D;
  const __nv_bfloat16* vb = v + ((long long)b * Hkv + hkv) * Sk * D;

  // keys this q tile can see: all of them, or up to its last row's diagonal
  int n_keys = Sk;
  if (causal) {
    const int last = min(q0 + BQ, Sq) - 1 + offset;
    n_keys = last < 0 ? 0 : (last + 1 < Sk ? last + 1 : Sk);
  }
  const int n_tiles = (n_keys + kBK - 1) / kBK;

  load_rows_async<BQ, D>(Qs, qb, q0, Sq);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows_async<kBK, D>(Ks, kb, 0, Sk);
    load_rows_async<kBK, D>(Vs, vb, 0, Sk);
    cp_async_commit();
    cp_async_wait<1>();                             // the Q tile is in
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // the warp's Q rows as A fragments: qf[mt][ks] covers rows 16 mt .. +15
  // of the warp and columns 16 ks .. +15
  uint32_t qf[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldmatrix_x4(qf[mt][ks], Qs + (warp * 16 * MT + mt * 16 + (lane & 15)) * LD
                                  + ks * 16 + (lane >> 4) * 8);

  // row state: [mt][0] is row gr, [mt][1] row gr + 8 of m tile mt; l is
  // this lane's share of the row sum (its 16 columns of each tile)
  float m[MT][2], l[MT][2], acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[mt][hh] = kNegInf;
      l[mt][hh] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    if (t + 1 < n_tiles) {                          // the next tile, in flight
      const int st = (t + 1) % kStages;
      load_rows_async<kBK, D>(Ks + st * kBK * LD, kb, k0 + kBK, Sk);
      load_rows_async<kBK, D>(Vs + st * kBK * LD, vb, k0 + kBK, Sk);
      cp_async_commit();
      cp_async_wait<1>();                           // this tile is in
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + (t % kStages) * kBK * LD;
    const __nv_bfloat16* Vt = Vs + (t % kStages) * kBK * LD;

    // a warp whose rows all lie above this tile's keys skips it: its m, l
    // and acc would stay as they are (p = 0, alpha = 1)
    if (!causal || k0 <= wrow1 + offset) {
      float s[MT][NK][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.0f;
      // S = Q K^T; one ldmatrix.x4 gives the B fragments of two n tiles
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int jj = 0; jj < NK / 2; ++jj) {
          uint32_t kf[4];
          ldmatrix_x4(kf, Kt + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
                              + ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * jj], qf[mt][ks], kf[0], kf[1]);
            mma_bf16(s[mt][2 * jj + 1], qf[mt][ks], kf[2], kf[3]);
          }
        }

      // scale, then mask where the tile crosses the diagonal or the Sk edge
      const bool masked = k0 + kBK > Sk ||
                          (causal && k0 + kBK - 1 > wrow0 + offset);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[mt][j][e] * sm_scale;
            if (masked) {
              const int row = wrow0 + mt * 16 + gr + 8 * (e >> 1);
              const int key = k0 + j * 8 + 2 * t4 + (e & 1);
              if (key >= Sk || (causal && key > row + offset)) x = kNegInf;
            }
            s[mt][j][e] = x;
          }

      // online softmax, two rows per m tile; a row's 64 scores sit on the
      // 4 lanes of its quad
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < NK; ++j)
            mx = fmaxf(mx, fmaxf(s[mt][j][2 * hh], s[mt][j][2 * hh + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[mt][hh], mx);
          // a row that has seen no valid key yet keeps p = 0: its masked
          // scores are kNegInf, and exp(kNegInf - 0) is 0
          const float ms = m_new == kNegInf ? 0.0f : m_new;
          // p = exp(s - ms) = 2^(s log2 e - ms log2 e): one FFMA and one
          // SFU op per score
          const float msl = ms * kLog2e;
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < NK; ++j)
#pragma unroll
            for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
              const float p = ex2(__fmaf_rn(s[mt][j][e], kLog2e, -msl));
              s[mt][j][e] = p;
              sum = sum + p;
            }
          const float alpha = expf(m[mt][hh] - ms);
          l[mt][hh] = alpha * l[mt][hh] + sum;
          m[mt][hh] = m_new;
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            acc[mt][j][2 * hh] = acc[mt][j][2 * hh] * alpha;
            acc[mt][j][2 * hh + 1] = acc[mt][j][2 * hh + 1] * alpha;
          }
        }

      // acc += P V over four 16-key steps; the score fragments of n tiles
      // 2 kk and 2 kk + 1 are the A fragment of step kk, as hi and lo
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            // r: 0 (row gr, keys 2 t4), 1 (row gr + 8), 2 (row gr, keys
            // 8 + 2 t4), 3 (row gr + 8, keys 8 + 2 t4)
            const float p0 = s[mt][2 * kk + (r >> 1)][2 * (r & 1)];
            const float p1 = s[mt][2 * kk + (r >> 1)][2 * (r & 1) + 1];
            const uint32_t hi = pack_bf16(p0, p1);
            ph[mt][r] = hi;
            pl[mt][r] = pack_bf16(p0 - __uint_as_float(hi << 16),
                                  p1 - __uint_as_float(hi & 0xffff0000u));
          }
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(
              vf, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                      + dp * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * dp], ph[mt], vf[0], vf[1]);
            mma_bf16(acc[mt][2 * dp], pl[mt], vf[0], vf[1]);
            mma_bf16(acc[mt][2 * dp + 1], ph[mt], vf[2], vf[3]);
            mma_bf16(acc[mt][2 * dp + 1], pl[mt], vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();              // every warp is done with this stage
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lt = l[mt][hh];
      lt = lt + __shfl_xor_sync(0xffffffffu, lt, 1);
      lt = lt + __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = wrow0 + mt * 16 + gr + 8 * hh;
      if (row >= Sq) continue;
      const float ls = lt == 0.0f ? 1.0f : lt;
      __nv_bfloat16* orow = o + ((long long)bh * Sq + row) * D;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        __nv_bfloat162 pair = __floats2bfloat162_rn(acc[mt][j][2 * hh] / ls,
                                                    acc[mt][j][2 * hh + 1] / ls);
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t4) = pair;
      }
      if (t4 == 0) lse[(long long)bh * Sq + row] = m[mt][hh] + logf(ls);
    }
}

// cudaFuncSetAttribute once for each device that launches `kern`: `done`
// holds one bit per device id below 64 (above, it is set at every launch)
template <typename K>
int allow_smem(K kern, size_t smem, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load() & bit)) return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  done.fetch_or(bit);
  return 0;
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Hkv, int Sq, int Sk,
               float sm_scale, int causal, cudaStream_t stream) {
  // cp.async copies 16 bytes at a time
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
          16 != 0)
    return (int)cudaErrorMisalignedAddress;
  constexpr size_t smem = mma_smem_bytes<D>();
  static std::atomic<unsigned long long> done{0};
  const int e = allow_smem(flash_attention_mma_kernel<D>, smem, done);
  if (e != 0) return e;
  constexpr int BQ = MmaTiles<D>::BQ;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  flash_attention_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, H, Hkv, Sq, Sk, sm_scale, causal);
  return (int)cudaGetLastError();
}

// ---- the float32 path -----------------------------------------------------

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int Hkv, int Sq, int Sk,
                float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  static std::atomic<unsigned long long> done{0};
  const int e = allow_smem(flash_attention_kernel<float, D>, smem, done);
  if (e != 0) return e;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_attention_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Hkv, Sq,
      Sk, sm_scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, H, Sq, D); k, v: (B, Hkv, Sk, D), all contiguous and of dtype
// code dt (0 = float32, 1 = bfloat16, which must be 16-byte aligned); lse:
// (B, H, Sq) float32.  D is 64, 112 or 128; H % Hkv == 0.  Launches on `stream`
// and returns cudaGetLastError().
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
  if (dt == 0 && D == 64)
    return launch_fp32<64>(q, k, v, o, l, B, H, Hkv, Sq, Sk, sm_scale,
                           causal, s);
  if (dt == 0 && D == 112)
    return launch_fp32<112>(q, k, v, o, l, B, H, Hkv, Sq, Sk, sm_scale,
                            causal, s);
  if (dt == 0 && D == 128)
    return launch_fp32<128>(q, k, v, o, l, B, H, Hkv, Sq, Sk, sm_scale,
                            causal, s);
  if (dt == 1 && D == 64)
    return launch_mma<64>(q, k, v, o, l, B, H, Hkv, Sq, Sk, sm_scale, causal,
                          s);
  if (dt == 1 && D == 112)
    return launch_mma<112>(q, k, v, o, l, B, H, Hkv, Sq, Sk, sm_scale, causal,
                           s);
  if (dt == 1 && D == 128)
    return launch_mma<128>(q, k, v, o, l, B, H, Hkv, Sq, Sk, sm_scale,
                           causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
