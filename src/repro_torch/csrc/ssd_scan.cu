// The Mamba-2 SSD chunked scan, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py: ssd_scan (:74) ->
// _ssd_kernel (:24), the pl.pallas_call at :88 whose grid (b, h, chunk) ran
// the chunks of each (batch, head) in order and kept the (N, P) state in
// VMEM scratch between grid steps.
//
// What it computes, per (b, h), chunk after chunk, in f32, from a zero
// state S (N x P), with L = min(chunk, s) and group g = h / (H / G):
//   cs = inclusive cumsum(dt * A)                                  (L)
//   W  = (C B^T) o where(i >= j, exp(cs_i - cs_j), 0) o dt_j       (L x L)
//   y  = W @ x + exp(cs_i) * (C @ S)                               (L x P)
//   S <- exp(cs_L) * S + B^T @ ((dt * exp(cs_L - cs)) o x)         (N x P)
// y is written in x's dtype; the final S as st[b, h, p, n] in f32 (the
// scratch state transposed, as the Pallas kernel emits it).  Steps past s
// in the last chunk load dt = 0 and B = C = x = 0: the state is then left
// exactly as it was (exp(0) = 1, no input enters) and their y is not
// written, so any s is taken.  The causal mask is a select, never a
// multiply: for i < j the exponent cs_i - cs_j is positive and may
// overflow, and inf * 0 would be NaN.
//
// What bounds it on the H100: operations.  Per (head, chunk) it does
// L*L*N (C B^T) + L*L*P (W x) + L*N*P (C S) + N*L*P (B^T x) multiply-adds,
// about 3.7 MFLOP at L = 64, N = 128, P = 64, against about 33 KB of
// device-memory traffic.
//
// Two designs, chosen by the inputs' dtype.
//
// bfloat16 (the served model): chunk-parallel, on tensor cores.  The only
// sequential part of the scan is the state's hand-off from chunk to chunk,
// S_c = exp(cs_L,c) S_{c-1} + local_c, with local_c = B^T ((dt o exp(cs_L -
// cs)) o x) a function of chunk c alone.  So one call makes three launches
// on the caller's stream, over the grids that make_plan gives:
//   1. ssd_state_mma_kernel, one 128-thread block per (b, h, chunk, 64
//      columns of P): the chunk's cumsum, local_c^T (P x N) into a scratch
//      tensor states[b, h, c, p, n] (f32) and cs_L into decay[b, h, c];
//   2. ssd_pass_kernel, one thread per four (p, n) of one (b, h): the
//      hand-off, nc steps of an axpy in f32, writing S_{c-1} (the state
//      entering chunk c) as its bf16 parts into planes[b, h, c, part, p, n]
//      and the final S into st;
//   3. ssd_output_mma_kernel, one block per (b, h, chunk, 64 columns):
//      y = W x + exp(cs) o (C S_{c-1}), with one C B^T tile per block.
// Three launches rather than one with an ordered hand-off between blocks:
// nothing waits on another block, so no schedule can deadlock, and the
// hand-off's loads do not depend on the chain (only its FMAs do), so pass
// 2 runs at the speed of its memory traffic; the two extra launches cost a
// few microseconds.  The price is the scratch traffic: each chunk's N x P
// state is written and read twice.  Blocks 1 and 3 compute cs by the same
// code from the same dt, so they agree bit for bit.  The scratch tensors
// are the wrapper's (torch.empty).
//
// The products are mma.sync.m16n8k16 bf16 x bf16 -> f32, operands from
// shared memory by ldmatrix (.trans where the operand is stored the other
// way round), 4 warps of 16 rows each.  C B^T has two bf16 operands, so its
// products are exact and only the summation order differs from f32.  The
// three products with an f32 operand (W x, C S, B^T (decay o x)) take it
// as three bf16 parts, hi = bf16(v), lo = bf16(v - hi) and lo2 = bf16(v -
// hi - lo), one mma each into one accumulator: the parts give v back
// exactly, so these products are exact too, and the kernel computes the
// f32 function in another summation order.  Two parts (16 significant
// bits) are not enough: the kernel and the plain version round their own,
// nearly equal, W, S and decay o x, and where a value sits on a 16-bit
// rounding boundary the two land a quantum apart, which moves a y that is
// the difference of two larger terms past atol 1e-6.  Each k step's
// products are summed by the tensor core into a zero accumulator and then
// added to the running sum by one rounded FADD, so the tensor core's
// truncating additions never see the running sum.  A warp skips the C B^T
// and W x tiles above its rows' diagonal.  B, C, x and the S parts come in
// by 16-byte cp.async copies (element by element where a row is not a
// whole number of 16-byte vectors), zero-filled past s, N and P; rows are
// padded by 16 bytes so that ldmatrix reads are free of bank conflicts.
// dt is loaded before the copies are issued.  The cumsum keeps the
// sequential left-to-right order (see chunk_cumsum).
//
// float32: the first design, kept for the f32 function (TF32 tensor cores
// would round B, C and x to 10-bit mantissas).  One 256-thread block per
// (b, h, 16 columns of P) walks the chunks in order with S (N x 16) in
// shared memory; each chunk loads B and C (L x N, row stride N + 1) and x
// as f32, then: cs (thread i sums dA_0..dA_i left to right); W, a 4 x 4
// register tile of C B^T per thread by FMAs over N, masked and scaled;
// y = W x + exp(cs) (C S), four rows and one column per thread; S updated
// in place after a barrier.
//
// Built with -fmad=false: each multiply and add rounds once, except the
// explicit __fmaf_rn of the f32 path's dot products; the mma is unaffected.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kMaxChunk = 64;   // L: the 4 x 4 tiles of 16 x 16 threads
constexpr int kMaxState = 256;  // N: B and C chunks fit shared memory

// ---- the float32 path ------------------------------------------------------

constexpr int kPT = 16;         // P columns per block
constexpr int kThreads = 256;

__host__ __device__ inline size_t smem_floats(int L, int N) {
  return (size_t)2 * L * (N + 1)      // B, C
         + (size_t)L * (L + 1)        // W
         + (size_t)L * kPT            // x
         + (size_t)N * kPT            // S
         + (size_t)4 * L;             // dt, dA, cs, decay
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bg,
                const float* __restrict__ Cg, float* __restrict__ y,
                float* __restrict__ st, int S, int H, int P, int G, int N,
                int L) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  const int ldw = L + 1;
  float* Bs = smem;                 // L x ldn
  float* Cs = Bs + L * ldn;         // L x ldn
  float* Ws = Cs + L * ldn;         // L x ldw
  float* Xs = Ws + L * ldw;         // L x kPT
  float* Ss = Xs + L * kPT;         // N x kPT: the state, (n, p)
  float* dts = Ss + N * kPT;        // L
  float* dAs = dts + L;             // L
  float* css = dAs + L;             // L
  float* decs = css + L;            // L: dt_j * exp(cs_last - cs_j)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tlo = lane & 15;                   // 0..15
  const int thi = (tid >> 5) * 2 + (lane >> 4);  // 0..15
  const int p0 = blockIdx.x * kPT;
  const int hh = blockIdx.y;
  const long long bb = blockIdx.z;
  const int grp = hh / (H / G);
  const float a = A[hh];
  const bool col_ok = p0 + tlo < P;

  for (int e = tid; e < N * kPT; e += kThreads) Ss[e] = 0.0f;

  // rows of the register tiles, clamped into the chunk so that every
  // shared-memory read stays inside its array (results of clamped rows
  // are never stored)
  int crow[4], brow[4], wrow[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    crow[r] = min(thi + 16 * r, L - 1) * ldn;
    brow[r] = min(tlo + 16 * r, L - 1) * ldn;
    wrow[r] = min(thi + 16 * r, L - 1) * ldw;
  }

  const int nchunks = (S + L - 1) / L;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * L;
    const int len = min(L, S - t0);
    __syncthreads();                 // the last chunk's readers are done

    for (int e = tid; e < L * N; e += kThreads) {
      const int i = e / N, k = e - i * N;
      float bv = 0.0f, cv = 0.0f;
      if (i < len) {
        const long long off = ((bb * S + t0 + i) * G + grp) * N + k;
        bv = Bg[off];
        cv = Cg[off];
      }
      Bs[i * ldn + k] = bv;
      Cs[i * ldn + k] = cv;
    }
    for (int e = tid; e < L * kPT; e += kThreads) {
      const int i = e / kPT, q = e - i * kPT;
      float xv = 0.0f;
      if (i < len && p0 + q < P)
        xv = x[((bb * S + t0 + i) * H + hh) * P + p0 + q];
      Xs[e] = xv;
    }
    for (int i = tid; i < L; i += kThreads) {
      const float d = i < len ? dt[(bb * S + t0 + i) * H + hh] : 0.0f;
      dts[i] = d;
      dAs[i] = d * a;
    }
    __syncthreads();

    // 1. inclusive cumsum, left to right
    if (tid < L) {
      float acc = 0.0f;
      for (int k = 0; k <= tid; ++k) acc = acc + dAs[k];
      css[tid] = acc;
    }
    __syncthreads();
    const float cs_last = css[L - 1];
    if (tid < L) decs[tid] = dts[tid] * expf(cs_last - css[tid]);

    // 2. W = (C B^T) o where(i >= j, exp(cs_i - cs_j), 0) o dt_j
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          cv[r] = Cs[crow[r] + k];
          bv[r] = Bs[brow[r] + k];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[r][q] = __fmaf_rn(cv[r], bv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = thi + 16 * r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = tlo + 16 * q;
          if (i < L && j < L) {
            float w = 0.0f;
            if (i >= j) w = acc[r][q] * expf(css[i] - css[j]) * dts[j];
            Ws[i * ldw + j] = w;
          }
        }
      }
    }
    __syncthreads();

    // 3. y = W @ x + exp(cs_i) * (C @ S)
    {
      float yv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < L; ++j) {
        const float xv = Xs[j * kPT + tlo];
#pragma unroll
        for (int r = 0; r < 4; ++r) yv[r] = __fmaf_rn(Ws[wrow[r] + j], xv, yv[r]);
      }
      float sv4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        const float sv = Ss[k * kPT + tlo];
#pragma unroll
        for (int r = 0; r < 4; ++r) sv4[r] = __fmaf_rn(Cs[crow[r] + k], sv, sv4[r]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = thi + 16 * r;
        if (i < len && col_ok) {
          const float out = yv[r] + expf(css[i]) * sv4[r];
          y[((bb * S + t0 + i) * H + hh) * P + p0 + tlo] = out;
        }
      }
    }
    __syncthreads();                 // every read of S for y is done

    // 4. S <- exp(cs_last) * S + B^T @ (decay o x), in place
    {
      const float gl = expf(cs_last);
      for (int n0 = 0; n0 < N; n0 += 128) {
        float acc[8];
        int nrow[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[r] = 0.0f;
          nrow[r] = min(n0 + thi + 16 * r, N - 1);
        }
        for (int j = 0; j < L; ++j) {
          const float xd = decs[j] * Xs[j * kPT + tlo];
          const float* brj = Bs + j * ldn;
#pragma unroll
          for (int r = 0; r < 8; ++r) acc[r] = __fmaf_rn(brj[nrow[r]], xd, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int n = n0 + thi + 16 * r;
          if (n < N) {
            float* s = Ss + n * kPT + tlo;
            *s = gl * *s + acc[r];
          }
        }
      }
    }
  }
  __syncthreads();

  // the final state, transposed to st[b, h, p, n]
  for (int e = tid; e < kPT * N; e += kThreads) {
    const int q = e / N, k = e - q * N;
    if (p0 + q < P) st[((bb * H + hh) * P + p0 + q) * N + k] = Ss[k * kPT + q];
  }
}

// ---- the bfloat16 path: chunk-parallel, tensor cores ----------------------

constexpr int kMmaThreads = 128;       // 4 warps of 16 rows
constexpr int kLP = 64;                // chunk rows in shared memory
constexpr int kPB = 64;                // P columns per block
constexpr int kLDX = kPB + 8;          // shared row of x, in bf16
constexpr int kPassThreads = 256;
constexpr int kParts = 3;              // bf16 parts of an f32 operand

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr int pad64(int n) { return (n + 63) & ~63; }

// shared bytes of the two tensor-core kernels, for a state of n
__host__ __device__ constexpr size_t state_smem_bytes(int n) {
  // B: kLP x (pad64(n) + 8); x, and decay o x as kParts parts: (1 +
  // kParts) x kLP x kLDX; dt, cs, decay
  return sizeof(bf16) * ((size_t)kLP * (pad64(n) + 8) +
                         (1 + kParts) * kLP * kLDX) +
         sizeof(float) * 3 * kLP;
}
__host__ __device__ constexpr size_t output_smem_bytes(int n) {
  // C, B: kLP x (NP + 8) each; S_{c-1} as kParts parts: kParts x kPB x
  // (NP + 8); x: kLP x kLDX; dt, cs
  return sizeof(bf16) * ((size_t)(2 * kLP + kParts * kPB) * (pad16(n) + 8) +
                         kLP * kLDX) +
         sizeof(float) * 2 * kLP;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
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

// acc += t for eight n tiles, one rounded add per element, and t = 0: a k
// step's products are summed by the tensor core into a zero accumulator,
// whose additions truncate, and only then added to the running sum
__device__ __forceinline__ void add_step(float (&acc)[8][4],
                                         float (&t)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = acc[j][e] + t[j][e];
      t[j][e] = 0.0f;
    }
}
__device__ __forceinline__ void zero(float (&t)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[j][e] = 0.0f;
}

// two f32 as a bf16 pair, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&h);
}
// v as hi = bf16(v), lo = bf16(v - hi) and lo2 = bf16(v - hi - lo):
// each takes the next 8 significant bits, and hi + lo + lo2 is v again
__device__ __forceinline__ void split_bf16(float v, bf16& hi, bf16& lo,
                                           bf16& lo2) {
  hi = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(hi);
  lo = __float2bfloat16_rn(r);
  lo2 = __float2bfloat16_rn(r - __bfloat162float(lo));
}

// Rows [0, kLP) x columns [0, cols_pad) of a bf16 tile into shared memory
// (row stride ld), from rows of `src` `stride` elements apart: rows at or
// past `rows` and columns at or past `cols` as zeros.  `vec`: every valid
// row is whole 16-byte vectors (cols % 8 == 0, aligned), copied by
// cp.async; otherwise element by element.  A thread steps through the
// tile kMmaThreads elements (or vectors) at a time with a carry, not a
// divide per step.
__device__ __forceinline__ void load_tile(bf16* dst, int ld,
                                          const bf16* __restrict__ src,
                                          long long stride, int rows,
                                          int cols, int cols_pad, bool vec) {
  const int unit = vec ? 8 : 1;              // elements a step copies
  const int per_row = cols_pad / unit;
  const int dr = kMmaThreads / per_row, dc = kMmaThreads % per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x % per_row;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  while (r < kLP) {
    const int k = c * unit;
    const bool valid = r < rows && k < cols;
    if (vec)
      cp_async16(dst + r * ld + k, valid ? src + r * stride + k : src, valid);
    else
      dst[r * ld + k] = valid ? src[r * stride + k] : zero;
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// dt of the chunk's row threadIdx.x (zero past `len`), loaded ahead of
// the block's copies so that their latencies overlap
__device__ __forceinline__ float load_dt(const bf16* __restrict__ dtp,
                                         long long stride, int len) {
  return threadIdx.x < len ? __bfloat162float(dtp[threadIdx.x * stride])
                           : 0.0f;
}

// dt (from load_dt) into dts, and the inclusive cumsum of dt * a into css,
// both kLP floats.  Every thread calls it; one thread adds left to right,
// in registers, the order of the plain version's (and the float32 path's)
// sequential cumsum: a cs_j one ulp off moves exp(cs_i - cs_j) by 2e-6
// near cs = -30, which a y near zero shows past atol 1e-6.  Ends with a
// barrier.
__device__ __forceinline__ void chunk_cumsum(float* dts, float* css, float d,
                                             float a) {
  if (threadIdx.x < kLP) {
    dts[threadIdx.x] = d;
    css[threadIdx.x] = d * a;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float4* c4 = reinterpret_cast<float4*>(css);
    float v[kLP];
#pragma unroll
    for (int q = 0; q < kLP / 4; ++q) {
      const float4 t = c4[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kLP; ++i) {
      acc = acc + v[i];
      v[i] = acc;
    }
#pragma unroll
    for (int q = 0; q < kLP / 4; ++q)
      c4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  __syncthreads();
}

// 1. local_c^T = (decay o x)^T B, (P x N) of chunk c, into
// states[b, h, c, p, n]; cs_L into decay[b, h, c]
__global__ void __launch_bounds__(kMmaThreads)
ssd_state_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bg,
                     float* __restrict__ states, float* __restrict__ decay,
                     int S, int H, int P, int G, int N, int L, int nc,
                     int ptiles, int vec_b, int vec_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NB = pad64(N), ldn = NB + 8;   // whole 64-column passes
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);          // kLP x ldn
  bf16* Xs = Bs + kLP * ldn;                             // kLP x kLDX
  bf16* Xp = Xs + kLP * kLDX;                            // kParts x kLP x kLDX
  float* dts = reinterpret_cast<float*>(Xp + kParts * kLP * kLDX);
  float* css = dts + kLP;
  float* decs = css + kLP;

  const int c = blockIdx.x / ptiles, p0 = (blockIdx.x - c * ptiles) * kPB;
  const int hh = blockIdx.y;
  const long long bb = blockIdx.z;
  const int grp = hh / (H / G);
  const int t0 = c * L, len = min(L, S - t0);
  const long long row0 = bb * S + t0;                    // token of row 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int pcols = min(kPB, P - p0);

  const float d = load_dt(dt + row0 * H + hh, H, len);
  load_tile(Bs, ldn, Bg + (row0 * G + grp) * N, (long long)G * N, len, N, NB,
            vec_b);
  load_tile(Xs, kLDX, x + row0 * H * P + (long long)hh * P + p0,
            (long long)H * P, len, pcols, kPB, vec_x);
  cp_async_commit();
  chunk_cumsum(dts, css, d, A[hh]);
  const float cs_last = css[kLP - 1];
  if (threadIdx.x < kLP)
    decs[threadIdx.x] = dts[threadIdx.x] * expf(cs_last - css[threadIdx.x]);
  if (threadIdx.x == 0 && p0 == 0)
    decay[(bb * H + hh) * nc + c] = cs_last;
  cp_async_wait_all();
  __syncthreads();

  // decay o x as its parts (zeros stay zeros)
  for (int e = threadIdx.x; e < kLP * (kPB / 8); e += kMmaThreads) {
    const int r = e / (kPB / 8), c8 = (e - r * (kPB / 8)) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(Xs + r * kLDX + c8);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
    uint4 part[kParts];
    bf16* h = reinterpret_cast<bf16*>(&part[0]);
    bf16* l = reinterpret_cast<bf16*>(&part[1]);
    bf16* l2 = reinterpret_cast<bf16*>(&part[2]);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      split_bf16(decs[r] * __bfloat162float(v[k]), h[k], l[k], l2[k]);
#pragma unroll
    for (int q = 0; q < kParts; ++q)
      *reinterpret_cast<uint4*>(Xp + (q * kLP + r) * kLDX + c8) = part[q];
  }
  __syncthreads();

  const int m0 = warp * 16;                  // this warp's 16 columns of P
  if (m0 >= pcols) return;
  // (decay o x)^T as A fragments: rows p, k over the chunk's rows
  const int ksteps = (len + 15) / 16;        // 16-row steps with rows
  uint32_t a[kParts][kLP / 16][4];
#pragma unroll
  for (int q = 0; q < kParts; ++q)
#pragma unroll
    for (int ks = 0; ks < kLP / 16; ++ks)
      if (ks < ksteps)
        ldmatrix_x4_trans(a[q][ks], Xp + (q * kLP + ks * 16 +
                                        ((lane >> 4) << 3) + (lane & 7)) *
                                           kLDX +
                                       m0 + ((lane >> 3) & 1) * 8);
  float* out = states + (((bb * H + hh) * nc + c) * P + p0) * (long long)N;
  const bool pairs = (N & 1) == 0;
  for (int nb = 0; nb < NB; nb += 64) {      // 64 state columns a pass
    float acc[8][4], t[8][4];
    zero(acc);
    zero(t);
#pragma unroll
    for (int ks = 0; ks < kLP / 16; ++ks) {
      if (ks >= ksteps) continue;
      uint32_t bf[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ldmatrix_x4_trans(bf[jj], Bs + (ks * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * ldn +
                                      nb + jj * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int q = 0; q < kParts; ++q)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          mma_bf16(t[2 * jj], a[q][ks], bf[jj][0], bf[jj][1]);
          mma_bf16(t[2 * jj + 1], a[q][ks], bf[jj][2], bf[jj][3]);
        }
      add_step(acc, t);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = nb + j * 8 + 2 * t4;
      if (n >= N) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = m0 + gr + 8 * hf;
        if (p >= pcols) continue;
        float* o = out + (long long)p * N + n;
        if (pairs) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
        } else {
          o[0] = acc[j][2 * hf];
          if (n + 1 < N) o[1] = acc[j][2 * hf + 1];
        }
      }
    }
  }
}

// 2. the hand-off: S_{c-1}, the state entering chunk c, as its kParts bf16
// parts into planes[b, h, c, kParts, p, n] (what block 3 multiplies), the
// final S into st.  Each thread takes VEC neighbouring (p, n) of one (b,
// h) through the chunks; a round's loads are issued together, ahead of
// its FMAs.
template <int VEC>
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(const float* __restrict__ states,
                const float* __restrict__ decay, bf16* __restrict__ planes,
                float* __restrict__ st, int H, int PN, int nc) {
  constexpr int kRound = 8;
  typedef typename std::conditional<VEC == 4, float4, float>::type F;
  const long long e =
      ((long long)blockIdx.x * kPassThreads + threadIdx.x) * VEC;
  if (e >= PN) return;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  const float* lp = states + bh * nc * PN + e;
  const float* dp = decay + bh * nc;
  bf16* hp = planes + bh * nc * kParts * PN + e;
  float s[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s[v] = 0.0f;
  for (int c0 = 0; c0 < nc; c0 += kRound) {
    F local[kRound];
    float g[kRound];
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const bool ok = c0 + u < nc;
      local[u] = ok ? *reinterpret_cast<const F*>(lp + (long long)(c0 + u) *
                                                           PN)
                    : F{};
      g[u] = ok ? dp[c0 + u] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      if (c0 + u >= nc) break;
      bf16* o = hp + (long long)(c0 + u) * kParts * PN;
      const float* lv = reinterpret_cast<const float*>(&local[u]);
      bf16 part[kParts][VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        split_bf16(s[v], part[0][v], part[1][v], part[2][v]);
        s[v] = expf(g[u]) * s[v] + lv[v];
      }
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        if constexpr (VEC == 4) {
          __nv_bfloat162 p01 = __halves2bfloat162(part[q][0], part[q][1]);
          __nv_bfloat162 p23 = __halves2bfloat162(part[q][2], part[q][3]);
          *reinterpret_cast<uint2*>(o + q * PN) =
              make_uint2(*reinterpret_cast<uint32_t*>(&p01),
                         *reinterpret_cast<uint32_t*>(&p23));
        } else {
          o[q * PN] = part[q][0];
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) st[bh * PN + e + v] = s[v];
}

// 3. y = W x + exp(cs) o (C S_{c-1}) of chunk c, 64 columns of P
__global__ void __launch_bounds__(kMmaThreads)
ssd_output_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
                      const float* __restrict__ A,
                      const bf16* __restrict__ Bg, const bf16* __restrict__ Cg,
                      const bf16* __restrict__ planes, bf16* __restrict__ y,
                      int S, int H, int P, int G, int N, int L, int nc,
                      int ptiles, int vec_b, int vec_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NP = pad16(N), ldn = NP + 8;
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);          // kLP x ldn
  bf16* Bs = Cs + kLP * ldn;                             // kLP x ldn
  bf16* Sp = Bs + kLP * ldn;                 // kParts x kPB x ldn: (p, n)
  bf16* Xs = Sp + kParts * kPB * ldn;                    // kLP x kLDX
  float* dts = reinterpret_cast<float*>(Xs + kLP * kLDX);
  float* css = dts + kLP;

  const int c = blockIdx.x / ptiles, p0 = (blockIdx.x - c * ptiles) * kPB;
  const int hh = blockIdx.y;
  const long long bb = blockIdx.z;
  const int grp = hh / (H / G);
  const int t0 = c * L, len = min(L, S - t0);
  const long long row0 = bb * S + t0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int pcols = min(kPB, P - p0);

  const float d = load_dt(dt + row0 * H + hh, H, len);
  const long long boff = (row0 * G + grp) * N;
  load_tile(Cs, ldn, Cg + boff, (long long)G * N, len, N, NP, vec_b);
  load_tile(Bs, ldn, Bg + boff, (long long)G * N, len, N, NP, vec_b);
  load_tile(Xs, kLDX, x + row0 * H * P + (long long)hh * P + p0,
            (long long)H * P, len, pcols, kPB, vec_x);
  // S_{c-1} as its parts (the first chunk's is zero, and its C S term is
  // skipped); rows past P and columns past N as zeros
  const bool carry = c > 0;
  if (carry) {
    const long long pn = (long long)P * N;
    const bf16* sp = planes + ((bb * H + hh) * nc + c) * kParts * pn +
                     (long long)p0 * N;
#pragma unroll
    for (int q = 0; q < kParts; ++q)
      load_tile(Sp + q * kPB * ldn, ldn, sp + q * pn, N, pcols, N, NP, vec_b);
  }
  cp_async_commit();
  chunk_cumsum(dts, css, d, A[hh]);
  cp_async_wait_all();
  __syncthreads();

  const int m0 = warp * 16;                  // this warp's 16 rows
  if (m0 >= len) return;
  // C B^T up to the warp's diagonal (16-column groups jj <= warp; the rest
  // stays zero and is masked below) and C S_{c-1}, one 16-wide step of N
  // at a time
  float s[8][4], yc[8][4], t[8][4];
  zero(s);
  zero(yc);
  zero(t);
  for (int ks = 0; ks < NP / 16; ++ks) {
    uint32_t cf[4];
    ldmatrix_x4(cf, Cs + (m0 + (lane & 15)) * ldn + ks * 16 + (lane >> 4) * 8);
    const int koff = ks * 16 + ((lane >> 3) & 1) * 8;
    uint32_t f[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (jj <= warp)
        ldmatrix_x4(f[jj], Bs + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                    ldn + koff);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (jj <= warp) {
        mma_bf16(t[2 * jj], cf, f[jj][0], f[jj][1]);
        mma_bf16(t[2 * jj + 1], cf, f[jj][2], f[jj][3]);
      }
    add_step(s, t);
    if (carry) {
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
#pragma unroll
        for (int dp = 0; dp < 4; ++dp)
          ldmatrix_x4(f[dp], Sp + (q * kPB + dp * 16 + (lane & 7) +
                                   ((lane >> 4) << 3)) * ldn + koff);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          mma_bf16(t[2 * dp], cf, f[dp][0], f[dp][1]);
          mma_bf16(t[2 * dp + 1], cf, f[dp][2], f[dp][3]);
        }
      }
      add_step(yc, t);
    }
  }

  // W = (C B^T) o where(i >= j, exp(cs_i - cs_j), 0) o dt_j, in registers
  float ci[2];
  ci[0] = css[m0 + gr];
  ci[1] = css[m0 + gr + 8];
#pragma unroll
  for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = m0 + gr + 8 * (e >> 1);
      const int j = j8 * 8 + 2 * t4 + (e & 1);
      s[j8][e] = i >= j ? s[j8][e] * expf(ci[e >> 1] - css[j]) * dts[j] : 0.0f;
    }

  // y = W x up to the warp's diagonal: the W fragments of n tiles 2 kk and
  // 2 kk + 1 are the A fragment of step kk, as its parts hi, lo and lo2
  float yd[8][4];
  zero(yd);
#pragma unroll
  for (int kk = 0; kk < kLP / 16; ++kk) {
    if (kk > warp) continue;
    uint32_t w[kParts][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // r: 0 (row gr, columns 2 t4), 1 (row gr + 8), 2 (row gr, columns
      // 8 + 2 t4), 3 (row gr + 8, columns 8 + 2 t4)
      const float v0 = s[2 * kk + (r >> 1)][2 * (r & 1)];
      const float v1 = s[2 * kk + (r >> 1)][2 * (r & 1) + 1];
      const uint32_t hi = pack_bf16(v0, v1);
      const float r0 = v0 - __uint_as_float(hi << 16);
      const float r1 = v1 - __uint_as_float(hi & 0xffff0000u);
      const uint32_t lo = pack_bf16(r0, r1);
      w[0][r] = hi;
      w[1][r] = lo;
      w[2][r] = pack_bf16(r0 - __uint_as_float(lo << 16),
                          r1 - __uint_as_float(lo & 0xffff0000u));
    }
    uint32_t xf[4][4];
#pragma unroll
    for (int dp = 0; dp < 4; ++dp)
      ldmatrix_x4_trans(xf[dp], Xs + (kk * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * kLDX +
                                    dp * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int q = 0; q < kParts; ++q)
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        mma_bf16(t[2 * dp], w[q], xf[dp][0], xf[dp][1]);
        mma_bf16(t[2 * dp + 1], w[q], xf[dp][2], xf[dp][3]);
      }
    add_step(yd, t);
  }

  // y = W x + exp(cs_i) (C S_{c-1}), rounded once to bf16
  const float gi[2] = {expf(ci[0]), expf(ci[1])};
  const bool pairs = (P & 1) == 0;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = m0 + gr + 8 * hf;
    if (i >= len) continue;
    bf16* yr = y + ((row0 + i) * H + hh) * (long long)P + p0;
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      const int p = j8 * 8 + 2 * t4;
      if (p >= pcols) continue;
      const float o0 = yd[j8][2 * hf] + gi[hf] * yc[j8][2 * hf];
      const float o1 = yd[j8][2 * hf + 1] + gi[hf] * yc[j8][2 * hf + 1];
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(yr + p) =
            __floats2bfloat162_rn(o0, o1);
      } else {
        yr[p] = __float2bfloat16_rn(o0);
        if (p + 1 < pcols) yr[p + 1] = __float2bfloat16_rn(o1);
      }
    }
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

// The grids of one call's launches, in launch order: the one place that
// decides them (the launchers launch them, ssd_scan_plan reports them).
// float32: ssd_scan_kernel over (16 columns of P, h, b).  bfloat16:
// ssd_state_mma_kernel over (chunk x 64 columns of P, h, b), ssd_pass_kernel
// over (kPassThreads threads of `vec` state entries each, h, b), and
// ssd_output_mma_kernel over the first grid again.  count is 0 where a
// grid would be too large.
struct Plan {
  int count;                 // launches
  dim3 grid[3];
  int nc, ptiles;            // chunks; 64-column blocks of P
  int vec;                   // the hand-off's state entries a thread
};

Plan make_plan(int b, int s, int h, int p, int n, int L, int dtype) {
  Plan pl{};
  if (dtype == 0) {
    pl.count = 1;
    pl.grid[0] = dim3((unsigned)((p + kPT - 1) / kPT), (unsigned)h,
                      (unsigned)b);
    return pl;
  }
  const long long nc = (s + L - 1) / L, ptiles = (p + kPB - 1) / kPB;
  const long long pn = (long long)p * n;
  if (nc * ptiles > 0x7fffffffLL || pn > 0x7fffffffLL) return pl;
  pl.count = 3;
  pl.nc = (int)nc;
  pl.ptiles = (int)ptiles;
  pl.vec = pn % 4 == 0 ? 4 : 1;     // whole float4s
  pl.grid[0] = pl.grid[2] =
      dim3((unsigned)(nc * ptiles), (unsigned)h, (unsigned)b);
  pl.grid[1] = dim3(
      (unsigned)((pn / pl.vec + kPassThreads - 1) / kPassThreads),
      (unsigned)h, (unsigned)b);
  return pl;
}

int launch_fp32(const void* x, const void* dt, const void* A, const void* B,
                const void* C, void* y, void* st, int s, int h, int p, int g,
                int n, int L, const Plan& pl, cudaStream_t stream) {
  const size_t smem = smem_floats(L, n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<pl.grid[0], kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(st), s, h, p, g, n, L);
  return (int)cudaGetLastError();
}

int launch_mma(const void* x, const void* dt, const void* A, const void* B,
               const void* C, void* y, void* st, void* states, void* planes,
               void* decay, int s, int h, int p, int g, int n, int L,
               const Plan& pl, cudaStream_t stream) {
  static std::atomic<unsigned long long> done_state{0}, done_output{0};
  int e = allow_smem(ssd_state_mma_kernel, state_smem_bytes(kMaxState),
                     done_state);
  if (e != 0) return e;
  e = allow_smem(ssd_output_mma_kernel, output_smem_bytes(kMaxState),
                 done_output);
  if (e != 0) return e;
  // 16-byte copies where every row of B, C and the S planes, and of x, is
  // whole vectors
  const int vec_b = n % 8 == 0 && (reinterpret_cast<uintptr_t>(B) |
                                   reinterpret_cast<uintptr_t>(C) |
                                   reinterpret_cast<uintptr_t>(planes)) %
                                          16 == 0;
  const int vec_x = p % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dtb = static_cast<const bf16*>(dt);
  const float* Af = static_cast<const float*>(A);
  const bf16* Bb = static_cast<const bf16*>(B);
  const bf16* Cb = static_cast<const bf16*>(C);
  float* sts = static_cast<float*>(states);
  bf16* pls = static_cast<bf16*>(planes);
  float* dec = static_cast<float*>(decay);

  ssd_state_mma_kernel<<<pl.grid[0], kMmaThreads, state_smem_bytes(n),
                         stream>>>(xb, dtb, Af, Bb, sts, dec, s, h, p, g, n,
                                   L, pl.nc, pl.ptiles, vec_b, vec_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int pn = p * n;
  if (pl.vec == 4)
    ssd_pass_kernel<4><<<pl.grid[1], kPassThreads, 0, stream>>>(
        sts, dec, pls, static_cast<float*>(st), h, pn, pl.nc);
  else
    ssd_pass_kernel<1><<<pl.grid[1], kPassThreads, 0, stream>>>(
        sts, dec, pls, static_cast<float*>(st), h, pn, pl.nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_output_mma_kernel<<<pl.grid[2], kMmaThreads, output_smem_bytes(n),
                          stream>>>(xb, dtb, Af, Bb, Cb, pls,
                                    static_cast<bf16*>(y), s, h, p, g, n, L,
                                    pl.nc, pl.ptiles, vec_b, vec_x);
  return (int)cudaGetLastError();
}

// the arguments both entry points refuse
bool refused(int b, int h, int g, int n, int chunk, int dtype) {
  return g <= 0 || h % g != 0 || chunk < 1 || chunk > kMaxChunk ||
         n > kMaxState || b > 65535 || h > 65535 || (dtype != 0 && dtype != 1);
}

}  // namespace

// x (b, s, h, p), dt (b, s, h), B and C (b, s, g, n): contiguous, all
// float32 (dtype 0) or all bfloat16 (dtype 1); A (h,) float32; y (b, s, h,
// p) in x's dtype; st (b, h, p, n) float32.  chunk is the chunk length L
// (the wrapper passes min(chunk, s)).  For bfloat16, three scratch
// tensors with nc = ceil(s / L): `states` of b * h * nc * p * n floats,
// `planes` of 3 * b * h * nc * p * n bfloat16 and `decay` of b * h * nc
// floats; float32 takes none (they may be null).  Launches on
// `stream` (bfloat16: three kernels, float32: one; see ssd_scan_plan) and
// returns cudaGetLastError().
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* st, void* states, void* planes,
                               void* decay, int b, int s, int h, int p, int g,
                               int n, int chunk, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0) return 0;
  if (refused(b, h, g, n, chunk, dtype)) return (int)cudaErrorInvalidValue;
  const int L = chunk < s ? chunk : s;
  const Plan pl = make_plan(b, s, h, p, n, L, dtype);
  if (pl.count == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fp32(x, dt, A, B, C, y, st, s, h, p, g, n, L, pl, stream_);
  if (states == nullptr || planes == nullptr || decay == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_mma(x, dt, A, B, C, y, st, states, planes, decay, s, h, p,
                    g, n, L, pl, stream_);
}

// The CUDA launches that ssd_scan_launch makes with these arguments: their
// number (0 if it would launch none or refuse them), and the blocks of each
// grid in launch order into blocks[0..count) (float32: ssd_scan_kernel;
// bfloat16: ssd_state_mma_kernel, ssd_pass_kernel, ssd_output_mma_kernel).
extern "C" int ssd_scan_plan(int b, int s, int h, int p, int g, int n,
                             int chunk, int dtype, long long* blocks) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 ||
      refused(b, h, g, n, chunk, dtype))
    return 0;
  const Plan pl = make_plan(b, s, h, p, n, chunk < s ? chunk : s, dtype);
  for (int i = 0; i < pl.count; ++i)
    blocks[i] = (long long)pl.grid[i].x * pl.grid[i].y * pl.grid[i].z;
  return pl.count;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
