// The Mamba-2 SSD chunked scan, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py: ssd_scan (:74) ->
// _ssd_kernel (:24), the pl.pallas_call at :88 whose grid (b, h, chunk) ran
// the chunks of each (batch, head) in order and kept the (N, P) state in
// VMEM scratch between grid steps.
//
// What it computes, per (b, h), chunk after chunk in order, in f32, from a
// zero state S (N x P), with L = min(chunk, s) and group g = h / (H / G):
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
// device-memory traffic; at ~110 FLOP per byte it sits above the FP32
// CUDA cores' ridge (67 TFLOP/s over 3.35 TB/s = 20).
//
// Design (simple first): one 256-thread block per (b, h, 16 columns of P);
// the P columns of y and S are independent, so at batch 1 the 48 heads of
// mamba2-780m give 192 blocks.  The chunk loop runs inside the block with
// S (N x 16) in shared memory; each chunk loads B and C (L x N, row stride
// N + 1 so that rows that differ by one sit in neighbouring banks), x
// (L x 16) and dt into shared memory as f32, then:
//   1. cs: thread i sums dA_0..dA_i left to right (the order of a
//      sequential cumsum);
//   2. W: each thread holds a 4 x 4 register tile of C B^T (rows
//      ti + 16r, columns tj + 16c), explicit FMAs over N, then the masked
//      decay and dt, stored as an L x (L + 1) tile;
//   3. y: four rows and one column per thread, W @ x then C @ S;
//   4. S: eight state rows and one column per thread, written in place
//      after a barrier (y has read S by then).
// The C B^T tile is recomputed by each of a head's four column blocks;
// tensor cores (wgmma) for the L x L and L x N products and TMA loads are
// the later, faster design.  Built with -fmad=false: each multiply and add
// rounds once, except the explicit __fmaf_rn of the dot products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 64;   // L: the 4 x 4 tiles of 16 x 16 threads
constexpr int kMaxState = 256;  // N: B and C chunks fit shared memory
constexpr int kPT = 16;         // P columns per block
constexpr int kThreads = 256;

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

__host__ __device__ inline size_t smem_floats(int L, int N) {
  return (size_t)2 * L * (N + 1)      // B, C
         + (size_t)L * (L + 1)        // W
         + (size_t)L * kPT            // x
         + (size_t)N * kPT            // S
         + (size_t)4 * L;             // dt, dA, cs, decay
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bg,
                const T* __restrict__ Cg, T* __restrict__ y,
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
        bv = to_f(Bg[off]);
        cv = to_f(Cg[off]);
      }
      Bs[i * ldn + k] = bv;
      Cs[i * ldn + k] = cv;
    }
    for (int e = tid; e < L * kPT; e += kThreads) {
      const int i = e / kPT, q = e - i * kPT;
      float xv = 0.0f;
      if (i < len && p0 + q < P)
        xv = to_f(x[((bb * S + t0 + i) * H + hh) * P + p0 + q]);
      Xs[e] = xv;
    }
    for (int i = tid; i < L; i += kThreads) {
      const float d = i < len ? to_f(dt[(bb * S + t0 + i) * H + hh]) : 0.0f;
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
          y[((bb * S + t0 + i) * H + hh) * P + p0 + tlo] = from_f<T>(out);
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

template <typename T>
int launch_typed(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, void* y, void* st, int b, int s, int h, int p,
                 int g, int n, int L, cudaStream_t stream) {
  const size_t smem = smem_floats(L, n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p + kPT - 1) / kPT), (unsigned)h, (unsigned)b);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), static_cast<float*>(st),
      s, h, p, g, n, L);
  return (int)cudaGetLastError();
}

}  // namespace

// x (b, s, h, p), dt (b, s, h), B and C (b, s, g, n): contiguous, all
// float32 (dtype 0) or all bfloat16 (dtype 1); A (h,) float32; y (b, s, h,
// p) in x's dtype; st (b, h, p, n) float32.  chunk is the chunk length L
// (the wrapper passes min(chunk, s)).  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* st, int b, int s, int h, int p, int g,
                               int n, int chunk, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0) return 0;
  if (g <= 0 || h % g != 0 || chunk < 1 || chunk > kMaxChunk ||
      n > kMaxState || b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  const int L = chunk < s ? chunk : s;
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(x, dt, A, B, C, y, st, b, s, h, p, g, n, L,
                               stream_);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(x, dt, A, B, C, y, st, b, s, h, p, g,
                                       n, L, stream_);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
