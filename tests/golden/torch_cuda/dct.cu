// kernel 'dct', local size (8, 1, 1): one thread block of 8 threads per work-group, one thread per work-item
// region transitions: direct, every successor is work-group uniform
// barriers: 1 of 5 kept as __syncthreads()
// emitted by repro_torch/core/targets/cuda_target.py
#include "wg_runtime.cuh"

extern "C" __global__ void __launch_bounds__(8) wg_kernel(float* b0, long long n0, float* b1, long long n1, float* b2, long long n2, int v0, int wg_lo, int wg_ng0, int wg_ng1, int wg_ng2) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const int wg_lin = (int)threadIdx.x;
  const int wg_grp = (int)blockIdx.x + wg_lo;
  const int wg_lid0 = wg_lin % 8;
  const int wg_lid1 = (wg_lin / 8) % 1;
  const int wg_lid2 = wg_lin / 8;
  const int wg_gid0 = wg_grp % wg_ng0;
  const int wg_gid1 = (wg_grp / wg_ng0) % wg_ng1;
  const int wg_gid2 = wg_grp / (wg_ng0 * wg_ng1);
  int v1 = 0;
  float v2 = 0;
  int v3 = 0;
  bool v4 = 0;
  float v5 = 0;
  int v6 = 0;
  int v7 = 0;
  float v8 = 0;
  float v9 = 0;
  float v10 = 0;
  int v11 = 0;
  float q0 = 0;  // vreg r.acc.loop
  int q1 = 0;  // vreg r.k.loop
  // region 0 (after barrier block b1, entry, dropped)
wg_r0:;
R0_b2:;
  v1 = wg_lid0;
  q0 = (0x0.0p+0f);
  q1 = (0);
  goto wg_r1;
  // region 1 (after barrier block b3, bloop-pre, dropped)
wg_r1:;
R1_b4:;
  goto R1_b5;
R1_b5:;
  v2 = q0;
  v3 = q1;
  goto wg_r2;
  // region 2 (after barrier block b6, bloop-header)
wg_r2:;
  __syncthreads();
R2_b7:;
  v4 = (v3 < v0);
  if (v4) goto R2_b11; else goto R2_b8;
R2_b8:;
  wg_st<float>(b2, n2, (long long)v1, v2);
  goto wg_r3;
R2_b11:;
  v5 = wg_ld<float>(b1, n1, (long long)v3);
  v6 = wg_imul(v1, v0);
  v7 = wg_iadd(v6, v3);
  v8 = wg_ld<float>(b0, n0, (long long)v7);
  v9 = (v5 * v8);
  v10 = (v2 + v9);
  v11 = wg_iadd(v3, (1));
  q0 = v10;
  q1 = v11;
  goto wg_r4;
  // region 3 (after barrier block b9, exit, dropped)
wg_r3:;
R3_b10:;
  goto wg_done;
  // region 4 (after barrier block b12, bloop-latch, dropped)
wg_r4:;
R4_b13:;
  goto R4_b5;
R4_b5:;
  v2 = q0;
  v3 = q1;
  goto wg_r2;
wg_done:;
}

extern "C" int wg_launch(float* b0, long long n0, float* b1, long long n1, float* b2, long long n2, int v0, int wg_lo, int wg_groups, int wg_ng0, int wg_ng1, int wg_ng2, int wg_device, void* wg_stream) {
  if (wg_groups <= 0) return 0;
  cudaError_t e = cudaSetDevice(wg_device);
  if (e != cudaSuccess) return (int)e;
  wg_kernel<<<wg_groups, 8, 0, (cudaStream_t)wg_stream>>>((float*)b0, n0, (float*)b1, n1, (float*)b2, n2, v0, wg_lo, wg_ng0, wg_ng1, wg_ng2);
  return (int)cudaGetLastError();
}

extern "C" const char* wg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
