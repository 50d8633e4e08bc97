// kernel 'reduce2', local size (2, 1, 1): one thread block of 2 threads per work-group, one thread per work-item
// region transitions: direct, every successor is work-group uniform
// barriers: 2 of 7 kept as __syncthreads()
// emitted by repro_torch/core/targets/cuda_target.py
#include "wg_runtime.cuh"

extern "C" __global__ void __launch_bounds__(2) wg_kernel(float* b0, long long n0, float* b1, long long n1, int wg_lo, int wg_ng0, int wg_ng1, int wg_ng2) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const int wg_lin = (int)threadIdx.x;
  const int wg_grp = (int)blockIdx.x + wg_lo;
  const int wg_lid0 = wg_lin % 2;
  const int wg_lid1 = (wg_lin / 2) % 1;
  const int wg_lid2 = wg_lin / 2;
  const int wg_gid0 = wg_grp % wg_ng0;
  const int wg_gid1 = (wg_grp / wg_ng0) % wg_ng1;
  const int wg_gid2 = wg_grp / (wg_ng0 * wg_ng1);
  float* l2 = (float*)(wg_smem + 0);  // local scratch
  int v0 = 0;
  int v1 = 0;
  int v2 = 0;
  float v3 = 0;
  int v4 = 0;
  bool v5 = 0;
  bool v6 = 0;
  float v7 = 0;
  bool v8 = 0;
  float v9 = 0;
  int v10 = 0;
  float v11 = 0;
  float v12 = 0;
  int v13 = 0;
  int q0 = 0;  // vreg r.s.loop
  // LOCAL arrays start zeroed in every work-group
  for (int i = wg_lin; i < 4; i += 2) ((int*)wg_smem)[i] = 0;
  __syncthreads();
  // region 0 (after barrier block b1, entry, dropped)
wg_r0:;
R0_b2:;
  v0 = wg_lid0;
  v1 = wg_iadd(wg_imul(wg_gid0, 2), wg_lid0);
  v2 = wg_gid0;
  v3 = wg_ld<float>(b0, n0, (long long)v1);
  l2[v0] = v3;
  goto wg_r1;
  // region 1 (after barrier block b3, explicit)
wg_r1:;
  __syncthreads();
R1_b4:;
  goto wg_r2;
  // region 2 (after barrier block b5, bloop-pre, dropped)
wg_r2:;
R2_b6:;
  q0 = (1);
  goto R2_b7;
R2_b7:;
  v4 = q0;
  goto wg_r3;
  // region 3 (after barrier block b8, bloop-header, dropped)
wg_r3:;
R3_b9:;
  v5 = (v4 > (0));
  if (v5) goto R3_b15; else goto R3_b10;
R3_b10:;
  v6 = (v0 == (0));
  if (v6) goto R3_b11; else goto R3_b12;
R3_b11:;
  v7 = l2[(0)];
  wg_st<float>(b1, n1, (long long)v2, v7);
  goto R3_b12;
R3_b12:;
  goto wg_r4;
R3_b15:;
  v8 = (v0 < v4);
  if (v8) goto R3_b16; else goto R3_b17;
R3_b16:;
  v9 = l2[v0];
  v10 = wg_iadd(v0, v4);
  v11 = wg_ld<float>(l2, 2, (long long)v10);
  v12 = (v9 + v11);
  l2[v0] = v12;
  goto R3_b17;
R3_b17:;
  goto wg_r5;
  // region 4 (after barrier block b13, exit, dropped)
wg_r4:;
R4_b14:;
  goto wg_done;
  // region 5 (after barrier block b18, explicit)
wg_r5:;
  __syncthreads();
R5_b19:;
  v13 = wg_idiv(v4, (2));
  goto wg_r6;
  // region 6 (after barrier block b20, bloop-latch, dropped)
wg_r6:;
R6_b21:;
  q0 = v13;
  goto R6_b7;
R6_b7:;
  v4 = q0;
  goto wg_r3;
wg_done:;
}

extern "C" int wg_launch(float* b0, long long n0, float* b1, long long n1, int wg_lo, int wg_groups, int wg_ng0, int wg_ng1, int wg_ng2, int wg_device, void* wg_stream) {
  if (wg_groups <= 0) return 0;
  cudaError_t e = cudaSetDevice(wg_device);
  if (e != cudaSuccess) return (int)e;
  wg_kernel<<<wg_groups, 2, 16, (cudaStream_t)wg_stream>>>((float*)b0, n0, (float*)b1, n1, wg_lo, wg_ng0, wg_ng1, wg_ng2);
  return (int)cudaGetLastError();
}

extern "C" const char* wg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
