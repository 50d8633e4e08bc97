// kernel 'condbar', local size (4, 1, 1): one thread block of 4 threads per work-group, one thread per work-item
// region transitions: direct, every successor is work-group uniform
// barriers: 1 of 4 kept as __syncthreads()
// emitted by repro_torch/core/targets/cuda_target.py
#include "wg_runtime.cuh"

extern "C" __global__ void __launch_bounds__(4) wg_kernel(float* b0, long long n0, int v0, int wg_lo, int wg_ng0, int wg_ng1, int wg_ng2) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const int wg_lin = (int)threadIdx.x;
  const int wg_grp = (int)blockIdx.x + wg_lo;
  const int wg_lid0 = wg_lin % 4;
  const int wg_lid1 = (wg_lin / 4) % 1;
  const int wg_lid2 = wg_lin / 4;
  const int wg_gid0 = wg_grp % wg_ng0;
  const int wg_gid1 = (wg_grp / wg_ng0) % wg_ng1;
  const int wg_gid2 = wg_grp / (wg_ng0 * wg_ng1);
  int v1 = 0;
  bool v2 = 0;
  float v3 = 0;
  float v4 = 0;
  float v5 = 0;
  float v6 = 0;
  // region 0 (after barrier block b1, entry, dropped)
wg_r0:;
R0_b2:;
  v1 = wg_iadd(wg_imul(wg_gid0, 4), wg_lid0);
  v2 = (v0 > (0));
  if (v2) goto wg_r2; else goto R0_b3;
R0_b3:;
  v3 = wg_ld<float>(b0, n0, (long long)v1);
  v4 = (v3 + (0x1.0000000000000p+0f));
  wg_st<float>(b0, n0, (long long)v1, v4);
  goto wg_r1;
  // region 1 (after barrier block b4, exit, dropped)
wg_r1:;
R1_b5:;
  goto wg_done;
  // region 2 (after barrier block b6, explicit)
wg_r2:;
  __syncthreads();
R2_b7:;
  v5 = wg_ld<float>(b0, n0, (long long)v1);
  v6 = (v5 + (0x1.0000000000000p+0f));
  wg_st<float>(b0, n0, (long long)v1, v6);
  goto wg_r3;
  // region 3 (after barrier block b8, exit, dropped)
wg_r3:;
R3_b9:;
  goto wg_done;
wg_done:;
}

extern "C" int wg_launch(float* b0, long long n0, int v0, int wg_lo, int wg_groups, int wg_ng0, int wg_ng1, int wg_ng2, int wg_device, void* wg_stream) {
  if (wg_groups <= 0) return 0;
  cudaError_t e = cudaSetDevice(wg_device);
  if (e != cudaSuccess) return (int)e;
  wg_kernel<<<wg_groups, 4, 0, (cudaStream_t)wg_stream>>>((float*)b0, n0, v0, wg_lo, wg_ng0, wg_ng1, wg_ng2);
  return (int)cudaGetLastError();
}

extern "C" const char* wg_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
