// kernel 'condbar', local size (4, 1, 1): one thread block per work-group, one thread per work-item
// emitted by repro_torch/core/targets/cuda_target.py
#include "wg_runtime.cuh"

extern "C" __global__ void __launch_bounds__(4) wg_kernel(float* b0, long long n0, int v0, int wg_lo, int wg_ng0, int wg_ng1, int wg_ng2) {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  __shared__ int wg_next[2];
  const int wg_lin = (int)threadIdx.x;
  const int wg_grp = (int)blockIdx.x + wg_lo;
  const int wg_lid0 = wg_lin % 4;
  const int wg_lid1 = (wg_lin / 4) % 1;
  const int wg_lid2 = wg_lin / 4;
  const int wg_gid0 = wg_grp % wg_ng0;
  const int wg_gid1 = (wg_grp / wg_ng0) % wg_ng1;
  const int wg_gid2 = wg_grp / (wg_ng0 * wg_ng1);
  int wg_nx = 4;
  int v1 = 0;
  bool v2 = 0;
  float v3 = 0;
  float v4 = 0;
  float v5 = 0;
  float v6 = 0;
  int wg_rid = 0;
  int wg_it = 0;
  while (wg_rid < 4) {
  wg_nx = 4;
  switch (wg_rid) {
  case 0: {
  // region 0 (after barrier block b1)
R0_b2:;
  v1 = wg_iadd(wg_imul(wg_gid0, 4), wg_lid0);
  v2 = (v0 > (0));
  if (v2) { wg_nx = 2; goto R0_end; } else goto R0_b3;
R0_b3:;
  v3 = wg_ld<float>(b0, n0, (long long)v1);
  v4 = (v3 + (0x1.0000000000000p+0f));
  wg_st<float>(b0, n0, (long long)v1, v4);
  { wg_nx = 1; goto R0_end; }
R0_end:;
  } break;
  case 1: {
  // region 1 (after barrier block b4)
R1_b5:;
  { wg_nx = 4; goto R1_end; }
R1_end:;
  } break;
  case 2: {
  // region 2 (after barrier block b6)
R2_b7:;
  v5 = wg_ld<float>(b0, n0, (long long)v1);
  v6 = (v5 + (0x1.0000000000000p+0f));
  wg_st<float>(b0, n0, (long long)v1, v6);
  { wg_nx = 3; goto R2_end; }
R2_end:;
  } break;
  case 3: {
  // region 3 (after barrier block b8)
R3_b9:;
  { wg_nx = 4; goto R3_end; }
R3_end:;
  } break;
  default: break;
  }
  // work-item 0 decides the next region (paper §4.4)
  if (wg_lin == 0) wg_next[wg_it & 1] = wg_nx;
  __syncthreads();
  wg_rid = wg_next[wg_it & 1];
  ++wg_it;
  }
  (void)wg_nx; (void)wg_next;
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
