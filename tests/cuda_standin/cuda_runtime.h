// A stand-in for the CUDA runtime, so that the kernels which
// src/repro_torch/core/targets/cuda_target.py emits compile with g++ and run on
// the CPU (tests/test_torch_cuda_emit.py).
//
// One std::thread per CUDA thread, one block at a time.  The threads of a block
// take turns in thread order, each running until it reaches __syncthreads() or
// leaves the kernel: a run is deterministic, and a barrier missing from the
// source shows as a wrong result, since thread 0 then runs ahead of the others
// through memory they have not written yet.  A thread that leaves the kernel
// while others wait at a barrier, threads waiting at different barriers, and
// a wait that passes the deadline all fail the launch (cudaGetLastError())
// instead of hanging.  A hand-made barrier stands in for std::barrier, which
// can neither time out nor tell which barrier a thread waits at.
#pragma once

#include <math.h>

#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(n)
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local dim3 threadIdx, blockIdx;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorLaunchFailure = 719 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, sizeof i);
  return i;
}
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

namespace wg_standin {

constexpr auto kDeadline = std::chrono::seconds(30);
enum { kRunning = 0, kAtBarrier = 1, kDone = 2 };

struct Block {
  std::mutex mu;
  std::vector<std::condition_variable> cv;
  std::vector<int> state;
  int n, turn = 0, site = -1;
  bool failed = false;
  explicit Block(int n) : cv(n), state(n, kRunning), n(n) {}
};

inline Block* g_block = nullptr;
inline unsigned char* g_smem = nullptr;
inline int g_error = cudaSuccess;
inline const char* g_why = "no error";
inline thread_local int t_tid = 0;

inline void fail_locked(Block& b, const char* why) {
  if (!b.failed) std::fprintf(stderr, "cuda stand-in: %s\n", why);
  b.failed = true;
  g_error = cudaErrorLaunchFailure;
  g_why = why;
  for (auto& c : b.cv) c.notify_all();
}

// b.mu held: hand the turn to the next running thread after t; when there is
// none, every live thread waits at the barrier (release it) or all are done.
inline void pass_locked(Block& b, int t) {
  for (int u = t + 1; u < b.n; ++u)
    if (b.state[u] == kRunning) {
      b.turn = u;
      b.cv[u].notify_one();
      return;
    }
  int waiting = 0, done = 0;
  for (int s : b.state) {
    waiting += s == kAtBarrier;
    done += s == kDone;
  }
  if (waiting == 0) {
    b.turn = b.n;
    return;
  }
  if (done) {
    fail_locked(b, "a thread left the kernel while others wait at a barrier");
    return;
  }
  for (int& s : b.state) s = kRunning;
  b.site = -1;
  b.turn = 0;
  b.cv[0].notify_one();
}

inline void wait_turn_locked(Block& b, std::unique_lock<std::mutex>& lk,
                             int t) {
  while (!b.failed && b.turn != t)
    if (b.cv[t].wait_for(lk, kDeadline) == std::cv_status::timeout &&
        b.turn != t)
      fail_locked(b, "a thread waited past the deadline");
}

inline void barrier(int site) {
  Block& b = *g_block;
  const int t = t_tid;
  std::unique_lock<std::mutex> lk(b.mu);
  if (b.failed) return;
  if (b.site < 0) {
    b.site = site;
  } else if (b.site != site) {
    fail_locked(b, "threads wait at different barriers");
    return;
  }
  b.state[t] = kAtBarrier;
  pass_locked(b, t);
  wait_turn_locked(b, lk, t);
}

inline unsigned char* smem() { return g_smem; }

template <class F>
void launch(int grid, int block, long long smem_bytes, F body) {
  unsigned char* mem = new (std::align_val_t(16)) unsigned char[smem_bytes + 16];
  g_smem = mem;
  for (int g = 0; g < grid && g_error == cudaSuccess; ++g) {
    Block b(block);
    g_block = &b;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&b, &body, g, t] {
        t_tid = t;
        threadIdx.x = (unsigned)t;
        blockIdx.x = (unsigned)g;
        {
          std::unique_lock<std::mutex> lk(b.mu);
          wait_turn_locked(b, lk, t);
        }
        body();
        std::unique_lock<std::mutex> lk(b.mu);
        b.state[t] = kDone;
        if (!b.failed) pass_locked(b, t);
      });
    for (auto& th : threads) th.join();
  }
  g_block = nullptr;
  g_smem = nullptr;
  ::operator delete[](mem, std::align_val_t(16));
}

}  // namespace wg_standin

#define __syncthreads() wg_standin::barrier(__LINE__)

inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  cudaError_t e = wg_standin::g_error;
  wg_standin::g_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : wg_standin::g_why;
}
