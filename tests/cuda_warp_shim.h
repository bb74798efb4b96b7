// Enough of CUDA to run a warp-per-item kernel source on the CPU, for tests.
//
// A launch runs each warp in turn on 32 host threads, one per lane;
// __syncwarp and the warp reductions are barriers across those threads, so
// a lane that reads what another lane has not yet written (a missing
// __syncwarp) shows up as a wrong result, as it may on the card.  Lanes that
// diverge at a __syncwarp (undefined on the card) leave the barrier waiting:
// after 60 s the process exits with a message instead of hanging.  Float
// intrinsics round as plain IEEE operations do, with contraction off
// (build with -ffp-contract=off).  The test that includes this in place of
// <cuda_runtime.h> points the kernel's `extern __shared__` array at
// `shim_smem` and turns its `<<<...>>>` launch into `shim_launch`.
#pragma once
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstring>
#include <thread>
#include <unistd.h>
#include <vector>

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x) alignas(x)

struct Dim3 { unsigned x; };
thread_local Dim3 threadIdx, blockIdx;
thread_local unsigned char* shim_smem;

// The warp's barrier: all 32 lanes arrive, then all go on.
class ShimBarrier {
 public:
  void arrive_and_wait() {
    const unsigned gen = generation_.load();
    if (arrived_.fetch_add(1) == 31) {
      arrived_.store(0);
      generation_.fetch_add(1);
      return;
    }
    const auto start = std::chrono::steady_clock::now();
    for (unsigned spins = 1; generation_.load() == gen; ++spins) {
      std::this_thread::yield();
      if (spins % 4096 == 0 &&
          std::chrono::steady_clock::now() - start > std::chrono::seconds(60)) {
        std::fprintf(stderr, "cuda_warp_shim: lanes diverged at a warp barrier\n");
        _exit(3);
      }
    }
  }

 private:
  std::atomic<int> arrived_{0};
  std::atomic<unsigned> generation_{0};
};

ShimBarrier* shim_warp;
unsigned shim_or[32];
int shim_add[32];
unsigned long long shim_shfl[32];

inline void __syncwarp(unsigned = 0xffffffffu) { shim_warp->arrive_and_wait(); }

inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  shim_or[threadIdx.x & 31] = v;
  shim_warp->arrive_and_wait();
  unsigned r = 0;
  for (unsigned x : shim_or) r |= x;
  shim_warp->arrive_and_wait();
  return r;
}

inline int __reduce_add_sync(unsigned, int v) {
  shim_add[threadIdx.x & 31] = v;
  shim_warp->arrive_and_wait();
  int r = 0;
  for (int x : shim_add) r += x;
  shim_warp->arrive_and_wait();
  return r;
}

template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  const unsigned lane = threadIdx.x & 31;
  unsigned long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  shim_shfl[lane] = bits;
  shim_warp->arrive_and_wait();
  T r;
  std::memcpy(&r, &shim_shfl[lane ^ lane_mask], sizeof(T));
  shim_warp->arrive_and_wait();
  return r;
}

inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { volatile float r = std::sqrt(a); return r; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// Run `kernel(params)` over `blocks` blocks of `warps` warps, one warp at a
// time, with `smem_bytes` of shared memory a block.
template <class Kernel, class Params>
void shim_launch(Kernel kernel, const Params& params, int blocks, int warps, size_t smem_bytes) {
  std::vector<unsigned char> smem(smem_bytes + 16, 0xCD);
  ShimBarrier warp;
  shim_warp = &warp;
  std::vector<std::thread> lanes;
  for (int lane = 0; lane < 32; ++lane) {
    lanes.emplace_back([&, lane] {
      shim_smem = smem.data();
      for (int b = 0; b < blocks; ++b) {
        for (int w = 0; w < warps; ++w) {
          blockIdx.x = b;
          threadIdx.x = w * 32 + lane;
          kernel(params);
          warp.arrive_and_wait();
        }
      }
    });
  }
  for (auto& t : lanes) t.join();
}
