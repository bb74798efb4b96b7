// Helpers shared by the hex-conv kernels for sm_90a (hexconv.cu, the
// forward; hexconv_dw.cu, the weight gradient): the tap offset tables, the
// cp.async copies, ldmatrix, and the warpgroup MMA (wgmma) with A from
// registers and B from shared memory by descriptor.
//
// Each kernel library is built from one .cu file that includes this
// header; nuzero_tpu_torch/ops/cuda/build.py keys the built library on
// this file as well as on the source.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// (dr, dc) per tap [c, n, ne, se, s, sw, nw]; row 0 = even columns,
// row 1 = odd columns (nuzero_tpu/ops/hexconv.py offset tables).
__constant__ int kDr[2][7] = {{0, -1, -1, 0, 1, 0, -1}, {0, -1, 0, 1, 1, 1, 0}};
__constant__ int kDc[2][7] = {{0, 0, 1, 1, 0, -1, -1}, {0, 0, 1, 1, 0, -1, -1}};

constexpr int kMaxSmem = 232448;  // dynamic shared memory per block on sm_90

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Bytes per copy of rows of `channels` bf16 values starting at `p`.
int copy_width(const void* p, int channels) {
  if (channels % 8 == 0 && aligned(p, 16)) return 16;
  if (channels % 2 == 0 && aligned(p, 4)) return 4;
  return 2;
}

// Bytes per copy of rows of `channels` f32 values starting at `p`.
int copy_width_f32(const void* p, int channels) {
  if (channels % 4 == 0 && aligned(p, 16)) return 16;
  if (channels % 2 == 0 && aligned(p, 8)) return 8;
  return 4;
}

namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy SIZE bytes (4, 8 or 16) global -> shared; bytes past `valid` are zeroed.
template <int SIZE>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int valid) {
  if constexpr (SIZE == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(SIZE), "r"(valid));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// The same with each 8x8 matrix transposed on its way to the registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Shared-memory descriptor of a B tile [16 k, N] in the MN-major layout
// without swizzle: core matrices of 8 k-rows x 8 n (16 B per row, 128 B
// each), N-adjacent core matrices 128 B apart, K-adjacent ones
// `k_stride` bytes apart.  In this layout the leading byte offset is the
// K-direction stride and the stride byte offset the N-direction one.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t k_stride) {
  const uint64_t lbo = k_stride, sbo = 128;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32);
}

// wgmma.m64nNk16 with A (4 registers: the m16n8k16 fragment of this warp's
// 16 rows) from registers and B (MN-major, imm-trans-b = 1) by descriptor.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ static __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};


// One k16 step over the block's BN columns, widest wgmma first
// (e.g. 72 = 64 + 8); column group j of 8 is accumulator d[4j .. 4j+3].
template <int BN, int OFF = 0>
__device__ __forceinline__ void mma_cols(float* acc, const uint32_t (&a)[4], uint64_t desc) {
  constexpr int REM = BN - OFF;
  if constexpr (REM > 0) {
    constexpr int NS = REM >= 128 ? 128 : REM >= 64 ? 64 : REM >= 32 ? 32 : REM >= 16 ? 16 : 8;
    Wgmma<NS>::run(acc + OFF / 2, a, desc + (OFF / 8) * (128 >> 4));
    mma_cols<BN, OFF + NS>(acc, a, desc);
  }
}

}  // namespace hop
}  // namespace
