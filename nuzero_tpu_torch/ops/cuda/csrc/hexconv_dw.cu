// Weight gradient of the hexagonal convolution (NHWC, 7 taps, zero
// padding) for sm_90a.
//
// The JAX package has no Pallas kernel for it: the backward of
// nuzero_tpu/ops/pallas/hexconv_kernel.py:hex_conv_pallas is XLA's VJP of
// the dual 3x3 conv (nuzero_tpu/ops/hexconv.py:_hex_conv_pallas_bwd).  dX is
// the forward kernels (hexconv.cu) on the mirrored taps; this file is dW:
//
//   dW[t*Cin + ci, co] = sum_m x[nbr_t(m), ci] * dY[m, co],
//
// over all M = B*H*W pixels, 0 for off-board taps: the product A^T dY of
// the forward's gathered tap matrix A [M, 7*Cin] with dY [M, Cout].  The
// reduction runs over M, which the forward never reduces over.
//
// What bounds it on an H100: at one training update's shapes (B=256, 5x5,
// M = 6400) the wide convs do ~2*6400 = 12,800 operations per element of
// dW, far above either ridge point: it is bound by operations.  This first
// kernel keeps f32 rounding and runs on the CUDA cores (FFMA) in both
// dtypes, bf16 inputs widened to f32 as they are loaded; a bf16 tensor-core
// (wgmma) kernel is later work.
//
// Design, simple first:
//   * grid (7*Cin / BR) x (Cout / BC) x slices: each block computes one
//     BR x BC tile of dW over one slice of the pixels, so that the narrow
//     outputs still fill the card;
//   * per chunk of MC pixels the block gathers the tap rows of its BR rows
//     of A^T into shared memory once (a table of each pixel's 7 neighbour
//     indices, -1 off the board, makes the parity shift and the zero fill
//     an index) and the matching MC x BC tile of dY, then each thread adds
//     a TR x TC outer product per pixel from float4 shared loads;
//   * deterministic sums: each slice writes its f32 partial tile into a
//     workspace [slices, 7*Cin, Cout] and a second kernel adds the slices
//     in a fixed order and rounds once to the output dtype.  No float
//     atomics: the same inputs give the same bits on every run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// (dr, dc) per tap [c, n, ne, se, s, sw, nw]; row 0 = even columns,
// row 1 = odd columns (nuzero_tpu/ops/hexconv.py offset tables).
__constant__ int kDr[2][7] = {{0, -1, -1, 0, 1, 0, -1}, {0, -1, 0, 1, 1, 1, 0}};
__constant__ int kDc[2][7] = {{0, 0, 1, 1, 0, -1, -1}, {0, 0, 1, 1, 0, -1, -1}};

constexpr int BR = 64;        // rows of dW (t*Cin + ci) per block
constexpr int BC = 64;        // output channels per block
constexpr int MC = 16;        // pixels per shared-memory chunk
constexpr int THREADS = 256;
constexpr int TR = 4;         // rows per thread
constexpr int TC = 4;         // output channels per thread
constexpr int LOAD_ROWS = THREADS / BR;  // chunk pixels loaded per pass
static_assert(BR == BC, "a thread loads one row of A^T and one column of dY");
static_assert((BR / TR) * (BC / TC) == THREADS, "one TR x TC tile per thread");
static_assert(MC % LOAD_ROWS == 0 && MC * 7 <= THREADS, "whole load passes, one tap index a thread");

struct Params {
  const void* x;    // [M, Cin]
  const void* dy;   // [M, Cout]
  float* part;      // [slices, 7*Cin, Cout]
  int M, H, W, Cin, Cout, K;  // K = 7*Cin
  int slice;        // pixels per slice, a multiple of MC
};

__device__ __forceinline__ float widen(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float widen(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__device__ __forceinline__ void dw_partial(const Params& p) {
  __shared__ __align__(16) float As[MC][BR];
  __shared__ __align__(16) float Ds[MC][BC];
  __shared__ int nbr[MC][7];
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BR, c0 = blockIdx.y * BC;
  const int m_begin = blockIdx.z * p.slice;
  const int m_end = min(p.M, m_begin + p.slice);

  // The row of A^T and the column of dY this thread loads: fixed over chunks.
  const int lane_rc = tid % BR;
  const int load_k = tid / BR;
  const int row = r0 + lane_rc;
  const bool row_ok = row < p.K;
  const int tap = row_ok ? row / p.Cin : 0;
  const int ci = row_ok ? row - tap * p.Cin : 0;
  const int col = c0 + lane_rc;
  const bool col_ok = col < p.Cout;
  // The TR x TC tile this thread accumulates.
  const int ty = tid / (BC / TC), tx = tid % (BC / TC);

  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += MC) {
    if (tid < MC * 7) {
      const int k = tid / 7, t = tid - (tid / 7) * 7;
      const int m = m0 + k;
      int idx = -1;
      if (m < m_end) {
        const int w = m % p.W, hw = m / p.W;
        const int h = hw % p.H, b = hw / p.H;
        const int hh = h + kDr[w & 1][t], ww = w + kDc[w & 1][t];
        if (hh >= 0 && hh < p.H && ww >= 0 && ww < p.W) idx = (b * p.H + hh) * p.W + ww;
      }
      nbr[k][t] = idx;
    }
    __syncthreads();
#pragma unroll
    for (int pass = 0; pass < MC / LOAD_ROWS; ++pass) {
      const int k = load_k + pass * LOAD_ROWS;
      const int idx = nbr[k][tap];
      As[k][lane_rc] = (row_ok && idx >= 0) ? widen(x, (int64_t)idx * p.Cin + ci) : 0.f;
      const int m = m0 + k;
      Ds[k][lane_rc] = (col_ok && m < m_end) ? widen(dy, (int64_t)m * p.Cout + col) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MC; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * TR]);
      const float4 d = *reinterpret_cast<const float4*>(&Ds[k][tx * TC]);
      const float av[TR] = {a.x, a.y, a.z, a.w};
      const float dv[TC] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = p.part + (int64_t)blockIdx.z * p.K * p.Cout;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = r0 + ty * TR + i;
    if (r >= p.K) continue;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = c0 + tx * TC + j;
      if (c < p.Cout) out[(int64_t)r * p.Cout + c] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(THREADS) hexconv_dw_f32_kernel(const Params p) {
  dw_partial<float>(p);
}

__global__ void __launch_bounds__(THREADS) hexconv_dw_bf16_kernel(const Params p) {
  dw_partial<__nv_bfloat16>(p);
}

__device__ __forceinline__ void narrow(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// dw[i] = sum over slices, in slice order, of part[s, i], rounded once.
template <typename T>
__global__ void hexconv_dw_reduce_kernel(const float* part, T* dw, int64_t n, int slices) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < slices; ++z) s += part[(int64_t)z * n + i];
    narrow(dw, i, s);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  dtype: 0 = f32, 1 = bf16.
// x: [B, H, W, Cin], dy: [B, H, W, Cout] in the given dtype; part: an f32
// workspace of slices * 7*Cin * Cout values; dw: [7, Cin, Cout] in the given
// dtype; all contiguous.  `slices` slices of `slice` pixels (a multiple of
// 16) must cover the B*H*W pixels.  Launches both kernels on `stream` and
// returns the cudaError_t of the launches (0 = success); no synchronize.
extern "C" int hexconv_dw(const void* x, const void* dy, float* part, void* dw, int B, int H,
                          int W, int Cin, int Cout, int dtype, int slices, int slice,
                          void* stream) {
  const int M = B * H * W;
  if (M == 0 || Cin == 0 || Cout == 0) return 0;
  if (slices < 1 || slice < MC || slice % MC != 0 || (int64_t)slices * slice < M ||
      (int64_t)(slices - 1) * slice >= M)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  Params p;
  p.x = x, p.dy = dy, p.part = part;
  p.M = M, p.H = H, p.W = W, p.Cin = Cin, p.Cout = Cout, p.K = 7 * Cin;
  p.slice = slice;
  const dim3 grid((p.K + BR - 1) / BR, (Cout + BC - 1) / BC, slices);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t n = (int64_t)p.K * Cout;
  const int reduce_blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  if (dtype == 0) {
    hexconv_dw_f32_kernel<<<grid, THREADS, 0, s>>>(p);
    hexconv_dw_reduce_kernel<float><<<reduce_blocks, 256, 0, s>>>(part, static_cast<float*>(dw),
                                                                 n, slices);
  } else if (dtype == 1) {
    hexconv_dw_bf16_kernel<<<grid, THREADS, 0, s>>>(p);
    hexconv_dw_reduce_kernel<__nv_bfloat16><<<reduce_blocks, 256, 0, s>>>(
        part, static_cast<__nv_bfloat16*>(dw), n, slices);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
