// Hexagonal convolution (NHWC, 7 taps, zero padding) for sm_90a.
//
// Replaces the Pallas TPU kernel nuzero_tpu/ops/pallas/hexconv_kernel.py
// (hex_conv_pallas / _kernel), which gathers the 7 column-parity-correct
// taps of a board block into a [BB*H*W, 7*Cin] VMEM tile and runs one MXU
// matmul against the [7*Cin, Cout] weights.
//
// Here the same function is a gathered-operand GEMM:
//   M = B*H*W output pixels, N = Cout, K = 7*Cin,
//   y[m, n] = sum_k A[m, k] * Wt[k, n],
//   A[m, t*Cin + ci] = x[b, h + dr_t(w), w + dc_t(w), ci]  (0 off the board).
// The tap matrix A never exists in device memory: each block gathers its
// (BM x BK) slice of A straight from x into shared memory, with the zero
// fill for off-board taps and for the ragged M, N and K edges.
//
// What bounds it on an H100: at the self-play shapes (5x5 boards, B in the
// hundreds, Cin/Cout up to 342/256) the GEMM is compute-bound: a 256->256
// conv at B=768 reads ~10 MB of x and writes ~10 MB of y for ~17.6 GFLOP,
// about 880 FLOP per byte, above the card's bf16 ridge point (~295).  So
// the design keeps the tap gather out of device memory (the plain version
// materializes A, 7x the size of x) and puts the bf16 product on the
// tensor cores (WMMA 16x16x16, f32 accumulation).  The f32 path stays on
// the CUDA cores (FMA), so f32 results keep f32 rounding rather than TF32.
// Neither path uses cp.async / TMA or wgmma.  The bf16 path holds the next
// K tile's operands in registers while the tensor cores work on the
// current one, and it loads and stores 16 bytes at a time where the
// channel count allows it (Cin, resp. Cout, a multiple of 8: every chunk
// of 8 channels then lies inside one tap and one 16-byte-aligned row).
// Channel counts such as 86, 150, 342, 138, 21 and 1 are not, so those
// operands take the scalar, per-element masked loads; the f32 path is
// scalar throughout.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

// (dr, dc) per tap [c, n, ne, se, s, sw, nw]; row 0 = even columns,
// row 1 = odd columns (nuzero_tpu/ops/hexconv.py offset tables).
__constant__ int kDr[2][7] = {{0, -1, -1, 0, 1, 0, -1}, {0, -1, 0, 1, 1, 1, 0}};
__constant__ int kDc[2][7] = {{0, 0, 1, 1, 0, -1, -1}, {0, 0, 1, 1, 0, -1, -1}};

template <typename T>
__device__ __forceinline__ T zero_val();
template <>
__device__ __forceinline__ float zero_val<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_val<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// Per-pixel gather base: for pixel m, the index of x[b, h, w, 0] and its
// (h, w); kept in shared memory so the K loop does not re-divide m.
struct PixelTable {
  int64_t base[64];
  int h[64];
  int w[64];
};

__device__ __forceinline__ void fill_pixels(PixelTable& pt, int m0, int M, int H,
                                            int W, int Cin, int BM) {
  for (int i = threadIdx.x; i < BM; i += blockDim.x) {
    int m = m0 + i;
    if (m < M) {
      int w = m % W;
      int h = (m / W) % H;
      pt.base[i] = (int64_t)m * Cin;  // == ((b*H + h)*W + w)*Cin
      pt.h[i] = h;
      pt.w[i] = w;
    } else {
      pt.base[i] = -1;
      pt.h[i] = 0;
      pt.w[i] = 0;
    }
  }
}

// Column k of the tap matrix: its channel and its tap's offsets for even
// and odd columns.  A thread keeps one column per K tile, so the division
// by Cin happens once per tile, not once per element.
struct TapCol {
  bool valid;
  int ci;
  int dr0, dc0, dr1, dc1;
};

__device__ __forceinline__ TapCol tap_col(int k, int K, int Cin) {
  TapCol c;
  c.valid = k < K;
  int t = c.valid ? k / Cin : 0;
  c.ci = k - t * Cin;
  c.dr0 = kDr[0][t];
  c.dc0 = kDc[0][t];
  c.dr1 = kDr[1][t];
  c.dc1 = kDc[1][t];
  return c;
}

// Value of A[m0 + i, k] for the column decoded in `c` (zero off the board
// or past the ragged edges).
template <typename T>
__device__ __forceinline__ T gather_a(const T* __restrict__ x, const PixelTable& pt, int i,
                                      const TapCol& c, int H, int W, int Cin) {
  int64_t base = pt.base[i];
  if (base < 0 || !c.valid) return zero_val<T>();
  int w = pt.w[i];
  bool odd = w & 1;
  int dr = odd ? c.dr1 : c.dr0;
  int dc = odd ? c.dc1 : c.dc0;
  int hh = pt.h[i] + dr;
  int ww = w + dc;
  if (hh < 0 || hh >= H || ww < 0 || ww >= W) return zero_val<T>();
  return x[base + (int64_t)(dr * W + dc) * Cin + c.ci];
}

// ---------------------------------------------------------------------
// f32: 64x64 output tile, 256 threads, 4x4 outputs per thread, BK = 16.
// ---------------------------------------------------------------------
constexpr int SBM = 64, SBN = 64, SBK = 16;
static_assert(256 % SBK == 0, "a thread keeps one A column per tile");

__global__ void __launch_bounds__(256)
hexconv_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   float* __restrict__ y, int M, int N, int K, int H, int W, int Cin) {
  __shared__ float As[SBK][SBM + 4];
  __shared__ float Bs[SBK][SBN + 4];
  __shared__ PixelTable pt;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;
  fill_pixels(pt, m0, M, H, W, Cin, SBM);
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += SBK) {
    // A tile: consecutive threads take consecutive k (contiguous
    // channels); each thread keeps column tid % SBK for the whole tile.
    {
      const int kk = tid % SBK;
      const TapCol col = tap_col(k0 + kk, K, Cin);
#pragma unroll
      for (int r = 0; r < (SBM * SBK) / 256; ++r) {
        int i = (tid + r * 256) / SBK;
        As[kk][i] = gather_a(x, pt, i, col, H, W, Cin);
      }
    }
    // B tile: consecutive threads take consecutive n (contiguous Cout).
#pragma unroll
    for (int r = 0; r < (SBK * SBN) / 256; ++r) {
      int e = tid + r * 256;
      int nn = e % SBN, kk = e / SBN;
      int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N) ? wt[(int64_t)k * N + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx * 4 + j;
      if (n < N) y[(int64_t)m * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------
// bf16: 64x64 output tile, 4 warps each owning a 32x32 quadrant as 2x2
// WMMA 16x16x16 fragments with f32 accumulators, BK = 32.
// VA: A rows are gathered as 16-byte chunks (Cin % 8 == 0, x aligned).
// VB: W and y move as 16-byte chunks (Cout % 8 == 0, both aligned).
// ---------------------------------------------------------------------
constexpr int TBM = 64, TBN = 64, TBK = 32, TT = 128;
constexpr int A_LD = TBK + 8;   // bf16 elements; multiple of 8 for WMMA
constexpr int B_LD = TBN + 8;
constexpr int C_LD = TBN + 4;   // f32 elements; multiple of 4 for WMMA
static_assert(TT % TBK == 0, "a thread keeps one A column per tile");
static_assert(TBM * TBK == 16 * TT && TBK * TBN == 16 * TT, "16 elements per thread");

// One thread's share (16 bf16) of an A or B tile, held in registers from
// its global loads until its shared-memory stores.
union Stage {
  uint4 v[2];
  unsigned short s[16];
};

template <bool VA>
__device__ __forceinline__ void load_a(Stage& st, const __nv_bfloat16* __restrict__ x,
                                       const PixelTable& pt, int k0, int K, int H, int W,
                                       int Cin) {
  const int tid = threadIdx.x;
  if constexpr (VA) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + r * TT;
      const int i = e / (TBK / 8), k = k0 + (e % (TBK / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      const int64_t base = pt.base[i];
      if (base >= 0 && k < K) {
        const int t = k / Cin, ci = k - t * Cin;
        const int w = pt.w[i], odd = w & 1;
        const int dr = kDr[odd][t], dc = kDc[odd][t];
        const int hh = pt.h[i] + dr, ww = w + dc;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W)
          v = *reinterpret_cast<const uint4*>(x + base + (int64_t)(dr * W + dc) * Cin + ci);
      }
      st.v[r] = v;
    }
  } else {
    const int kk = tid % TBK;
    const TapCol col = tap_col(k0 + kk, K, Cin);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = (tid + r * TT) / TBK;
      st.s[r] = __bfloat16_as_ushort(gather_a(x, pt, i, col, H, W, Cin));
    }
  }
}

template <bool VA>
__device__ __forceinline__ void store_a(const Stage& st, __nv_bfloat16* As) {
  const int tid = threadIdx.x;
  if constexpr (VA) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + r * TT;
      *reinterpret_cast<uint4*>(As + (e / (TBK / 8)) * A_LD + (e % (TBK / 8)) * 8) = st.v[r];
    }
  } else {
    const int kk = tid % TBK;
#pragma unroll
    for (int r = 0; r < 16; ++r)
      As[((tid + r * TT) / TBK) * A_LD + kk] = __ushort_as_bfloat16(st.s[r]);
  }
}

template <bool VB>
__device__ __forceinline__ void load_b(Stage& st, const __nv_bfloat16* __restrict__ wt,
                                       int k0, int n0, int K, int N) {
  const int tid = threadIdx.x;
  if constexpr (VB) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + r * TT;
      const int k = k0 + e / (TBN / 8), n = n0 + (e % (TBN / 8)) * 8;
      st.v[r] = (k < K && n < N) ? *reinterpret_cast<const uint4*>(wt + (int64_t)k * N + n)
                                 : make_uint4(0, 0, 0, 0);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int e = tid + r * TT;
      const int k = k0 + e / TBN, n = n0 + e % TBN;
      st.s[r] = (k < K && n < N) ? __bfloat16_as_ushort(wt[(int64_t)k * N + n]) : 0;
    }
  }
}

template <bool VB>
__device__ __forceinline__ void store_b(const Stage& st, __nv_bfloat16* Bs) {
  const int tid = threadIdx.x;
  if constexpr (VB) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + r * TT;
      *reinterpret_cast<uint4*>(Bs + (e / (TBN / 8)) * B_LD + (e % (TBN / 8)) * 8) = st.v[r];
    }
  } else {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int e = tid + r * TT;
      Bs[(e / TBN) * B_LD + e % TBN] = __ushort_as_bfloat16(st.s[r]);
    }
  }
}

template <bool VA, bool VB>
__global__ void __launch_bounds__(TT)
hexconv_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                    __nv_bfloat16* __restrict__ y, int M, int N, int K, int H, int W,
                    int Cin) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[TBM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[TBK * B_LD];
  __shared__ __align__(128) float Cs[TBM * C_LD];
  __shared__ PixelTable pt;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  fill_pixels(pt, m0, M, H, W, Cin, TBM);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  Stage sa, sb;
  load_a<VA>(sa, x, pt, 0, K, H, W, Cin);
  load_b<VB>(sb, wt, 0, n0, K, N);
  for (int k0 = 0; k0 < K; k0 += TBK) {
    store_a<VA>(sa, As);
    store_b<VB>(sb, Bs);
    __syncthreads();
    // The next tile's global loads are in flight during this tile's MMAs.
    if (k0 + TBK < K) {
      load_a<VA>(sa, x, pt, k0 + TBK, K, H, W, Cin);
      load_b<VB>(sb, wt, k0 + TBK, n0, K, N);
    }
#pragma unroll
    for (int ks = 0; ks < TBK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + i * 16) * A_LD + ks, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + ks * B_LD + wn + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * C_LD + wn + j * 16, acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  if constexpr (VB) {
    for (int e = tid; e < TBM * TBN / 8; e += TT) {
      const int i = e / (TBN / 8), nn = (e % (TBN / 8)) * 8;
      const int m = m0 + i, n = n0 + nn;
      if (m < M && n < N) {
        union {
          uint4 v;
          unsigned short s[8];
        } out;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          out.s[j] = __bfloat16_as_ushort(__float2bfloat16(Cs[i * C_LD + nn + j]));
        *reinterpret_cast<uint4*>(y + (int64_t)m * N + n) = out.v;
      }
    }
  } else {
    for (int e = tid; e < TBM * TBN; e += TT) {
      const int i = e / TBN, nn = e % TBN;
      const int m = m0 + i, n = n0 + nn;
      if (m < M && n < N) y[(int64_t)m * N + n] = __float2bfloat16(Cs[i * C_LD + nn]);
    }
  }
}

template <bool VA, bool VB>
void launch_bf16(const void* x, const void* wt, void* y, int M, int N, int K, int H, int W,
                 int Cin, cudaStream_t s) {
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
  hexconv_bf16_kernel<VA, VB><<<grid, TT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<__nv_bfloat16*>(y), M, N, K, H, W, Cin);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Plain C interface (loaded with ctypes).  dtype: 0 = f32, 1 = bf16.
// x: [B, H, W, Cin], wt: [7*Cin, Cout] (== [7, Cin, Cout]), y: [B, H, W, Cout],
// all contiguous in the given dtype.  Launches on `stream` and returns the
// cudaError_t of the launch (0 = success); it does not synchronize.
extern "C" int hexconv_forward(const void* x, const void* wt, void* y, int B, int H, int W,
                               int Cin, int Cout, int dtype, void* stream) {
  const int M = B * H * W;
  const int K = 7 * Cin;
  const int N = Cout;
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dim3 grid((N + SBN - 1) / SBN, (M + SBM - 1) / SBM);
    hexconv_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                             static_cast<const float*>(wt),
                                             static_cast<float*>(y), M, N, K, H, W, Cin);
  } else if (dtype == 1) {
    const bool va = Cin % 8 == 0 && aligned16(x);
    const bool vb = Cout % 8 == 0 && aligned16(wt) && aligned16(y);
    if (va && vb)
      launch_bf16<true, true>(x, wt, y, M, N, K, H, W, Cin, s);
    else if (va)
      launch_bf16<true, false>(x, wt, y, M, N, K, H, W, Cin, s);
    else if (vb)
      launch_bf16<false, true>(x, wt, y, M, N, K, H, W, Cin, s);
    else
      launch_bf16<false, false>(x, wt, y, M, N, K, H, W, Cin, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
