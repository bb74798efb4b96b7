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
// The tap matrix A never exists in device memory.
//
// What bounds it on an H100: at the self-play shapes (5x5 boards, B in the
// hundreds) the wide convs are compute-bound: 256->256 and 342->256 at
// B=768 do ~880 and ~1000 FLOP per byte of x, W and y, above the card's
// bf16 ridge point (~295), and in f32 64->64 at B=512 does ~110 FLOP per
// byte against the CUDA cores' ridge of 20; the narrow outputs (->21, ->1)
// are bound by moving x.  Two kernels, each reading x once per block from
// a halo slab in shared memory that all 7 taps share:
//
// * f32 (f32::hexconv_f32_kernel) stays on the CUDA cores (FFMA), so f32
//   results keep f32 rounding rather than TF32 (see the note at the
//   kernel);
// * bf16 (hop::hexconv_bf16_wgmma_kernel) puts the product on Hopper's
//   warpgroup tensor cores (see the note at the kernel).

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------
// bf16: the Hopper kernel.  One block of three warpgroups computes
// BM = 192 pixels x BN output channels, each warpgroup 64 rows, with
// wgmma.m64nNk16.f32.bf16.bf16 (A from registers, B from shared memory,
// f32 accumulators in registers).  K = 7*Cin runs channel chunk outer,
// tap inner, so one slab chunk serves 7 B tiles:
//
//   * the halo slab: the taps of pixels [m0, m0+BM) all lie in the flat
//     pixel range [m0-W-1, m0+BM+W+1), so the block copies that range's
//     chunk of KC channels into shared memory (cp.async, 16 B where the
//     row allows it, 4 B for even Cin, 2 B by plain loads otherwise),
//     re-pitched to ROW_BYTES with the channels past Cin zeroed.  All 7
//     taps of the chunk read it; off-board taps read a zero row.  x is
//     read once per block instead of once per tap element;
//   * A from registers: each lane's ldmatrix.x4 row address is its
//     pixel's tap row in the slab (computed once per tap, outside the
//     channel loop), which is the m16n8k16 A fragment that wgmma's
//     register-A form takes.  No A tile is ever built;
//   * B through a ring: the [KC, BN] slice of W[t] for (chunk, tap) goes
//     by cp.async into a ring of NSTAGE stages, AHEAD stages ahead, in the
//     MN-major no-swizzle core-matrix layout of the wgmma descriptor
//     (8 k-rows x 16 B per core matrix), zero past Cin and past Cout.
//     The next stages' copies are issued while the current stage's
//     wgmmas run;
//   * epilogue: f32 -> bf16 through shared memory, then 16-byte stores
//     where Cout % 8 == 0 (4- or 2-byte stores otherwise).
//
// What bounds it: every block streams all of W[:, :, n0:n0+BN] from L2
// (~0.46 MB per block at 256->256), and at the self-play shapes that
// traffic, more than the tensor cores, sets the pace.  A taller tile
// shares each B tile among more pixels; BM = 192 with BN <= 128 keeps the
// accumulators in registers at one block per SM (BN = 128 spills 32
// bytes) and was the fastest of the tiles tried (BM 128, 192, 256;
// BN 128, 256).  BN is
// Cout rounded up to a wgmma width; wider Cout is split into balanced
// tiles.
// ---------------------------------------------------------------------
namespace hop {

constexpr int NWG = 3;                  // warpgroups per block
constexpr int BM = 64 * NWG;            // pixels per block
constexpr int THREADS = 128 * NWG;
constexpr int KC = 64;                  // channels per slab chunk and B stage
constexpr int NSTAGE = 4;               // B ring stages
constexpr int AHEAD = NSTAGE - 1;       // stages loaded ahead of the one computed
constexpr int ROW_BYTES = KC * 2 + 16;  // slab pitch: 9 x 16 B, so 8 consecutive
                                        // rows fall in 8 distinct 16-B bank groups
static_assert(AHEAD <= 7, "a chunk's slab is loaded with its first tap's B tile");

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wt;
  __nv_bfloat16* y;
  int M, N, H, W, Cin;
  int va, vb, vy;  // bytes per copy of x rows, W rows and y rows: 16, 4 or 2
  int slab_rows;   // BM + 2W + 2
};

template <int BN>
struct Tile {
  static constexpr int STAGE_BYTES = KC * BN * 2;
  static constexpr int K_STRIDE = BN * 16;  // bytes between 8-k rows of core matrices
  static constexpr int RING_BYTES = NSTAGE * STAGE_BYTES;
  static constexpr int C_LD = BN + 8;       // epilogue staging pitch, bf16 elements
  static_assert(BM * C_LD * 2 <= RING_BYTES + 2 * BM * ROW_BYTES,
                "the epilogue tile fits in the ring and the slab");
  static int smem_bytes(int slab_rows) { return RING_BYTES + (2 * slab_rows + 1) * ROW_BYTES; }
};

// One chunk of the halo slab: flat pixels [p0, p0 + slab_rows), channels
// [c0, c0 + KC) of x, zero past Cin.  Rows off [0, M) are left unwritten:
// only off-board taps point there, and those read the zero row.
template <int SIZE>
__device__ __forceinline__ void load_slab(const Params& p, unsigned char* dst0, int c0, int p0) {
  constexpr int UPR = KC * 2 / SIZE;  // copies per row
  const int kc = min(KC, p.Cin - c0);
  for (int u = threadIdx.x; u < p.slab_rows * UPR; u += THREADS) {
    const int r = u / UPR, j = u % UPR, ch = j * (SIZE / 2), q = p0 + r;
    if (q < 0 || q >= p.M) continue;
    unsigned char* dst = dst0 + r * ROW_BYTES + j * SIZE;
    const __nv_bfloat16* src = p.x + (int64_t)q * p.Cin + c0 + ch;
    const int valid = ch < kc ? min(SIZE, (kc - ch) * 2) : 0;
    if constexpr (SIZE == 2)
      *reinterpret_cast<__nv_bfloat16*>(dst) = valid ? *src : __ushort_as_bfloat16(0);
    else
      cp_async<SIZE>(smem_u32(dst), valid ? static_cast<const void*>(src) : p.x, valid);
  }
}

// The B tile of (tap t, chunk c0): W[t][c0 .. c0+KC)[n0 .. n0+BN) in the
// descriptor's core-matrix layout, zero past Cin and past Cout.  Copy u
// lands at byte u * SIZE, so a warp writes one contiguous run of shared
// memory; on the global side it reads 8 rows.
template <int BN, int SIZE>
__device__ __forceinline__ void load_b(const Params& p, unsigned char* dst0, int t, int c0,
                                       int n0) {
  constexpr int PER = 16 / SIZE;  // copies per 16-byte core-matrix row
  constexpr int NG = BN / 8;      // core matrices along N
  for (int u = threadIdx.x; u < KC * BN * 2 / SIZE; u += THREADS) {
    const int rest = u / (PER * 8), ng = rest % NG, kg = rest / NG;
    const int k = kg * 8 + (u / PER) % 8, n = ng * 8 + (u % PER) * (SIZE / 2);
    unsigned char* dst = dst0 + u * SIZE;
    const int ci = c0 + k, col = n0 + n;
    const int valid = ci < p.Cin && col < p.N ? min(SIZE, (p.N - col) * 2) : 0;
    const __nv_bfloat16* src = p.wt + ((int64_t)t * p.Cin + ci) * p.N + col;
    if constexpr (SIZE == 2)
      *reinterpret_cast<__nv_bfloat16*>(dst) = valid ? *src : __ushort_as_bfloat16(0);
    else
      cp_async<SIZE>(smem_u32(dst), valid ? static_cast<const void*>(src) : p.wt, valid);
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1) hexconv_bf16_wgmma_kernel(const Params p) {
  using T = Tile<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* slab = smem + T::RING_BYTES;  // two chunk buffers of slab_rows rows
  unsigned char* zero_row = slab + 2 * p.slab_rows * ROW_BYTES;
  const int tid = threadIdx.x, lane = tid & 31, wg = tid / 128, warp = (tid / 32) & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int W = p.W, Cin = p.Cin;
  const int chunks = (Cin + KC - 1) / KC, stages = 7 * chunks;
  const int p0 = m0 - W - 1;                     // flat pixel of slab row 0

  for (int i = tid; i < ROW_BYTES / 16; i += THREADS)
    reinterpret_cast<uint4*>(zero_row)[i] = make_uint4(0, 0, 0, 0);

  // This lane's ldmatrix row for each tap: its pixel's tap neighbour in the
  // slab (byte offset, with the lane's k half), or -1 for the zero row.
  int roff[7];
  {
    const int i = wg * 64 + warp * 16 + (lane & 15), m = m0 + i;
    const int w = m % W, h = (m / W) % p.H, odd = w & 1;
#pragma unroll
    for (int t = 0; t < 7; ++t) {
      const int dr = kDr[odd][t], dc = kDc[odd][t], hh = h + dr, ww = w + dc;
      const bool on = m < p.M && hh >= 0 && hh < p.H && ww >= 0 && ww < W;
      roff[t] = on ? (i + W + 1 + dr * W + dc) * ROW_BYTES + (lane >> 4) * 16 : -1;
    }
  }

  // Stage s is one (chunk, tap) pair, tap minor: slab buffer (s / 7) & 1,
  // ring slot s % NSTAGE.  Each block starts the cycle of chunks and of
  // taps at its own offset, so that the blocks of a wave do not all ask
  // L2 for the same B tile at once.
  const int spread = blockIdx.x + blockIdx.y;
  const int first_t = spread % 7, first_c = (spread / 7) % chunks;
  auto chunk_tap = [&](int s, int& c, int& t) {
    c = s / 7 + first_c;
    t = s % 7 + first_t;
    if (c >= chunks) c -= chunks;
    if (t >= 7) t -= 7;
  };
  auto issue = [&](int s) {
    int c, t;
    chunk_tap(s, c, t);
    if (s % 7 == 0) {
      unsigned char* dst = slab + ((s / 7) & 1) * p.slab_rows * ROW_BYTES;
      if (p.va == 16) load_slab<16>(p, dst, c * KC, p0);
      else if (p.va == 4) load_slab<4>(p, dst, c * KC, p0);
      else load_slab<2>(p, dst, c * KC, p0);
    }
    unsigned char* dst = ring + (s % NSTAGE) * T::STAGE_BYTES;
    if (p.vb == 16) load_b<BN, 16>(p, dst, t, c * KC, n0);
    else if (p.vb == 4) load_b<BN, 4>(p, dst, t, c * KC, n0);
    else load_b<BN, 2>(p, dst, t, c * KC, n0);
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < stages) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<AHEAD - 1>();  // this thread's copies of stage s have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // everyone's have, and stage s - 1's wgmmas have retired
    int c, t;
    chunk_tap(s, c, t);
    const int ksteps = (min(KC, Cin - c * KC) + 15) / 16;
    int off = roff[0];
#pragma unroll
    for (int q = 1; q < 7; ++q)
      if (t == q) off = roff[q];
    const uint32_t row = off >= 0 ? smem_u32(slab + ((s / 7) & 1) * p.slab_rows * ROW_BYTES) + off
                                  : smem_u32(zero_row) + (lane >> 4) * 16;
    uint32_t a[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < ksteps) ldmatrix_x4(a[ks], row + ks * 32);
    wgmma_fence();
    fence_acc(acc);
    const uint32_t b = smem_u32(ring + (s % NSTAGE) * T::STAGE_BYTES);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < ksteps) mma_cols<BN>(acc, a[ks], b_desc(b + ks * 2 * T::K_STRIDE, T::K_STRIDE));
    wgmma_commit();
    // The copies for stage s + AHEAD go out while the tensor cores work;
    // they refill the slot of stage s - 1 and, at a chunk's first stage,
    // the slab buffer of the chunk before this one.
    if (s + AHEAD < stages) issue(s + AHEAD);
    cp_async_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }

  // Epilogue: the bf16 tile through the (now idle) ring and slab, then
  // coalesced stores.
  __syncthreads();
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem);
  {
    const int r = wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(cs + r * T::C_LD + col) =
          __floats2bfloat162_rn(acc[4 * n], acc[4 * n + 1]);
      *reinterpret_cast<__nv_bfloat162*>(cs + (r + 8) * T::C_LD + col) =
          __floats2bfloat162_rn(acc[4 * n + 2], acc[4 * n + 3]);
    }
  }
  __syncthreads();
  const int rows = min(BM, p.M - m0), cols = min(BN, p.N - n0);
  __nv_bfloat16* y = p.y + (int64_t)m0 * p.N + n0;
  if (p.vy == 16) {
    const int upr = cols / 8;
    for (int u = tid; u < rows * upr; u += THREADS) {
      const int r = u / upr, j = (u - r * upr) * 8;
      *reinterpret_cast<uint4*>(y + (int64_t)r * p.N + j) =
          *reinterpret_cast<const uint4*>(cs + r * T::C_LD + j);
    }
  } else if (p.vy == 4) {
    const int upr = cols / 2;
    for (int u = tid; u < rows * upr; u += THREADS) {
      const int r = u / upr, j = (u - r * upr) * 2;
      *reinterpret_cast<__nv_bfloat162*>(y + (int64_t)r * p.N + j) =
          *reinterpret_cast<const __nv_bfloat162*>(cs + r * T::C_LD + j);
    }
  } else {
    for (int u = tid; u < rows * cols; u += THREADS) {
      const int r = u / cols, j = u - r * cols;
      y[(int64_t)r * p.N + j] = cs[r * T::C_LD + j];
    }
  }
}

template <int BN>
int launch_bn(Params p, cudaStream_t s) {
  p.slab_rows = BM + 2 * p.W + 2;
  const int smem = Tile<BN>::smem_bytes(p.slab_rows);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);  // W over ~190
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(hexconv_bf16_wgmma_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  hexconv_bf16_wgmma_kernel<BN><<<grid, THREADS, smem, s>>>(p);
  return 0;
}

// BN: Cout rounded up to a width below; wider Cout in balanced tiles
// (138 = 2 x 72, 192 = 2 x 96, 256 = 2 x 128, anything wider by 128).
int launch(const Params& p, cudaStream_t s) {
  if (p.N <= 8) return launch_bn<8>(p, s);
  if (p.N <= 24) return launch_bn<24>(p, s);
  if (p.N <= 64) return launch_bn<64>(p, s);
  if (p.N <= 128) return launch_bn<128>(p, s);
  if (p.N <= 144) return launch_bn<72>(p, s);
  if (p.N <= 192) return launch_bn<96>(p, s);
  return launch_bn<128>(p, s);
}

}  // namespace hop

// ---------------------------------------------------------------------
// f32: FFMA on the CUDA cores.  A TF32 or split-precision tensor-core
// product would change what the f32 path computes, so the product stays
// f32 x f32 -> f32 FMA and its roofline is the CUDA cores' 67 TFLOP/s.
// At the 64-filter self-play shapes (B=512, 5x5) the convs with Cout >= 32
// are bound by those FMAs (64->64: 0.37 G multiply-adds, ~110 FLOP per
// byte of x, W and y against a ridge of 20); the narrow head convs (->21,
// ->16, ->1) are bound by bytes, and in practice by launch and latency.
// One block computes BM pixels x BN output channels:
//
//   * the halo slab: as in the bf16 kernel, the taps of pixels
//     [m0, m0+BM) lie in the flat pixel range [m0-W-1, m0+BM+W+1); the
//     block copies that range's chunk of KC channels into one of two slab
//     buffers by cp.async (16 B where Cin % 4 == 0, 8 B for even Cin, 4 B
//     otherwise), zero past Cin.  Each buffer ends in a zero row that
//     off-board taps read.  A table of every pixel's 7 tap rows, built once
//     per block, makes the parity shift and the zero fill an address; x is
//     read from device memory once per block, not once per tap element;
//   * A straight from the slab: per 4 channels a thread reads one float4
//     of each of its TM pixels' tap rows.  Its pixels are ROWS apart, so
//     the lanes of a warp read neighbouring slab rows (the 272-B pitch puts
//     them in distinct banks) and the lanes of one row share a broadcast.
//     (Copying each tap's A values into a k-major tile first, so that a
//     thread reads float4s of 4 pixels, was 1.6x slower per evaluation.)
//   * B through a ring: the [KC, BN] slice of W[t] for (chunk, tap) goes by
//     cp.async into a ring of NSTAGE stages, AHEAD ahead; the copies of
//     stage s + AHEAD are issued before stage s's FMAs;
//   * the register tile: TM pixels x 4 channels per thread, TM + 4 float4
//     shared loads per 16 TM FFMA;
//   * K split inside the block: KSPLIT groups of threads take interleaved
//     4-channel groups of every stage and add their partial tiles in the
//     epilogue, through shared memory, before coalesced stores; so a block
//     keeps ~256 threads however narrow its BN;
//   * BN is Cout rounded up to 4, 8, 16, 24, 32, 48 or 64 (wider Cout in
//     tiles of 48 or 64), so a narrow conv does no FMAs on padding;
//   * BM = 49 (7 x 7) puts the 12,800 pixels of the 64-filter leg in 262
//     tiles, two per SM on 132 SMs; 64-pixel tiles (200) left 64 SMs with
//     one tile and 68 with two.
//
// What bounds it now: feeding the FFMAs.  At 64->64, B=512 the kernel runs
// at ~25 TFLOP/s, and cuBLAS's f32 GEMM of the same [M, 7 Cin] x [7 Cin, 64]
// product, with A already gathered, at ~29 (timed beside it on an H100).
// Neither loads issued a group ahead, nor fewer shared loads, nor dropping
// the barrier, nor FFMA orders with fewer register-bank conflicts moved it
// by more than a few percent.
// ---------------------------------------------------------------------
namespace f32 {

constexpr int BM = 49;              // pixels per block
constexpr int TM = 7;               // pixels per thread
constexpr int TN = 4;               // output channels per thread: one float4 of B
constexpr int ROWS = BM / TM;       // thread rows of one K group
constexpr int KC = 64;              // channels per slab chunk and B stage
constexpr int KG = KC / 4;          // 4-channel groups per chunk
constexpr int NSTAGE = 4;           // B ring stages
constexpr int AHEAD = NSTAGE - 1;   // stages loaded ahead of the one computed
constexpr int SP = KC + 4;          // slab pitch in floats
constexpr int TARGET_THREADS = 256;  // per block, reached by the K split
static_assert(BM % TM == 0 && KC % 4 == 0, "whole thread rows and channel groups");
static_assert(AHEAD <= 7, "a chunk's slab is loaded with its first tap's B tile");

constexpr int pow2_floor(int v) { return v >= 2 ? 2 * pow2_floor(v / 2) : 1; }

template <int BN>
struct Cfg {
  static constexpr int COLS = BN / TN;
  static constexpr int GROUP = ROWS * COLS;  // threads of one K group
  static constexpr int KSPLIT = pow2_floor(
      TARGET_THREADS / GROUP < 1 ? 1 : TARGET_THREADS / GROUP > KG ? KG : TARGET_THREADS / GROUP);
  static constexpr int THREADS = GROUP * KSPLIT;
  // Registers for at least 512 threads per SM (two blocks of 224 at BN=64).
  static constexpr int MIN_BLOCKS = 512 / THREADS > 0 ? 512 / THREADS : 1;
  static constexpr int STAGE = KC * BN;  // floats per ring stage
  static_assert(BN % TN == 0 && KG % KSPLIT == 0, "tile shape");
  // Ring, two slab buffers of slab_rows + 1 rows (the last one zero) and
  // the tap table; the epilogue's KSPLIT partial tiles reuse the space.
  static int smem_bytes(int slab_rows) {
    const int main = (NSTAGE * STAGE + 2 * (slab_rows + 1) * SP + 7 * BM) * 4;
    const int epilogue = KSPLIT * BM * BN * 4;
    return main > epilogue ? main : epilogue;
  }
};

struct Params {
  const float* x;
  const float* wt;
  float* y;
  int M, N, H, W, Cin;
  int va, vb, vy;  // bytes per copy of x rows, W rows and y rows: 16, 8 or 4
  int slab_rows;   // BM + 2W + 2
};

// One chunk of the halo slab: flat pixels [p0, p0 + slab_rows), channels
// [c0, c0 + kc4) of x (kc4: the chunk's channels rounded up to 4), zero
// past Cin.  Rows off [0, M) are left unwritten: only off-board taps point
// there, and those read the zero row.
template <int THREADS, int SIZE>
__device__ __forceinline__ void load_slab(const Params& p, float* dst0, int c0, int p0) {
  constexpr int UPR = KC * 4 / SIZE;  // copies per row
  constexpr int F = SIZE / 4;         // floats per copy
  const int kc = min(KC, p.Cin - c0), kc4 = (kc + 3) & ~3;
  for (int u = threadIdx.x; u < p.slab_rows * UPR; u += THREADS) {
    const int r = u / UPR, ch = (u % UPR) * F, q = p0 + r;
    if (ch >= kc4 || q < 0 || q >= p.M) continue;
    const float* src = p.x + (int64_t)q * p.Cin + c0 + ch;
    const int valid = ch < kc ? min(SIZE, (kc - ch) * 4) : 0;
    hop::cp_async<SIZE>(hop::smem_u32(dst0 + r * SP + ch), valid ? src : p.x, valid);
  }
}

// The B tile of (tap t, chunk c0): W[t][c0 .. c0+kc4)[n0 .. n0+BN), row
// major with pitch BN, zero past Cin and past Cout.  Where the block's
// threads cover whole rows, each thread copies one fixed column of every
// STEP-th row, so a copy costs an add and a compare.
template <int BN, int THREADS, int SIZE>
__device__ __forceinline__ void load_b(const Params& p, float* dst0, int t, int c0, int n0) {
  constexpr int UPR = BN * 4 / SIZE;  // copies per row
  constexpr int F = SIZE / 4;         // floats per copy
  const int kc4 = (min(KC, p.Cin - c0) + 3) & ~3;
  const float* src0 = p.wt + ((int64_t)t * p.Cin + c0) * p.N + n0;
  if constexpr (THREADS % UPR == 0 && KC % (THREADS / UPR) == 0) {
    constexpr int STEP = THREADS / UPR;
    const int k0 = threadIdx.x / UPR, n = (threadIdx.x % UPR) * F;
    const int vcol = n0 + n < p.N ? min(SIZE, (p.N - n0 - n) * 4) : 0;
#pragma unroll
    for (int i = 0; i < KC / STEP; ++i) {
      const int k = k0 + i * STEP;
      if (k >= kc4) break;
      const int valid = c0 + k < p.Cin ? vcol : 0;
      hop::cp_async<SIZE>(hop::smem_u32(dst0 + k * BN + n), valid ? src0 + k * p.N + n : p.wt, valid);
    }
  } else {
    for (int u = threadIdx.x; u < kc4 * UPR; u += THREADS) {
      const int k = u / UPR, n = (u % UPR) * F, col = n0 + n;
      const int valid = c0 + k < p.Cin && col < p.N ? min(SIZE, (p.N - col) * 4) : 0;
      hop::cp_async<SIZE>(hop::smem_u32(dst0 + k * BN + n), valid ? src0 + k * p.N + n : p.wt, valid);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(Cfg<BN>::THREADS, Cfg<BN>::MIN_BLOCKS)
hexconv_f32_kernel(const Params p) {
  using C = Cfg<BN>;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* slab = ring + NSTAGE * C::STAGE;
  const int buf = (p.slab_rows + 1) * SP;  // floats per slab buffer
  int* tbl = reinterpret_cast<int*>(slab + 2 * buf);
  const int tid = threadIdx.x, g = tid / C::GROUP, tx = tid % C::COLS,
            ty = (tid % C::GROUP) / C::COLS;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int W = p.W, Cin = p.Cin;
  const int chunks = (Cin + KC - 1) / KC, stages = 7 * chunks;
  const int p0 = m0 - W - 1;  // flat pixel of slab row 0
  const int zero = p.slab_rows * SP;

  for (int u = tid; u < SP; u += C::THREADS) {
    slab[zero + u] = 0.0f;
    slab[buf + zero + u] = 0.0f;
  }
  // tbl[t * BM + i]: the slab offset of pixel i's tap t, or the zero row.
  for (int i = tid; i < BM; i += C::THREADS) {
    const int m = m0 + i, w = m % W, h = (m / W) % p.H, odd = w & 1;
#pragma unroll
    for (int t = 0; t < 7; ++t) {
      const int dr = kDr[odd][t], dc = kDc[odd][t], hh = h + dr, ww = w + dc;
      const bool on = m < p.M && hh >= 0 && hh < p.H && ww >= 0 && ww < W;
      tbl[t * BM + i] = on ? (i + W + 1 + dr * W + dc) * SP : zero;
    }
  }

  // Stage s is one (chunk, tap) pair, tap minor: slab buffer (s / 7) & 1,
  // ring slot s % NSTAGE.  Each block starts the cycle of chunks and of
  // taps at its own offset, so that the blocks of a wave do not all ask
  // L2 for the same B tile at once.
  const int spread = blockIdx.x + blockIdx.y;
  const int first_t = spread % 7, first_c = (spread / 7) % chunks;
  auto chunk_tap = [&](int s, int& c, int& t) {
    c = s / 7 + first_c;
    t = s % 7 + first_t;
    if (c >= chunks) c -= chunks;
    if (t >= 7) t -= 7;
  };
  auto issue = [&](int s) {
    int c, t;
    chunk_tap(s, c, t);
    if (s % 7 == 0) {
      float* dst = slab + ((s / 7) & 1) * buf;
      if (p.va == 16) load_slab<C::THREADS, 16>(p, dst, c * KC, p0);
      else if (p.va == 8) load_slab<C::THREADS, 8>(p, dst, c * KC, p0);
      else load_slab<C::THREADS, 4>(p, dst, c * KC, p0);
    }
    float* dst = ring + (s % NSTAGE) * C::STAGE;
    if (p.vb == 16) load_b<BN, C::THREADS, 16>(p, dst, t, c * KC, n0);
    else if (p.vb == 8) load_b<BN, C::THREADS, 8>(p, dst, t, c * KC, n0);
    else load_b<BN, C::THREADS, 4>(p, dst, t, c * KC, n0);
  };

  float acc[TM][TN];
#pragma unroll
  for (int j = 0; j < TM; ++j)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[j][n] = 0.0f;

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < stages) issue(s);
    hop::cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    hop::cp_async_wait<AHEAD - 1>();  // this thread's copies of stage s have landed
    __syncthreads();  // everyone's have, and everyone is done with stage s - 1
    // The copies for stage s + AHEAD refill the slot of stage s - 1 and, at
    // a chunk's first stage, the slab buffer of the chunk before this one.
    if (s + AHEAD < stages) issue(s + AHEAD);
    hop::cp_async_commit();
    int c, t;
    chunk_tap(s, c, t);
    const int groups = (min(KC, Cin - c * KC) + 3) / 4;
    const float* sl = slab + ((s / 7) & 1) * buf;
    const float* bs = ring + (s % NSTAGE) * C::STAGE + tx * TN;
    int off[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) off[j] = tbl[t * BM + ty + j * ROWS];
#pragma unroll
    for (int q = 0; q < KG / C::KSPLIT; ++q) {
      const int kg = q * C::KSPLIT + g;
      if (kg < groups) {
        float4 a[TM], b[4];
#pragma unroll
        for (int j = 0; j < TM; ++j) a[j] = *reinterpret_cast<const float4*>(sl + off[j] + 4 * kg);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          b[k] = *reinterpret_cast<const float4*>(bs + (4 * kg + k) * BN);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int j = 0; j < TM; ++j) {
            const float ak = k == 0 ? a[j].x : k == 1 ? a[j].y : k == 2 ? a[j].z : a[j].w;
            acc[j][0] = fmaf(ak, b[k].x, acc[j][0]);
            acc[j][1] = fmaf(ak, b[k].y, acc[j][1]);
            acc[j][2] = fmaf(ak, b[k].z, acc[j][2]);
            acc[j][3] = fmaf(ak, b[k].w, acc[j][3]);
          }
        }
      }
    }
  }

  // Epilogue: the KSPLIT partial tiles through the (now idle) ring and
  // slab, summed in a fixed order, then coalesced stores.
  __syncthreads();
  float* part = smem;
#pragma unroll
  for (int j = 0; j < TM; ++j)
    *reinterpret_cast<float4*>(part + (g * BM + ty + j * ROWS) * BN + tx * TN) =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  __syncthreads();
  const int rows = min(BM, p.M - m0), cols = min(BN, p.N - n0);
  float* y = p.y + (int64_t)m0 * p.N + n0;
  if (p.vy == 16) {
    const int upr = cols / 4;
    for (int u = tid; u < rows * upr; u += C::THREADS) {
      const int r = u / upr, j = (u - r * upr) * 4;
      float4 v = *reinterpret_cast<const float4*>(part + r * BN + j);
#pragma unroll
      for (int k = 1; k < C::KSPLIT; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(part + (k * BM + r) * BN + j);
        v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
      }
      *reinterpret_cast<float4*>(y + (int64_t)r * p.N + j) = v;
    }
  } else {
    for (int u = tid; u < rows * cols; u += C::THREADS) {
      const int r = u / cols, j = u - r * cols;
      float v = part[r * BN + j];
#pragma unroll
      for (int k = 1; k < C::KSPLIT; ++k) v += part[(k * BM + r) * BN + j];
      y[(int64_t)r * p.N + j] = v;
    }
  }
}

template <int BN>
int launch_bn(Params p, cudaStream_t s) {
  p.slab_rows = BM + 2 * p.W + 2;
  const int smem = Cfg<BN>::smem_bytes(p.slab_rows);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);  // W over ~126
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(hexconv_f32_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  hexconv_f32_kernel<BN><<<grid, Cfg<BN>::THREADS, smem, s>>>(p);
  return 0;
}

// BN: Cout rounded up to a width below; wider Cout in tiles of 48 (up to
// 96) or 64.
int launch(const Params& p, cudaStream_t s) {
  if (p.N <= 4) return launch_bn<4>(p, s);
  if (p.N <= 8) return launch_bn<8>(p, s);
  if (p.N <= 16) return launch_bn<16>(p, s);
  if (p.N <= 24) return launch_bn<24>(p, s);
  if (p.N <= 32) return launch_bn<32>(p, s);
  if (p.N <= 48) return launch_bn<48>(p, s);
  if (p.N <= 64) return launch_bn<64>(p, s);
  if (p.N <= 96) return launch_bn<48>(p, s);
  return launch_bn<64>(p, s);
}

}  // namespace f32

}  // namespace

// Plain C interface (loaded with ctypes).  dtype: 0 = f32, 1 = bf16.
// x: [B, H, W, Cin], wt: [7*Cin, Cout] (== [7, Cin, Cout]), y: [B, H, W, Cout],
// all contiguous in the given dtype.  Launches on `stream` and returns the
// cudaError_t of the launch (0 = success); it does not synchronize.
extern "C" int hexconv_forward(const void* x, const void* wt, void* y, int B, int H, int W,
                               int Cin, int Cout, int dtype, void* stream) {
  const int M = B * H * W;
  const int N = Cout;
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    f32::Params p;
    p.x = static_cast<const float*>(x);
    p.wt = static_cast<const float*>(wt);
    p.y = static_cast<float*>(y);
    p.M = M, p.N = N, p.H = H, p.W = W, p.Cin = Cin;
    p.va = copy_width_f32(x, Cin);
    p.vb = copy_width_f32(wt, Cout);
    p.vy = copy_width_f32(y, Cout);
    const int err = f32::launch(p, s);
    if (err != 0) return err;
  } else if (dtype == 1) {
    hop::Params p;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.wt = static_cast<const __nv_bfloat16*>(wt);
    p.y = static_cast<__nv_bfloat16*>(y);
    p.M = M, p.N = N, p.H = H, p.W = W, p.Cin = Cin;
    p.va = copy_width(x, Cin);
    p.vb = copy_width(wt, Cout);
    p.vy = copy_width(y, Cout);
    const int err = hop::launch(p, s);
    if (err != 0) return err;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
