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
// dW, far above either ridge point: it is bound by operations.  Two
// kernels, one per dtype, each summing pixel slices into an f32 workspace
// [slices, 7*Cin, Cout] that a second kernel (hexconv_dw_reduce_kernel)
// adds in slice order and rounds once to the output dtype.  No float
// atomics: the same inputs give the same bits on every run.
//
// * f32 (hexconv_dw_f32_kernel) stays on the CUDA cores (FFMA), so f32
//   results keep f32 rounding (see the note at the kernel);
// * bf16 (hop::hexconv_dw_bf16_wgmma_kernel) puts the product on Hopper's
//   warpgroup tensor cores (see the note at the kernel).

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------
// f32: FFMA on the CUDA cores, f32 x f32 -> f32.
//   * grid (7*Cin / BR) x (Cout / BC) x slices: each block computes one
//     BR x BC tile of dW over one slice of the pixels, so that the narrow
//     outputs still fill the card;
//   * per chunk of MC pixels the block gathers the tap rows of its BR rows
//     of A^T into shared memory once (a table of each pixel's 7 neighbour
//     indices, -1 off the board, makes the parity shift and the zero fill
//     an index) and the matching MC x BC tile of dY, then each thread adds
//     a TR x TC outer product per pixel from float4 shared loads.
// ---------------------------------------------------------------------

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
  const float* x;   // [M, Cin]
  const float* dy;  // [M, Cout]
  float* part;      // [slices, 7*Cin, Cout]
  int M, H, W, Cin, Cout, K;  // K = 7*Cin
  int slice;        // pixels per slice, a multiple of MC
};

__global__ void __launch_bounds__(THREADS) hexconv_dw_f32_kernel(const Params p) {
  __shared__ __align__(16) float As[MC][BR];
  __shared__ __align__(16) float Ds[MC][BC];
  __shared__ int nbr[MC][7];
  const float* x = p.x;
  const float* dy = p.dy;
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
      As[k][lane_rc] = (row_ok && idx >= 0) ? x[(int64_t)idx * p.Cin + ci] : 0.f;
      const int m = m0 + k;
      Ds[k][lane_rc] = (col_ok && m < m_end) ? dy[(int64_t)m * p.Cout + col] : 0.f;
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

// ---------------------------------------------------------------------
// bf16: the Hopper kernel.  Per block: CK = 64 input channels ci of x, BN
// output channels of dY and one slice of the pixels, for all 7 taps.  The
// product is wgmma.m64nNk16.f32.bf16.bf16 with M = the 64 channels ci of
// one tap, N = BN and K = 16 pixels, f32 accumulators in registers:
//
//   * the halo slab: the taps of pixels [m0, m0+P) all lie in the flat
//     pixel range [m0-W-1, m0+P+W+1), so the block copies that range of
//     its 64 channels of x into shared memory (cp.async, 16 B where the
//     row allows it, 4 B for even Cin, 2 B by plain loads otherwise),
//     pixel-major with the channels past Cin zeroed, at a pitch of 144 B
//     (9 x 16 B) so that 8 consecutive rows fall in 8 distinct bank
//     groups.  One slab feeds all 7 taps; off-board taps and the pixels
//     past the slice read a zero row;
//   * A from registers: ldmatrix.x4.trans straight from the slab.  Each
//     lane gives the 16-byte row address of x[nbr_t(m), ci0..ci0+7] for
//     one pixel of the k16 step (a table of each pixel's 7 tap rows, built
//     once per chunk, makes the parity shift and the zero fill an
//     address), and the transpose delivers the (ci x pixel) fragment that
//     wgmma's register A takes.  No A tile is ever built;
//   * B = the dY tile [P pixels x BN] in shared memory, in the MN-major
//     no-swizzle core-matrix layout of the forward's B (here the pixels
//     play the role of the forward's k rows), zero past Cout and past the
//     slice.  One dY tile is the B of all 7 taps' products;
//   * warp specialization: a producer warpgroup copies each chunk of P =
//     128 pixels (slab, dY tile, tap table) into a ring of STAGES stages
//     and two consumer warpgroups run the products, taps 0-3 and 4-6, on
//     the stages that are full; named barriers pass each stage between
//     them.  The consumers' instruction stream is the table read, the
//     ldmatrix and the wgmma of each k16 step and nothing else.  With the
//     copies in the same warps (the first design) the kernel took 28 us
//     at 256->256 (B=256, 5x5), of which leaving the wgmmas out saved 4 us
//     and leaving the copies out 7.5 us (tune_dw.py's diagnostic builds,
//     PERF.md): the warps issuing copies were not feeding the tensor cores;
//   * registers: the 7 taps' accumulators of a 64 x BN tile are 7*64*BN
//     f32 values, 128 a consumer thread at BN = 64 with four taps; the
//     producer gives its registers up to the consumers (setmaxnreg).  (A
//     grid axis over tap groups, two taps a warpgroup at BN = 128, timed
//     2% faster to 6% slower than this: PERF.md);
//   * within a chunk the A fragments of step s+1 are loaded while step s's
//     wgmmas run (A registers double-buffered), and a stage goes back to
//     the producer once the next chunk's first step has retired its last
//     wgmma, so the tensor cores do not drain between chunks;
//   * the 64 x BN x 7 partial tile goes to the slice's workspace rows,
//     and the reduce kernel adds the slices in order.
//
// What bounds it: per k16 step and tap the SM reads 2 KB of A fragments
// and 2*BN*16 B of dY from shared memory for 64*BN*16 multiply-adds, so at
// BN = 64 shared memory keeps pace with the tensor cores only just.  But
// on the card the wgmmas are the smaller part of the time: the copies,
// the 114 KB f32 partial that each block writes at BN = 64 (read back by
// the reduce kernel) and each block's fixed start and end costs weigh
// more, at 5x5 boards where a block sees only ~7 chunks (PERF.md).  The
// narrow convs (Cin 64, Cout 1 or 21) pad M or N and are bound by those
// fixed costs.
// ---------------------------------------------------------------------
namespace hop {

constexpr int NWG = 2;                       // consumer warpgroups
constexpr int TPW = 4;                       // taps per consumer: 0-3 and 4-6
constexpr int PRODUCER_THREADS = 128;        // one producer warpgroup
constexpr int DW_THREADS = PRODUCER_THREADS + 128 * NWG;
constexpr int PRODUCER_REGS = 56;            // setmaxnreg: 128 x 56 + 256 x 224
constexpr int CONSUMER_REGS = 224;           //   = 64,512 of the SM's 65,536
constexpr int CK = 64;                       // input channels per block: the wgmma's M
constexpr int KSTEPS = 8;                    // k16 steps per chunk
constexpr int P = 16 * KSTEPS;               // pixels per chunk
constexpr int STAGES = 3;                    // chunks in flight
static_assert(STAGES >= 3, "the producer signals a chunk once the next one is issued");
constexpr int ROW_BYTES = CK * 2 + 16;       // slab pitch: 9 x 16 B
// Named barriers (0 is __syncthreads): FULL + s when stage s holds a
// chunk, EMPTY + s when the consumers are done with it.
constexpr int FULL = 1, EMPTY = FULL + STAGES;
static_assert(EMPTY + STAGES <= 16, "16 named barriers");
static_assert(PRODUCER_THREADS * PRODUCER_REGS + 128 * NWG * CONSUMER_REGS <= 65536,
              "the register file");

struct DwParams {
  const __nv_bfloat16* x;   // [M, Cin]
  const __nv_bfloat16* dy;  // [M, Cout]
  float* part;              // [slices, 7*Cin, Cout]
  int M, H, W, Cin, Cout;
  int slice;                // pixels per slice, a multiple of 16
  int va, vd;               // bytes per copy of x rows and dY rows: 16, 4 or 2
  int slab_rows;            // P + 2W + 2
};

template <int BN>
struct DwTile {
  static constexpr int DY_BYTES = P * BN * 2;  // one dY tile
  static constexpr int K_STRIDE = BN * 16;     // bytes between 8-pixel core-matrix rows
};

// Shared memory of a block at tile width `bn`: per stage a dY tile, a slab
// and a tap table, and the zero row.
constexpr int smem_bytes(int bn, int slab_rows) {
  return STAGES * (P * bn * 2 + slab_rows * ROW_BYTES + 7 * P * 4) + ROW_BYTES;
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(DW_THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(DW_THREADS) : "memory");
}

// The producer's loaders: thread `pt` of PRODUCER_THREADS issues every
// PRODUCER_THREADS-th copy.

// The slab of one chunk: flat pixels [p0, p0 + slab_rows), channels
// [c0, c0 + CK) of x, zero past Cin.  Rows off [0, M) are left unwritten:
// only off-board taps point there, and those read the zero row.
template <int SIZE>
__device__ __forceinline__ void load_slab(const DwParams& p, unsigned char* dst0, int c0, int p0,
                                          int pt) {
  constexpr int UPR = CK * 2 / SIZE;               // copies per row
  constexpr int STEP = PRODUCER_THREADS / UPR;     // rows between a thread's copies
  static_assert(PRODUCER_THREADS % UPR == 0, "each thread keeps one column of the rows");
  const int j = pt % UPR, ch = j * (SIZE / 2);
  const int kc = min(CK, p.Cin - c0);
  const int valid = ch < kc ? min(SIZE, (kc - ch) * 2) : 0;
  int r = pt / UPR, q = p0 + r;
  const __nv_bfloat16* src = p.x + (int64_t)q * p.Cin + c0 + ch;
  uint32_t dst = smem_u32(dst0 + r * ROW_BYTES + j * SIZE);
  const int64_t src_step = (int64_t)STEP * p.Cin;
  for (; r < p.slab_rows; r += STEP, q += STEP, src += src_step, dst += STEP * ROW_BYTES) {
    if (q < 0 || q >= p.M) continue;
    if constexpr (SIZE == 2) {
      const __nv_bfloat16 v = valid ? *src : __ushort_as_bfloat16(0);
      asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(dst), "h"(__bfloat16_as_ushort(v)));
    } else {
      cp_async<SIZE>(dst, valid ? static_cast<const void*>(src) : p.x, valid);
    }
  }
}

// The dY tile of one chunk: dY[m0 .. m0+P)[n0 .. n0+BN) in the descriptor's
// core-matrix layout (8 pixels x 16 B per core matrix), zero past Cout and
// at pixels from m_end on.  Copy u lands at byte u * SIZE.
template <int BN, int SIZE>
__device__ __forceinline__ void load_dy(const DwParams& p, unsigned char* dst0, int m0, int m_end,
                                        int n0, int pt) {
  constexpr int PER = 16 / SIZE;  // copies per 16-byte core-matrix row
  constexpr int NG = BN / 8;      // core matrices along N
  constexpr int GROUP = 8 * NG * PER;  // copies per 8 pixels
  if constexpr (PRODUCER_THREADS % GROUP == 0) {
    // Each thread keeps one column and pixel of every 8-pixel group it
    // copies, PRODUCER_THREADS / GROUP groups apart.
    constexpr int GSTEP = PRODUCER_THREADS / GROUP;
    const int v = pt % GROUP, ng = v / (8 * PER), k8 = (v / PER) % 8;
    const int col = n0 + ng * 8 + (v % PER) * (SIZE / 2);
    const int valid_col = col < p.Cout ? min(SIZE, (p.Cout - col) * 2) : 0;
    int m = m0 + (pt / GROUP) * 8 + k8;
    const __nv_bfloat16* src = p.dy + (int64_t)m * p.Cout + col;
    uint32_t dst = smem_u32(dst0 + pt * SIZE);
    const int64_t src_step = (int64_t)GSTEP * 8 * p.Cout;
    for (int u = pt; u < P * BN * 2 / SIZE;
         u += PRODUCER_THREADS, m += GSTEP * 8, src += src_step, dst += PRODUCER_THREADS * SIZE) {
      const int valid = m < m_end ? valid_col : 0;
      if constexpr (SIZE == 2) {
        const __nv_bfloat16 v = valid ? *src : __ushort_as_bfloat16(0);
        asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(dst), "h"(__bfloat16_as_ushort(v)));
      } else {
        cp_async<SIZE>(dst, valid ? static_cast<const void*>(src) : p.dy, valid);
      }
    }
  } else {
    for (int u = pt; u < P * BN * 2 / SIZE; u += PRODUCER_THREADS) {
      const int rest = u / (PER * 8), ng = rest % NG, kg = rest / NG;
      const int m = m0 + kg * 8 + (u / PER) % 8, col = n0 + ng * 8 + (u % PER) * (SIZE / 2);
      unsigned char* dst = dst0 + u * SIZE;
      const int valid = m < m_end && col < p.Cout ? min(SIZE, (p.Cout - col) * 2) : 0;
      const __nv_bfloat16* src = p.dy + (int64_t)m * p.Cout + col;
      if constexpr (SIZE == 2)
        *reinterpret_cast<__nv_bfloat16*>(dst) = valid ? *src : __ushort_as_bfloat16(0);
      else
        cp_async<SIZE>(smem_u32(dst), valid ? static_cast<const void*>(src) : p.dy, valid);
    }
  }
}

// tbl[t * P + i]: the shared address of the slab row that pixel m0 + i's
// tap t reads, or the zero row (off the board, or at or past m_end).
__device__ __forceinline__ void fill_table(const DwParams& p, uint32_t* tbl, uint32_t slab,
                                           uint32_t zero, int m0, int m_end, int pt) {
  for (int i = pt; i < P; i += PRODUCER_THREADS) {
    const int m = m0 + i;
    const int w = m % p.W, h = (m / p.W) % p.H, odd = w & 1;
#pragma unroll
    for (int t = 0; t < 7; ++t) {
      const int dr = kDr[odd][t], dc = kDc[odd][t], hh = h + dr, ww = w + dc;
      const bool on = m < m_end && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
      tbl[t * P + i] = on ? slab + (i + p.W + 1 + dr * p.W + dc) * ROW_BYTES : zero;
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(DW_THREADS, 1) hexconv_dw_bf16_wgmma_kernel(const DwParams p) {
  using T = DwTile<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  // Stage s: its dY tile at dyb + s * DY_BYTES, its slab at slab + s *
  // slab_rows * ROW_BYTES, its table at tbl + s * 7 * P; then the zero row.
  unsigned char* dyb = smem;
  unsigned char* slab = smem + STAGES * T::DY_BYTES;
  uint32_t* tbl = reinterpret_cast<uint32_t*>(slab + STAGES * p.slab_rows * ROW_BYTES);
  unsigned char* zero_row = reinterpret_cast<unsigned char*>(tbl + STAGES * 7 * P);
  const int tid = threadIdx.x;
  // The warpgroup, broadcast from lane 0 so that the compiler knows it is
  // warp-uniform (a wgmma under a branch it cannot prove uniform is
  // serialized): 0 is the producer, 1 .. NWG the consumers.
  const int wg = __shfl_sync(0xffffffff, tid / 128, 0);
  const int c0 = blockIdx.x * CK, n0 = blockIdx.y * BN;
  const int m_begin = blockIdx.z * p.slice, m_end = min(p.M, m_begin + p.slice);
  const int chunks = (m_end - m_begin + P - 1) / P;

  for (int i = tid; i < ROW_BYTES / 16; i += DW_THREADS)
    reinterpret_cast<uint4*>(zero_row)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  if (wg == 0) {
    // Producer.  Chunk c goes to stage c % STAGES once the consumers have
    // released the chunk that stage held (c - STAGES); its stage is FULL
    // once chunk c + 1's copies are issued too, so that the copies of two
    // chunks are in flight.  (The consumers release chunk c - STAGES when
    // they start chunk c - STAGES + 1, which needs chunk c - STAGES + 1 to
    // be FULL, which the producer signals when it has issued chunk
    // c - STAGES + 2 <= c - 1: no cycle for STAGES >= 3.)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    auto full = [&](int s) {
      // This thread's copies and stores of the stage are in shared memory;
      // make them visible to the wgmmas (async proxy), then to the consumers.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __threadfence_block();
      bar_arrive(FULL + s);
    };
    int s = 0;
    for (int c = 0; c < chunks; ++c, s = s + 1 == STAGES ? 0 : s + 1) {
      if (c >= STAGES) bar_sync(EMPTY + s);
      const int m0 = m_begin + c * P;
      unsigned char* sl = slab + s * p.slab_rows * ROW_BYTES;
      if (p.va == 16) load_slab<16>(p, sl, c0, m0 - p.W - 1, tid);
      else if (p.va == 4) load_slab<4>(p, sl, c0, m0 - p.W - 1, tid);
      else load_slab<2>(p, sl, c0, m0 - p.W - 1, tid);
      unsigned char* d = dyb + s * T::DY_BYTES;
      if (p.vd == 16) load_dy<BN, 16>(p, d, m0, m_end, n0, tid);
      else if (p.vd == 4) load_dy<BN, 4>(p, d, m0, m_end, n0, tid);
      else load_dy<BN, 2>(p, d, m0, m_end, n0, tid);
      fill_table(p, tbl + s * 7 * P, smem_u32(sl), smem_u32(zero_row), m0, m_end, tid);
      cp_async_commit();
      if (c > 0) {
        cp_async_wait<1>();  // chunk c - 1's copies have landed
        full(s == 0 ? STAGES - 1 : s - 1);
      }
    }
    cp_async_wait<0>();
    full(s == 0 ? STAGES - 1 : s - 1);
    return;
  }

  // Consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int lane = tid & 31, warp = (tid / 32) & 3;
  const int t0 = (wg - 1) * TPW;  // this warpgroup's first tap
  // The pixel of a k16 step whose row this lane addresses for ldmatrix.x4
  // (matrices: pixels 0-7 / 8-15 x channels +0 / +8), and the byte offset
  // of its 8 channels in a slab row (this warp's 16 of the 64 rows of M).
  const int lane_px = ((lane >> 4) << 3) | (lane & 7);
  const uint32_t lane_col = (warp * 16 + ((lane >> 3) & 1) * 8) * 2;

  float acc[TPW][BN / 2];
#pragma unroll
  for (int j = 0; j < TPW; ++j)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[j][i] = 0.0f;

  uint32_t a[2][TPW][4];
  for (int c = 0, s = 0; c < chunks; ++c, s = s + 1 == STAGES ? 0 : s + 1) {
    bar_sync(FULL + s);
    const uint32_t* tb = tbl + s * 7 * P;
    const uint32_t dbase = smem_u32(dyb + s * T::DY_BYTES);
    const int steps = min(KSTEPS, (m_end - m_begin - c * P + 15) / 16);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      if (ks < steps) {
#pragma unroll
        for (int j = 0; j < TPW; ++j)
          if (t0 + j < 7)
            ldmatrix_x4_trans(a[ks & 1][j], tb[(t0 + j) * P + ks * 16 + lane_px] + lane_col);
        wgmma_fence();
        const uint64_t desc = b_desc(dbase + ks * 2 * T::K_STRIDE, T::K_STRIDE);
#pragma unroll
        for (int j = 0; j < TPW; ++j)
          if (t0 + j < 7) mma_cols<BN>(acc[j], a[ks & 1][j], desc);
        wgmma_commit();
        // Every group but this step's has retired: step ks - 1's A
        // registers may be reloaded, and at a chunk's first step the chunk
        // before is done with, so its stage goes back to the producer
        // (which waits for it only where a chunk is left to load there).
        wgmma_wait<1>();
        if (ks == 0 && c > 0 && c - 1 + STAGES < chunks)
          bar_arrive(EMPTY + (s == 0 ? STAGES - 1 : s - 1));
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < TPW; ++j) fence_acc(acc[j]);

  // This slice's partial tile: rows t*Cin + c0 + r of the workspace.
  float* out = p.part + (int64_t)blockIdx.z * 7 * p.Cin * p.Cout;
  const bool pairs = (p.Cout & 1) == 0;
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int t = t0 + j;
    if (t >= 7) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = c0 + warp * 16 + (lane >> 2) + half * 8;
      if (ci >= p.Cin) continue;
      float* row = out + ((int64_t)t * p.Cin + ci) * p.Cout;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const int co = n0 + n * 8 + (lane & 3) * 2;
        const float v0 = acc[j][4 * n + 2 * half], v1 = acc[j][4 * n + 2 * half + 1];
        if (pairs && co + 1 < p.Cout) {
          *reinterpret_cast<float2*>(row + co) = make_float2(v0, v1);
        } else {
          if (co < p.Cout) row[co] = v0;
          if (co + 1 < p.Cout) row[co + 1] = v1;
        }
      }
    }
  }
}

template <int BN>
int launch_bn(DwParams p, int slices, cudaStream_t s) {
  p.slab_rows = P + 2 * p.W + 2;
  const int smem = smem_bytes(BN, p.slab_rows);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(hexconv_dw_bf16_wgmma_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((p.Cin + CK - 1) / CK, (p.Cout + BN - 1) / BN, slices);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  hexconv_dw_bf16_wgmma_kernel<BN><<<grid, DW_THREADS, smem, s>>>(p);
  return 0;
}

// BN: Cout over ceil(Cout / 64) balanced tiles, rounded up to a width
// below (1 -> 8, 21 -> 24, 138 -> 3 x 48, 256 -> 4 x 64, 342 -> 6 x 64).
int tile_width(int cout) {
  const int tiles = (cout + 63) / 64, per = (cout + tiles - 1) / tiles;
  return per <= 8 ? 8 : per <= 16 ? 16 : per <= 24 ? 24 : per <= 32 ? 32 : per <= 48 ? 48 : 64;
}

int launch(const DwParams& p, int slices, cudaStream_t s) {
  switch (tile_width(p.Cout)) {
    case 8: return launch_bn<8>(p, slices, s);
    case 16: return launch_bn<16>(p, slices, s);
    case 24: return launch_bn<24>(p, slices, s);
    case 32: return launch_bn<32>(p, slices, s);
    case 48: return launch_bn<48>(p, slices, s);
    default: return launch_bn<64>(p, slices, s);
  }
}

}  // namespace hop

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
// The bf16 kernel refuses boards wider than hexconv_dw_max_width.
extern "C" int hexconv_dw(const void* x, const void* dy, float* part, void* dw, int B, int H,
                          int W, int Cin, int Cout, int dtype, int slices, int slice,
                          void* stream) {
  const int M = B * H * W;
  if (M == 0 || Cin == 0 || Cout == 0) return 0;
  if (slices < 1 || slice < MC || slice % MC != 0 || (int64_t)slices * slice < M ||
      (int64_t)(slices - 1) * slice >= M)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int64_t n = (int64_t)7 * Cin * Cout;
  const int reduce_blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  if (dtype == 0) {
    Params p;
    p.x = static_cast<const float*>(x), p.dy = static_cast<const float*>(dy), p.part = part;
    p.M = M, p.H = H, p.W = W, p.Cin = Cin, p.Cout = Cout, p.K = 7 * Cin;
    p.slice = slice;
    const dim3 grid((p.K + BR - 1) / BR, (Cout + BC - 1) / BC, slices);
    if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
    hexconv_dw_f32_kernel<<<grid, THREADS, 0, s>>>(p);
    hexconv_dw_reduce_kernel<float><<<reduce_blocks, 256, 0, s>>>(part, static_cast<float*>(dw),
                                                                 n, slices);
  } else if (dtype == 1) {
    hop::DwParams p;
    p.x = static_cast<const __nv_bfloat16*>(x), p.dy = static_cast<const __nv_bfloat16*>(dy);
    p.part = part;
    p.M = M, p.H = H, p.W = W, p.Cin = Cin, p.Cout = Cout;
    p.slice = slice;
    p.va = copy_width(x, Cin);
    p.vd = copy_width(dy, Cout);
    const int err = hop::launch(p, slices, s);
    if (err != 0) return err;
    hexconv_dw_reduce_kernel<__nv_bfloat16><<<reduce_blocks, 256, 0, s>>>(
        part, static_cast<__nv_bfloat16*>(dw), n, slices);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The blocks of one pixel slice of the dW kernel of `dtype`: the grid plan
// (nuzero_tpu_torch/ops/cuda/hexconv_kernel.py) sizes the slices by it.
// The bf16 kernel's blocks take 64 input channels and one BN tile of Cout;
// -1 for f32, whose plan is its own.
extern "C" int hexconv_dw_blocks_per_slice(int Cin, int Cout, int dtype) {
  if (dtype != 1) return -1;
  const int bn = hop::tile_width(Cout);
  return ((Cin + hop::CK - 1) / hop::CK) * ((Cout + bn - 1) / bn);
}

// The widest board (W) the dW kernel of `dtype` takes at `Cout`: the bf16
// kernel's STAGES slabs of P + 2W + 2 rows must fit its shared memory
// beside the dY tiles and tap tables; -1 where there is no such cap (f32).
extern "C" int hexconv_dw_max_width(int Cout, int dtype) {
  if (dtype != 1) return -1;
  const int rows = (kMaxSmem - hop::smem_bytes(hop::tile_width(Cout), 0)) /
                   (hop::STAGES * hop::ROW_BYTES);
  return (rows - hop::P - 2) / 2;  // slab rows P + 2W + 2 <= rows
}
