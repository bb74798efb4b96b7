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
// kernels, one per dtype, each summing pixel slices in f32 into a
// workspace of partials [partials, 7*Cin, Cout] that a second kernel
// (hexconv_dw_reduce_kernel) adds in order and rounds once to the output
// dtype.  No float atomics: the same inputs give the same bits on every
// run.
//
// * f32 (f32::hexconv_dw_f32_kernel) stays on the CUDA cores (FFMA), so
//   f32 results keep f32 rounding; thread-block clusters add up to 8
//   slices before the workspace, and one cluster writes dW itself (see
//   the note at the kernel);
// * bf16 (hop::hexconv_dw_bf16_wgmma_kernel) puts the product on Hopper's
//   warpgroup tensor cores (see the note at the kernel).

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------
// f32: FFMA on the CUDA cores, f32 x f32 -> f32.  Per block: CK = 32
// input channels ci of x, BN output channels of dY, all 7 taps and one
// slice of the pixels, so that x and dY are each read once per chunk:
//
//   * the halo slab: the taps of pixels [m0, m0+P) all lie in the flat
//     pixel range [m0-W-1, m0+P+W+1), so the block copies that range of
//     its CK channels of x into shared memory, and the P x BN tile of dY
//     beside it, by cp.async (16, 8 or 4 bytes by the rows' alignment);
//     a table of each pixel's 7 tap rows, built per chunk, makes the
//     parity shift and the zero fill a row offset, with a zero row for
//     off-board taps and the pixels past the slice.  This is the layout of
//     the f32 forward (hexconv.cu) and of the bf16 dW below;
//   * a ring of STAGES chunks: chunk c+STAGES-1's copies and table are
//     issued right after the one barrier of chunk c, and land while chunk
//     c's products run;
//   * the register tile: each thread accumulates TR = 4 channels x TC = 4
//     output channels for all 7 taps (112 f32 sums).  Per pixel it reads
//     the pixel's 7 tap offsets (two int4), one float4 of dY and one
//     float4 of x per tap, 10 shared loads for 112 FFMA;
//   * KS = 2 groups of threads hold the same CK x BN tile and take
//     alternate pixels of each chunk (a K split inside the block), so that
//     a block's tile, which the cluster reduction moves between SMs, is
//     half the registers' worth of partial sums; the groups' tiles are
//     added in shared memory first;
//   * the reduction over the pixels: each thread sums its pixels in order;
//     the blocks of up to 8 consecutive slices of one (CK, BN) tile form a
//     thread-block cluster and add their tiles in slice order through
//     distributed shared memory, each block taking one share of the tile;
//     only the cluster's sum leaves the SM: into dW where one cluster
//     covers all slices, else into the workspace, whose partials
//     hexconv_dw_reduce_kernel adds in order.  No float atomics.  The
//     reduce kernel is launched as a programmatic dependent of the main
//     one, so its launch overlaps the main kernel's epilogue.
//
// What bounds it: at 5x5 boards, fixed costs as much as the products.  A
// 32 x 64 tile does 7*32*64 = 14,336 FFMA per pixel against one row of x
// and one of dY copied, so the main loop is bound by issuing FFMA and the
// shared loads that feed them (about 60% of the FFMA peak on the card);
// but a block sees only a few chunks (the plan, hexconv_kernel.py's
// dw_slices, keeps one wave of blocks whose clusters the card holds at
// once), and each pays its first chunk's copies, two cluster barriers, the
// exchange of its 56 KB tile and the reduce kernel: about 10 of a 64->64
// conv's 22 us (per-block phase times of an instrumented copy, PERF.md).
// ---------------------------------------------------------------------
namespace f32 {

constexpr int KS = 2;           // thread groups of a block, splitting each chunk's pixels
constexpr int CK = 64 / KS;     // input channels per block
constexpr int TR = 4;           // input channels per thread
constexpr int TC = 4;           // output channels per thread: one float4 of dY
constexpr int P = 16 * KS;      // pixels per chunk: 16 per group
constexpr int STAGES = 2;       // chunks in flight
constexpr int TBL = 8;          // tap-table ints per pixel (7 taps, padded)
constexpr int MAX_CLUSTER = 8;  // blocks per cluster (the portable maximum)
static_assert(CK % TR == 0 && TBL == 8, "whole thread rows; a pixel's taps are two int4");

template <int BN>
struct Cfg {
  static constexpr int COLS = BN / TC;                  // threads along Cout
  static constexpr int GROUP = (CK / TR) * COLS;        // threads of one group
  static constexpr int THREADS = KS * GROUP;
  static constexpr int TILE4 = 7 * CK * BN / 4;         // float4s of a block's tile
  static_assert(BN % TC == 0 && THREADS <= 1024, "tile shape");
};

struct Params {
  const float* x;   // [M, Cin]
  const float* dy;  // [M, Cout]
  float* out;       // dW [7*Cin, Cout] (one cluster), else [slices / cluster, 7*Cin, Cout]
  int M, H, W, Cin, Cout;
  int slice;        // pixels per slice, a multiple of 16
  int cluster;      // blocks per cluster along the slices
  int va, vd;       // bytes per copy of x rows and dY rows: 16, 8 or 4
  int vo;           // 1 where rows of dW take float4 stores (Cout % 4 == 0)
  int slab_rows;    // P + 2W + 2
};

// Floats of one ring stage: the slab and its zero row, the dY tile, the
// tap table.
__host__ __device__ constexpr int stage_floats(int bn, int slab_rows) {
  return (slab_rows + 1) * CK + P * bn + P * TBL;
}
// The ring, or in the epilogue the KS groups' 7 x CK x BN tiles, whichever
// is larger.
constexpr int smem_bytes(int bn, int slab_rows) {
  return 4 * (STAGES * stage_floats(bn, slab_rows) > KS * 7 * CK * bn
                  ? STAGES * stage_floats(bn, slab_rows) : KS * 7 * CK * bn);
}

// The slab of one chunk: flat pixels [p0, p0 + slab_rows), channels
// [c0, c0 + CK) of x.  Rows off [0, M) are left unwritten (only off-board
// taps point there, and those read the zero row), and so are the channels
// past Cin (they feed only rows of the tile that are never stored).
template <int THREADS, int SIZE>
__device__ __forceinline__ void load_slab(const Params& p, float* dst, int c0, int p0) {
  constexpr int F = SIZE / 4, UPR = CK / F;  // floats per copy, copies per row
  const int kc = min(CK, p.Cin - c0);
  for (int u = threadIdx.x; u < p.slab_rows * UPR; u += THREADS) {
    const int r = u / UPR, ch = (u % UPR) * F, q = p0 + r;
    if (ch >= kc || q < 0 || q >= p.M) continue;
    hop::cp_async<SIZE>(hop::smem_u32(dst + r * CK + ch), p.x + (int64_t)q * p.Cin + c0 + ch,
                        SIZE);
  }
}

// The dY tile of one chunk: dY[m0 .. m0+P)[n0 .. n0+BN), row major, zero
// at pixels from m_end on (they meet the zero row of x, and 0 * garbage
// could be NaN); columns past Cout are left unwritten.
template <int BN, int THREADS, int SIZE>
__device__ __forceinline__ void load_dy(const Params& p, float* dst, int m0, int m_end, int n0) {
  constexpr int F = SIZE / 4, UPR = BN / F;
  for (int u = threadIdx.x; u < P * UPR; u += THREADS) {
    const int k = u / UPR, col = (u % UPR) * F, m = m0 + k, co = n0 + col;
    if (co >= p.Cout) continue;
    const bool on = m < m_end;
    hop::cp_async<SIZE>(hop::smem_u32(dst + k * BN + col),
                        on ? p.dy + (int64_t)m * p.Cout + co : p.dy, on ? SIZE : 0);
  }
}

template <int BN>
__global__ void __launch_bounds__(Cfg<BN>::THREADS, 1) hexconv_dw_f32_kernel(const Params p) {
  using C = Cfg<BN>;
  extern __shared__ __align__(16) float smem[];
  // Stage s at smem + s * stage: the slab (slab_rows rows of CK floats),
  // its zero row, the dY tile [P][BN], the tap table [P][TBL].
  const int stage = stage_floats(BN, p.slab_rows);
  const int zero = p.slab_rows * CK;  // the zero row's offset in a stage
  const int tid = threadIdx.x, g = tid / C::GROUP;
  const int ty = (tid % C::GROUP) / C::COLS, tx = tid % C::COLS;
  const int c0 = blockIdx.x * CK, n0 = blockIdx.y * BN;
  const int m_begin = blockIdx.z * p.slice, m_end = min(p.M, m_begin + p.slice);
  const int chunks = (m_end - m_begin + P - 1) / P;
  const int W = p.W;

  for (int u = tid; u < STAGES * CK; u += C::THREADS)
    smem[(u / CK) * stage + zero + u % CK] = 0.0f;
  // Global memory only once the kernel before this one on the stream is done.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  auto issue = [&](int c) {
    float* st = smem + (c % STAGES) * stage;
    const int m0 = m_begin + c * P;
    if (p.va == 16) load_slab<C::THREADS, 16>(p, st, c0, m0 - W - 1);
    else if (p.va == 8) load_slab<C::THREADS, 8>(p, st, c0, m0 - W - 1);
    else load_slab<C::THREADS, 4>(p, st, c0, m0 - W - 1);
    float* d = st + zero + CK;
    if (p.vd == 16) load_dy<BN, C::THREADS, 16>(p, d, m0, m_end, n0);
    else if (p.vd == 8) load_dy<BN, C::THREADS, 8>(p, d, m0, m_end, n0);
    else load_dy<BN, C::THREADS, 4>(p, d, m0, m_end, n0);
    // tbl[i * TBL + t]: the offset in the stage of the slab row that pixel
    // m0 + i's tap t reads, or of the zero row.
    int* tbl = reinterpret_cast<int*>(d + P * BN);
    for (int i = tid; i < P; i += C::THREADS) {
      const int m = m0 + i, w = m % W, h = (m / W) % p.H, odd = w & 1;
      int o[TBL];
#pragma unroll
      for (int t = 0; t < 7; ++t) {
        const int dr = kDr[odd][t], dc = kDc[odd][t], hh = h + dr, ww = w + dc;
        const bool on = m < m_end && hh >= 0 && hh < p.H && ww >= 0 && ww < W;
        o[t] = on ? (i + W + 1 + dr * W + dc) * CK : zero;
      }
      o[7] = zero;
      reinterpret_cast<int4*>(tbl + i * TBL)[0] = make_int4(o[0], o[1], o[2], o[3]);
      reinterpret_cast<int4*>(tbl + i * TBL)[1] = make_int4(o[4], o[5], o[6], o[7]);
    }
  };

  float acc[7][TR][TC];
#pragma unroll
  for (int t = 0; t < 7; ++t)
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[t][i][j] = 0.0f;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) issue(c);
    hop::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    hop::cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();  // everyone's have, and everyone is done with chunk c - 1
    if (c + STAGES - 1 < chunks) issue(c + STAGES - 1);  // into chunk c - 1's stage
    hop::cp_async_commit();
    // Group g takes the chunk's pixels g, g + KS, g + 2 KS, ...
    const float* sl = smem + (c % STAGES) * stage + ty * TR;
    const float* ds = smem + (c % STAGES) * stage + zero + CK + g * BN + tx * TC;
    const int* tbl = reinterpret_cast<const int*>(smem + (c % STAGES) * stage + zero + CK +
                                                  P * BN) + g * TBL;
#pragma unroll
    for (int k = 0; k < P / KS; ++k) {
      const int4 o0 = reinterpret_cast<const int4*>(tbl + k * KS * TBL)[0];
      const int4 o1 = reinterpret_cast<const int4*>(tbl + k * KS * TBL)[1];
      const int off[7] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z};
      const float4 d = *reinterpret_cast<const float4*>(ds + k * KS * BN);
      const float dv[TC] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int t = 0; t < 7; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(sl + off[t]);
        const float av[TR] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) acc[t][i][j] = fmaf(av[i], dv[j], acc[t][i][j]);
      }
    }
  }

  // Epilogue.  The groups' tiles [7][CK][BN] are added in group order in
  // shared memory into the block's tile (group g > 0 stores its tile, group
  // 0 adds them to its registers and stores the sum); then the cluster adds
  // its blocks' tiles in slice (rank) order, one share of the tile per
  // block, to dW or to the cluster's workspace partial.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the reduce kernel
  __syncthreads();  // the ring is no longer read
  float* tile = smem;
  auto at = [&](int group, int t, int i) {
    return reinterpret_cast<float4*>(tile + group * 4 * C::TILE4 + (t * CK + ty * TR + i) * BN +
                                     tx * TC);
  };
  if (g > 0) {
#pragma unroll
    for (int t = 0; t < 7; ++t)
#pragma unroll
      for (int i = 0; i < TR; ++i)
        *at(g, t, i) = make_float4(acc[t][i][0], acc[t][i][1], acc[t][i][2], acc[t][i][3]);
  }
  if (KS > 1) __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int t = 0; t < 7; ++t)
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float4 s = make_float4(acc[t][i][0], acc[t][i][1], acc[t][i][2], acc[t][i][3]);
#pragma unroll
        for (int k = 1; k < KS; ++k) {
          const float4 q = *at(k, t, i);
          s.x += q.x, s.y += q.y, s.z += q.z, s.w += q.w;
        }
        *at(0, t, i) = s;
      }
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = p.cluster;
  const int rank = csize > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  if (csize > 1) cluster.sync(); else __syncthreads();
  const float4* ranks[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    ranks[r] = reinterpret_cast<const float4*>(
        r < csize && csize > 1 ? cluster.map_shared_rank(tile, r) : tile);
  const int share = (C::TILE4 + csize - 1) / csize;
  const int v_end = min(C::TILE4, (rank + 1) * share);
  float* out = p.out;
  if (static_cast<int>(gridDim.z) > csize)
    out += (int64_t)(blockIdx.z / csize) * 7 * p.Cin * p.Cout;
  for (int v = rank * share + tid; v < v_end; v += C::THREADS) {
    const int row = v / (BN / 4), col = (v % (BN / 4)) * 4;
    const int t = row / CK, ci = c0 + row % CK, co = n0 + col;
    if (ci >= p.Cin || co >= p.Cout) continue;
    float4 s = ranks[0][v];
#pragma unroll
    for (int r = 1; r < MAX_CLUSTER; ++r) {
      if (r < csize) {
        const float4 q = ranks[r][v];
        s.x += q.x, s.y += q.y, s.z += q.z, s.w += q.w;
      }
    }
    float* dst = out + ((int64_t)t * p.Cin + ci) * p.Cout + co;
    if (p.vo && co + 3 < p.Cout) {
      *reinterpret_cast<float4*>(dst) = s;
    } else {
      const float sv[4] = {s.x, s.y, s.z, s.w};
      for (int j = 0; j < 4 && co + j < p.Cout; ++j) dst[j] = sv[j];
    }
  }
  if (csize > 1) cluster.sync();  // no block leaves while its tile is read
}

template <int BN>
cudaError_t configure() {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(hexconv_dw_f32_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  return cudaSuccess;
}

// Launch configuration: `slices` slices in clusters of `cluster` blocks,
// a programmatic dependent of the kernel before it on the stream (it may
// start early and waits for that kernel at griddepcontrol.wait).
template <int BN>
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  Launch(int cin, int cout, int slices, int cluster, int smem, cudaStream_t s) {
    cfg.gridDim = dim3((cin + CK - 1) / CK, (cout + BN - 1) / BN, slices);
    cfg.blockDim = dim3(Cfg<BN>::THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = cluster;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
  }
};

// The most clusters of `cluster` blocks that the card holds at once on
// boards W wide (a cluster's blocks share one GPC); 0 where it cannot say.
template <int BN>
int max_clusters(int W, int cluster) {
  const int smem = smem_bytes(BN, P + 2 * W + 2);
  if (smem > kMaxSmem || configure<BN>() != cudaSuccess) return 0;
  Launch<BN> l(CK, BN, cluster, cluster, smem, 0);
  l.cfg.numAttrs = 1;  // the clusters alone
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, hexconv_dw_f32_kernel<BN>, &l.cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

template <int BN>
int launch_bn(Params p, int slices, cudaStream_t s) {
  p.slab_rows = P + 2 * p.W + 2;
  const int smem = smem_bytes(BN, p.slab_rows);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = configure<BN>();
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((p.Cout + BN - 1) / BN > 65535 || slices > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  Launch<BN> l(p.Cin, p.Cout, slices, p.cluster, smem, s);
  return static_cast<int>(cudaLaunchKernelEx(&l.cfg, hexconv_dw_f32_kernel<BN>, p));
}

// BN: Cout over ceil(Cout / 64) balanced tiles, rounded up to 16, 32, 48
// or 64 (1 -> 16, 21 -> 32, 42 -> 48, 138 -> 3 x 48, 256 -> 4 x 64).
int tile_width(int cout) {
  const int tiles = (cout + 63) / 64, per = (cout + tiles - 1) / tiles;
  return per <= 16 ? 16 : per <= 32 ? 32 : per <= 48 ? 48 : 64;
}

int launch(const Params& p, int slices, cudaStream_t s) {
  switch (tile_width(p.Cout)) {
    case 16: return launch_bn<16>(p, slices, s);
    case 32: return launch_bn<32>(p, slices, s);
    case 48: return launch_bn<48>(p, slices, s);
    default: return launch_bn<64>(p, slices, s);
  }
}

// Blocks per cluster for `slices` slices: the largest count up to
// MAX_CLUSTER that divides them (hexconv_kernel.py:dw_cluster says the same).
int cluster_size(int slices) {
  for (int c = MAX_CLUSTER; c > 1; --c)
    if (slices % c == 0) return c;
  return 1;
}

}  // namespace f32
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
//     and leaving the copies out 7.5 us (diagnostic builds without them,
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
  // As a programmatic dependent (f32): read only once the main kernel is
  // done, and let the next kernel launch, which waits for this one in turn.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < slices; ++z) s += part[(int64_t)z * n + i];
    narrow(dw, i, s);
  }
}

}  // namespace

// The pixel step of both kernels' slices.
constexpr int SLICE_STEP = 16;
static_assert(f32::P % SLICE_STEP == 0 && hop::P % SLICE_STEP == 0, "whole chunks or k16 steps");

// Plain C interface (loaded with ctypes).  dtype: 0 = f32, 1 = bf16.
// x: [B, H, W, Cin], dy: [B, H, W, Cout] in the given dtype; dw: [7, Cin,
// Cout] in the given dtype; all contiguous.  `slices` slices of `slice`
// pixels (a multiple of 16) must cover the B*H*W pixels, none empty.
// part: an f32 workspace of hexconv_dw_partials(slices, dtype) * 7*Cin *
// Cout values.  Launches on `stream`
// and returns the cudaError_t of the launches (0 = success); no
// synchronize.  Both kernels refuse boards wider than hexconv_dw_max_width.
extern "C" int hexconv_dw(const void* x, const void* dy, float* part, void* dw, int B, int H,
                          int W, int Cin, int Cout, int dtype, int slices, int slice,
                          void* stream) {
  const int M = B * H * W;
  if (M == 0 || Cin == 0 || Cout == 0) return 0;
  if (slices < 1 || slice < SLICE_STEP || slice % SLICE_STEP != 0 ||
      (int64_t)slices * slice < M || (int64_t)(slices - 1) * slice >= M)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int64_t n = (int64_t)7 * Cin * Cout;
  const int reduce_blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  if (dtype == 0) {
    f32::Params p;
    p.x = static_cast<const float*>(x), p.dy = static_cast<const float*>(dy);
    p.M = M, p.H = H, p.W = W, p.Cin = Cin, p.Cout = Cout;
    p.slice = slice;
    p.cluster = f32::cluster_size(slices);
    const int partials = slices / p.cluster;
    p.out = partials == 1 ? static_cast<float*>(dw) : part;
    p.va = copy_width_f32(x, Cin);
    p.vd = copy_width_f32(dy, Cout);
    p.vo = Cout % 4 == 0 && aligned(p.out, 16);
    const int err = f32::launch(p, slices, s);
    if (err != 0) return err;
    if (partials > 1) {
      // A programmatic dependent of the main kernel: its launch overlaps
      // the main kernel's epilogue.
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(reduce_blocks);
      cfg.blockDim = dim3(256);
      cfg.stream = s;
      cudaLaunchAttribute pdl;
      pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
      pdl.val.programmaticStreamSerializationAllowed = 1;
      cfg.attrs = &pdl;
      cfg.numAttrs = 1;
      const cudaError_t e =
          cudaLaunchKernelEx(&cfg, hexconv_dw_reduce_kernel<float>, static_cast<const float*>(part),
                             static_cast<float*>(dw), n, partials);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
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

// The workspace partials of `slices` slices: one per cluster of the f32
// kernel (none where one cluster covers them: it writes dW itself), one
// per slice for bf16.
extern "C" int hexconv_dw_partials(int slices, int dtype) {
  if (dtype != 0) return slices;
  const int c = f32::cluster_size(slices);
  return slices == c ? 0 : slices / c;
}

// The blocks of one pixel slice of the dW kernel of `dtype`: the grid plan
// (nuzero_tpu_torch/ops/cuda/hexconv_kernel.py) sizes the slices by it.
// A block takes CK input channels (f32: 64 / KS; bf16: 64) and one BN tile
// of Cout.
extern "C" int hexconv_dw_blocks_per_slice(int Cin, int Cout, int dtype) {
  const int ck = dtype == 0 ? f32::CK : hop::CK;
  const int bn = dtype == 0 ? f32::tile_width(Cout) : hop::tile_width(Cout);
  return ((Cin + ck - 1) / ck) * ((Cout + bn - 1) / bn);
}

// The most clusters of `cluster` blocks (1 to 8) of the f32 dW kernel that
// the card holds at once at `Cout` on boards W wide: the grid plan keeps the
// slices' clusters in one wave.  0 where it cannot say; -1 for bf16, whose
// blocks take a whole SM each.
extern "C" int hexconv_dw_max_clusters(int Cout, int W, int cluster, int dtype) {
  if (dtype != 0) return -1;
  if (cluster < 1 || cluster > f32::MAX_CLUSTER) return 0;
  switch (f32::tile_width(Cout)) {
    case 16: return f32::max_clusters<16>(W, cluster);
    case 32: return f32::max_clusters<32>(W, cluster);
    case 48: return f32::max_clusters<48>(W, cluster);
    default: return f32::max_clusters<64>(W, cluster);
  }
}

// The widest board (W) the dW kernel of `dtype` takes at `Cout`: its
// STAGES slabs of P + 2W + 2 rows must fit its shared memory beside the
// dY tiles and tap tables.
extern "C" int hexconv_dw_max_width(int Cout, int dtype) {
  if (dtype == 0) {
    const int bn = f32::tile_width(Cout);
    int w = 0;
    while (f32::smem_bytes(bn, f32::P + 2 * (w + 1) + 2) <= kMaxSmem) ++w;
    return w;
  }
  const int rows = (kMaxSmem - hop::smem_bytes(hop::tile_width(Cout), 0)) /
                   (hop::STAGES * hop::ROW_BYTES);
  return (rows - hop::P - 2) / 2;  // slab rows P + 2W + 2 <= rows
}
