// The PUCT descent of a batch of search trees in one kernel: each game's walk
// from its root to the node where its simulation stops.
//
// Source note.  No TPU kernel stands behind this one: the JAX search's descent
// (nuzero_tpu/search/mcts.py:144) is a plain lax.while_loop over depth, every
// game of the batch stepping in lockstep under vmap.  The port's plain version
// is the eager body nuzero_tpu_torch/search/mcts.py:_descend_plain, one depth
// step of ~55-60 small [B, A] kernels (gathers, where, log, sqrt, div, argmax)
// and its later steps under graphs.run_while, a while-node under capture: ~195-
// 230 kernels a descent.  This kernel returns the same five outputs bit for
// bit, and is what mcts._descend launches for a tree on the card.  It reads
// the tree and writes nothing to it; its outputs are the wrapper's fresh
// tensors, so it is safe under capture.
//
// Bound.  A descent reads, per game, the visit and value-sum rows (N x 8 bytes:
// 4.8 KB at N = 604, 1.6 KB at N = 204) and, at each depth of its walk, the
// node's prior, legal and child rows (A x 9 bytes) and a few flags; it writes
// depth_cap + 3 words.  At the benchmark's shapes that is well under 2 MB a
// descent, under a microsecond at the card's memory rate.  What bounds it is
// latency: the walk is a chain of dependent reads (a node's row, then the
// child it picks, then that child's row), a few trips deep, so the kernel
// takes about as long as its deepest game, a few microseconds.
//
// Design.  One warp per game, its visit and value-sum rows copied once into
// the warp's shared memory, so that each depth's gathers of the children's
// statistics hit shared memory and the only global reads a depth are the
// node's coalesced prior, legal and child rows.  The games a block are sized
// by N so that they fit the block's default 48 KB of shared memory (eight up
// to N = 768, one from N = 3,073 on, past 48 KB up to the card's 227 KB at
// N = 29,056); A, N and depth_cap are run-time arguments, so one build serves
// every game and tree size.  The lanes
// stride over the A actions (sixteen loads in flight a lane), each keeping its
// best (score, action); a shuffle reduction then picks the greater score, NaN
// the greatest, and on equal scores the lower action, as torch.argmax does.
// Every lane ends with the same choice, so the walk is uniform across the warp.
// The score follows the eager body's operations in its order with explicit
// round-to-nearest intrinsics (no contraction into FMAs) and the math
// library's logf, which PyTorch's CUDA log calls; the constants come from the
// host as f32.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kMaxWarps = 8;        // games a block, at most
constexpr int kUnroll = 16;         // actions a lane loads at once
constexpr int kSmemDefault = 48 * 1024;
constexpr float kNegInf = -1e9f;    // mcts.NEG_INF, the score of an illegal action
constexpr unsigned kAll = 0xffffffffu;

struct Params {
  const int* root;                   // [B]
  const int* visit;                  // [B, N]
  const float* value_sum;            // [B, N]
  const int* to_play;                // [B, N]
  const unsigned char* expanded;     // [B, N]
  const unsigned char* is_terminal;  // [B, N]
  const float* prior;                // [B, N, A]
  const unsigned char* legal;        // [B, N, A]
  const int* child;                  // [B, N, A]
  int* stop_node;                    // [B]
  int* sel_action;                   // [B]
  unsigned char* needs_alloc;        // [B]
  int* path;                         // [B, depth_cap]
  unsigned char* capped;             // [B]
  int B, N, A, depth_cap, warps;
  float pb_c_base, recip_base, pb_c_init, value_factor;
};

// Whether score s at action i goes before score t at action j in
// torch.argmax's order: NaN first, then the greater score, ties to the lower
// action.  An action of A or more is a lane's empty slot and goes last.
__device__ __forceinline__ bool before(float s, int i, float t, int j, int A) {
  if (j >= A) return i < A;
  if (i >= A) return false;
  const bool s_nan = s != s, t_nan = t != t;
  if (s_nan || t_nan) return s_nan && (!t_nan || i < j);
  return s > t || (s == t && i < j);
}

__global__ void __launch_bounds__(kMaxWarps * 32) search_descend_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * p.warps + warp;
  if (b >= p.B) return;
  const int N = p.N, A = p.A;
  int* visit = reinterpret_cast<int*>(smem) + static_cast<size_t>(warp) * 2 * N;
  float* vsum = reinterpret_cast<float*>(visit + N);
  const size_t row0 = static_cast<size_t>(b) * N;
#pragma unroll 8
  for (int i = lane; i < N; i += 32) {
    visit[i] = p.visit[row0 + i];
    vsum[i] = p.value_sum[row0 + i];
  }
  int* path = p.path + static_cast<size_t>(b) * p.depth_cap;
  int node = p.root[b];
  __syncwarp();

  int action = 0, trips = 0;
  bool stopped = false, needs_alloc = false;
  for (; trips < p.depth_cap; ++trips) {
    if ((trips & 31) == lane) path[trips] = node;
    const size_t nb = row0 + node;
    // The node's flags and its rows are read together, whether or not the
    // walk goes on from it: one round of reads a depth where A <= 32 kUnroll.
    const bool go_on = p.expanded[nb] != 0 && p.is_terminal[nb] == 0;
    const int to_play = p.to_play[nb];
    int next = -1;
    action = 0;
    {
      // c = log(((pv + base) + 1) * (1 / base)) + init, as _exploration_bias.
      const float pv = static_cast<float>(visit[node]);
      const float c = __fadd_rn(
          logf(__fmul_rn(__fadd_rn(__fadd_rn(pv, p.pb_c_base), 1.0f), p.recip_base)),
          p.pb_c_init);
      const float root_pv = __fsqrt_rn(pv);
      const float vf = to_play == 1 ? -p.value_factor : p.value_factor;
      const float* prior = p.prior + nb * A;
      const unsigned char* legal = p.legal + nb * A;
      const int* child = p.child + nb * A;
      float best = 0.0f;
      int best_a = A, best_child = -1;
      for (int base = lane; base < A; base += 32 * kUnroll) {
        float pr[kUnroll];
        int ch[kUnroll];
        unsigned char lg[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int a = base + 32 * k;
          if (a < A) pr[k] = prior[a], lg[k] = legal[a], ch[k] = child[a];
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int a = base + 32 * k;
          if (a >= A) break;
          float cv = 0.0f, cvsum = 0.0f;
          if (ch[k] >= 0) cv = static_cast<float>(visit[ch[k]]), cvsum = vsum[ch[k]];
          // _puct_scores: q, then u = ((prior * sqrt(pv)) / (1 + cv)) * c.
          const float q = cv > 0.0f ? __fdiv_rn(cvsum, fmaxf(cv, 1.0f)) : 0.0f;
          const float u = __fmul_rn(__fdiv_rn(__fmul_rn(pr[k], root_pv), __fadd_rn(cv, 1.0f)), c);
          const float score = lg[k] ? __fadd_rn(u, __fmul_rn(vf, q)) : kNegInf;
          if (before(score, a, best, best_a, A)) best = score, best_a = a, best_child = ch[k];
        }
      }
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
        const float s = __shfl_xor_sync(kAll, best, offset);
        const int a = __shfl_xor_sync(kAll, best_a, offset);
        const int c_ = __shfl_xor_sync(kAll, best_child, offset);
        if (before(s, a, best, best_a, A)) best = s, best_a = a, best_child = c_;
      }
      if (go_on) action = best_a, next = best_child;
    }
    if (!go_on || next == -1) {
      // A node that cannot go on stops with action 0; a missing child is
      // the leaf to allocate.
      stopped = true;
      needs_alloc = go_on;
      ++trips;
      break;
    }
    node = next;
  }
  // Slots past the walk hold N; a walk still going after depth_cap trips is
  // capped and allocates nothing.
  for (int d = trips + ((lane - trips) & 31); d < p.depth_cap; d += 32) path[d] = N;
  if (lane == 0) {
    p.stop_node[b] = node;
    p.sel_action[b] = action;
    p.needs_alloc[b] = needs_alloc;
    p.capped[b] = !stopped;
  }
}

// The games a block, given N: as many as their visit and value-sum rows (8
// bytes a node) fit the default 48 KB, at most kMaxWarps, at least one (which
// may need up to the card's opt-in maximum).
int games_per_block(int N) {
  const int fit = kSmemDefault / (8 * N);
  return fit < 1 ? 1 : (fit > kMaxWarps ? kMaxWarps : fit);
}

}  // namespace

extern "C" {

// The launch fails (an error code) where one game's rows pass the card's
// shared memory a block.
int search_descend(const int* root, const int* visit, const float* value_sum,
                   const int* to_play, const unsigned char* expanded,
                   const unsigned char* is_terminal, const float* prior,
                   const unsigned char* legal, const int* child, int* stop_node,
                   int* sel_action, unsigned char* needs_alloc, int* path,
                   unsigned char* capped, int B, int N, int A, int depth_cap, float pb_c_base,
                   float recip_base, float pb_c_init, float value_factor, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  Params p;
  p.root = root, p.visit = visit, p.value_sum = value_sum, p.to_play = to_play;
  p.expanded = expanded, p.is_terminal = is_terminal;
  p.prior = prior, p.legal = legal, p.child = child;
  p.stop_node = stop_node, p.sel_action = sel_action, p.needs_alloc = needs_alloc;
  p.path = path, p.capped = capped;
  p.B = B, p.N = N, p.A = A, p.depth_cap = depth_cap;
  p.warps = games_per_block(N);
  p.pb_c_base = pb_c_base, p.recip_base = recip_base;
  p.pb_c_init = pb_c_init, p.value_factor = value_factor;
  const size_t smem = static_cast<size_t>(p.warps) * 8 * N;
  if (smem > kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(search_descend_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  search_descend_kernel<<<(B + p.warps - 1) / p.warps, p.warps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
