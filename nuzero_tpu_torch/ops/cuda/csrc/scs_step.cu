// The SCS env's whole transition in one kernel: decode, the applier of each
// game's own action, then the stage machine run to rest.
//
// Source note.  No TPU kernel stands behind this one: the JAX engine's step
// (nuzero_tpu/envs/scs/game.py, SCSGame.step and _update_env) is plain JAX,
// one game under vmap, its appliers under lax.switch and the stage machine a
// lax.while_loop.  The port's plain version is the eager body
// nuzero_tpu_torch/envs/scs/game.py:SCSGame._step, which evaluates all seven
// appliers on the whole batch and selects, then runs the stage machine as
// batched passes; on the card that is ~850-1,400 small kernels a step and a
// while-node under capture.  This kernel computes the same fields bit for
// bit, and is what SCSGame.step launches for a state on the card.
//
// Bound.  A game's state is a few hundred bytes at 5x5 (about 2 KB at 15x15
// with stacking 2): the step reads and writes that once, so bandwidth is no
// limit (B = 1,024 moves under 2 MB).  What bounds it is latency: a chain of
// dependent reads per game (decode, one applier, then up to 1 + stage_passes
// passes of the stage machine, each a scan over the game's units), so the
// kernel's time is that of its longest game, a few microseconds.
//
// Design.  One warp per game, four games a block, so B <= 1,024 is one wave
// on the card's 132 SMs.  The warp copies its game's board and unit tables
// into shared memory; the scalars live in registers, the same in every lane.
// Only the game's own applier runs (a switch on the decoded kind).  Work over
// the board's tiles (re-compacting the stacks, the end-of-game count) and
// over the units (the stage machine's "no unit with status s" tests, the
// turn's reset) is spread over the lanes; the rest runs in every lane alike.
// The stage machine loops per game, at most 1 + stage_passes passes, as the
// JAX engine's while_loop does; a game still advancing after them sets the
// overflow flag (never a truncation); the kernel only ever sets the flag, so
// it may be a capture's own.  Float arithmetic uses explicit round-to-nearest
// intrinsics and the host's f32 constants.  Movement points (allowance minus
// costs) and the end-of-game shares (times the f32 reciprocal of the victory
// point counts) follow the eager body's order exactly.  The combat sums of
// confirm do not: the kernel adds the U unit values one after another, in
// unit order, while the eager body's torch.where(...).sum(-1) adds them in
// the order of PyTorch's reduction, which is not sequential once U is 5 or
// more, and differs between the CPU and CUDA.  So the two are equal bit for
// bit where every partial sum is exact in f32, as it is for the scenarios'
// tables: every unit and terrain value in configs/scenarios is 0.5, 1, 2 or
// 3, a randomized map draws each tile from its scenario's own terrain types,
// and sums of a few such values are exact.  For other tables each sum may differ from the
// eager body's by a few units in the last place (about U ulp of the largest
// partial sum), which can turn a combat tied within that margin the other
// way; the eager body itself gives such a tie differently on the two devices.
// Tables (terrain, units, neighbours, schedule) come from the env at run
// time, so one build serves every scenario.

#include <cuda_runtime.h>

namespace {

constexpr int kFields = 20;  // SCSState's fields, in declaration order
enum Field {
  BOARD, ALIVE, PLACED, ROW, COL, MOV, STATUS, REINF_NEXT, TURN, STAGE, LENGTH,
  TERMINAL, TERMINAL_VALUE, HAS_TARGET, TARGET_ROW, TARGET_COL, IS_ATTACKER,
  ATTACKER_SEQ, N_ATTACKERS, VP
};
constexpr int kWarps = 4;             // games a block
constexpr int kUnset = 1000000;       // attacker_seq and stack order when unset
constexpr int kNoPick = 100000000;    // argmin's filler in the strongest-unit pick
constexpr float kNeg = -1e9f;         // amax's filler in the strongest-unit pick
constexpr unsigned kAll = 0xffffffffu;

struct Params {
  const void* in[kFields];
  long long in_stride[kFields];  // elements from one game to the next
  void* out[kFields];            // contiguous
  const int* action;
  long long action_stride;
  // t_attack, t_defense, t_cost, min_nbr_cost [RC]; u_attack, u_defense, u_allowance [U]
  const float* ftab;
  const int* itab;    // nbr_flat, nbr_ok [6, RC]; reinf_turn [2, S]; reinf_count [2]
  unsigned char* overflow;
  int B, R, C, K, S, turns, stage_passes;
  float recip_vp0, recip_vp1;  // f32 1 / max(n_vp[p], 1)
};

__host__ __device__ inline size_t game_bytes(int rc, int k, int u) {
  size_t words = static_cast<size_t>(rc) * k + 5 * u;  // board, row, col, status, attacker_seq, mov
  size_t bytes = 4 * words + 3 * u;                     // + alive, placed, is_attacker
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// One game: its tables in the warp's shared memory, its scalars in registers.
struct Game {
  int lane, R, C, K, S, U, RC;
  const float *t_att, *t_def, *t_cost, *min_cost, *u_att, *u_def, *u_allow;
  const int *nbr, *nbr_ok, *r_turn, *r_count;
  int *board, *row, *col, *status, *aseq;
  float* mov;
  unsigned char *alive, *placed, *isatt;
  int rn0, rn1, turn, stage, length, tr, tc, natt;
  bool terminal, ht;
  float tv;
};

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int owner(const Game& g, int t) {
  int b = g.board[t * g.K];
  return b >= 0 ? b / g.S : -1;
}

// The tile (r, c), or -1 off the board.
__device__ __forceinline__ int tile(const Game& g, int r, int c) {
  return (r >= 0 && r < g.R && c >= 0 && c < g.C) ? r * g.C + c : -1;
}

// Put uid on top of tile t's stack (no-op when full): _board_push.
__device__ void push_unit(Game& g, int t, int uid) {
  if (g.lane == 0) {
    int* st = g.board + t * g.K;
    int n = 0;
    for (int k = 0; k < g.K; ++k) n += st[k] >= 0;
    if (n < g.K) st[n] = uid;
  }
  __syncwarp();
}

// Drop uid from tile `here`'s stack and re-compact every stack: _board_remove.
__device__ void drop_unit(Game& g, int here, int uid) {
  for (int t = g.lane; t < g.RC; t += 32) {
    int* st = g.board + t * g.K;
    int n = 0;
    for (int j = 0; j < g.K; ++j) {
      int v = st[j];
      if (v >= 0 && (v != uid || t != here)) st[n++] = v;
    }
    for (; n < g.K; ++n) st[n] = -1;
  }
  __syncwarp();
}

// Status moved, or attacked where no enemy stands next to the unit: _end_movement.
__device__ void end_movement(Game& g, int uid) {
  int opp = 1 - uid / g.S;
  int t = g.row[uid] * g.C + g.col[uid];
  bool adj = false;
  for (int d = 0; d < 6; ++d)
    adj |= g.nbr_ok[d * g.RC + t] != 0 && owner(g, g.nbr[d * g.RC + t]) == opp;
  __syncwarp();
  if (g.lane == 0) g.status[uid] = adj ? 1 : 2;
  __syncwarp();
}

// The strongest candidate: max k1, then k2, then k3, then least order
// (first unit on ties): _lexi_pick, each mask recomputed on the fly.
template <class Cand, class Order>
__device__ int lexi_pick(const Game& g, Cand cand, const float* k1, const float* k2,
                         const float* k3, Order order) {
  auto top = [&](auto mask, const float* k) {
    float m = mask(0) ? k[0] : kNeg;
    for (int u = 1; u < g.U; ++u) {
      float v = mask(u) ? k[u] : kNeg;
      m = v > m ? v : m;
    }
    return m;
  };
  float a = top(cand, k1);
  auto m1 = [&](int u) { return cand(u) && k1[u] == a; };
  float b = top(m1, k2);
  auto m2 = [&](int u) { return m1(u) && k2[u] == b; };
  float c = top(m2, k3);
  int best = 0, least = m2(0) && k3[0] == c ? order(0) : kNoPick;
  for (int u = 1; u < g.U; ++u) {
    int o = m2(u) && k3[u] == c ? order(u) : kNoPick;
    if (o < least) least = o, best = u;
  }
  return best;
}

// _destroy: off its tile where `kill`, and dead.
__device__ void destroy(Game& g, int uid, bool kill) {
  if (kill) drop_unit(g, tile(g, g.row[uid], g.col[uid]), uid);
  __syncwarp();
  if (g.lane == 0) g.alive[uid] = !kill && g.alive[uid];
  __syncwarp();
}

// _act_confirm: resolve the combat at the target.
__device__ void confirm(Game& g) {
  const int tr = g.tr, tc = g.tc, trc = tr * g.C + tc;
  auto on_target = [&](int u) {
    return g.row[u] == tr && g.col[u] == tc && g.placed[u] && g.alive[u];
  };
  float sdef = 0.0f, total_att = 0.0f;
  for (int u = 0; u < g.U; ++u) sdef = __fadd_rn(sdef, on_target(u) ? g.u_def[u] : 0.0f);
  float total_def = __fmul_rn(sdef, g.t_def[trc]);
  auto att = [&](int u) { return g.isatt[u] && g.alive[u]; };
  for (int u = 0; u < g.U; ++u) {
    float mod = g.t_att[g.row[u] * g.C + g.col[u]];
    total_att = __fadd_rn(total_att, att(u) ? __fmul_rn(g.u_att[u], mod) : 0.0f);
  }
  int a_uid = lexi_pick(g, att, g.u_att, g.u_def, g.u_allow, [&](int u) { return g.aseq[u]; });
  __syncwarp();
  // All attackers end fighting before the losses.
  for (int u = g.lane; u < g.U; u += 32)
    if (g.isatt[u] && g.alive[u]) g.status[u] = 2;
  __syncwarp();
  destroy(g, a_uid, total_att <= total_def);
  const int* stack = g.board + trc * g.K;
  auto stack_order = [&](int u) {
    for (int k = 0; k < g.K; ++k)
      if (stack[k] == u) return k;
    return kUnset;
  };
  int d_uid = lexi_pick(g, on_target, g.u_def, g.u_att, g.u_allow, stack_order);
  __syncwarp();
  destroy(g, d_uid, total_att >= total_def);
  for (int u = g.lane; u < g.U; u += 32) g.isatt[u] = 0, g.aseq[u] = kUnset;
  __syncwarp();
  g.ht = false;
  g.natt = 0;
}

// The game's own applier (ref play_action) and the length.
__device__ void apply(Game& g, int action) {
  const int K = g.K;
  const int plane = floordiv(action, g.RC);
  const int rc = action - plane * g.RC;
  const int r = rc / g.C, c = rc % g.C;
  const int movement_limit = 1 + 6 * K, target_limit = movement_limit + 1;
  const int attackers_limit = target_limit + K, confirm_limit = attackers_limit + 1;
  const int no_move_limit = confirm_limit + K;
  const bool in_move = plane >= 1 && plane < movement_limit;
  const int mv_index = min(max(plane - 1, 0), 6 * K - 1);
  int kind = 6;
  if (plane < 1) kind = 0;
  else if (in_move) kind = 1;
  else if (plane < target_limit) kind = 2;
  else if (plane < attackers_limit) kind = 3;
  else if (plane < confirm_limit) kind = 4;
  else if (plane < no_move_limit) kind = 5;
  int s_lvl;
  if (in_move) s_lvl = mv_index % K;
  else if (plane < confirm_limit) s_lvl = min(max(plane - target_limit, 0), K - 1);
  else if (plane < no_move_limit) s_lvl = min(max(plane - confirm_limit, 0), K - 1);
  else s_lvl = min(max(plane - no_move_limit, 0), K - 1);
  const int t = r * g.C + c;
  const int at = max(g.board[t * K + s_lvl], 0);  // the unit at (r, c, s_lvl)
  const float mov_at = g.mov[at];
  __syncwarp();  // every lane has read before any lane writes

  switch (kind) {
    case 0: {  // place the player's next reinforcement
      const int p = (g.stage == -1 || g.stage >= 4) ? 1 : 0;
      const int slot = p ? g.rn1 : g.rn0;
      const int uid = p * g.S + min(slot, g.S - 1);
      push_unit(g, t, uid);
      if (g.lane == 0 && uid >= 0 && uid < g.U) {
        g.alive[uid] = 1;
        g.placed[uid] = 1;
        g.row[uid] = r;
        g.col[uid] = c;
        g.mov[uid] = g.u_allow[uid];
        g.status[uid] = 0;
      }
      __syncwarp();
      if (p) ++g.rn1; else ++g.rn0;
      break;
    }
    case 1: {  // move one tile
      const int dst = g.nbr[(mv_index / K) * g.RC + t];
      const float new_mov = __fsub_rn(mov_at, g.t_cost[dst]);
      drop_unit(g, t, at);
      push_unit(g, dst, at);
      if (g.lane == 0) {
        g.row[at] = dst / g.C;
        g.col[at] = dst % g.C;
        g.mov[at] = new_mov;
      }
      __syncwarp();
      if (!(__fsub_rn(new_mov, g.min_cost[dst]) >= 0.0f)) end_movement(g, at);
      break;
    }
    case 2:  // choose the target
      g.ht = true;
      g.tr = r;
      g.tc = c;
      break;
    case 3:  // choose an attacker
      if (g.lane == 0) {
        g.isatt[at] = 1;
        g.aseq[at] = g.natt;
      }
      __syncwarp();
      ++g.natt;
      break;
    case 4:
      confirm(g);
      break;
    case 5:  // no move: moved, then as at a move's end
      end_movement(g, at);
      break;
    default:  // no fight
      if (g.lane == 0) g.status[at] = 2;
      __syncwarp();
  }
  ++g.length;
}

// (ref player_ended_reinforcements)
__device__ __forceinline__ bool ended_reinforcements(const Game& g, int p, int nxt) {
  return nxt >= g.r_count[p] || g.r_turn[p * g.S + min(nxt, g.S - 1)] != g.turn;
}

// (ref check_termination): +1, -1 or 0 by the shares of victory points held.
__device__ float termination_value(const Game& g, const unsigned char* vp, float recip0,
                                   float recip1) {
  int held_by_p2 = 0, held_by_p1 = 0;  // p1's points that p2 holds, and the converse
  for (int t = g.lane; t < g.RC; t += 32) {
    int o = owner(g, t);
    held_by_p2 += vp[t] != 0 && o == 1;
    held_by_p1 += vp[g.RC + t] != 0 && o == 0;
  }
  held_by_p2 = __reduce_add_sync(kAll, held_by_p2);
  held_by_p1 = __reduce_add_sync(kAll, held_by_p1);
  float p1 = __fmul_rn(static_cast<float>(held_by_p1), recip1);
  float p2 = __fmul_rn(static_cast<float>(held_by_p2), recip0);
  return p1 > p2 ? 1.0f : (p1 < p2 ? -1.0f : 0.0f);
}

// One pass of the stage machine: _advance.  Returns whether the game advanced.
__device__ bool stage_pass(Game& g, int turns, const unsigned char* vp, float recip0,
                           float recip1) {
  const bool er0 = ended_reinforcements(g, 0, g.rn0);
  const bool er1 = ended_reinforcements(g, 1, g.rn1);
  unsigned bits = 0;  // 1: p0 available, 2: p1 available, 4: p0 moved, 8: p1 moved
  for (int u = g.lane; u < g.U; u += 32) {
    if (g.placed[u] && g.alive[u]) {
      int s = g.status[u], p = u >= g.S;
      if (s == 0) bits |= 1u << p;
      if (s == 1) bits |= 4u << p;
    }
  }
  bits = __reduce_or_sync(kAll, bits);
  const bool nm0 = !(bits & 1), nm1 = !(bits & 2), na0 = !(bits & 4), na1 = !(bits & 8);
  const int st = g.stage;
  const bool ht = g.ht;
  const bool game_over = st == 6 && na1 && g.turn + 1 > turns;
  const bool next_turn = st == 6 && na1 && !game_over;
  int ns = st;
  if (st == -2 && er0) ns = -1;
  if (st == -1 && er1) ns = 0;
  if (st == 0 && er0) ns = 1;
  if (st == 1 && nm0) ns = 2;
  if (st == 2 && na0) ns = 4;
  if (st == 2 && !na0 && ht) ns = 3;
  if (st == 3 && !ht) ns = 2;
  if (st == 4 && er1) ns = 5;
  if (st == 5 && nm1) ns = 6;
  if (next_turn) ns = 0;
  if (st == 6 && !na1 && ht) ns = 7;
  if (st == 7 && !ht) ns = 6;
  const bool inc_turn = (st == -1 && er1) || next_turn;
  const bool advanced = (ns != st || inc_turn) && !g.terminal && !game_over;
  g.stage = ns;
  g.turn += inc_turn;
  if (next_turn) {  // new_turn: every standing unit available, at full allowance
    for (int u = g.lane; u < g.U; u += 32) {
      if (g.placed[u] && g.alive[u]) {
        g.status[u] = 0;
        g.mov[u] = g.u_allow[u];
      }
    }
    __syncwarp();
  }
  if (game_over && !g.terminal) g.tv = termination_value(g, vp, recip0, recip1);
  g.terminal = g.terminal || game_over;
  return advanced;
}

template <class T>
__device__ __forceinline__ const T* field(const Params& p, int f, int b) {
  return static_cast<const T*>(p.in[f]) + b * p.in_stride[f];
}

template <class T>
__device__ __forceinline__ T* result(const Params& p, int f, int b, int n) {
  return static_cast<T*>(p.out[f]) + static_cast<long long>(b) * n;
}

template <class T>
__device__ __forceinline__ void copy(T* dst, const T* src, int n, int lane) {
  for (int i = lane; i < n; i += 32) dst[i] = src[i];
}

__device__ __forceinline__ void copy_bool(unsigned char* dst, const unsigned char* src, int n,
                                          int lane) {
  for (int i = lane; i < n; i += 32) dst[i] = src[i] != 0;
}

__global__ void __launch_bounds__(kWarps * 32) scs_step_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= p.B) return;
  Game g;
  g.lane = lane;
  g.R = p.R, g.C = p.C, g.K = p.K, g.S = p.S, g.U = 2 * p.S, g.RC = p.R * p.C;
  const int RC = g.RC, U = g.U, RCK = RC * p.K;
  g.t_att = p.ftab, g.t_def = p.ftab + RC, g.t_cost = p.ftab + 2 * RC;
  g.min_cost = p.ftab + 3 * RC, g.u_att = p.ftab + 4 * RC;
  g.u_def = g.u_att + U, g.u_allow = g.u_att + 2 * U;
  g.nbr = p.itab, g.nbr_ok = p.itab + 6 * RC, g.r_turn = p.itab + 12 * RC;
  g.r_count = g.r_turn + U;

  unsigned char* mine = smem + (threadIdx.x >> 5) * game_bytes(RC, p.K, U);
  g.board = reinterpret_cast<int*>(mine);
  g.row = g.board + RCK, g.col = g.row + U, g.status = g.col + U, g.aseq = g.status + U;
  g.mov = reinterpret_cast<float*>(g.aseq + U);
  g.alive = reinterpret_cast<unsigned char*>(g.mov + U);
  g.placed = g.alive + U, g.isatt = g.placed + U;

  copy(g.board, field<int>(p, BOARD, b), RCK, lane);
  copy_bool(g.alive, field<unsigned char>(p, ALIVE, b), U, lane);
  copy_bool(g.placed, field<unsigned char>(p, PLACED, b), U, lane);
  copy(g.row, field<int>(p, ROW, b), U, lane);
  copy(g.col, field<int>(p, COL, b), U, lane);
  copy(g.mov, field<float>(p, MOV, b), U, lane);
  copy(g.status, field<int>(p, STATUS, b), U, lane);
  copy_bool(g.isatt, field<unsigned char>(p, IS_ATTACKER, b), U, lane);
  copy(g.aseq, field<int>(p, ATTACKER_SEQ, b), U, lane);
  const int* rn = field<int>(p, REINF_NEXT, b);
  g.rn0 = rn[0], g.rn1 = rn[1];
  g.turn = *field<int>(p, TURN, b);
  g.stage = *field<int>(p, STAGE, b);
  g.length = *field<int>(p, LENGTH, b);
  g.terminal = *field<unsigned char>(p, TERMINAL, b) != 0;
  g.tv = *field<float>(p, TERMINAL_VALUE, b);
  g.ht = *field<unsigned char>(p, HAS_TARGET, b) != 0;
  g.tr = *field<int>(p, TARGET_ROW, b);
  g.tc = *field<int>(p, TARGET_COL, b);
  g.natt = *field<int>(p, N_ATTACKERS, b);
  const unsigned char* vp = field<unsigned char>(p, VP, b);
  const int action = p.action[b * p.action_stride];
  __syncwarp();

  apply(g, action);
  // _update_env: one pass, then more while the game advanced, at most stage_passes.
  bool more = stage_pass(g, p.turns, vp, p.recip_vp0, p.recip_vp1);
  for (int trip = 0; trip < p.stage_passes && more; ++trip)
    more = stage_pass(g, p.turns, vp, p.recip_vp0, p.recip_vp1);
  if (more && lane == 0) *p.overflow = 1;
  __syncwarp();

  copy(result<int>(p, BOARD, b, RCK), g.board, RCK, lane);
  copy(result<unsigned char>(p, ALIVE, b, U), g.alive, U, lane);
  copy(result<unsigned char>(p, PLACED, b, U), g.placed, U, lane);
  copy(result<int>(p, ROW, b, U), g.row, U, lane);
  copy(result<int>(p, COL, b, U), g.col, U, lane);
  copy(result<float>(p, MOV, b, U), g.mov, U, lane);
  copy(result<int>(p, STATUS, b, U), g.status, U, lane);
  copy(result<unsigned char>(p, IS_ATTACKER, b, U), g.isatt, U, lane);
  copy(result<int>(p, ATTACKER_SEQ, b, U), g.aseq, U, lane);
  copy_bool(result<unsigned char>(p, VP, b, 2 * RC), vp, 2 * RC, lane);
  if (lane == 0) {
    int* rn_out = result<int>(p, REINF_NEXT, b, 2);
    rn_out[0] = g.rn0, rn_out[1] = g.rn1;
    *result<int>(p, TURN, b, 1) = g.turn;
    *result<int>(p, STAGE, b, 1) = g.stage;
    *result<int>(p, LENGTH, b, 1) = g.length;
    *result<unsigned char>(p, TERMINAL, b, 1) = g.terminal;
    *result<float>(p, TERMINAL_VALUE, b, 1) = g.tv;
    *result<unsigned char>(p, HAS_TARGET, b, 1) = g.ht;
    *result<int>(p, TARGET_ROW, b, 1) = g.tr;
    *result<int>(p, TARGET_COL, b, 1) = g.tc;
    *result<int>(p, N_ATTACKERS, b, 1) = g.natt;
  }
}

}  // namespace

extern "C" {

// The launch fails (an error code) where four games pass the card's 227 KB a block.
int scs_step(const void* const* in, const long long* in_stride, void* const* out,
             const int* action, long long action_stride, const float* ftab,
             const int* itab, unsigned char* overflow, int B, int R, int C, int K, int S,
             int turns, int stage_passes, float recip_vp0, float recip_vp1, void* stream) {
  if (B <= 0) return 0;
  Params p;
  for (int f = 0; f < kFields; ++f) {
    p.in[f] = in[f];
    p.in_stride[f] = in_stride[f];
    p.out[f] = out[f];
  }
  p.action = action, p.action_stride = action_stride;
  p.ftab = ftab, p.itab = itab, p.overflow = overflow;
  p.B = B, p.R = R, p.C = C, p.K = K, p.S = S, p.turns = turns, p.stage_passes = stage_passes;
  p.recip_vp0 = recip_vp0, p.recip_vp1 = recip_vp1;
  const size_t smem = kWarps * game_bytes(R * C, K, 2 * S);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        scs_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scs_step_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
