// The env device code shared by the port's CUDA kernels (train_rollout.cu,
// rollout.cu): the murmur3 counter RNG, the spec-table accessors, the
// counter-RNG reset, the env step, the LidarInFront obs, the Gumbel-argmax
// sample and the tanh MLP.  Each env function is the per-env counterpart of
// the plain PyTorch code named beside it; the tile functions run a whole
// block over a tile of envs (the obs, the MLP, the Gumbel scores), and the
// warp functions at the end run a warp's counter-RNG resets together.
//
// The functions are __host__ __device__: g++ builds this file for the host
// (tests/test_torch_train_rollout.py, tests/test_torch_rollout.py), so the CPU
// tests hold the device code against the plain twins.  Launch code stays
// behind __CUDACC__.
//
// Parity hazards: uint32 arithmetic is native here (the twins mask int64);
// logf and tanhf are the IEEE functions (no -use_fast_math), but the MLP sums
// in another order than torch's matmul, so a policy action can differ from
// the twin's only at a near-tie of the top two Gumbel scores.

#pragma once

#include <cstdint>
#include <cmath>
#include <cstddef>
#include <cstring>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define NGX_HD __host__ __device__ __forceinline__
#define NGX_CALL __host__ __device__ __noinline__
#else
#define NGX_HD inline
#define NGX_CALL
#endif

// Header slots of the int32 table buffer: the same names, in the same
// order, as HEADER in ngx_torch/ops/tables.py.  F_* slots hold float bits;
// O_* slots hold the offset of an array in the same buffer.
namespace tb {
enum : int {
  H, I, A, R, NB, K, NSLOT, NKEEP, NPLACE, NINT, NH,
  OBS_DIM, RANDOM_INV, TABLE_ID, ADJ_ITEM, EXTRACT_AMOUNT,
  EXTRACT_YIELD, EXTRACT_SRC, RUBBER, HAS_BREAK, HAS_CRAFT,
  GOAL_ANY,
  F_REWARD_STEP, F_REWARD_INTER, F_REWARD_DONE, F_CRAFT_SUCCESS,
  F_BREAK_COST,
  O_OP, O_ARG, O_COST_OK, O_COST_FAIL, O_UNBREAK, O_BREW,
  O_BYIELD, O_RIN, O_ROUT, O_RMULTI, O_CC_OK, O_CC_MISS,
  O_CC_NOTAB, O_GOAL, O_INV_LO, O_INV_SPAN, O_INV_SET, O_PLACE,
  O_INT_IDS, O_INT_FLAT, O_BASE, O_BEAMS, O_SLOT, O_KEEP,
  O_DIMS,
  CRAFT_VARIANT, CRAFT_NAG, STICK_R, TAP_R, PLANK_I, STICK_I, TAP_I,
  GOAL_FRONT_MODE, GOAL_FRONT, HAS_DEADEND, WALL, WALL_COIN, PLACE_TAP,
  TREE, RESET_TAP, O_DEADEND,
  AXE_MODE, AXE_ID, AXE_BI, F_AXE_COST, FENCE_MODE, FENCE_ID,
  CRATE_ID, O_CRATE, FIRE_ITEM, F_FIRE_REWARD, HAS_GRAB,
  O_ENTITY, NEDIT, O_EDITS, LANE_BITS,
  N_TAB,
};
}  // namespace tb

// op codes, craft variants, nags, axe and fence modes (ngx_torch/core/
// spec.py), reset-edit kinds (ngx_torch/core/reset.py); RNG salts
// (pallas_rollout.py:312-330, :347, :368, :397, :421-424, :965)
enum Op {
  OP_FORWARD = 1, OP_LEFT = 2, OP_RIGHT = 3, OP_BREAK = 4, OP_PLACE = 5,
  OP_EXTRACT_RUBBER = 6, OP_EXTRACT_STRING = 7, OP_CRAFT = 8, OP_SELECT = 9,
  OP_FUSED_PLACE_EXTRACT = 10, OP_CHOP = 11, OP_JUMP = 12,
};
enum Craft { CRAFT_MODERN = 0, CRAFT_LEGACY_TABLE_FIRST = 1, CRAFT_LEGACY_NO_TABLE = 2 };
enum Nag { NAG_NONE = 0, NAG_V2 = 1, NAG_V4 = 2 };
enum Axe { AXE_NONE = 0, AXE_BONUS = 1, AXE_REQUIRED = 2 };
enum Fence { FENCE_NONE = 0, FENCE_MEDIUM = 1, FENCE_HARD = 2 };
enum Edit { EDIT_FENCE = 0, EDIT_FILL = 1 };
enum Salt { SALT_ACTION = 5, SALT_AGENT = 2, SALT_FACING = 3, SALT_INV = 4,
            SALT_PLACE0 = 16, SALT_COIN = 40, SALT_TAP0 = 41, SALT_EDIT0 = 100,
            SALT_EDIT_STRIDE = 4 };
// a mark on a map cell during a fence edit: item ids are below 32, so the
// int8 cell has bit 6 free
enum { CENTER_MARK = 64 };

struct Regs {
  int r, c, facing, selected, step_count, last_action, last_done;
  float last_reward, last_cost;
};

NGX_HD float tab_f(const int* tab, int slot) {
  union { int i; float f; } u;
  u.i = tab[slot];
  return u.f;
}

// The header slots of a table by value (the wrapper passes them beside the
// table): a kernel parameter, read from the constant bank.
struct SpecHdr {
  int v[tb::N_TAB + 1];
  NGX_HD int operator[](int slot) const { return v[slot]; }
};

// Float slot `slot` of a header (SpecHdr or the table itself).
template <class Hdr>
NGX_HD float hdr_f(const Hdr& hd, int slot) {
  union { int i; float f; } u;
  u.i = hd[slot];
  return u.f;
}

// ---- the murmur3 counter RNG (pallas_rollout.py:106-142, rng.py) ---------
NGX_HD uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

NGX_HD uint32_t rng_bits(uint32_t seed, uint32_t ctr, uint32_t salt,
                         uint32_t row, uint32_t col) {
  const uint32_t base =
      mix32((seed * 0x9E3779B1u) ^ (ctr * 0x632BE59Bu) ^ (salt * 0x85EBCA77u));
  const uint32_t lane = row * 0x01000193u + col * 0x9E3779B9u;
  return mix32(mix32(lane ^ base));
}

NGX_HD float rng_u01(uint32_t seed, uint32_t ctr, uint32_t salt,
                     uint32_t row, uint32_t col) {
  // 24-bit mantissa uniform in [0, 1): exact in float32
  return (float)(rng_bits(seed, ctr, salt, row, col) >> 8) * (1.0f / 16777216.0f);
}

NGX_HD int rng_randint(uint32_t seed, uint32_t ctr, uint32_t salt,
                       uint32_t row, uint32_t col, int n) {
  return (int)((rng_bits(seed, ctr, salt, row, col) >> 1) % (uint32_t)n);
}

// The RNG stream of env b: the LOGICAL block's int32 seed + blk*7919, which
// wraps like uint32 (pallas_rollout.py:718, :1071), and the row in it —
// whatever blockDim the launch uses.
NGX_HD void env_stream(int seed, int block, int b, uint32_t& s, uint32_t& row) {
  s = (uint32_t)seed + (uint32_t)(b / block) * 7919u;
  row = (uint32_t)(b % block);
}

// The facings 0..3 (up, down, left, right): the row and column step and
// the facing after a left or a right turn, as nibbles of one constant each
// (DR -1, 1, 0, 0; DC 0, 0, -1, 1; LEFT 2, 3, 1, 0; RIGHT 3, 2, 0, 1) —
// a shift and a mask, where an indexed array costs the step a local-memory
// round trip or a chain of selects.
NGX_HD int face_dr(int f) { return ((0x1120 >> (4 * f)) & 15) - 1; }
NGX_HD int face_dc(int f) { return ((0x2011 >> (4 * f)) & 15) - 1; }
NGX_HD int turn_left(int f) { return (0x0132 >> (4 * f)) & 15; }
NGX_HD int turn_right(int f) { return (0x1023 >> (4 * f)) & 15; }

NGX_HD int read_cell(const int8_t* m, int h, int r, int c) {
  return (r >= 0 && r < h && c >= 0 && c < h) ? (int)m[r * h + c] : 0;
}

// ---- the percent-fill edits' arithmetic (pallas_rollout.py:261-291, 388-394)
// n = ceil(count * p / 100) as the reference computes it, in float64: the
// float64 p/100 rounds some exact products just above an integer (25 * 0.28
// -> 7.000000000000001 -> 8).  IEEE double division and multiply, no fast
// math, so it is numpy's value.
NGX_HD int ceil_percent(int count, int p) {
  return (int)ceil((double)count * ((double)p / 100.0));
}

// The selection score of a cell: U = 30 - LANE uniform bits over the cell
// index in the low LANE bits, so the scores of a map are distinct.
NGX_HD uint32_t edit_score(uint32_t seed, uint32_t ctr, uint32_t salt,
                           uint32_t row, int cell, int lane) {
  const uint32_t bits = rng_bits(seed, ctr, salt, row, (uint32_t)cell);
  return ((bits >> (32 - (30 - lane))) << lane) | (uint32_t)cell;
}

NGX_HD bool edit_eligible(int kind, int from, int wall, int v) {
  // a fence center is neither air nor wall; a fill takes the cells of its
  // source item (air for additem)
  return kind == EDIT_FENCE ? (v != 0 && v != wall) : v == from;
}

// The score of a cell that no edit may select: above every 30-bit score.
enum : uint32_t { NOT_ELIGIBLE = 0xFFFFFFFFu };

// A map's edit scores, hashed where asked: NOT_ELIGIBLE off the edit's cells.
struct EditScore {
  const int8_t* m;
  int kind, from, wall, lane;
  uint32_t seed, ctr, salt, row;
  NGX_HD uint32_t operator()(int cell) const {
    return edit_eligible(kind, from, wall, m[cell])
               ? edit_score(seed, ctr, salt, row, cell, lane) : NOT_ELIGIBLE;
  }
};

// The score threshold below which exactly min(n, count) eligible cells lie
// (_select_n_uniform): 30 halvings of [0, 2^30) on the integer score, as the
// TPU kernel bisects, calling score(cell) for every cell in every round;
// the scores are distinct, so the set is the n smallest.
template <class Score>
NGX_HD uint32_t edit_threshold(int hw, int n, const Score& score) {
  uint32_t lo = 0, hi = 1u << 30;
  for (int it = 0; it < 30; ++it) {
    const uint32_t mid = (lo + hi) / 2;
    int c = 0;
    for (int cell = 0; cell < hw; ++cell) c += score(cell) < mid;
    if (c < n)
      lo = mid;
    else
      hi = mid;
  }
  return hi;
}

// ---- reset: pallas_rollout.py:309-445 (reset.py reset_rows) ---------------
// Plain placements, the v3 wall coin, the Pogostick-v0 tap, the novelty
// percent-fill edits (NOV only), the inventory.
template <bool NOV>
NGX_HD void reset_env(const int* tab, int8_t* m, int* inv, Regs& s,
                      uint32_t seed, uint32_t ctr, uint32_t row) {
  const int h = tab[tb::H], hw = h * h;
  const int DR[4] = {-1, 1, 0, 0}, DC[4] = {0, 0, -1, 1};
  const int* int_ids = tab + tab[tb::O_INT_IDS];
  const int* int_flat = tab + tab[tb::O_INT_FLAT];
  const int* base = tab + tab[tb::O_BASE];
  const int* place = tab + tab[tb::O_PLACE];
  // agent cell uniform over the 2-margin interior, facing uniform
  const int acell = int_ids[rng_randint(seed, ctr, SALT_AGENT, row, 0, tab[tb::NINT])];
  s.facing = rng_randint(seed, ctr, SALT_FACING, row, 0, 4);
  for (int i = 0; i < hw; ++i) m[i] = (int8_t)base[i];
  // each placement: max of u01 over the valid cells, the first (lowest)
  // index on ties; valid = cell and its 4 neighbours air, interior, not the
  // agent's cell (interior cells have all 4 neighbours in bounds)
  for (int j = 0; j < tab[tb::NPLACE]; ++j) {
    int best = -1;
    float best_u = -1.0f;
    for (int cell = 0; cell < hw; ++cell) {
      if (!int_flat[cell] || cell == acell || m[cell] != 0 ||
          m[cell - 1] != 0 || m[cell + 1] != 0 || m[cell - h] != 0 ||
          m[cell + h] != 0)
        continue;
      const float u = rng_u01(seed, ctr, SALT_PLACE0 + j, row, cell);
      if (u > best_u) {
        best_u = u;
        best = cell;
      }
    }
    if (best >= 0) m[best] = (int8_t)place[j];
  }
  // v3: the top hash bit puts a wall in front of the agent, only onto air
  // (novel_gridworld_v3_env.py:148-152); the front of an interior agent is
  // in the map
  if (tab[tb::WALL_COIN]) {
    const int fcell = acell + DR[s.facing] * h + DC[s.facing];
    if ((rng_bits(seed, ctr, SALT_COIN, row, 0) >> 31) && m[fcell] == 0)
      m[fcell] = (int8_t)tab[tb::WALL];
  }
  // Pogostick-v0: one tree_tap on an air cell (not the agent's) one step in
  // direction d from a tree (pogostick_v0_env.py:155-178); the first maximum
  // over the direction-major [4*HW] scores, so a cell next to k trees
  // carries weight k
  if (tab[tb::PLACE_TAP]) {
    int best = -1;
    float best_u = -1.0f;
    for (int d = 0; d < 4; ++d) {
      for (int cell = 0; cell < hw; ++cell) {
        const int r = cell / h, c = cell % h;
        const int tr = r - DR[d], tc = c - DC[d];
        if (m[cell] != 0 || cell == acell || tr < 0 || tr >= h || tc < 0 ||
            tc >= h || m[tr * h + tc] != tab[tb::TREE])
          continue;
        const float u = rng_u01(seed, ctr, SALT_TAP0 + d, row, cell);
        if (u > best_u) {
          best_u = u;
          best = cell;
        }
      }
    }
    if (best >= 0) m[best] = (int8_t)tab[tb::RESET_TAP];
  }
  // the novelty percent-fill edits, in injection order (pallas_rollout.py
  // :380-419): edit j draws its percent at salt 100+4j, column 0, and its
  // cells at salt 101+4j; the agent's cell may be selected but is never
  // written
  const int* edits = tab + tab[tb::O_EDITS];
  const int wall = tab[tb::WALL], lane = tab[tb::LANE_BITS];
  for (int j = 0; j < (NOV ? tab[tb::NEDIT] : 0); ++j) {
    const int kind = edits[5 * j], from = edits[5 * j + 1];
    const int to = edits[5 * j + 2], plo = edits[5 * j + 3];
    const uint32_t salt = SALT_EDIT0 + SALT_EDIT_STRIDE * (uint32_t)j;
    const int p = rng_randint(seed, ctr, salt, row, 0, edits[5 * j + 4] - plo) + plo;
    int count = 0;
    for (int cell = 0; cell < hw; ++cell)
      count += edit_eligible(kind, from, wall, m[cell]);
    int n = ceil_percent(count, p);
    n = n < count ? n : count;
    if (n == 0) continue;
    const EditScore score = {m, kind, from, wall, lane, seed, ctr, salt + 1, row};
    const uint32_t thr = edit_threshold(hw, n, score);
    if (kind == EDIT_FILL) {
      // a write changes only its own cell, which is not read again
      for (int cell = 0; cell < hw; ++cell)
        if (cell != acell && score(cell) < thr) m[cell] = (int8_t)to;
    } else {
      // mark the centers, then write each one's 3x3 block onto air that is
      // not the agent's cell (add_fence_around, pogostick_v1_env.py:524-536);
      // a center is not air, so the writes never touch a mark
      for (int cell = 0; cell < hw; ++cell)
        if (score(cell) < thr) m[cell] = (int8_t)(m[cell] | CENTER_MARK);
      for (int cell = 0; cell < hw; ++cell) {
        if (!(m[cell] & CENTER_MARK)) continue;
        const int r = cell / h, c = cell % h;
        for (int dr = -1; dr <= 1; ++dr)
          for (int dc = -1; dc <= 1; ++dc) {
            const int rr = r + dr, cc = c + dc, k = rr * h + cc;
            if (rr >= 0 && rr < h && cc >= 0 && cc < h && k != acell && m[k] == 0)
              m[k] = (int8_t)to;
          }
      }
      for (int cell = 0; cell < hw; ++cell)
        m[cell] = (int8_t)(m[cell] & ~CENTER_MARK);
    }
  }
  const int* lo = tab + tab[tb::O_INV_LO];
  const int* span = tab + tab[tb::O_INV_SPAN];
  const int* set = tab + tab[tb::O_INV_SET];
  for (int i = 0; i < tab[tb::I]; ++i) {
    int v = lo[i];
    if (tab[tb::RANDOM_INV])
      v += (int)((rng_bits(seed, ctr, SALT_INV, row, i) >> 1) % (uint32_t)span[i]);
    inv[i] = set[i] >= 0 ? set[i] : v;
  }
  s.r = acell / h;
  s.c = acell % h;
  s.selected = -1;
  s.step_count = 0;
  s.last_action = 0;
  s.last_done = 0;
  s.last_reward = 0.0f;
  s.last_cost = 0.0f;
}

// ---- step: ngx_torch/core/step.py (ngx/core/step.py:224-638) -------------
// The op families of the 11 presets and the novelty families: JUMP, CHOP,
// the axe modes, the fence restriction, the crate grant, grab-entities and
// the fire-wall death.  A novelty branch runs only where the spec's table
// sets its mode, op or item, which a novelty-free spec never does.  NOV
// compiles them in: each kernel has an instantiation with them and one
// without, and the wrapper launches the one without for a spec that uses
// none (ngx_torch/ops/tables.py has_novelty).  The novelty branches made the
// train kernel 41% slower on Pogostick-v1 (PERF.md): the code they
// add changes the whole loop's code generation, taken or not.
//
// hd: the table's header slots — the table itself (a `const int*`, as the
// tile kernels pass it) or a SpecHdr, which the rollout kernel takes by
// value so that every header read is one constant-bank operand rather than
// a shared-memory load; the arrays are read from tab at hd's offsets.  The
// map, the inventory and the table never alias.
template <bool NOV, class Hdr>
NGX_HD void step_env(const Hdr& hd, const int* __restrict__ tab,
                     int8_t* __restrict__ m, int* __restrict__ inv, Regs& s,
                     int a, float& reward, bool& done) {
  const int h = hd[tb::H], ni = hd[tb::I];
  const int op = tab[hd[tb::O_OP] + a], arg = tab[hd[tb::O_ARG] + a];
  const int dr0 = face_dr(s.facing), dc0 = face_dc(s.facing);
  const int fr = s.r + dr0, fc = s.c + dc0;
  const bool front_in = fr >= 0 && fr < h && fc >= 0 && fc < h;
  const int front = read_cell(m, h, fr, fc);

  const bool is_fwd = op == OP_FORWARD, fwd_ok = front == 0;
  // jump (novelty_wrappers.py:1360-1382): two cells ahead when that cell is
  // in the map and air; the cell between is not checked
  const bool is_jump = NOV && op == OP_JUMP;
  const int jr = fr + dr0, jc = fc + dc0;
  const bool jump_ok = jr >= 0 && jr < h && jc >= 0 && jc < h && m[jr * h + jc] == 0;

  // break, with the fence gate and the axe (step.py:271-316)
  const bool is_break = op == OP_BREAK;
  const bool breakable = front != 0 && !tab[hd[tb::O_UNBREAK] + front];
  const int fmode = NOV ? hd[tb::FENCE_MODE] : (int)FENCE_NONE;
  const int fid = hd[tb::FENCE_ID];
  bool fence_blocked = false;
  if (fmode == FENCE_MEDIUM) {
    // the agent's two sides across its facing are fence-free (:933-941)
    const bool ns = s.facing == 0 || s.facing == 1;
    const int sa = ns ? read_cell(m, h, s.r, s.c - 1) : read_cell(m, h, s.r - 1, s.c);
    const int sb = ns ? read_cell(m, h, s.r, s.c + 1) : read_cell(m, h, s.r + 1, s.c);
    fence_blocked = sa == fid || sb == fid;
  } else if (fmode == FENCE_HARD) {
    // the whole 3x3 around the target is fence-free (:943-949)
    for (int dr = -1; dr <= 1; ++dr)
      for (int dc = -1; dc <= 1; ++dc)
        fence_blocked = fence_blocked || read_cell(m, h, fr + dr, fc + dc) == fid;
  }
  // the fence itself is always breakable (:928-930)
  if (fmode != FENCE_NONE) fence_blocked = fence_blocked && front != fid;
  const int amode = NOV ? hd[tb::AXE_MODE] : (int)AXE_NONE;
  const int axe = hd[tb::AXE_ID];
  // the axe in the inventory AND selected (novelty_wrappers.py:56,67)
  const bool axe_sel = amode != AXE_NONE && inv[axe] >= 1 && s.selected == axe;
  const bool break_ok =
      breakable && !fence_blocked && (amode != AXE_REQUIRED || axe_sel);
  const bool is_chop = NOV && op == OP_CHOP;   // a break that yields 2 (:1288-1307)

  const int adj = hd[tb::ADJ_ITEM];
  const bool next_to_tree =
      read_cell(m, h, fr - 1, fc) == adj || read_cell(m, h, fr + 1, fc) == adj ||
      read_cell(m, h, fr, fc - 1) == adj || read_cell(m, h, fr, fc + 1) == adj;
  const int arg_i = arg < 0 ? 0 : (arg > ni - 1 ? ni - 1 : arg);
  const bool have_arg = inv[arg_i] >= 1;
  const bool is_place = op == OP_PLACE, place_ok = have_arg && front == 0;
  const bool is_exr = op == OP_EXTRACT_RUBBER;
  const bool exr_at_tap = front == hd[tb::EXTRACT_SRC];
  const bool exr_ok = exr_at_tap && next_to_tree;
  const bool is_exs = op == OP_EXTRACT_STRING;
  const bool exs_ok = front == hd[tb::EXTRACT_SRC];
  const bool is_select = op == OP_SELECT, sel_ok = have_arg;

  // fused place+extract (novel_gridworld_v4_env.py:277-305): places the tap
  // when none is on the map, extracts when one is
  const bool is_fused = op == OP_FUSED_PLACE_EXTRACT;
  const int tap_i = hd[tb::TAP_I];
  bool fused_place = false, fused_extract = false;
  if (is_fused) {
    int taps = 0;
    for (int i = 0; i < h * h; ++i) taps += m[i] == tap_i;
    fused_place = taps == 0 && inv[tap_i] >= 1 && next_to_tree && front == 0;
    fused_extract = taps == 1 && next_to_tree && front == tap_i;
  }

  const bool is_craft = op == OP_CRAFT;
  int rec = 0;
  bool craft_ok = false, craft_notable = false, nag = false;
  const int* need = nullptr;
  const int* rout = nullptr;
  if (hd[tb::HAS_CRAFT] && is_craft) {   // every use below is a craft's
    rec = arg < 0 ? 0 : (arg > hd[tb::R] - 1 ? hd[tb::R] - 1 : arg);
    need = tab + hd[tb::O_RIN] + rec * ni;
    rout = tab + hd[tb::O_ROUT] + rec * ni;
    bool have_all = true;
    for (int i = 0; i < ni; ++i) have_all = have_all && inv[i] >= need[i];
    const bool multi = tab[hd[tb::O_RMULTI] + rec] != 0;
    const bool at_table = front == hd[tb::TABLE_ID];
    bool missing;
    if (hd[tb::CRAFT_VARIANT] == CRAFT_MODERN) {
      missing = !have_all;
      craft_notable = have_all && multi && !at_table;
    } else if (hd[tb::CRAFT_VARIANT] == CRAFT_LEGACY_TABLE_FIRST) {
      craft_notable = multi && !at_table;   // the table check first
      missing = !craft_notable && !have_all;
    } else {                                // no table requirement (v2)
      missing = !have_all;
    }
    craft_ok = !missing && !craft_notable;
    const int pl = hd[tb::PLANK_I];
    if (hd[tb::CRAFT_NAG] == NAG_V2)       // plank after consuming (v2:306-323)
      nag = rec == hd[tb::STICK_R] && inv[pl] + rout[pl] - need[pl] < 8;
    else if (hd[tb::CRAFT_NAG] == NAG_V4)  // before consuming (v4:398-405)
      nag = (rec == hd[tb::STICK_R] && inv[pl] < 8) ||
            (rec == hd[tb::TAP_R] && inv[hd[tb::STICK_I]] < 8);
  }

  // every condition above read the pre-step map and inventory; now write
  const bool write_break =
      (is_break && break_ok) || (is_chop && breakable) || (is_exs && exs_ok);
  const bool write_place = (is_place && place_ok) || (is_fused && fused_place);
  if (front_in && (write_break || write_place))
    m[fr * h + fc] = (int8_t)(write_break ? 0 : (is_fused ? tap_i : arg));
  if (is_break && break_ok)
    inv[front] += amode != AXE_NONE ? (axe_sel && hd[tb::AXE_BI] ? 2 : 1)
                                    : tab[hd[tb::O_BYIELD] + front];
  if (is_chop && breakable) inv[front] += 2;
  // the crate grants its contents whenever Break targets it, before the
  // break resolves (novelty_wrappers.py:1085-1088)
  if (NOV && is_break && hd[tb::CRATE_ID] >= 0 && front == hd[tb::CRATE_ID]) {
    const int* crate = tab + hd[tb::O_CRATE];
    for (int i = 0; i < ni; ++i) inv[i] += crate[i];
  }
  if (is_place && place_ok) inv[arg_i] -= 1;
  if (is_exr && exr_ok) inv[hd[tb::RUBBER]] += hd[tb::EXTRACT_AMOUNT];
  if (is_exs && exs_ok && hd[tb::EXTRACT_YIELD] >= 0)
    inv[hd[tb::EXTRACT_YIELD]] += hd[tb::EXTRACT_AMOUNT];
  if (is_fused && (fused_place || fused_extract)) inv[hd[tb::RUBBER]] += 1;
  if (is_fused && fused_place) inv[tap_i] -= 1;
  if (is_craft && craft_ok)
    for (int i = 0; i < ni; ++i) inv[i] += rout[i] - need[i];

  const float r_step = hdr_f(hd, tb::F_REWARD_STEP);
  const float r_inter = hdr_f(hd, tb::F_REWARD_INTER);
  float rw = r_step;
  // with an axe novelty: +10 with the axe selected on any breakable, the
  // step reward without it (novelty_wrappers.py:45-84)
  if (is_break && break_ok)
    rw = amode != AXE_NONE ? (axe_sel ? r_inter : r_step) : tab_f(tab, hd[tb::O_BREW] + front);
  if (is_chop && breakable) rw = r_inter;
  if (is_place && place_ok && next_to_tree) rw = r_inter;
  if (is_exr && exr_ok) rw = r_inter;
  if (is_exs && exs_ok) rw = r_inter;
  if (is_craft) rw = craft_ok && !nag ? hdr_f(hd, tb::F_CRAFT_SUCCESS) : r_step;
  if (is_fused && fused_place) rw = 20.0f;
  if (is_fused && fused_extract) rw = 15.0f;

  const bool result = !((is_fwd && !fwd_ok) || (is_jump && !jump_ok) ||
                        (is_break && !break_ok) || (is_chop && !breakable) ||
                        (is_place && !place_ok) || (is_exr && !exr_ok) ||
                        (is_exs && !exs_ok) || (is_craft && !craft_ok) ||
                        (is_select && !sel_ok));
  float cost = result ? tab_f(tab, hd[tb::O_COST_OK] + a) : tab_f(tab, hd[tb::O_COST_FAIL] + a);
  if (hd[tb::HAS_BREAK] && is_break)   // the axe discount only on its success
    cost = axe_sel && break_ok ? hdr_f(hd, tb::F_AXE_COST) : hdr_f(hd, tb::F_BREAK_COST);
  if (hd[tb::HAS_CRAFT] && is_craft)
    cost = craft_ok ? tab_f(tab, hd[tb::O_CC_OK] + rec)
                    : (craft_notable ? tab_f(tab, hd[tb::O_CC_NOTAB] + rec)
                                     : tab_f(tab, hd[tb::O_CC_MISS] + rec));
  // the fence restriction's tail: every break it lets through costs the
  // break cost and two steps, even where the inner break failed
  // (novelty_wrappers.py:930,950-984)
  int step_inc = 1;
  if (fmode != FENCE_NONE && is_break && breakable && !fence_blocked) {
    cost = hdr_f(hd, tb::F_BREAK_COST);
    step_inc = 2;
  }

  if (is_fwd && fwd_ok) {
    s.r = fr;
    s.c = fc;
  }
  if (is_jump && jump_ok) {
    s.r = jr;
    s.c = jc;
  }
  if (op == OP_LEFT) s.facing = turn_left(s.facing);
  if (op == OP_RIGHT) s.facing = turn_right(s.facing);
  if (is_select && sel_ok) s.selected = arg;

  // grab-entities (pogostick_v1_env.py:538-554): every entity in the 3x3
  // around the agent's new cell moves to the inventory
  if (NOV && hd[tb::HAS_GRAB]) {
    const int* ent = tab + hd[tb::O_ENTITY];
    for (int dr = -1; dr <= 1; ++dr)
      for (int dc = -1; dc <= 1; ++dc) {
        const int rr = s.r + dr, cc = s.c + dc;
        if (rr < 0 || rr >= h || cc < 0 || cc >= h) continue;
        const int v = m[rr * h + cc];
        if (ent[v]) {
          inv[v] += 1;
          m[rr * h + cc] = 0;
        }
      }
  }

  // the goal over the post-step state (pogostick_v1_env.py:354-357): the
  // block in front (novel_gridworld_v0_env.py:236-239) or the inventory
  bool goal_met;
  if (hd[tb::GOAL_FRONT_MODE]) {
    goal_met = read_cell(m, h, s.r + face_dr(s.facing), s.c + face_dc(s.facing)) ==
               hd[tb::GOAL_FRONT];
  } else {
    const int* goal = tab + hd[tb::O_GOAL];
    bool all_met = true, any_met = false;
    for (int i = 0; i < ni; ++i) {
      if (goal[i] > 0) {
        all_met = all_met && inv[i] >= goal[i];
        any_met = any_met || inv[i] >= goal[i];
      }
    }
    goal_met = hd[tb::GOAL_ANY] ? any_met : all_met;
  }
  if (goal_met) rw = hdr_f(hd, tb::F_REWARD_DONE);
  bool d = goal_met;
  // dead end (novel_gridworld_v2_env.py:263-266): no dead-end recipe is
  // craftable from the post-step inventory
  if (hd[tb::HAS_DEADEND] && !goal_met) {
    const int* dead = tab + hd[tb::O_DEADEND];
    bool craftable = false;
    for (int q = 0; q < hd[tb::R]; ++q) {
      if (!dead[q]) continue;
      const int* rin = tab + hd[tb::O_RIN] + q * ni;
      bool ok = true;
      for (int i = 0; i < ni; ++i) ok = ok && inv[i] >= rin[i];
      craftable = craftable || ok;
    }
    d = !craftable;
  }
  // the fire-wall death, after everything (novelty_wrappers.py:1171-1189)
  const int fire = NOV ? hd[tb::FIRE_ITEM] : -1;
  if (fire >= 0 && (read_cell(m, h, s.r - 1, s.c) == fire ||
                    read_cell(m, h, s.r + 1, s.c) == fire ||
                    read_cell(m, h, s.r, s.c - 1) == fire ||
                    read_cell(m, h, s.r, s.c + 1) == fire)) {
    rw = hdr_f(hd, tb::F_FIRE_REWARD);
    d = true;
  }

  s.step_count += step_inc;
  s.last_action = a;
  s.last_reward = rw;
  s.last_cost = cost;
  s.last_done = d;
  reward = rw;
  done = d;
}

// ---- LidarInFront obs (pallas_rollout.py:471-530, rays.py make_lidar) -----
// Part `part` of the obs: beam part < NB (its NSLOT values: the hit's
// distance in its item's slot), or the kept inventory (part NB).  Writes the
// values to x[k * xs] (the MLP input column) and, when orow is not null, to
// orow[k].  The parts are independent, so a block spreads an env's NB + 1
// parts over its threads.
NGX_HD void lidar_part(const int* tab, const int8_t* m, const int* inv,
                       const Regs& s, int part, float* x, int xs, float* orow) {
  const int h = tab[tb::H], nb = tab[tb::NB], kr = tab[tb::K], ns = tab[tb::NSLOT];
  if (part == nb) {
    const int* keep = tab + tab[tb::O_KEEP];
    for (int i = 0; i < tab[tb::NKEEP]; ++i) {
      const float val = (float)inv[keep[i]];
      x[(nb * ns + i) * xs] = val;
      if (orow) orow[nb * ns + i] = val;
    }
    return;
  }
  const int* beam = tab + tab[tb::O_BEAMS] + (s.facing * nb + part) * kr * 2;
  int dist = 0, hv = 0;
  for (int k = 0; k < kr; ++k) {
    int rr = s.r + beam[2 * k];
    int cc = s.c + beam[2 * k + 1];
    rr = rr < 0 ? 0 : (rr > h - 1 ? h - 1 : rr);
    cc = cc < 0 ? 0 : (cc > h - 1 ? h - 1 : cc);
    const int v = m[rr * h + cc];
    if (v != 0) {
      dist = k + 1;
      hv = v;
      break;
    }
  }
  const int sl = dist > 0 ? tab[tab[tb::O_SLOT] + hv] : -1;
  for (int q = 0; q < ns; ++q) {
    const float val = q == sl ? (float)dist : 0.0f;
    x[(part * ns + q) * xs] = val;
    if (orow) orow[part * ns + q] = val;
  }
}

// ---- Gumbel-argmax (pallas_rollout.py:965-970) ---------------------------
// The score of action a: its logit less log(-log(u + 1e-10) + 1e-10), u the
// counter-RNG uniform of (seed, ctr, salt 5, row, a).  The scores are
// independent, so a block spreads a tile's over its threads.
NGX_HD float gumbel_score(float logit, uint32_t seed, uint32_t ctr,
                          uint32_t row, int a) {
  const float u = rng_u01(seed, ctr, SALT_ACTION, row, a);
  return logit - logf(-logf(u + 1e-10f) + 1e-10f);
}

// The first maximum of na scores of stride xs (strict >: the min index).
NGX_HD int argmax_col(const float* scores, int xs, int na) {
  int best = 0;
  float best_s = -INFINITY;
  for (int a = 0; a < na; ++a) {
    if (scores[a * xs] > best_s) {
      best_s = scores[a * xs];
      best = a;
    }
  }
  return best;
}

// ---- the tile MLP: one block computes the policy of a tile of E envs ------
//
// A block of N threads owns a tile of E envs (E a multiple of 4, N >= E).
// Each time step runs four phases, each ended by a barrier (the MLP's after
// every layer):
//   * env phase (tile_obs): the LidarInFront obs of env e into column e of
//     the activation tile X, k-major [k][E]; the NB beams and the inventory
//     of every env are NB + 1 independent parts, spread over all N threads;
//   * MLP phase (tile_mlp): all N threads compute each layer y = act(W x +
//     b) over the tile, each thread 4 units x 4 envs at a time from one
//     16-byte shared load of weights and one of activations a k (16 FMAs),
//     the activations ping-ponging between two tiles;
//   * score phase (tile_scores): every logit less its Gumbel noise, A x E
//     independent scores spread over all N threads;
//   * act phase: thread e < E takes env e's first maximum score, steps the
//     env and resets or restores it.
// The weights are k-major and padded to a multiple of 4 units, as
// ngx_torch/ops/tables.py policy_params lays them out: per layer W^T
// [din][dp] and then the bias [dp].  They sit in shared memory where they
// fit beside the tiles; otherwise each layer streams through two buffers of
// kc rows with cp.async, the next chunk's copy overlapping this chunk's
// FMAs, and the partial sums wait in the output tile between chunks.
//
// Sum order: every output is bias[j], then acc = fmaf(W[j][k], x[k], acc)
// for k ascending, then tanhf on hidden layers — the order of the
// one-thread-per-env MLP that this replaced, so the actions, and everything
// that follows from them, are that code's bit for bit.

NGX_HD int pad4(int n) { return (n + 3) & ~3; }

NGX_HD size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

#if defined(__CUDACC__)
typedef float4 vec4;
NGX_HD vec4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
NGX_HD void st4(float* p, vec4 v) { *reinterpret_cast<float4*>(p) = v; }
#else
struct alignas(16) vec4 { float x, y, z, w; };
inline vec4 ld4(const float* p) { vec4 v; std::memcpy(&v, p, 16); return v; }
inline void st4(float* p, vec4 v) { std::memcpy(p, &v, 16); }
#endif

// The block a tile's code runs on.  The code between two sync()s is a phase,
// written `for (int tid = blk.lo; tid < blk.hi; ++tid) {...}`: on the card
// each thread runs the body once with its own index and sync() is
// __syncthreads(); on the host (the g++ build of the tests) the loop runs
// the body for every index in order and sync() does nothing.  copy / commit
// / wait move weights from device memory to shared memory: cp.async on the
// card (16-byte pieces; count a multiple of 4 floats, both ends 16-byte
// aligned), a plain copy on the host.
struct HostBlock {
  int lo, hi, n;
  explicit HostBlock(int threads) : lo(0), hi(threads), n(threads) {}
  void sync() const {}
  void copy(float* dst, const float* src, int count) const {
    std::memcpy(dst, src, (size_t)count * 4);
  }
  void commit() const {}
  void wait(bool) const {}
};

#if defined(__CUDACC__)
// (__host__ __device__ with device bodies, so that the __host__ __device__
// tile code may call it; only kernels construct one)
struct DevBlock {
  int lo, hi, n;
  NGX_HD DevBlock() {
#if defined(__CUDA_ARCH__)
    lo = threadIdx.x;
    hi = lo + 1;
    n = blockDim.x;
#else
    lo = hi = n = 0;
#endif
  }
  NGX_HD void sync() const {
#if defined(__CUDA_ARCH__)
    __syncthreads();
#endif
  }
  NGX_HD void copy(float* dst, const float* src, int count) const {
#if defined(__CUDA_ARCH__)
    for (int i = 4 * lo; i < count; i += 4 * n) {
      const unsigned s = (unsigned)__cvta_generic_to_shared(dst + i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(s), "l"(src + i) : "memory");
    }
#endif
  }
  NGX_HD void commit() const {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
  }
  // wait for this thread's copies but the newest group (one) or for all
  NGX_HD void wait(bool one) const {
#if defined(__CUDA_ARCH__)
    if (one)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
  }
};
#endif

// One layer (or one chunk of its k rows, k0..k1-1) over the tile, for thread
// tid of nthr.  wt: W^T from row k0, row stride dp; x, y: [k][E] tiles.  The
// first chunk starts from the bias, a later one from the partial sums in y;
// the last applies tanh (act) and leaves y final.  Units dout..dp-1 are
// padding: computed from zero weights, never stored.
NGX_HD void dense_tile(const float* wt, int k0, int k1, int dp,
                       const float* bias, int dout, bool first, bool last,
                       bool act, const float* x, float* y, int E, int tid,
                       int nthr) {
  const int ne = E >> 2, items = ne * (dp >> 2);
  for (int it = tid; it < items; it += nthr) {
    // env-major: the threads of a warp share a few unit groups, so a
    // k's weight load is a broadcast and the env loads are one wavefront
    const int e0 = (it % ne) * 4, j0 = (it / ne) * 4;
    float acc[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int ee = 0; ee < 4; ++ee)
        acc[jj][ee] = j0 + jj >= dout ? 0.0f
                      : first ? bias[j0 + jj] : y[(j0 + jj) * E + e0 + ee];
    for (int k = k0; k < k1; ++k) {
      const vec4 w = ld4(wt + (size_t)(k - k0) * dp + j0);
      const vec4 v = ld4(x + (size_t)k * E + e0);
      const float wj[4] = {w.x, w.y, w.z, w.w}, xe[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int ee = 0; ee < 4; ++ee)
          acc[jj][ee] = fmaf(wj[jj], xe[ee], acc[jj][ee]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (j0 + jj >= dout) continue;
      float o[4];
#pragma unroll
      for (int ee = 0; ee < 4; ++ee)
        o[ee] = last && act ? tanhf(acc[jj][ee]) : acc[jj][ee];
      st4(y + (j0 + jj) * E + e0, vec4{o[0], o[1], o[2], o[3]});
    }
  }
}

// The tower over the tile (the tab's O_DIMS widths): from the obs in x,
// through the layers, to the logits, whose tile it returns (x or y).  sw:
// the weights in shared memory, or null to stream them from gw through
// wbuf, two buffers of `chunk` floats, kc rows a chunk.  Ends after a
// barrier.
template <class Blk>
NGX_HD float* tile_mlp(const Blk& blk, const int* tab, const float* gw,
                             const float* sw, float* wbuf, int kc, int chunk,
                             float* x, float* y, int E) {
  const int* dims = tab + tab[tb::O_DIMS];
  const int nl = tab[tb::NH] + 1;
  size_t off = 0;
  for (int l = 0; l < nl; ++l) {
    const int din = dims[l], dout = dims[l + 1], dp = pad4(dout);
    const bool act = l < nl - 1;
    if (sw) {
      for (int tid = blk.lo; tid < blk.hi; ++tid)
        dense_tile(sw + off, 0, din, dp, sw + off + (size_t)din * dp, dout,
                   true, true, act, x, y, E, tid, blk.n);
      blk.sync();
    } else {
      const float* g = gw + off;
      const int nc = (din + kc - 1) / kc;
      blk.copy(wbuf, g, (din < kc ? din : kc) * dp);
      blk.commit();
      for (int c = 0; c < nc; ++c) {
        const int k0 = c * kc, k1 = din < k0 + kc ? din : k0 + kc;
        if (c + 1 < nc) {
          const int k2 = din < k1 + kc ? din : k1 + kc;
          blk.copy(wbuf + ((c + 1) & 1) * chunk, g + (size_t)k1 * dp,
                   (k2 - k1) * dp);
          blk.commit();
        }
        blk.wait(c + 1 < nc);
        blk.sync();
        for (int tid = blk.lo; tid < blk.hi; ++tid)
          dense_tile(wbuf + (c & 1) * chunk, k0, k1, dp, g + (size_t)din * dp,
                     dout, c == 0, c == nc - 1, act, x, y, E, tid, blk.n);
        blk.sync();
      }
    }
    off += (size_t)(din + 1) * dp;
    float* tmp = x;
    x = y;
    y = tmp;
  }
  return x;
}

// What an env keeps across the phases of a step, in shared memory.
struct EnvSlot {
  Regs s;
  uint32_t seed, row;
  int base, n_done, dcount;
  float rsum;
};

// Dynamic shared memory of a tile's block, byte offsets: the table buffer,
// the two activation tiles, the obs staging rows (the train kernel's), the
// env slots, inventories (int32) and maps (int8, item ids are below 32),
// then the weights (resident) or the two chunk buffers (streamed).
struct TileLayout {
  int off_x, off_y, off_o, off_slot, off_inv, off_map, off_w, bytes;
  int n_params, resident, kc, chunk;
};

// The layout for widths dims[0..n_dims-1] in at most `budget` bytes;
// false where not even one-row chunks fit.
NGX_HD bool tile_layout(int n_tab, const int* dims, int n_dims, int E, int hw,
                        int ni, bool obs_stage, size_t budget, TileLayout& L) {
  size_t widest = 0, maxdp = 0, maxdin = 0, np = 0;
  for (int l = 0; l + 1 < n_dims; ++l) {
    const size_t din = dims[l], dp = pad4(dims[l + 1]);
    np += (din + 1) * dp;
    widest = widest > din ? widest : din;
    widest = widest > (size_t)dims[l + 1] ? widest : dims[l + 1];
    maxdp = maxdp > dp ? maxdp : dp;
    maxdin = maxdin > din ? maxdin : din;
  }
  size_t off = align16((size_t)n_tab * 4);
  L.off_x = (int)off;
  off += align16(widest * E * 4);
  L.off_y = (int)off;
  off += align16(widest * E * 4);
  L.off_o = (int)off;
  off += obs_stage ? align16((size_t)dims[0] * E * 4) : 0;
  L.off_slot = (int)off;
  off += align16((size_t)E * sizeof(EnvSlot));
  L.off_inv = (int)off;
  off += align16((size_t)E * ni * 4);
  L.off_map = (int)off;
  off += align16((size_t)E * hw);
  L.off_w = (int)off;
  L.n_params = (int)np;
  L.resident = off + np * 4 <= budget;
  if (L.resident) {
    L.kc = L.chunk = 0;
    off += np * 4;
  } else {
    const size_t kc = off < budget ? (budget - off) / (2 * maxdp * 4) : 0;
    if (kc < 1) return false;
    L.kc = (int)(kc < maxdin ? kc : maxdin);
    L.chunk = L.kc * (int)maxdp;
    off += (size_t)2 * L.chunk * 4;
  }
  L.bytes = (int)off;
  return true;
}

// Copy the table (and the weights, where resident) into the block's shared
// memory and zero the activation tiles (the columns of a ragged tile's
// missing envs stay 0).  Ends after a barrier.
template <class Blk>
NGX_HD void tile_setup(const Blk& blk, unsigned char* smem, const TileLayout& L,
                       const int* tab, int n_tab, const float* params) {
  int* t = reinterpret_cast<int*>(smem);
  float* w = reinterpret_cast<float*>(smem + L.off_w);
  float* z = reinterpret_cast<float*>(smem + L.off_x);
  const int nz = (L.off_o - L.off_x) / 4;
  for (int tid = blk.lo; tid < blk.hi; ++tid) {
    for (int i = tid; i < n_tab; i += blk.n) t[i] = tab[i];
    for (int i = tid; i < (L.resident ? L.n_params : 0); i += blk.n) w[i] = params[i];
    for (int i = tid; i < nz; i += blk.n) z[i] = 0.0f;
  }
  blk.sync();
}

// The shared-memory pointers of a tile, from its layout.
struct Tile {
  const int* tab;
  float *x, *y, *o, *w;
  EnvSlot* slot;
  int* inv;
  int8_t* map;
  NGX_HD Tile(unsigned char* smem, const TileLayout& L)
      : tab(reinterpret_cast<const int*>(smem)),
        x(reinterpret_cast<float*>(smem + L.off_x)),
        y(reinterpret_cast<float*>(smem + L.off_y)),
        o(reinterpret_cast<float*>(smem + L.off_o)),
        w(reinterpret_cast<float*>(smem + L.off_w)),
        slot(reinterpret_cast<EnvSlot*>(smem + L.off_slot)),
        inv(reinterpret_cast<int*>(smem + L.off_inv)),
        map(reinterpret_cast<int8_t*>(smem + L.off_map)) {}
};

// The env phase: after a barrier (the envs' state is the act phase's), the
// obs of the tile's nv envs into the columns of x and, where o is not null,
// into their staging rows; the NB + 1 parts of each env's obs spread over
// the block's threads.  Ends after a barrier.
template <class Blk>
NGX_HD void tile_obs(const Blk& blk, const Tile& S, int nv, int E, float* o) {
  const int* tab = S.tab;
  const int hw = tab[tb::H] * tab[tb::H], ni = tab[tb::I];
  const int parts = tab[tb::NB] + 1, od = tab[tb::OBS_DIM];
  blk.sync();
  for (int tid = blk.lo; tid < blk.hi; ++tid)
    for (int i = tid; i < parts * E; i += blk.n) {
      const int e = i % E;
      if (e < nv)
        lidar_part(tab, S.map + e * hw, S.inv + e * ni, S.slot[e].s, i / E,
                   S.x + e, E, o ? o + e * od : nullptr);
    }
  blk.sync();
}

// The score phase: each logit of the tile's nv envs less its Gumbel noise
// at counter ctr, in place in the logits tile lg, spread over the block's
// threads.  Ends after a barrier.
template <class Blk>
NGX_HD void tile_scores(const Blk& blk, const Tile& S, float* lg, int nv,
                        int E, uint32_t ctr) {
  const int na = S.tab[tb::A];
  for (int tid = blk.lo; tid < blk.hi; ++tid)
    for (int i = tid; i < na * E; i += blk.n) {
      const int e = i % E;
      if (e < nv)
        lg[i] = gumbel_score(lg[i], S.slot[e].seed, ctr, S.slot[e].row, i / E);
    }
  blk.sync();
}

// ---- the warp: 32 lanes, one env each, that reset their done envs together
//
// The rollout kernel's 'prng' and 'input' modes (rollout.cu) run a warp over
// 32 envs, lane e stepping env e.  The envs that a step finished are reset
// by the whole warp at once (warp_reset): for k of them, groups of
// G = 32 / next_pow2(k) lanes (at least `lanes`), one env a group, each lane
// taking every G-th cell.  A placement's (or the tap's) first maximum is a
// shuffle reduction over the group; the percent-fill edits hash each cell's
// score once into the group's row of a score buffer in shared memory and
// find the n smallest by bisecting on the stored scores (group_threshold).
// k = 32 is the one-lane-per-env loop, less the edits' 29 re-hashes of
// every cell.  A step on which no env finished costs one vote.
//
// Warp code is written as phases over lanes, `for (int L = w.lo; L < w.hi;
// ++L) {...}`, with the warp's collectives (ballot, the group sum and
// maximum) and sync() between phases; a value that lives across phases is a
// Lanes<T, W::N>.  On the card (DevWarp) a thread runs the body for its own
// lane, a Lanes is one register and the collectives are __ballot_sync,
// __reduce_add_sync, __shfl_xor_sync and __syncwarp; on the host (HostWarp,
// the g++ build of the tests) the body runs for the 32 lanes in order, a
// Lanes is an array and the collectives are loops.
template <class T, int N>
struct Lanes {
  T v[N];
  NGX_HD T& operator[](int lane) { return v[N == 1 ? 0 : lane]; }
  NGX_HD const T& operator[](int lane) const { return v[N == 1 ? 0 : lane]; }
};

typedef unsigned long long Key;   // a first-maximum key (first_max_key)

NGX_HD int popc32(unsigned x) {
#if defined(__CUDA_ARCH__)
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

NGX_HD int low_bit(unsigned x) {   // x != 0
#if defined(__CUDA_ARCH__)
  return __ffs((int)x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// The lowest n set bits of x.
NGX_HD unsigned low_bits(unsigned x, int n) {
  unsigned r = 0;
  for (int i = 0; i < n && x; ++i) {
    r |= x & (0u - x);
    x &= x - 1;
  }
  return r;
}

struct HostWarp {
  static constexpr int N = 32;
  int lo = 0, hi = 32;
  void sync() const {}
  unsigned ballot(const Lanes<bool, N>& p) const {
    unsigned m = 0;
    for (int l = 0; l < 32; ++l) m |= (unsigned)p[l] << l;
    return m;
  }
  // every lane of each aligned group of g lanes (g a power of 2) gets the
  // group's sum, or its largest key
  void group_sum(Lanes<int, N>& v, int g) const {
    for (int l0 = 0; l0 < 32; l0 += g) {
      int s = 0;
      for (int l = l0; l < l0 + g; ++l) s += v[l];
      for (int l = l0; l < l0 + g; ++l) v[l] = s;
    }
  }
  void group_max(Lanes<Key, N>& k, int g) const {
    for (int l0 = 0; l0 < 32; l0 += g) {
      Key m = k[l0];
      for (int l = l0 + 1; l < l0 + g; ++l) m = k[l] > m ? k[l] : m;
      for (int l = l0; l < l0 + g; ++l) k[l] = m;
    }
  }
};

#if defined(__CUDACC__)
struct DevWarp {
  static constexpr int N = 1;
  static constexpr unsigned ALL = 0xFFFFFFFFu;
  int lo, hi;
  NGX_HD DevWarp() {
#if defined(__CUDA_ARCH__)
    // (volatile: kept in a register, not re-read from SR_TID every phase)
    asm volatile("mov.u32 %0, %%laneid;" : "=r"(lo));
    hi = lo + 1;
#else
    lo = hi = 0;
#endif
  }
  NGX_HD void sync() const {
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
  }
  NGX_HD unsigned ballot(const Lanes<bool, N>& p) const {
#if defined(__CUDA_ARCH__)
    return __ballot_sync(ALL, p.v[0]);
#else
    return 0;
#endif
  }
  NGX_HD void group_sum(Lanes<int, N>& v, int g) const {
#if defined(__CUDA_ARCH__)
    if (g == 32) {
      v.v[0] = (int)__reduce_add_sync(ALL, (unsigned)v.v[0]);
      return;
    }
    for (int o = g >> 1; o; o >>= 1) v.v[0] += __shfl_xor_sync(ALL, v.v[0], o);
#endif
  }
  NGX_HD void group_max(Lanes<Key, N>& k, int g) const {
#if defined(__CUDA_ARCH__)
    for (int o = g >> 1; o; o >>= 1) {
      const Key x = __shfl_xor_sync(ALL, k.v[0], o);
      k.v[0] = x > k.v[0] ? x : k.v[0];
    }
#endif
  }
};
#endif

// The first-maximum key of a score u24 (a uniform's 24 bits) at index idx:
// the larger u wins, then the lower index, as `if (u > best_u)` over
// ascending indices picks; 0 is no candidate.  u and idx need 33 bits or
// more, hence 64.
NGX_HD Key first_max_key(uint32_t u24, int idx) {
  return ((Key)(u24 + 1u) << 32) | (Key)(0xFFFFFFFFu - (uint32_t)idx);
}

NGX_HD int first_max_index(Key k) { return (int)(0xFFFFFFFFu - (uint32_t)k); }

// The agent's cell and facing of a counter-RNG reset (reset_env's first two
// draws).
template <class Hdr>
NGX_HD void reset_draw(const Hdr& hd, const int* tab, uint32_t seed,
                       uint32_t ctr, uint32_t row, int& acell, int& facing) {
  acell = tab[hd[tb::O_INT_IDS] +
              rng_randint(seed, ctr, SALT_AGENT, row, 0, hd[tb::NINT])];
  facing = rng_randint(seed, ctr, SALT_FACING, row, 0, 4);
}

// Per group of G lanes: the threshold below which exactly n[L] of the
// group's stored scores row[L][0..hw-1] lie (n >= 1 and at most the count
// of eligible ones; the scores distinct; a group with n 0 or no row gets
// 2^30 and selects nothing it writes): edit_threshold's 30 halvings, each
// counting the stored scores below the midpoint, every G-th cell a lane.
template <class W>
NGX_HD void group_threshold(const W& w, const Lanes<const uint32_t*, W::N>& row,
                            int hw, int G, const Lanes<int, W::N>& n,
                            Lanes<uint32_t, W::N>& thr) {
  Lanes<uint32_t, W::N> lo;
  for (int L = w.lo; L < w.hi; ++L) {
    lo[L] = 0;
    thr[L] = 1u << 30;
  }
  for (int it = 0; it < 30; ++it) {
    Lanes<int, W::N> c;
    for (int L = w.lo; L < w.hi; ++L) {
      const uint32_t mid = (lo[L] + thr[L]) / 2;
      c[L] = 0;
      if (row[L])
        for (int cell = L % G; cell < hw; cell += G) c[L] += row[L][cell] < mid;
    }
    w.group_sum(c, G);
    for (int L = w.lo; L < w.hi; ++L) {
      const uint32_t mid = (lo[L] + thr[L]) / 2;
      if (c[L] < n[L])
        lo[L] = mid;
      else
        thr[L] = mid;
    }
  }
}

// The percent-fill edits (reset_env's, pallas_rollout.py :380-419) of each
// group's env (env[L] >= 0: map smap + env*hw, agent cell acell, stream
// (sd, ctr, rw)), the group's G lanes taking every G-th cell: every cell's
// score hashed once into the group's row of `score` (hw words a group),
// then group_threshold.  A fence writes `to` onto each air cell (not the
// agent's) with a selected centre in its 3x3 block: the cells each centre
// would write, gathered per cell, so no two lanes write one cell.  Ends
// after a sync.
template <class W>
NGX_HD void group_edits(const W& w, const int* tab, int8_t* smap,
                        uint32_t* score, int G,
                        const Lanes<int, W::N>& env,
                        const Lanes<int, W::N>& acell,
                        const Lanes<uint32_t, W::N>& sd,
                        const Lanes<uint32_t, W::N>& rw, uint32_t ctr) {
  const int h = tab[tb::H], hw = h * h;
  const int* edits = tab + tab[tb::O_EDITS];
  const int wall = tab[tb::WALL], lane_bits = tab[tb::LANE_BITS];
  for (int j = 0; j < tab[tb::NEDIT]; ++j) {
    const int kind = edits[5 * j], from = edits[5 * j + 1];
    const int to = edits[5 * j + 2], plo = edits[5 * j + 3];
    const uint32_t salt = SALT_EDIT0 + SALT_EDIT_STRIDE * (uint32_t)j;
    Lanes<int, W::N> c, n;
    Lanes<const uint32_t*, W::N> row;
    Lanes<uint32_t, W::N> thr;
    for (int L = w.lo; L < w.hi; ++L) {
      c[L] = 0;
      row[L] = nullptr;
      if (env[L] < 0) continue;
      uint32_t* r = score + (L / G) * hw;
      const EditScore sc = {smap + env[L] * hw, kind, from, wall, lane_bits,
                            sd[L], ctr, salt + 1, rw[L]};
      for (int cell = L % G; cell < hw; cell += G) {
        r[cell] = sc(cell);
        c[L] += r[cell] != NOT_ELIGIBLE;
      }
      row[L] = r;
    }
    w.group_sum(c, G);
    for (int L = w.lo; L < w.hi; ++L) {
      n[L] = 0;
      if (env[L] < 0) continue;
      const int p = rng_randint(sd[L], ctr, salt, rw[L], 0, edits[5 * j + 4] - plo) + plo;
      const int k = ceil_percent(c[L], p);
      n[L] = k < c[L] ? k : c[L];
    }
    group_threshold(w, row, hw, G, n, thr);
    w.sync();   // the group's scores, for a fence's gather
    for (int L = w.lo; L < w.hi; ++L) {
      if (env[L] < 0 || n[L] == 0) continue;
      int8_t* m = smap + env[L] * hw;
      const uint32_t* r = row[L];
      for (int cell = L % G; cell < hw; cell += G) {
        if (cell == acell[L]) continue;
        bool hit = false;
        if (kind == EDIT_FILL) {
          hit = r[cell] < thr[L];
        } else if (m[cell] == 0) {
          const int rr = cell / h, cc = cell % h;
          for (int dr = -1; dr <= 1; ++dr)
            for (int dc = -1; dc <= 1; ++dc) {
              const int r2 = rr + dr, c2 = cc + dc;
              hit = hit || (r2 >= 0 && r2 < h && c2 >= 0 && c2 < h &&
                            r[r2 * h + c2] < thr[L]);
            }
        }
        if (hit) m[cell] = (int8_t)to;
      }
    }
    w.sync();
  }
}

// Reset the maps and inventories of the envs of `mask` (bit e: env b0 + e
// of the warp, map smap + e*hw, inventory sinv + e*ni) with the counter RNG
// at ctr: reset_env's result bit for bit (each env's lane sets its fresh
// registers from reset_draw).  Groups of G lanes take one env each, in as
// many passes as the groups need; the edits (NOV) use one row of hw words of
// `score` a group, so `score` holds 32 / lanes rows.  Starts and ends with a
// sync.  Out of line on the card: inlined into the T loop, its registers
// pushed the step's loop invariants into local memory.
template <bool NOV, class W>
NGX_CALL void warp_reset(const W w, const int* tab, int8_t* smap, int* sinv,
                         uint32_t* score, unsigned mask, int lanes, int seed,
                         int block, int b0, uint32_t ctr) {
  const int* hd = tab;
  const int h = hd[tb::H], hw = h * h, ni = hd[tb::I];
  const int* int_flat = tab + hd[tb::O_INT_FLAT];
  const int* base = tab + hd[tb::O_BASE];
  const int* place = tab + hd[tb::O_PLACE];
  const int k = popc32(mask);
  int groups = 1;
  while (groups < k) groups <<= 1;
  int G = 32 / groups;
  G = G < lanes ? lanes : G;
  groups = 32 / G;
  w.sync();
  for (unsigned todo = mask; todo;) {
    const unsigned cur = low_bits(todo, groups);   // this pass's envs
    todo &= ~cur;
    const int kc = popc32(cur);
    // lane L works on the (L / G)-th env of cur, cells L % G, L % G + G, ...
    Lanes<int, W::N> env, acell, facing;
    Lanes<uint32_t, W::N> sd, rw;
    for (int L = w.lo; L < w.hi; ++L) {
      const int g = L / G;
      env[L] = g < kc ? low_bit(low_bits(cur, g + 1) & ~low_bits(cur, g)) : -1;
      acell[L] = facing[L] = 0;
      if (env[L] < 0) continue;
      env_stream(seed, block, b0 + env[L], sd[L], rw[L]);
      reset_draw(hd, tab, sd[L], ctr, rw[L], acell[L], facing[L]);
      int8_t* m = smap + env[L] * hw;
      for (int cell = L % G; cell < hw; cell += G) m[cell] = (int8_t)base[cell];
    }
    w.sync();
    // each placement: the first maximum of u over the valid cells (cell and
    // its 4 neighbours air, interior, not the agent's), after the writes of
    // the placements before it
    for (int j = 0; j < hd[tb::NPLACE]; ++j) {
      Lanes<Key, W::N> key;
      for (int L = w.lo; L < w.hi; ++L) {
        key[L] = 0;
        if (env[L] < 0) continue;
        const int8_t* m = smap + env[L] * hw;
        for (int cell = L % G; cell < hw; cell += G) {
          if (!int_flat[cell] || cell == acell[L] || m[cell] != 0 ||
              m[cell - 1] != 0 || m[cell + 1] != 0 || m[cell - h] != 0 ||
              m[cell + h] != 0)
            continue;
          const Key kk = first_max_key(
              rng_bits(sd[L], ctr, SALT_PLACE0 + j, rw[L], cell) >> 8, cell);
          key[L] = kk > key[L] ? kk : key[L];
        }
      }
      w.group_max(key, G);
      for (int L = w.lo; L < w.hi; ++L)
        if (env[L] >= 0 && L % G == 0 && key[L])
          smap[env[L] * hw + first_max_index(key[L])] = (int8_t)place[j];
      w.sync();
    }
    // v3's wall coin, onto air in front of the agent
    if (hd[tb::WALL_COIN]) {
      for (int L = w.lo; L < w.hi; ++L) {
        if (env[L] < 0 || L % G) continue;
        const int fcell = acell[L] + face_dr(facing[L]) * h + face_dc(facing[L]);
        int8_t* m = smap + env[L] * hw;
        if ((rng_bits(sd[L], ctr, SALT_COIN, rw[L], 0) >> 31) && m[fcell] == 0)
          m[fcell] = (int8_t)hd[tb::WALL];
      }
      w.sync();
    }
    // Pogostick-v0's tap: the first maximum over the direction-major
    // [4*HW] scores of air cells (not the agent's) one step from a tree
    if (hd[tb::PLACE_TAP]) {
      Lanes<Key, W::N> key;
      for (int L = w.lo; L < w.hi; ++L) {
        key[L] = 0;
        if (env[L] < 0) continue;
        const int8_t* m = smap + env[L] * hw;
        for (int d = 0; d < 4; ++d) {
          for (int cell = L % G; cell < hw; cell += G) {
            const int tr = cell / h - face_dr(d), tc = cell % h - face_dc(d);
            if (m[cell] != 0 || cell == acell[L] || tr < 0 || tr >= h ||
                tc < 0 || tc >= h || m[tr * h + tc] != hd[tb::TREE])
              continue;
            const Key kk = first_max_key(
                rng_bits(sd[L], ctr, SALT_TAP0 + d, rw[L], cell) >> 8,
                d * hw + cell);
            key[L] = kk > key[L] ? kk : key[L];
          }
        }
      }
      w.group_max(key, G);
      for (int L = w.lo; L < w.hi; ++L)
        if (env[L] >= 0 && L % G == 0 && key[L])
          smap[env[L] * hw + first_max_index(key[L]) % hw] = (int8_t)hd[tb::RESET_TAP];
      w.sync();
    }
    if (NOV && hd[tb::NEDIT] > 0)
      group_edits(w, tab, smap, score, G, env, acell, sd, rw, ctr);
    // the inventory, every G-th item a lane
    const int* lo = tab + hd[tb::O_INV_LO];
    const int* span = tab + hd[tb::O_INV_SPAN];
    const int* set = tab + hd[tb::O_INV_SET];
    for (int L = w.lo; L < w.hi; ++L) {
      if (env[L] < 0) continue;
      int* inv = sinv + env[L] * ni;
      for (int i = L % G; i < ni; i += G) {
        int v = lo[i];
        if (hd[tb::RANDOM_INV])
          v += (int)((rng_bits(sd[L], ctr, SALT_INV, rw[L], i) >> 1) % (uint32_t)span[i]);
        inv[i] = set[i] >= 0 ? set[i] : v;
      }
    }
    w.sync();
  }
}

#if defined(__CUDACC__)

static inline cudaError_t smem_budget(size_t& optin) {
  int dev = 0, v = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  optin = (size_t)v;
  return e;
}

// The checks and the shared-memory layout of a tile-MLP launch: E a positive
// multiple of 4, E <= N <= 256, the weights 16-byte aligned and as many as
// the widths need.
static inline cudaError_t tile_launch_layout(
    int n_tab, const int* dims, int n_dims, int envs, int threads, int hw,
    int n_items, bool obs_stage, const float* params, int n_params,
    TileLayout& L) {
  if (envs < 4 || envs % 4 || threads < envs || threads > 256 || n_dims < 2 ||
      !dims || !params || reinterpret_cast<uintptr_t>(params) % 16)
    return cudaErrorInvalidValue;
  size_t optin = 0;
  cudaError_t e = smem_budget(optin);
  if (e != cudaSuccess) return e;
  if (!tile_layout(n_tab, dims, n_dims, envs, hw, n_items, obs_stage, optin, L) ||
      L.n_params != n_params)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

#endif  // __CUDACC__
