// The env device code shared by the port's CUDA kernels (train_rollout.cu,
// rollout.cu): the murmur3 counter RNG, the spec-table accessors, the
// counter-RNG reset, the env step, the LidarInFront obs, the tanh MLP and the
// Gumbel-argmax sample.  Each function is the per-env counterpart of the
// plain PyTorch code named beside it, and the kernels call them with one
// thread per env.
//
// The functions are __host__ __device__: g++ builds this file for the host
// (tests/test_torch_train_rollout.py, tests/test_torch_rollout.py), so the CPU
// tests hold the device code against the plain twins.  Launch code stays
// behind __CUDACC__ in the .cu files.
//
// Parity hazards: uint32 arithmetic is native here (the twins mask int64);
// logf and tanhf are the IEEE functions (no -use_fast_math), but the MLP sums
// in another order than torch's matmul, so a policy action can differ from
// the twin's only at a near-tie of the top two Gumbel scores.

#pragma once

#include <cstdint>
#include <cmath>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define NGX_HD __host__ __device__ __forceinline__
#else
#define NGX_HD inline
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

NGX_HD float tab_farr(const int* tab, int off_slot, int idx) {
  return tab_f(tab, tab[off_slot] + idx);
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

// The score threshold below which exactly min(n, count) eligible cells lie
// (_select_n_uniform): 30 halvings of [0, 2^30) on the integer score, as the
// TPU kernel bisects; the scores are distinct, so the set is the n smallest.
NGX_HD uint32_t edit_threshold(const int8_t* m, int hw, int kind, int from,
                               int wall, int n, uint32_t seed, uint32_t ctr,
                               uint32_t salt, uint32_t row, int lane) {
  uint32_t lo = 0, hi = 1u << 30;
  for (int it = 0; it < 30; ++it) {
    const uint32_t mid = (lo + hi) / 2;
    int c = 0;
    for (int cell = 0; cell < hw; ++cell)
      c += edit_eligible(kind, from, wall, m[cell]) &&
           edit_score(seed, ctr, salt, row, cell, lane) < mid;
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
    const uint32_t thr = edit_threshold(m, hw, kind, from, wall, n, seed, ctr,
                                        salt + 1, row, lane);
    if (kind == EDIT_FILL) {
      // a write changes only its own cell, which is not read again
      for (int cell = 0; cell < hw; ++cell)
        if (cell != acell && edit_eligible(kind, from, wall, m[cell]) &&
            edit_score(seed, ctr, salt + 1, row, cell, lane) < thr)
          m[cell] = (int8_t)to;
    } else {
      // mark the centers, then write each one's 3x3 block onto air that is
      // not the agent's cell (add_fence_around, pogostick_v1_env.py:524-536);
      // a center is not air, so the writes never touch a mark
      for (int cell = 0; cell < hw; ++cell)
        if (edit_eligible(kind, from, wall, m[cell]) &&
            edit_score(seed, ctr, salt + 1, row, cell, lane) < thr)
          m[cell] = (int8_t)(m[cell] | CENTER_MARK);
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
template <bool NOV>
NGX_HD void step_env(const int* tab, int8_t* m, int* inv, Regs& s, int a,
                     float& reward, bool& done) {
  const int h = tab[tb::H], ni = tab[tb::I];
  const int op = tab[tab[tb::O_OP] + a], arg = tab[tab[tb::O_ARG] + a];
  const int DR[4] = {-1, 1, 0, 0}, DC[4] = {0, 0, -1, 1};
  const int LEFT[4] = {2, 3, 1, 0}, RIGHT[4] = {3, 2, 0, 1};
  const int fr = s.r + DR[s.facing], fc = s.c + DC[s.facing];
  const bool front_in = fr >= 0 && fr < h && fc >= 0 && fc < h;
  const int front = read_cell(m, h, fr, fc);

  const bool is_fwd = op == OP_FORWARD, fwd_ok = front == 0;
  // jump (novelty_wrappers.py:1360-1382): two cells ahead when that cell is
  // in the map and air; the cell between is not checked
  const bool is_jump = NOV && op == OP_JUMP;
  const int jr = fr + DR[s.facing], jc = fc + DC[s.facing];
  const bool jump_ok = jr >= 0 && jr < h && jc >= 0 && jc < h && m[jr * h + jc] == 0;

  // break, with the fence gate and the axe (step.py:271-316)
  const bool is_break = op == OP_BREAK;
  const bool breakable = front != 0 && !tab[tab[tb::O_UNBREAK] + front];
  const int fmode = NOV ? tab[tb::FENCE_MODE] : (int)FENCE_NONE;
  const int fid = tab[tb::FENCE_ID];
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
  const int amode = NOV ? tab[tb::AXE_MODE] : (int)AXE_NONE;
  const int axe = tab[tb::AXE_ID];
  // the axe in the inventory AND selected (novelty_wrappers.py:56,67)
  const bool axe_sel = amode != AXE_NONE && inv[axe] >= 1 && s.selected == axe;
  const bool break_ok =
      breakable && !fence_blocked && (amode != AXE_REQUIRED || axe_sel);
  const bool is_chop = NOV && op == OP_CHOP;   // a break that yields 2 (:1288-1307)

  const int adj = tab[tb::ADJ_ITEM];
  const bool next_to_tree =
      read_cell(m, h, fr - 1, fc) == adj || read_cell(m, h, fr + 1, fc) == adj ||
      read_cell(m, h, fr, fc - 1) == adj || read_cell(m, h, fr, fc + 1) == adj;
  const int arg_i = arg < 0 ? 0 : (arg > ni - 1 ? ni - 1 : arg);
  const bool have_arg = inv[arg_i] >= 1;
  const bool is_place = op == OP_PLACE, place_ok = have_arg && front == 0;
  const bool is_exr = op == OP_EXTRACT_RUBBER;
  const bool exr_at_tap = front == tab[tb::EXTRACT_SRC];
  const bool exr_ok = exr_at_tap && next_to_tree;
  const bool is_exs = op == OP_EXTRACT_STRING;
  const bool exs_ok = front == tab[tb::EXTRACT_SRC];
  const bool is_select = op == OP_SELECT, sel_ok = have_arg;

  // fused place+extract (novel_gridworld_v4_env.py:277-305): places the tap
  // when none is on the map, extracts when one is
  const bool is_fused = op == OP_FUSED_PLACE_EXTRACT;
  const int tap_i = tab[tb::TAP_I];
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
  if (tab[tb::HAS_CRAFT]) {
    rec = arg < 0 ? 0 : (arg > tab[tb::R] - 1 ? tab[tb::R] - 1 : arg);
    need = tab + tab[tb::O_RIN] + rec * ni;
    rout = tab + tab[tb::O_ROUT] + rec * ni;
    bool have_all = true;
    for (int i = 0; i < ni; ++i) have_all = have_all && inv[i] >= need[i];
    const bool multi = tab[tab[tb::O_RMULTI] + rec] != 0;
    const bool at_table = front == tab[tb::TABLE_ID];
    bool missing;
    if (tab[tb::CRAFT_VARIANT] == CRAFT_MODERN) {
      missing = !have_all;
      craft_notable = have_all && multi && !at_table;
    } else if (tab[tb::CRAFT_VARIANT] == CRAFT_LEGACY_TABLE_FIRST) {
      craft_notable = multi && !at_table;   // the table check first
      missing = !craft_notable && !have_all;
    } else {                                // no table requirement (v2)
      missing = !have_all;
    }
    craft_ok = !missing && !craft_notable;
    const int pl = tab[tb::PLANK_I];
    if (tab[tb::CRAFT_NAG] == NAG_V2)       // plank after consuming (v2:306-323)
      nag = rec == tab[tb::STICK_R] && inv[pl] + rout[pl] - need[pl] < 8;
    else if (tab[tb::CRAFT_NAG] == NAG_V4)  // before consuming (v4:398-405)
      nag = (rec == tab[tb::STICK_R] && inv[pl] < 8) ||
            (rec == tab[tb::TAP_R] && inv[tab[tb::STICK_I]] < 8);
  }

  // every condition above read the pre-step map and inventory; now write
  const bool write_break =
      (is_break && break_ok) || (is_chop && breakable) || (is_exs && exs_ok);
  const bool write_place = (is_place && place_ok) || (is_fused && fused_place);
  if (front_in && (write_break || write_place))
    m[fr * h + fc] = (int8_t)(write_break ? 0 : (is_fused ? tap_i : arg));
  if (is_break && break_ok)
    inv[front] += amode != AXE_NONE ? (axe_sel && tab[tb::AXE_BI] ? 2 : 1)
                                    : tab[tab[tb::O_BYIELD] + front];
  if (is_chop && breakable) inv[front] += 2;
  // the crate grants its contents whenever Break targets it, before the
  // break resolves (novelty_wrappers.py:1085-1088)
  if (NOV && is_break && tab[tb::CRATE_ID] >= 0 && front == tab[tb::CRATE_ID]) {
    const int* crate = tab + tab[tb::O_CRATE];
    for (int i = 0; i < ni; ++i) inv[i] += crate[i];
  }
  if (is_place && place_ok) inv[arg_i] -= 1;
  if (is_exr && exr_ok) inv[tab[tb::RUBBER]] += tab[tb::EXTRACT_AMOUNT];
  if (is_exs && exs_ok && tab[tb::EXTRACT_YIELD] >= 0)
    inv[tab[tb::EXTRACT_YIELD]] += tab[tb::EXTRACT_AMOUNT];
  if (is_fused && (fused_place || fused_extract)) inv[tab[tb::RUBBER]] += 1;
  if (is_fused && fused_place) inv[tap_i] -= 1;
  if (is_craft && craft_ok)
    for (int i = 0; i < ni; ++i) inv[i] += rout[i] - need[i];

  const float r_step = tab_f(tab, tb::F_REWARD_STEP);
  const float r_inter = tab_f(tab, tb::F_REWARD_INTER);
  float rw = r_step;
  // with an axe novelty: +10 with the axe selected on any breakable, the
  // step reward without it (novelty_wrappers.py:45-84)
  if (is_break && break_ok)
    rw = amode != AXE_NONE ? (axe_sel ? r_inter : r_step) : tab_farr(tab, tb::O_BREW, front);
  if (is_chop && breakable) rw = r_inter;
  if (is_place && place_ok && next_to_tree) rw = r_inter;
  if (is_exr && exr_ok) rw = r_inter;
  if (is_exs && exs_ok) rw = r_inter;
  if (is_craft) rw = craft_ok && !nag ? tab_f(tab, tb::F_CRAFT_SUCCESS) : r_step;
  if (is_fused && fused_place) rw = 20.0f;
  if (is_fused && fused_extract) rw = 15.0f;

  const bool result = !((is_fwd && !fwd_ok) || (is_jump && !jump_ok) ||
                        (is_break && !break_ok) || (is_chop && !breakable) ||
                        (is_place && !place_ok) || (is_exr && !exr_ok) ||
                        (is_exs && !exs_ok) || (is_craft && !craft_ok) ||
                        (is_select && !sel_ok));
  float cost = result ? tab_farr(tab, tb::O_COST_OK, a) : tab_farr(tab, tb::O_COST_FAIL, a);
  if (tab[tb::HAS_BREAK] && is_break)   // the axe discount only on its success
    cost = axe_sel && break_ok ? tab_f(tab, tb::F_AXE_COST) : tab_f(tab, tb::F_BREAK_COST);
  if (tab[tb::HAS_CRAFT] && is_craft)
    cost = craft_ok ? tab_farr(tab, tb::O_CC_OK, rec)
                    : (craft_notable ? tab_farr(tab, tb::O_CC_NOTAB, rec)
                                     : tab_farr(tab, tb::O_CC_MISS, rec));
  // the fence restriction's tail: every break it lets through costs the
  // break cost and two steps, even where the inner break failed
  // (novelty_wrappers.py:930,950-984)
  int step_inc = 1;
  if (fmode != FENCE_NONE && is_break && breakable && !fence_blocked) {
    cost = tab_f(tab, tb::F_BREAK_COST);
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
  if (op == OP_LEFT) s.facing = LEFT[s.facing];
  if (op == OP_RIGHT) s.facing = RIGHT[s.facing];
  if (is_select && sel_ok) s.selected = arg;

  // grab-entities (pogostick_v1_env.py:538-554): every entity in the 3x3
  // around the agent's new cell moves to the inventory
  if (NOV && tab[tb::HAS_GRAB]) {
    const int* ent = tab + tab[tb::O_ENTITY];
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
  if (tab[tb::GOAL_FRONT_MODE]) {
    goal_met = read_cell(m, h, s.r + DR[s.facing], s.c + DC[s.facing]) ==
               tab[tb::GOAL_FRONT];
  } else {
    const int* goal = tab + tab[tb::O_GOAL];
    bool all_met = true, any_met = false;
    for (int i = 0; i < ni; ++i) {
      if (goal[i] > 0) {
        all_met = all_met && inv[i] >= goal[i];
        any_met = any_met || inv[i] >= goal[i];
      }
    }
    goal_met = tab[tb::GOAL_ANY] ? any_met : all_met;
  }
  if (goal_met) rw = tab_f(tab, tb::F_REWARD_DONE);
  bool d = goal_met;
  // dead end (novel_gridworld_v2_env.py:263-266): no dead-end recipe is
  // craftable from the post-step inventory
  if (tab[tb::HAS_DEADEND] && !goal_met) {
    const int* dead = tab + tab[tb::O_DEADEND];
    bool craftable = false;
    for (int q = 0; q < tab[tb::R]; ++q) {
      if (!dead[q]) continue;
      const int* rin = tab + tab[tb::O_RIN] + q * ni;
      bool ok = true;
      for (int i = 0; i < ni; ++i) ok = ok && inv[i] >= rin[i];
      craftable = craftable || ok;
    }
    d = !craftable;
  }
  // the fire-wall death, after everything (novelty_wrappers.py:1171-1189)
  const int fire = NOV ? tab[tb::FIRE_ITEM] : -1;
  if (fire >= 0 && (read_cell(m, h, s.r - 1, s.c) == fire ||
                    read_cell(m, h, s.r + 1, s.c) == fire ||
                    read_cell(m, h, s.r, s.c - 1) == fire ||
                    read_cell(m, h, s.r, s.c + 1) == fire)) {
    rw = tab_f(tab, tb::F_FIRE_REWARD);
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
// Writes the obs to x[k * xs] (the MLP input column) and, when orow is not
// null, to orow[k].
NGX_HD void lidar_obs(const int* tab, const int8_t* m, const int* inv,
                      const Regs& s, float* x, int xs, float* orow) {
  const int h = tab[tb::H], nb = tab[tb::NB], kr = tab[tb::K], ns = tab[tb::NSLOT];
  const int* beams = tab + tab[tb::O_BEAMS] + s.facing * nb * kr * 2;
  const int* slot = tab + tab[tb::O_SLOT];
  for (int b = 0; b < nb; ++b) {
    int dist = 0, hv = 0;
    for (int k = 0; k < kr; ++k) {
      int rr = s.r + beams[(b * kr + k) * 2];
      int cc = s.c + beams[(b * kr + k) * 2 + 1];
      rr = rr < 0 ? 0 : (rr > h - 1 ? h - 1 : rr);
      cc = cc < 0 ? 0 : (cc > h - 1 ? h - 1 : cc);
      const int v = m[rr * h + cc];
      if (v != 0) {
        dist = k + 1;
        hv = v;
        break;
      }
    }
    const int sl = dist > 0 ? slot[hv] : -1;
    for (int q = 0; q < ns; ++q) {
      const float val = q == sl ? (float)dist : 0.0f;
      x[(b * ns + q) * xs] = val;
      if (orow) orow[b * ns + q] = val;
    }
  }
  const int* keep = tab + tab[tb::O_KEEP];
  for (int i = 0; i < tab[tb::NKEEP]; ++i) {
    const float val = (float)inv[keep[i]];
    x[(nb * ns + i) * xs] = val;
    if (orow) orow[nb * ns + i] = val;
  }
}

// ---- one dense layer over a column: y = act(W x + b), W [dout, din] ------
NGX_HD void dense(const float* W, const float* bias, int din, int dout,
                  const float* x, float* y, int xs, bool act) {
  for (int j0 = 0; j0 < dout; j0 += 8) {
    float acc[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[jj] = j0 + jj < dout ? bias[j0 + jj] : 0.0f;
    for (int k = 0; k < din; ++k) {
      const float xk = x[k * xs];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        if (j0 + jj < dout) acc[jj] = fmaf(W[(j0 + jj) * din + k], xk, acc[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      if (j0 + jj < dout) y[(j0 + jj) * xs] = act ? tanhf(acc[jj]) : acc[jj];
  }
}

// ---- Gumbel-argmax (pallas_rollout.py:965-970) ---------------------------
NGX_HD int gumbel_argmax(const float* logits, int xs, int na, uint32_t seed,
                         uint32_t ctr, uint32_t row) {
  int best = 0;
  float best_s = -INFINITY;
  for (int a = 0; a < na; ++a) {
    const float u = rng_u01(seed, ctr, SALT_ACTION, row, a);
    const float g = logf(-logf(u + 1e-10f) + 1e-10f);
    const float sc = logits[a * xs] - g;
    if (sc > best_s) {   // strict: the first maximum wins, the min index
      best_s = sc;
      best = a;
    }
  }
  return best;
}

// ---- the policy's action at counter ctr ----------------------------------
// LidarInFront obs -> tanh MLP (the tab's O_DIMS widths, params laid out
// [W0, b0, W1, b1, ...]) -> Gumbel-argmax with salt 5.  buf0 and buf1 are
// the two activation columns of stride xs; orow takes the obs row, or null.
NGX_HD int policy_act(const int* tab, const float* params, const int8_t* m,
                      const int* inv, const Regs& s, float* buf0, float* buf1,
                      int xs, float* orow, uint32_t seed, uint32_t ctr,
                      uint32_t row) {
  const int* dims = tab + tab[tb::O_DIMS];
  lidar_obs(tab, m, inv, s, buf0, xs, orow);
  const float* w = params;
  float* in = buf0;
  float* out = buf1;
  for (int l = 0; l <= tab[tb::NH]; ++l) {
    const int din = dims[l], dout = dims[l + 1];
    dense(w, w + din * dout, din, dout, in, out, xs, l < tab[tb::NH]);
    w += din * dout + dout;
    float* tmp = in;
    in = out;
    out = tmp;
  }
  return gumbel_argmax(in, xs, tab[tb::A], seed, ctr, row);
}

#if defined(__CUDACC__)

// Dynamic shared memory of one thread block: the table buffer, the policy
// weights where they fit, then each thread's inventory (int32) and map
// (int8, item ids are below 32).
struct SmemLayout {
  size_t off_params, off_inv, off_map, bytes;
  int params_in_smem;
};

static inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

static inline cudaError_t smem_layout(int n_tab, int n_params, int threads,
                                      int n_items, int hw, SmemLayout& L) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const size_t per_block = align16((size_t)threads * n_items * 4) + (size_t)threads * hw;
  size_t off = align16((size_t)n_tab * 4);
  L.off_params = off;
  L.params_in_smem = off + align16((size_t)n_params * 4) + per_block <= (size_t)optin;
  if (L.params_in_smem) off += align16((size_t)n_params * 4);
  L.off_inv = off;
  off += align16((size_t)threads * n_items * 4);
  L.off_map = off;
  off += (size_t)threads * hw;
  L.bytes = off;
  return off > (size_t)optin ? cudaErrorInvalidValue : cudaSuccess;
}

// Copy the table (and the weights, where they fit) into shared memory and
// point this thread at its map and inventory.
__device__ __forceinline__ void block_setup(
    unsigned char* smem, const int* tab, int n_tab, const float* params,
    int n_params, int params_in_smem, size_t off_params, size_t off_inv,
    size_t off_map, const int*& s_tab, const float*& s_params, int*& inv,
    int8_t*& m) {
  int* t = reinterpret_cast<int*>(smem);
  float* p = reinterpret_cast<float*>(smem + off_params);
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) t[i] = tab[i];
  if (params_in_smem)
    for (int i = threadIdx.x; i < n_params; i += blockDim.x) p[i] = params[i];
  __syncthreads();
  s_tab = t;
  s_params = params_in_smem ? p : params;
  inv = reinterpret_cast<int*>(smem + off_inv) + threadIdx.x * t[tb::I];
  m = reinterpret_cast<int8_t*>(smem + off_map) + threadIdx.x * t[tb::H] * t[tb::H];
}

#endif  // __CUDACC__
