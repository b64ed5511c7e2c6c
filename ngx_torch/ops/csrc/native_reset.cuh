// ngx's native reset on jax.random's keys (ngx/core/reset.py:30-221; the
// plain twin is native_reset_plain in ngx_torch/core/reset.py), one row at a
// time on a warp: the device code of native_reset.cu.
//
// The functions are __host__ __device__: g++ builds this file for the host
// (tests/test_torch_native_reset_kernel.py), where a HostWarp runs the 32
// lanes of each phase in turn, so the CPU tests hold the device code against
// the plain twin bit for bit.
//
// A row's draws, in ngx's order: split(key, 7); the agent's cell and facing
// (randint); one categorical a placement over the free cells, on
// split(k_items, n); the random start inventory (randint, per-item bounds);
// v3's wall coin (bernoulli 0.5); Pogostick-v0's tap over the direction-major
// [4, HW] planes; each percent-fill edit on fold_in(k_edits, j); the start
// inventory's grants.  Threefry2x32 is native uint32 arithmetic here (the
// twin masks int64), randint's products wrap in uint32 as jax's do, and no
// float is computed:
//   * a categorical over a 0 / -inf mask is the first cell of maximal
//     `bits >> 9` among the unmasked ones: the Gumbel score is strictly
//     increasing in the uniform, which is (bits >> 9) / 2^23 (ops/threefry.py
//     proves it by exhaustion), so a placement is a first-maximum key
//     (first_max_key) reduced over the warp, and a row with no free cell
//     keeps its map;
//   * bernoulli(0.5) is `bits >> 31 == 0`;
//   * an edit's stable argsort of uniform scores ranks the eligible cells by
//     (bits >> 9, cell): its n smallest are the cells below the least
//     threshold that n keys lie under, found by bisection over the keys'
//     23 + LANE_BITS bits, each step one count over the warp (as
//     group_threshold bisects the counter reset's scores).
//
// What bounds it: each row's serial chain of hashes.  A reset is a few
// hundred threefry blocks (a block is about 80 integer operations) over
// a map of HW cells, so the card is far from its integer and byte peaks;
// one launch replaces the plain twin's ~3,000 small ones.  The design: a
// warp a row, lanes striding the cells, the row's int32 map and its edit
// keys in shared memory; the work is fixed a row and the grid is the row
// count, so one geometry serves B = 1 to 8,192.

#pragma once

#include "threefry.cuh"

// ---- the rows of a batch ---------------------------------------------------
// The leaves of an EnvState batch (ngx_torch/core/state.py), in field order.
struct StateRows {
  int* map;
  int* agent;
  int* facing;
  int* inventory;
  int* selected;
  int* step_count;
  int* last_action;
  float* last_reward;
  float* last_cost;
  unsigned char* last_done;
};

NGX_HD StateRows state_rows(void* const* p) {
  return StateRows{static_cast<int*>(p[0]),   static_cast<int*>(p[1]),
                   static_cast<int*>(p[2]),   static_cast<int*>(p[3]),
                   static_cast<int*>(p[4]),   static_cast<int*>(p[5]),
                   static_cast<int*>(p[6]),   static_cast<float*>(p[7]),
                   static_cast<float*>(p[8]), static_cast<unsigned char*>(p[9])};
}

// A launch over n rows.  Row b's key is keys[b] ([n, 2], the words of
// jax.random.key_data), or, where keys is null, split(parent, N)[b +
// offset] for any N past it.  With done ([n]) the kernel writes the carried
// state of a step: row b of `in` where done[b] is 0, else its reset; with
// no done every row resets and `in` is unread.
struct NativeResetArgs {
  const int* tab;
  int n, hw, ni;
  const long long* keys;
  const long long* parent;
  long long offset;
  const unsigned char* done;
  StateRows in, out;
};

// The shared memory of one row: its edit keys, then its map.
NGX_HD size_t native_reset_row_bytes(int hw) {
  return align16((size_t)hw * (sizeof(unsigned long long) + sizeof(int)));
}

template <class W>
NGX_HD void copy_row(const W& w, const NativeResetArgs& p, long long row) {
  const StateRows &a = p.in, &o = p.out;
  for (int L = w.lo; L < w.hi; ++L) {
    for (int c = L; c < p.hw; c += 32) o.map[row * p.hw + c] = a.map[row * p.hw + c];
    for (int i = L; i < p.ni; i += 32)
      o.inventory[row * p.ni + i] = a.inventory[row * p.ni + i];
    if (L == 0) {
      o.agent[2 * row] = a.agent[2 * row];
      o.agent[2 * row + 1] = a.agent[2 * row + 1];
      o.facing[row] = a.facing[row];
      o.selected[row] = a.selected[row];
      o.step_count[row] = a.step_count[row];
      o.last_action[row] = a.last_action[row];
      o.last_reward[row] = a.last_reward[row];
      o.last_cost[row] = a.last_cost[row];
      o.last_done[row] = a.last_done[row];
    }
  }
}

// Row `row` of the launch on warp w: a copy where the row is not done, else
// the native reset of its key into p.out.  `m` (hw ints) and `ks` (hw keys)
// are the row's shared memory.  The branches are uniform over the warp.
template <class W>
NGX_HD void native_reset_row(const W& w, const NativeResetArgs& p, long long row,
                             int* m, unsigned long long* ks) {
  if (p.done && !p.done[row]) {
    copy_row(w, p, row);
    return;
  }
  const int* tab = p.tab;
  const int h = tab[tb::H], hw = p.hw, ni = p.ni;
  const int wall = tab[tb::WALL];
  const TfKey key =
      p.keys ? TfKey{(uint32_t)p.keys[2 * row], (uint32_t)p.keys[2 * row + 1]}
             : tf_child(TfKey{(uint32_t)p.parent[0], (uint32_t)p.parent[1]},
                        (unsigned long long)(row + p.offset));
  // split(key, 7): agent, facing, items, inventory, coin, tap, edits
  const int acell = tab[tab[tb::O_INT_IDS] +
                        tf_randint(tf_child(key, 0), 0, 0, tab[tb::NINT])];
  const int facing = tf_randint(tf_child(key, 1), 0, 0, 4);
  const int* base = tab + tab[tb::O_BASE];
  for (int L = w.lo; L < w.hi; ++L)
    for (int c = L; c < hw; c += 32) m[c] = base[c];
  w.sync();

  // each placement: the first maximal uniform over the free cells (the cell
  // and its 4 neighbours air, interior, not the agent's), after the writes
  // of the placements before it
  const int* int_flat = tab + tab[tb::O_INT_FLAT];
  const int* place = tab + tab[tb::O_PLACE];
  const TfKey k_items = tf_child(key, 2);
  for (int j = 0; j < tab[tb::NPLACE]; ++j) {
    const TfKey kj = tf_child(k_items, (unsigned)j);
    Lanes<Key, W::N> best;
    for (int L = w.lo; L < w.hi; ++L) {
      best[L] = 0;
      for (int c = L; c < hw; c += 32) {
        if (!int_flat[c] || c == acell || m[c] != 0 || m[c - 1] != 0 ||
            m[c + 1] != 0 || m[c - h] != 0 || m[c + h] != 0)
          continue;
        const Key k = first_max_key(tf_bits(kj, (uint32_t)c) >> 9, c);
        best[L] = k > best[L] ? k : best[L];
      }
    }
    w.group_max(best, 32);
    for (int L = w.lo; L < w.hi; ++L)
      if (L == 0 && best[L]) m[first_max_index(best[L])] = place[j];
    w.sync();
  }

  // v3's wall coin, onto air in front of the agent (reset.py:132-137)
  if (tab[tb::WALL_COIN]) {
    for (int L = w.lo; L < w.hi; ++L) {
      const int f = acell + face_dr(facing) * h + face_dc(facing);
      if (L == 0 && (tf_bits(tf_child(key, 4), 0) >> 31) == 0 && m[f] == 0)
        m[f] = wall;
    }
    w.sync();
  }

  // Pogostick-v0's tap: the first maximum over the direction-major [4, HW]
  // air cells (not the agent's) one step from a tree
  if (tab[tb::PLACE_TAP]) {
    const TfKey k_tap = tf_child(key, 5);
    Lanes<Key, W::N> best;
    for (int L = w.lo; L < w.hi; ++L) {
      best[L] = 0;
      for (int d = 0; d < 4; ++d)
        for (int c = L; c < hw; c += 32) {
          const int tr = c / h - face_dr(d), tc = c % h - face_dc(d);
          if (m[c] != 0 || c == acell || tr < 0 || tr >= h || tc < 0 ||
              tc >= h || m[tr * h + tc] != tab[tb::TREE])
            continue;
          const int idx = d * hw + c;
          const Key k = first_max_key(tf_bits(k_tap, (uint32_t)idx) >> 9, idx);
          best[L] = k > best[L] ? k : best[L];
        }
    }
    w.group_max(best, 32);
    for (int L = w.lo; L < w.hi; ++L)
      if (L == 0 && best[L]) m[first_max_index(best[L]) % hw] = tab[tb::RESET_TAP];
    w.sync();
  }

  // the percent-fill edits in injection order (reset.py:248-290): edit j on
  // k = fold_in(k_edits, j), its percent randint(split(k)[0]) and its cells
  // the n smallest (uniform, cell) of split(k)[1] among the eligible ones;
  // the agent's cell is never written, and a fence writes the air cells of
  // its centres' 3x3 blocks
  const int* edits = tab + tab[tb::O_EDITS];
  const int lane_bits = tab[tb::LANE_BITS];
  const TfKey k_edits = tf_child(key, 6);
  for (int j = 0; j < tab[tb::NEDIT]; ++j) {
    const int kind = edits[5 * j], from = edits[5 * j + 1], to = edits[5 * j + 2];
    const TfKey ke = tf_child(k_edits, (unsigned)j);
    const TfKey k_shuf = tf_child(ke, 1);
    Lanes<int, W::N> cnt;
    for (int L = w.lo; L < w.hi; ++L) {
      cnt[L] = 0;
      for (int c = L; c < hw; c += 32) {
        const bool ok = edit_eligible(kind, from, wall, m[c]);
        ks[c] = ok ? ((Key)(tf_bits(k_shuf, (uint32_t)c) >> 9) << lane_bits) | (Key)c
                   : ~(Key)0;
        cnt[L] += ok;
      }
    }
    w.group_sum(cnt, 32);
    w.sync();
    const int count = cnt[w.lo];
    const int pct = tf_randint(tf_child(ke, 0), 0, edits[5 * j + 3], edits[5 * j + 4]);
    const int want = ceil_percent(count, pct);
    const int n = want < count ? want : count;
    if (n <= 0) continue;
    // the least t with n keys below it: exactly n, since the keys differ
    Key lo = 0, hi = (Key)1 << (23 + lane_bits);
    while (hi - lo > 1) {
      const Key mid = lo + (hi - lo) / 2;
      Lanes<int, W::N> below;
      for (int L = w.lo; L < w.hi; ++L) {
        below[L] = 0;
        for (int c = L; c < hw; c += 32) below[L] += ks[c] < mid;
      }
      w.group_sum(below, 32);
      if (below[w.lo] >= n)
        hi = mid;
      else
        lo = mid;
    }
    for (int L = w.lo; L < w.hi; ++L)
      for (int c = L; c < hw; c += 32) {
        if (c == acell) continue;
        bool hit = false;
        if (kind == EDIT_FILL) {
          hit = ks[c] < hi;
        } else if (m[c] == 0) {
          const int r = c / h, cc = c % h;
          for (int dr = -1; dr <= 1; ++dr)
            for (int dc = -1; dc <= 1; ++dc) {
              const int r2 = r + dr, c2 = cc + dc;
              hit = hit || (r2 >= 0 && r2 < h && c2 >= 0 && c2 < h &&
                            ks[r2 * h + c2] < hi);
            }
        }
        if (hit) m[c] = to;
      }
    w.sync();
  }

  // the state: the map, the inventory (drawn where its bounds differ, then
  // the start grants) and the registers of a fresh env
  const int* inv_lo = tab + tab[tb::O_INV_LO];
  const int* inv_span = tab + tab[tb::O_INV_SPAN];
  const int* inv_set = tab + tab[tb::O_INV_SET];
  const TfKey k_inv = tf_child(key, 3);
  const StateRows& o = p.out;
  for (int L = w.lo; L < w.hi; ++L) {
    for (int c = L; c < hw; c += 32) o.map[row * hw + c] = m[c];
    for (int i = L; i < ni; i += 32) {
      const int v = tab[tb::RANDOM_INV]
                        ? tf_randint(k_inv, (uint32_t)i, inv_lo[i], inv_lo[i] + inv_span[i])
                        : inv_lo[i];
      o.inventory[row * ni + i] = inv_set[i] >= 0 ? inv_set[i] : v;
    }
    if (L == 0) {
      o.agent[2 * row] = acell / h;
      o.agent[2 * row + 1] = acell % h;
      o.facing[row] = facing;
      o.selected[row] = -1;
      o.step_count[row] = 0;
      o.last_action[row] = 0;
      o.last_reward[row] = 0.0f;
      o.last_cost[row] = 0.0f;
      o.last_done[row] = 0;
    }
  }
  w.sync();
}
