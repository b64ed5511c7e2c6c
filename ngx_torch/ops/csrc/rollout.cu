// The env-stepping rollout, for sm_90a (H100).
//
// Replaces make_pallas_rollout (ngx/ops/pallas_rollout.py:533, kernel body
// :710, call :776) in its three action modes: for every env, the counter-RNG
// reset at ctr 0 of its logical block, then T steps whose actions come from
// the counter RNG ('prng', salt 1), from an input stream ('input', int32
// [T, B]) or from the in-kernel policy ('policy': LidarInFront obs -> tanh
// MLP -> Gumbel-argmax, salt 5), each followed by the env step and, on done,
// the counter-RNG reset at ctr t+1.  It returns the final state and, per
// env, the running float32 sum of the rewards and the count of episode ends.
// There is no episode cap.  The plain twin is rollout_plain in
// ngx_torch/ops/rollout.py; the wrapper rollout there builds this file
// (ngx_torch/ops/_build.py), checks every tensor and launches ngx_rollout.
//
// What bounds it on this card: not bytes.  In 'prng' mode an env step reads
// and writes a few bytes of its map and inventory in shared memory and does
// a few hundred integer ops (the step, one hash for the action); a reset
// hashes every interior cell once per placement.  Nothing goes to device
// memory until the end: the final state (~150 bytes an env).  So the kernel
// is bound by the serial chain of each env's steps, by its resets and by
// how many envs the SMs hold at once, not by a roofline.  'policy' mode adds
// the MLP's multiply-adds (9,280 an env-step at hidden (64, 64)):
// operations bound it on paper.
//
// Design of 'prng' and 'input' (warp_rollout): a warp owns 32 envs, lane e
// stepping env e for all T steps, the maps (int8_t cells, or int16_t past
// 64 item ids: ngx_env.cuh wide_cell) and the inventories (int32) in shared
// memory, the table in shared memory once per block and its
// header slots by value in the constant bank (SpecHdr; 1-2% faster than
// reading them from the shared table, PERF.md).  After each step a ballot
// names the envs it finished and the warp resets them together (ngx_env.cuh
// warp_reset: the placements spread over groups of lanes, the edits' scores
// hashed once, into one shared-memory row of hw scores a reset group); a
// step that finished none costs the vote.  The groups are at least
// `lanes` wide: the caller's floor, doubled where a block would not fit
// (warp_fit), and doubled again where fewer score rows let the SMs hold
// the grid in fewer waves (warp_residency: at B 65,536 on fenced maps, 32
// rows a warp leave 3 blocks an SM and two waves, 16 rows 4 blocks and
// one).  At the end the warp writes its envs' maps, inventories and
// registers as contiguous spans of the outputs, neighbouring lanes on
// neighbouring addresses.  'policy' runs the tile MLP
// of train_rollout.cu (ngx_env.cuh): a block of N threads owns E envs, with
// an env phase, an MLP phase and a score phase over the whole tile, an act
// phase (thread e steps env e) and a reset phase (the block's warps reset
// the envs that the step finished through warp_reset, ngx_env.cuh
// tile_finish) each step (policy_tile).  Both address the RNG stream by the
// LOGICAL block (seed + (e / block) * 7919, row e % block), whatever the
// launch geometry.
//
// Parity hazards (see rollout.py): the reward sum is added step by step in
// float32, as the JAX kernel's fregs[:, 2] + r (:664), so each env's sum is
// bit-exact; the initial state is the ctr-0 reset (:633-636), a boundary at
// step t resets with ctr t+1, and a fresh state carries the sums over
// (:668).
//
// The ablations of ngx's throughput_fn (ngx/vector/__init__.py:119-204),
// which split a step's time between the action draw, the env step and the
// reset, are variants of warp_rollout, one template argument V each, so
// that the default's code is what it was: 'hash' actions (ngx's
// _hash_actions), 'fixed' (action 0), no auto-reset (done envs step on
// from their terminal state; the done counts still add up), and 'packed',
// which writes the final state in make_state_packers' int32 words
// (ngx_torch/core/state.py) in place of the four state outputs.  Each is
// instantiated alone, as ngx's perf breakdown runs them
// (ngx/cli/perf.py:127-135), not in every combination.

#include "ngx_env.cuh"

#if defined(__CUDACC__)
#include <mutex>
#endif

enum ActionSource { SRC_PRNG = 0, SRC_INPUT = 1, SRC_POLICY = 2 };
enum { SALT_PRNG_ACTION = 1 };   // pallas_rollout.py:655
enum ActionRng { RNG_COUNTER = 0, RNG_HASH = 1, RNG_FIXED = 2 };
// The variants of warp_rollout (its template argument V).
enum WarpVariant {
  WV_PRNG = 0,       // counter-RNG actions, auto-reset: the default
  WV_INPUT = 1,      // actions from p.actions
  WV_HASH = 2,       // ngx's _hash_actions, auto-reset
  WV_FIXED = 3,      // action 0, auto-reset
  WV_NO_RESET = 4,   // counter-RNG actions, no auto-reset
  WV_PACKED = 5,     // the default, the final state written packed
};

// The variant of a 'prng'/'input' launch; -1 for a combination that is not
// instantiated (two ablations at once, or an ablation of 'input').
NGX_HD int warp_variant(int source, int action_rng, int auto_reset,
                        bool packed) {
  if (action_rng < RNG_COUNTER || action_rng > RNG_FIXED) return -1;
  const int n = (action_rng != RNG_COUNTER) + (auto_reset ? 0 : 1) + (packed ? 1 : 0);
  if (source == SRC_INPUT) return n ? -1 : WV_INPUT;
  if (source != SRC_PRNG || n > 1) return -1;
  if (action_rng == RNG_HASH) return WV_HASH;
  if (action_rng == RNG_FIXED) return WV_FIXED;
  if (!auto_reset) return WV_NO_RESET;
  return packed ? WV_PACKED : WV_PRNG;
}

// ngx's 'hash' action of global env b at 0-based step t
// (ngx/vector/__init__.py:150-158; ngx_torch/ops/rng.py hash_actions).
NGX_HD int hash_action(uint32_t b, uint32_t t, int na) {
  return (int)((mix32((b * 0x9E3779B1u) ^ (t * 0x85EBCA6Bu)) >> 1) % (uint32_t)na);
}

NGX_HD int float_bits(float f) {
  union { float f; int i; } u;
  u.f = f;
  return u.i;
}

// One env's state in make_state_packers' words (ngx/core/state.py:88-171,
// bit for bit, the 15-bit inventory fields without a width guard as
// there): the map at 6 cells of 5 bits a word, the inventory at 2 counts
// of 15 bits, the scalars' word, step_count, then last_reward and
// last_cost bit-cast.
template <class Hdr>
NGX_HD void pack_env(const Hdr& hd, const int8_t* m, const int* inv,
                     const Regs& s, int* out) {
  const int hw = hd[tb::H] * hd[tb::H], ni = hd[tb::I];
  const int map_w = (hw + 5) / 6, inv_w = (ni + 1) / 2;
  for (int k = 0; k < map_w; ++k) {
    uint32_t x = 0;
    for (int j = 0; j < 6 && 6 * k + j < hw; ++j)
      x += (uint32_t)m[6 * k + j] << (5 * j);
    out[k] = (int)x;
  }
  for (int k = 0; k < inv_w; ++k) {
    const uint32_t lo = (uint32_t)inv[2 * k];
    const uint32_t hi = 2 * k + 1 < ni ? (uint32_t)inv[2 * k + 1] : 0u;
    out[map_w + k] = (int)(lo | (hi << 15));
  }
  int* q = out + map_w + inv_w;
  q[0] = (int)((uint32_t)s.r | ((uint32_t)s.c << 5) | ((uint32_t)s.facing << 10) |
               ((uint32_t)(s.selected + 1) << 12) | ((uint32_t)s.last_action << 18) |
               ((uint32_t)s.last_done << 24));
  q[1] = s.step_count;
  q[2] = float_bits(s.last_reward);
  q[3] = float_bits(s.last_cost);
}

// Shared memory of a 'prng'/'input' block of `warps` warps, byte offsets
// and strides: the table, then per warp its 32 maps (cell_bytes(ni) a cell;
// at least 1,152 bytes, which stage the registers at the end), its 32
// inventories and `rows` rows of hw edit scores (none without reset edits).
struct WarpLayout {
  int off_map, map_stride, off_inv, off_score, score_stride, bytes;
};

NGX_HD WarpLayout warp_layout(int n_tab, int hw, int ni, int rows, int warps) {
  WarpLayout L;
  L.off_map = (int)align16((size_t)n_tab * 4);
  const int maps = 32 * hw * cell_bytes(ni);
  L.map_stride = (int)align16(maps > 32 * 9 * 4 ? maps : 32 * 9 * 4);
  L.off_inv = L.off_map + warps * L.map_stride;
  L.off_score = L.off_inv + (int)align16((size_t)warps * 32 * ni * 4);
  L.score_stride = (int)align16((size_t)rows * hw * 4);
  L.bytes = L.off_score + warps * L.score_stride;
  return L;
}

// The layout of `warps` warps within `budget` bytes: the edits' score rows,
// one a reset group, halved (and the fewest lanes a reset takes doubled)
// until the block fits; false where not even one row a warp does.
NGX_HD bool warp_fit(int n_tab, int hw, int ni, bool edits, int warps,
                     size_t budget, int& lanes, WarpLayout& W) {
  for (;;) {
    W = warp_layout(n_tab, hw, ni, edits ? 32 / lanes : 0, warps);
    if ((size_t)W.bytes <= budget) return true;
    if (!edits || lanes == 32) return false;
    lanes *= 2;
  }
}

// The launch's layout: `threads` halved (a multiple of 32, down to one
// warp) until warp_fit finds one within `budget`; the RNG block is logical,
// so the geometry changes no result.  False where one warp does not fit.
NGX_HD bool warp_pick(int n_tab, int hw, int ni, bool edits, size_t budget,
                      int& threads, int& lanes, WarpLayout& W) {
  for (;;) {
    int l = lanes;
    if (warp_fit(n_tab, hw, ni, edits, threads / 32, budget, l, W)) {
      lanes = l;
      return true;
    }
    if (threads <= 32) return false;
    threads = threads / 64 * 32;
  }
}

// The shared-memory bytes of a block of `threads` threads within `budget`
// and, in lanes, the fewest lanes a reset then takes (warp_fit); negated
// where it does not fit (the bytes of one score row a warp); 0 for a
// geometry the kernel refuses.  The host's query.
NGX_HD int warp_smem(int n_tab, int hw, int ni, bool edits, int threads,
                     size_t budget, int& lanes) {
  if (threads < 32 || threads > 256 || threads % 32 || lanes < 1 ||
      lanes > 32 || (lanes & (lanes - 1)))
    return 0;
  WarpLayout W;
  if (warp_fit(n_tab, hw, ni, edits, threads / 32, budget, lanes, W))
    return W.bytes;
  return -warp_layout(n_tab, hw, ni, edits ? 1 : 0, threads / 32).bytes;
}

// The geometry of a 'prng'/'input' launch: threads a block, the fewest
// lanes a reset takes, blocks an SM, waves of the grid over the SMs, and
// whether warp_residency widened the lanes.
struct WarpGeometry {
  int threads, lanes, sm_blocks, waves, widened;
};

NGX_HD int grid_waves(int grid, int per_sm, int sms) {
  return per_sm > 0 ? (grid + per_sm * sms - 1) / (per_sm * sms) : 0x7fffffff;
}

// The lanes of a 'prng'/'input' launch of B envs on `sms` SMs, from
// warp_pick's g.threads and g.lanes (its floor, with W its layout): for a
// spec with reset edits, among the powers of 2 from g.lanes up to 32 the
// one whose score rows (32 / lanes a warp) let the SMs hold the grid in
// the fewest waves, the fewest lanes of equal waves.  blocks[l]: the blocks
// of g.threads threads an SM holds with l lanes' layout (on the card, the
// runtime's occupancy query).  Every block runs the same T steps, so a
// second wave costs about as much as the first, while wider groups slow
// only the resets; at T 0, all resets, the wave still counts for more (the
// pool draw of 65,536 fenced rows: 0.49 ms at lanes 1, 0.28 at 2, PERF.md).
// The RNG block is logical: the geometry changes no result.
NGX_HD void warp_residency(int n_tab, int hw, int ni, bool edits, int B,
                           int sms, const int* blocks, WarpGeometry& g,
                           WarpLayout& W) {
  const int grid = (B + g.threads - 1) / g.threads;
  g.sm_blocks = blocks[g.lanes];
  g.waves = grid_waves(grid, g.sm_blocks, sms);
  g.widened = 0;
  for (int l = g.lanes * 2; edits && l <= 32; l *= 2) {
    const int waves = grid_waves(grid, blocks[l], sms);
    if (waves < g.waves) {
      W = warp_layout(n_tab, hw, ni, 32 / l, g.threads / 32);
      g = WarpGeometry{g.threads, l, blocks[l], waves, 1};
    }
  }
}

struct EnvRolloutArgs {
  const int* tab;
  int n_tab;
  const int* actions;     // [T, B], 'input' mode
  const float* params;    // the policy tower, 'policy' mode
  int source, seed, B, T, block, envs;
  int lanes;              // 'prng'/'input': the fewest lanes a reset takes
  int* map_out;
  int* ir_out;
  float* fr_out;
  int* inv_out;
  float* rsum_out;
  int* dcount_out;
  WarpLayout W;           // 'prng'/'input'
  TileLayout L;           // 'policy'
  int* packed_out;        // [B, n_words], the WV_PACKED variant
};

// The final state and sums of env b.
template <class Cell>
NGX_HD void write_env(const EnvRolloutArgs& p, int hw, int ni, int b,
                      const Cell* m, const int* inv, const Regs& s,
                      float rsum, int dcount) {
  for (int i = 0; i < hw; ++i) p.map_out[(size_t)b * hw + i] = m[i];
  for (int i = 0; i < ni; ++i) p.inv_out[(size_t)b * ni + i] = inv[i];
  int* iro = p.ir_out + (size_t)b * 7;
  iro[0] = s.r;
  iro[1] = s.c;
  iro[2] = s.facing;
  iro[3] = s.selected;
  iro[4] = s.step_count;
  iro[5] = s.last_action;
  iro[6] = s.last_done;
  p.fr_out[(size_t)b * 2] = s.last_reward;
  p.fr_out[(size_t)b * 2 + 1] = s.last_cost;
  p.rsum_out[b] = rsum;
  p.dcount_out[b] = dcount;
}

// ---- 'prng' / 'input': the whole rollout of envs b0 .. b0 + 31, a warp ---
// smap, sinv, score: the warp's maps, inventories and edit-score rows.  In
// a ragged last warp the lanes past the batch step throwaway envs of their
// own, left out of the votes and the outputs: no lane test on the step's
// chain.  V (WarpVariant): where the actions come from — p.actions
// ('input'), the counter RNG ('prng'), ngx's hash or action 0 — whether
// done envs reset, and whether the final state is written packed (int8_t
// cells only: make_state_packers takes at most 31 item ids).
template <bool NOV, int V, class W, class Hdr, class Cell>
NGX_HD void warp_rollout(const EnvRolloutArgs& p, const W& w, const Hdr& hd,
                         const int* tab, Cell* smap, int* sinv,
                         uint32_t* score, int b0) {
  const int hw = hd[tb::H] * hd[tb::H], ni = hd[tb::I], na = hd[tb::A];
  const int nv = p.B - b0 < 32 ? p.B - b0 : 32;   // a ragged last warp
  const unsigned live = nv == 32 ? ~0u : (1u << nv) - 1u;
  Lanes<Regs, W::N> s;
  Lanes<float, W::N> rsum;
  Lanes<int, W::N> dcount;
  Lanes<uint32_t, W::N> sd, rw;
  for (int L = w.lo; L < w.hi; ++L) {
    env_stream(p.seed, p.block, b0 + L, sd[L], rw[L]);
    rsum[L] = 0.0f;
    dcount[L] = 0;
  }
  warp_reset<NOV>(w, tab, smap, sinv, score, ~0u, p.lanes, p.seed, p.block,
                  b0, 0u);
  fresh_regs(w, hd, tab, ~0u, 0u, sd, rw, s);
  for (int t = 0; t < p.T; ++t) {
    const uint32_t ctr = (uint32_t)t + 1u;   // action draw and reset: t+1
    Lanes<bool, W::N> done;
    for (int L = w.lo; L < w.hi; ++L) {
      const int a = V == WV_INPUT ? (L < nv ? p.actions[(size_t)t * p.B + b0 + L] : 0)
                  : V == WV_HASH ? hash_action((uint32_t)(b0 + L), (uint32_t)t, na)
                  : V == WV_FIXED ? 0
                  : rng_randint(sd[L], ctr, SALT_PRNG_ACTION, rw[L], 0, na);
      float reward;
      bool d;
      step_env<NOV>(hd, tab, smap + L * hw, sinv + L * ni, s[L], a, reward, d);
      rsum[L] += reward;
      dcount[L] += d ? 1 : 0;
      done[L] = d;
    }
    if constexpr (V != WV_NO_RESET) {
      const unsigned mask = w.ballot(done) & live;
      if (mask) {
        warp_reset<NOV>(w, tab, smap, sinv, score, mask, p.lanes, p.seed,
                        p.block, b0, ctr);
        fresh_regs(w, hd, tab, mask, ctr, sd, rw, s);
      }
    }
  }
  w.sync();
  if constexpr (V == WV_PACKED) {
    // each lane packs its own env (a row of n_words words)
    const int nw = (hw + 5) / 6 + (ni + 1) / 2 + 4;
    for (int L = w.lo; L < w.hi; ++L) {
      if (L >= nv) continue;
      pack_env(hd, smap + L * hw, sinv + L * ni, s[L],
               p.packed_out + (size_t)(b0 + L) * nw);
      p.rsum_out[b0 + L] = rsum[L];
      p.dcount_out[b0 + L] = dcount[L];
    }
    return;
  }
  // the outputs as contiguous spans: the maps and inventories from shared
  // memory, then the registers staged in the maps' place
  for (int L = w.lo; L < w.hi; ++L) {
    for (int i = L; i < nv * hw; i += 32) p.map_out[(size_t)b0 * hw + i] = smap[i];
    for (int i = L; i < nv * ni; i += 32) p.inv_out[(size_t)b0 * ni + i] = sinv[i];
  }
  w.sync();
  int* ist = reinterpret_cast<int*>(smap);
  float* fst = reinterpret_cast<float*>(smap) + 32 * 7;
  for (int L = w.lo; L < w.hi; ++L) {
    if (L >= nv) continue;
    const Regs& r = s[L];
    int* q = ist + L * 7;
    q[0] = r.r;
    q[1] = r.c;
    q[2] = r.facing;
    q[3] = r.selected;
    q[4] = r.step_count;
    q[5] = r.last_action;
    q[6] = r.last_done;
    fst[L * 2] = r.last_reward;
    fst[L * 2 + 1] = r.last_cost;
    p.rsum_out[b0 + L] = rsum[L];
    p.dcount_out[b0 + L] = dcount[L];
  }
  w.sync();
  for (int L = w.lo; L < w.hi; ++L) {
    for (int i = L; i < nv * 7; i += 32) p.ir_out[(size_t)b0 * 7 + i] = ist[i];
    for (int i = L; i < nv * 2; i += 32) p.fr_out[(size_t)b0 * 2 + i] = fst[i];
  }
}

// ---- 'policy': the whole rollout of tile `tile`, the block's threads -----
// (after tile_setup; envs tile*E .. tile*E + E - 1)
template <bool NOV, class Cell, class Blk>
NGX_HD void policy_tile(const EnvRolloutArgs& p, const Blk& blk,
                        unsigned char* smem, int tile) {
  typedef typename Blk::Warp W;
  const Tile<Cell> S(smem, p.L);
  const int* tab = S.tab;
  const int E = p.envs, b0 = tile * E;
  const int nv = p.B - b0 < E ? p.B - b0 : E;   // a ragged last tile
  const int hw = tab[tb::H] * tab[tb::H], ni = tab[tb::I], na = tab[tb::A];
  for (int e = blk.lo; e < blk.hi; ++e) {
    if (e >= nv) continue;
    EnvSlot& q = S.slot[e];
    env_stream(p.seed, p.block, b0 + e, q.seed, q.row);
    q.rsum = 0.0f;
    q.dcount = 0;
  }
  // every env's ctr-0 reset, in the reset phase; then, each step, the
  // envs that the step finished at ctr t+1
  uint32_t ctr = 0u;
  const auto reset = [&](const W& w, unsigned mask, int c0, uint32_t* score,
                         int lanes) {
    tile_reset_envs<NOV>(w, S, mask, c0, score, lanes, p.seed, p.block, b0,
                         ctr);
  };
  const FinishGeometry g = finish_geometry(blk, E);
  tile_finish(blk, S, g, nv, [](int) { return true; }, reset);
  for (int t = 0; t < p.T; ++t) {
    ctr = (uint32_t)t + 1u;   // action draw and reset: t+1
    tile_obs(blk, S, nv, E, nullptr);
    float* scores = tile_mlp(blk, tab, p.params, p.L.resident ? S.w : nullptr,
                             S.w, p.L.kc, p.L.chunk, S.x, S.y, E);
    tile_scores(blk, S, scores, nv, E, ctr);
    // act phase
    for (int e = blk.lo; e < blk.hi; ++e) {
      if (e >= nv) continue;
      EnvSlot& q = S.slot[e];
      Regs s = q.s;
      const int a = argmax_col(scores + e, E, na);
      float reward;
      bool done;
      step_env<NOV>(tab, tab, S.map + e * hw, S.inv + e * ni, s, a, reward,
                    done);
      q.rsum += reward;
      q.dcount += done ? 1 : 0;
      q.s = s;
    }
    // reset phase: the step's done is its last_done
    tile_finish(blk, S, g, nv,
                [&](int e) { return S.slot[e].s.last_done != 0; }, reset);
  }
  for (int e = blk.lo; e < blk.hi; ++e)
    if (e < nv)
      write_env(p, hw, ni, b0 + e, S.map + e * hw, S.inv + e * ni,
                S.slot[e].s, S.slot[e].rsum, S.slot[e].dcount);
}

#if defined(__CUDACC__)

// One launch layout, as warp_launch_layout found it for these arguments.
struct WarpLaunch {
  int dev;
  const void* kernel;
  int n_tab, hw, ni, edits, threads, lanes, B;
  WarpGeometry g;
  WarpLayout W;
};

// The layouts found so far (a ring; a process launches a handful), and the
// one each host thread launched last, for ngx_rollout_geometry.
static WarpLaunch warp_launches[32];
static int n_warp_launches = 0;
static std::mutex warp_launches_mu;
static thread_local WarpLaunch last_warp_launch;
static thread_local bool warp_launched = false;

// The checks and the layout of a 'prng'/'input' launch of `kernel` within
// the card's opt-in budget (warp_pick: `threads` halved where need be),
// its lanes widened where the SMs then hold the grid in fewer waves
// (warp_residency, fed the runtime's occupancy query for each candidate
// layout), found once for each device, kernel, table, map, item count,
// spec edits, threads, lanes and B: the queries are not paid twice.
static inline cudaError_t warp_launch_layout(const void* kernel, int n_tab,
                                             int hw, int ni, bool edits,
                                             int B, int& threads, int& lanes,
                                             WarpLayout& W) {
  if (threads < 32 || threads > 256 || threads % 32 || lanes < 1 ||
      lanes > 32 || (lanes & (lanes - 1)))
    return cudaErrorInvalidValue;
  WarpLaunch L = {0, kernel, n_tab, hw, ni, edits, threads, lanes, B};
  cudaError_t e = cudaGetDevice(&L.dev);
  if (e != cudaSuccess) return e;
  const auto same = [&](const WarpLaunch& c) {
    return c.dev == L.dev && c.kernel == kernel && c.n_tab == n_tab &&
           c.hw == hw && c.ni == ni && c.edits == L.edits &&
           c.threads == threads && c.lanes == lanes && c.B == B;
  };
  bool found = false;
  {
    std::lock_guard<std::mutex> lock(warp_launches_mu);
    const int n = n_warp_launches < 32 ? n_warp_launches : 32;
    for (int i = 0; i < n && !found; ++i)
      if (same(warp_launches[i])) {
        L = warp_launches[i];
        found = true;
      }
  }
  if (!found) {
    size_t optin = 0;
    int sms = 0, blocks[33] = {};
    e = smem_budget(optin);
    if (e != cudaSuccess) return e;
    L.g = WarpGeometry{threads, lanes, 0, 0, 0};
    if (!warp_pick(n_tab, hw, ni, edits, optin, L.g.threads, L.g.lanes, L.W))
      return cudaErrorInvalidValue;
    // the floor's layout is the largest: the query's cap for every candidate
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, L.dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.W.bytes);
    for (int l = L.g.lanes; l <= (edits ? 32 : L.g.lanes) && e == cudaSuccess;
         l *= 2)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks[l], kernel, L.g.threads,
          warp_layout(n_tab, hw, ni, edits ? 32 / l : 0, L.g.threads / 32)
              .bytes);
    if (e != cudaSuccess) return e;
    warp_residency(n_tab, hw, ni, edits, B, sms, blocks, L.g, L.W);
    std::lock_guard<std::mutex> lock(warp_launches_mu);
    warp_launches[n_warp_launches++ % 32] = L;
  }
  threads = L.g.threads;
  lanes = L.g.lanes;
  W = L.W;
  last_warp_launch = L;
  return cudaSuccess;
}

template <bool NOV, int V, class Cell>
__global__ void __launch_bounds__(256)
    rollout_kernel(const __grid_constant__ EnvRolloutArgs p,
                   const __grid_constant__ SpecHdr hd) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* t = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < p.n_tab; i += blockDim.x) t[i] = p.tab[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * blockDim.x + warp * 32;
  if (b0 >= p.B) return;
  const DevWarp w;
  warp_rollout<NOV, V>(
      p, w, hd, t,
      reinterpret_cast<Cell*>(smem + p.W.off_map + warp * p.W.map_stride),
      reinterpret_cast<int*>(smem + p.W.off_inv) + warp * 32 * hd[tb::I],
      reinterpret_cast<uint32_t*>(smem + p.W.off_score + warp * p.W.score_stride),
      b0);
}

// The rollout kernel of variant v (warp_variant) on cells of type Cell;
// null for the packed variant of the wide cell, which has none.
template <bool NOV, class Cell>
static auto warp_kernel(int v) -> decltype(&rollout_kernel<NOV, WV_PRNG, Cell>) {
  switch (v) {
    case WV_INPUT: return rollout_kernel<NOV, WV_INPUT, Cell>;
    case WV_HASH: return rollout_kernel<NOV, WV_HASH, Cell>;
    case WV_FIXED: return rollout_kernel<NOV, WV_FIXED, Cell>;
    case WV_NO_RESET: return rollout_kernel<NOV, WV_NO_RESET, Cell>;
    case WV_PACKED:
      if constexpr (sizeof(Cell) == 1) return rollout_kernel<NOV, WV_PACKED, Cell>;
      return nullptr;
    default: return rollout_kernel<NOV, WV_PRNG, Cell>;
  }
}

template <bool NOV, class Cell>
__global__ void __launch_bounds__(256) policy_rollout_kernel(const EnvRolloutArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DevBlock blk;
  tile_setup(blk, smem, p.L, p.tab, p.n_tab, p.params);
  policy_tile<NOV, Cell>(p, blk, smem, blockIdx.x);
}

// hdr: the table's header slots (host memory, tb::N_TAB + 1 of them); dims:
// the tower's widths [OBS_DIM, *hidden, A] (host memory, n_dims of them;
// 'policy' only); envs: the tile's envs ('policy'); threads: CUDA threads a
// block (a multiple of 32 in 'prng'/'input'); lanes: the fewest lanes that
// reset one env ('prng'/'input'), a floor that warp_launch_layout may
// widen (ngx_rollout_geometry reads what it took); action_rng (ActionRng), auto_reset and
// packed_out (int32 [B, n_words], or null): the 'prng' ablations
// (warp_variant); with packed_out the four state outputs are not written.
// n_items picks the map cell (wide_cell): int8_t up to 64 item ids, int16_t
// past them, which has no packed variant.
extern "C" int ngx_rollout(
    const int* tab, int n_tab, const int* hdr, const int* dims, int n_dims,
    const int* actions, const float* params, int n_params, int source,
    int action_rng, int auto_reset, int seed, int B, int T, int block,
    int envs, int threads, int lanes, int hw, int n_items, int* map_out,
    int* ir_out, float* fr_out, int* inv_out, float* rsum_out,
    int* dcount_out, int* packed_out, int novelty, void* stream) {
  warp_launched = false;
  if (block < 1 || B < 1 || T < 0 || source < SRC_PRNG || source > SRC_POLICY)
    return (int)cudaErrorInvalidValue;
  const bool wide = wide_cell(n_items);
  EnvRolloutArgs p = {tab, n_tab, actions, params, source, seed, B, T, block,
                      envs, lanes, map_out, ir_out, fr_out, inv_out, rsum_out,
                      dcount_out, WarpLayout{}, TileLayout{}, packed_out};
  cudaError_t e;
  size_t bytes;
  int grid;
  if (source == SRC_POLICY) {
    if (action_rng != RNG_COUNTER || !auto_reset || packed_out)
      return (int)cudaErrorInvalidValue;
    e = tile_launch_layout(n_tab, dims, n_dims, envs, threads, hw, n_items,
                           false, params, n_params, p.L);
    if (e != cudaSuccess) return (int)e;
    p.envs = envs;
    bytes = p.L.bytes;
    grid = (B + envs - 1) / envs;
    auto kernel = wide ? (novelty ? policy_rollout_kernel<true, int16_t>
                                  : policy_rollout_kernel<false, int16_t>)
                       : (novelty ? policy_rollout_kernel<true, int8_t>
                                  : policy_rollout_kernel<false, int8_t>);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
  }
  const int v = warp_variant(source, action_rng, auto_reset, packed_out != nullptr);
  if (!hdr || v < 0 || (wide && v == WV_PACKED)) return (int)cudaErrorInvalidValue;
  SpecHdr hd;
  std::memcpy(hd.v, hdr, sizeof(hd.v));
  if (hd[tb::N_TAB] != n_tab || hd[tb::H] * hd[tb::H] != hw ||
      hd[tb::I] != n_items)
    return (int)cudaErrorInvalidValue;
  auto kernel = wide ? (novelty ? warp_kernel<true, int16_t>(v)
                                : warp_kernel<false, int16_t>(v))
                     : (novelty ? warp_kernel<true, int8_t>(v)
                                : warp_kernel<false, int8_t>(v));
  e = warp_launch_layout(reinterpret_cast<const void*>(kernel), n_tab, hw,
                         n_items, novelty && hd[tb::NEDIT] > 0, B, threads,
                         p.lanes, p.W);
  if (e != cudaSuccess) return (int)e;
  bytes = p.W.bytes;
  grid = (B + threads - 1) / threads;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(p, hd);
  e = cudaGetLastError();
  warp_launched = e == cudaSuccess;
  return (int)e;
}

// The geometry of this host thread's last ngx_rollout call, where it
// launched 'prng' or 'input': out[0..4] the threads a block, the fewest
// lanes a reset took, the blocks an SM (the runtime's occupancy query),
// the waves of the grid, and 1 where warp_residency widened the lanes.  0
// where that call launched none.
extern "C" int ngx_rollout_geometry(int* out) {
  if (!warp_launched) return 0;
  const WarpLaunch& L = last_warp_launch;
  const int v[5] = {L.g.threads, L.g.lanes, L.g.sm_blocks, L.g.waves,
                    L.g.widened};
  std::memcpy(out, v, sizeof(v));
  return 1;
}

// warp_smem within the card's opt-in budget: the dynamic shared-memory
// bytes of a 'prng'/'input' block of `threads` threads and, in *lanes, the
// fewest lanes a reset then takes; negated where it does not fit.
extern "C" int ngx_rollout_smem(int n_tab, int hw, int n_items, int edits,
                                int threads, int* lanes) {
  size_t optin = 0;
  if (smem_budget(optin) != cudaSuccess) return 0;
  return warp_smem(n_tab, hw, n_items, edits != 0, threads, optin, *lanes);
}

#endif  // __CUDACC__
