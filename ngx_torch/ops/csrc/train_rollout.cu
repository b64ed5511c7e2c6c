// The PPO trainer's fused acting rollout, for sm_90a (H100).
//
// Replaces make_pallas_train_rollout (ngx/ops/pallas_rollout.py:812, kernel
// body :1059), native-reset mode: over T steps, for every env, the
// LidarInFront obs, the tanh MLP actor, the Gumbel-argmax action, the env
// step, the episode-cap truncation and, on done, the counter-RNG reset.  The
// plain twin is train_rollout_plain in ngx_torch/ops/train_rollout.py; the
// wrapper train_rollout there builds this file (ngx_torch/ops/_build.py),
// checks every tensor and launches ngx_train_rollout below.
//
// What bounds it on this card: not bytes.  Per env and step it writes the
// obs row (OBS_DIM floats) and four scalars, about 270 bytes, and it does
// OBS_DIM*h0 + h0*h1 + h1*A multiply-adds (9,280 at hidden (64, 64)) plus a
// few hundred integer ops of lidar, step and reset.  The work is a serial
// chain per env, and B = 8192 envs are only 256 warps on 132 SMs, so the
// kernel is bound by the latency of that chain, not by a roofline.
//
// Design (simple and correct first):
//   * one thread owns one env for all T steps; the time loop runs inside the
//     thread (the TPU's sequential grid axis and t_chunk have no
//     counterpart here);
//   * the env's map lives in shared memory as int8 (item ids are below 32)
//     and its inventory as int32: reads and writes of a cell are direct
//     indexing — the TPU kernel's one-hot map reads, ADJ/shift matmuls and
//     integer bisection were Mosaic workarounds and are gone;
//   * the spec tables and, where they fit, the policy weights are copied to
//     shared memory once per thread block: all threads of a warp read the
//     same weight at the same time, a broadcast.  Wider towers (the (256,
//     256) solver widths, 344 KB) are read from global memory through L1;
//   * hidden activations live in a global scratch buffer laid out [k][B],
//     so a warp's loads and stores of one unit are coalesced;
//   * the RNG stream is addressed by the LOGICAL block: env e draws from
//     (seed + (e / block) * 7919, row = e % block), whatever blockDim is.
//
// Parity hazards (see train_rollout.py): uint32 arithmetic is native here;
// the Gumbel score uses logf (not __logf) and the MLP sums in another order
// than torch's matmul, so an action can differ from the twin only at a
// near-tie of the top two scores.  Built without -use_fast_math.

#include <cstdint>
#include <cmath>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define NGX_HD __host__ __device__ __forceinline__
#else
#define NGX_HD inline
#endif

// Header slots of the int32 table buffer: the same names, in the same
// order, as HEADER in ngx_torch/ops/train_rollout.py.  F_* slots hold float
// bits; O_* slots hold the offset of an array in the same buffer.
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
  N_TAB,
};
}  // namespace tb

// op codes (ngx_torch/core/spec.py) and RNG salts (pallas_rollout.py:312-330,
// :421-424, :965)
enum Op {
  OP_FORWARD = 1, OP_LEFT = 2, OP_RIGHT = 3, OP_BREAK = 4, OP_PLACE = 5,
  OP_EXTRACT_RUBBER = 6, OP_EXTRACT_STRING = 7, OP_CRAFT = 8, OP_SELECT = 9,
};
enum Salt { SALT_ACTION = 5, SALT_AGENT = 2, SALT_FACING = 3, SALT_INV = 4,
            SALT_PLACE0 = 16 };

struct Regs {
  int r, c, facing, selected, step_count, last_action, last_done;
  float last_reward, last_cost;
};

struct RolloutArgs {
  const int* tab;
  int n_tab;
  const int* map_in;
  const int* ir_in;
  const float* fr_in;
  const int* inv_in;
  const float* params;
  int n_params;
  int params_in_smem;
  int seed, B, T, block, cap;
  float* scratch;
  int maxw;
  int* map_out;
  int* ir_out;
  float* fr_out;
  int* inv_out;
  float* obs_out;
  int* act_out;
  float* rew_out;
  unsigned char* done_out;
  int off_params, off_inv, off_map;   // byte offsets into dynamic smem
};

NGX_HD float tab_f(const int* tab, int slot) {
  union { int i; float f; } u;
  u.i = tab[slot];
  return u.f;
}

NGX_HD float tab_farr(const int* tab, int off_slot, int idx) {
  return tab_f(tab, tab[off_slot] + idx);
}

// ---- the murmur3 counter RNG (pallas_rollout.py:106-142) -----------------
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

// ---- reset: pallas_rollout.py:309-445, plain placements + inventory ------
NGX_HD void reset_env(const int* tab, int8_t* m, int* inv, Regs& s,
                      uint32_t seed, uint32_t ctr, uint32_t row) {
  const int h = tab[tb::H], hw = h * h;
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

// ---- step: ngx_torch/core/step.py, the supported op families -------------
NGX_HD int read_cell(const int8_t* m, int h, int r, int c) {
  return (r >= 0 && r < h && c >= 0 && c < h) ? (int)m[r * h + c] : 0;
}

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
  const bool is_break = op == OP_BREAK;
  const bool break_ok = front != 0 && !tab[tab[tb::O_UNBREAK] + front];
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

  const bool is_craft = op == OP_CRAFT;
  int rec = 0;
  bool craft_ok = false, craft_notable = false;
  const int* need = nullptr;
  const int* rout = nullptr;
  if (tab[tb::HAS_CRAFT]) {
    rec = arg < 0 ? 0 : (arg > tab[tb::R] - 1 ? tab[tb::R] - 1 : arg);
    need = tab + tab[tb::O_RIN] + rec * ni;
    rout = tab + tab[tb::O_ROUT] + rec * ni;
    bool have_all = true;
    for (int i = 0; i < ni; ++i) have_all = have_all && inv[i] >= need[i];
    craft_notable = have_all && tab[tab[tb::O_RMULTI] + rec] &&
                    front != tab[tb::TABLE_ID];
    craft_ok = have_all && !craft_notable;
  }

  // every condition above read the pre-step inventory; now write
  const bool write_break = (is_break && break_ok) || (is_exs && exs_ok);
  const bool write_place = is_place && place_ok;
  if (front_in && (write_break || write_place))
    m[fr * h + fc] = (int8_t)(write_break ? 0 : arg);
  if (is_break && break_ok) inv[front] += tab[tab[tb::O_BYIELD] + front];
  if (write_place) inv[arg_i] -= 1;
  if (is_exr && exr_ok) inv[tab[tb::RUBBER]] += tab[tb::EXTRACT_AMOUNT];
  if (is_exs && exs_ok && tab[tb::EXTRACT_YIELD] >= 0)
    inv[tab[tb::EXTRACT_YIELD]] += tab[tb::EXTRACT_AMOUNT];
  if (is_craft && craft_ok)
    for (int i = 0; i < ni; ++i) inv[i] += rout[i] - need[i];

  const float r_inter = tab_f(tab, tb::F_REWARD_INTER);
  float rw = tab_f(tab, tb::F_REWARD_STEP);
  if (is_break && break_ok) rw = tab_farr(tab, tb::O_BREW, front);
  if (is_place && place_ok && next_to_tree) rw = r_inter;
  if (is_exr && exr_ok) rw = r_inter;
  if (is_exs && exs_ok) rw = r_inter;
  if (is_craft)
    rw = craft_ok ? tab_f(tab, tb::F_CRAFT_SUCCESS) : tab_f(tab, tb::F_REWARD_STEP);

  const bool result = !((is_fwd && !fwd_ok) || (is_break && !break_ok) ||
                        (is_place && !place_ok) || (is_exr && !exr_ok) ||
                        (is_exs && !exs_ok) || (is_craft && !craft_ok) ||
                        (is_select && !sel_ok));
  float cost = result ? tab_farr(tab, tb::O_COST_OK, a) : tab_farr(tab, tb::O_COST_FAIL, a);
  if (tab[tb::HAS_BREAK] && is_break) cost = tab_f(tab, tb::F_BREAK_COST);
  if (tab[tb::HAS_CRAFT] && is_craft)
    cost = craft_ok ? tab_farr(tab, tb::O_CC_OK, rec)
                    : (craft_notable ? tab_farr(tab, tb::O_CC_NOTAB, rec)
                                     : tab_farr(tab, tb::O_CC_MISS, rec));

  // inventory goal over the post-step inventory (pogostick_v1_env.py:354-357)
  const int* goal = tab + tab[tb::O_GOAL];
  bool all_met = true, any_met = false;
  for (int i = 0; i < ni; ++i) {
    if (goal[i] > 0) {
      all_met = all_met && inv[i] >= goal[i];
      any_met = any_met || inv[i] >= goal[i];
    }
  }
  const bool goal_met = tab[tb::GOAL_ANY] ? any_met : all_met;
  if (goal_met) rw = tab_f(tab, tb::F_REWARD_DONE);

  if (is_fwd && fwd_ok) {
    s.r = fr;
    s.c = fc;
  }
  if (op == OP_LEFT) s.facing = LEFT[s.facing];
  if (op == OP_RIGHT) s.facing = RIGHT[s.facing];
  if (is_select && sel_ok) s.selected = arg;
  s.step_count += 1;
  s.last_action = a;
  s.last_reward = rw;
  s.last_cost = cost;
  s.last_done = goal_met;
  reward = rw;
  done = goal_met;
}

// ---- LidarInFront obs (pallas_rollout.py:471-530, rays.py:95-116) --------
// Writes the obs to x[k * xs] (the MLP input column) and to orow[k].
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
      orow[b * ns + q] = val;
    }
  }
  const int* keep = tab + tab[tb::O_KEEP];
  for (int i = 0; i < tab[tb::NKEEP]; ++i) {
    const float val = (float)inv[keep[i]];
    x[(nb * ns + i) * xs] = val;
    orow[nb * ns + i] = val;
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

// ---- the whole rollout of env b ------------------------------------------
NGX_HD void rollout_env(const RolloutArgs& p, const int* tab,
                        const float* params, int8_t* m, int* inv, int b) {
  const int hw = tab[tb::H] * tab[tb::H], ni = tab[tb::I], B = p.B, od = tab[tb::OBS_DIM];
  // the RNG block of env b: int32 seed + blk*7919 wraps like uint32
  const uint32_t seed = (uint32_t)p.seed + (uint32_t)(b / p.block) * 7919u;
  const uint32_t row = (uint32_t)(b % p.block);
  for (int i = 0; i < hw; ++i) m[i] = (int8_t)p.map_in[(size_t)b * hw + i];
  for (int i = 0; i < ni; ++i) inv[i] = p.inv_in[(size_t)b * ni + i];
  const int* ir = p.ir_in + (size_t)b * 7;
  Regs s = {ir[0], ir[1], ir[2], ir[3], ir[4], ir[5], ir[6],
            p.fr_in[(size_t)b * 2], p.fr_in[(size_t)b * 2 + 1]};
  float* buf0 = p.scratch + b;
  float* buf1 = p.scratch + (size_t)p.maxw * B + b;
  const int* dims = tab + tab[tb::O_DIMS];
  for (int t = 0; t < p.T; ++t) {
    const uint32_t ctr = (uint32_t)t + 1u;   // action draw and reset: t+1
    const size_t tb = (size_t)t * B + b;
    lidar_obs(tab, m, inv, s, buf0, B, p.obs_out + tb * od);
    const float* w = params;
    float* in = buf0;
    float* out = buf1;
    for (int l = 0; l <= tab[tb::NH]; ++l) {
      const int din = dims[l], dout = dims[l + 1];
      dense(w, w + din * dout, din, dout, in, out, B, l < tab[tb::NH]);
      w += din * dout + dout;
      float* tmp = in;
      in = out;
      out = tmp;
    }
    const int a = gumbel_argmax(in, B, tab[tb::A], seed, ctr, row);
    float reward;
    bool done;
    step_env(tab, m, inv, s, a, reward, done);
    // the trainer's time limit: native resets restart the count from 0
    done = done || s.step_count >= p.cap;
    p.act_out[tb] = a;
    p.rew_out[tb] = reward;
    p.done_out[tb] = done ? 1 : 0;
    if (done) reset_env(tab, m, inv, s, seed, ctr, row);
  }
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
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(256) train_rollout_kernel(const RolloutArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_tab = reinterpret_cast<int*>(smem);
  float* s_params = reinterpret_cast<float*>(smem + p.off_params);
  for (int i = threadIdx.x; i < p.n_tab; i += blockDim.x) s_tab[i] = p.tab[i];
  if (p.params_in_smem)
    for (int i = threadIdx.x; i < p.n_params; i += blockDim.x)
      s_params[i] = p.params[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const int hw = s_tab[tb::H] * s_tab[tb::H];
  int* inv = reinterpret_cast<int*>(smem + p.off_inv) + threadIdx.x * s_tab[tb::I];
  int8_t* m = reinterpret_cast<int8_t*>(smem + p.off_map) + threadIdx.x * hw;
  rollout_env(p, s_tab, p.params_in_smem ? s_params : p.params, m, inv, b);
}

static size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

extern "C" int ngx_train_rollout(
    const int* tab, int n_tab, const int* map_in, const int* ir_in,
    const float* fr_in, const int* inv_in, const float* params, int n_params,
    int seed, int B, int T, int block, int cap, int threads, int hw,
    int n_items, float* scratch, int maxw, int* map_out, int* ir_out,
    float* fr_out, int* inv_out, float* obs_out, int* act_out, float* rew_out,
    unsigned char* done_out, void* stream) {
  if (threads < 1 || threads > 256 || block < 1 || B < 1 || T < 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  RolloutArgs p = {tab, n_tab, map_in, ir_in, fr_in, inv_in, params, n_params,
                   0, seed, B, T, block, cap, scratch, maxw, map_out, ir_out,
                   fr_out, inv_out, obs_out, act_out, rew_out, done_out,
                   0, 0, 0};
  const size_t per_block = align16((size_t)threads * n_items * 4) + (size_t)threads * hw;
  size_t off = align16((size_t)n_tab * 4);
  p.off_params = (int)off;
  p.params_in_smem = off + align16((size_t)n_params * 4) + per_block <= (size_t)optin;
  if (p.params_in_smem) off += align16((size_t)n_params * 4);
  p.off_inv = (int)off;
  off += align16((size_t)threads * n_items * 4);
  p.off_map = (int)off;
  off += (size_t)threads * hw;
  if (off > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(train_rollout_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)off);
  if (e != cudaSuccess) return (int)e;
  const int grid = (B + threads - 1) / threads;
  train_rollout_kernel<<<grid, threads, off, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* ngx_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

#endif  // __CUDACC__
