// The PPO trainer's fused acting rollout, for sm_90a (H100).
//
// Replaces make_pallas_train_rollout (ngx/ops/pallas_rollout.py:812, kernel
// body :1059) in both of its reset modes: over T steps, for every env, the
// LidarInFront obs, the tanh MLP actor, the Gumbel-argmax action, the env
// step, the episode-cap truncation and, on done, a fresh state — the
// counter-RNG reset (native mode) or the next slot of the env's input pool
// (pool mode, :946-1016, :1203-1227).  The plain twin is train_rollout_plain
// in ngx_torch/ops/train_rollout.py; the wrapper train_rollout there builds
// this file (ngx_torch/ops/_build.py), checks every tensor and launches
// ngx_train_rollout below.
//
// Pool mode: env b's k-th restore in a launch (k from 1) takes slot
// (k - 1) % R of its R pool rows, read from global memory only then (no pool
// data goes to shared memory).  A restore sets the map, inventory, agent,
// facing and step_count from the slot, selected -1, last_action and
// last_done 0, last_reward and last_cost 0, and the env's cap base to the
// slot's step_count; the cap counts step_count - base.  Native mode keeps
// base 0.  The base of each env comes in and goes out.
//
// What bounds it on this card: operations, on paper.  Per env and step it
// writes the obs row (OBS_DIM floats) and four scalars, about 270 bytes, and
// it does OBS_DIM*h0 + h0*h1 + h1*A multiply-adds (9,280 at hidden (64, 64),
// 9.7 GFLOP a launch at B 8,192, T 64) plus a few hundred integer ops of
// lidar, step and reset, a serial chain per env.
//
// Design: a block of N threads owns a tile of E envs (ngx_env.cuh, "the tile
// MLP") and runs the time loop inside the block (the TPU's sequential grid
// axis and t_chunk have no counterpart here).  Each step: the env phase
// (the envs' obs into the activation tile and the tile's obs rows, beams
// spread over all N threads), the tile's obs rows copied to obs_out by all
// N threads (one contiguous span, coalesced), the MLP phase (all N threads,
// one 4x4 register tile of units x envs at a time, weights in shared
// memory), the score phase (the Gumbel scores, spread over all N threads)
// and the act phase (thread e: the argmax, step, cap, reset or restore, the
// trajectory scalars).  Each env's map (int8, item ids are below 32),
// inventory and registers live in shared memory; direct indexing replaces
// the TPU kernel's one-hot map reads, ADJ/shift matmuls and integer
// bisection (Mosaic workarounds).  The RNG stream is addressed by the
// LOGICAL block: env b draws from (seed + (b / block) * 7919, row = b %
// block), whatever the tile geometry.
//
// Parity hazards (see train_rollout.py and ngx_env.cuh): uint32 arithmetic
// is native here; the Gumbel score uses logf (not __logf) and the MLP sums
// in another order than torch's matmul, so an action can differ from the
// twin only at a near-tie of the top two scores.  Built without
// -use_fast_math.

#include "ngx_env.cuh"

struct RolloutArgs {
  const int* tab;
  int n_tab;
  const int* map_in;
  const int* ir_in;
  const float* fr_in;
  const int* inv_in;
  const float* params;   // the tower, laid out as policy_params lays it out
  int seed, B, T, block, cap, envs;
  int* map_out;
  int* ir_out;
  float* fr_out;
  int* inv_out;
  float* obs_out;
  int* act_out;
  float* rew_out;
  unsigned char* done_out;
  // pool mode (pool_map non-null): [B, R, HW], [B, R, I], [B, R, 4] (row,
  // col, facing, step_count), the cap base in and out [B]
  const int* pool_map;
  const int* pool_inv;
  const int* pool_sc;
  int R;
  const int* base_in;
  int* base_out;
  TileLayout L;
};

// ---- the whole rollout of tile `tile`: envs tile*E .. tile*E + E - 1 -----
// (after tile_setup; the block's threads run it together)
template <bool NOV, class Blk>
NGX_HD void rollout_tile(const RolloutArgs& p, const Blk& blk,
                         unsigned char* smem, int tile) {
  const Tile S(smem, p.L);
  const int* tab = S.tab;
  const int E = p.envs, B = p.B, b0 = tile * E;
  const int nv = B - b0 < E ? B - b0 : E;   // a ragged last tile
  const int hw = tab[tb::H] * tab[tb::H], ni = tab[tb::I];
  const int od = tab[tb::OBS_DIM], na = tab[tb::A];
  const bool pool = p.pool_map != nullptr;
  for (int e = blk.lo; e < blk.hi; ++e) {
    if (e >= nv) continue;
    const int b = b0 + e;
    EnvSlot& q = S.slot[e];
    int8_t* m = S.map + e * hw;
    int* inv = S.inv + e * ni;
    env_stream(p.seed, p.block, b, q.seed, q.row);
    for (int i = 0; i < hw; ++i) m[i] = (int8_t)p.map_in[(size_t)b * hw + i];
    for (int i = 0; i < ni; ++i) inv[i] = p.inv_in[(size_t)b * ni + i];
    const int* ir = p.ir_in + (size_t)b * 7;
    q.s = {ir[0], ir[1], ir[2], ir[3], ir[4], ir[5], ir[6],
           p.fr_in[(size_t)b * 2], p.fr_in[(size_t)b * 2 + 1]};
    q.base = pool ? p.base_in[b] : 0;
    q.n_done = 0;
  }
  for (int t = 0; t < p.T; ++t) {
    const uint32_t ctr = (uint32_t)t + 1u;   // action draw and reset: t+1
    // env phase: each env's obs into its column of x and its staging row
    tile_obs(blk, S, nv, E, S.o);
    // the tile's obs rows are one contiguous span of obs_out
    float* orows = p.obs_out + ((size_t)t * B + b0) * od;
    for (int tid = blk.lo; tid < blk.hi; ++tid)
      for (int i = tid; i < nv * od; i += blk.n) orows[i] = S.o[i];
    float* scores = tile_mlp(blk, tab, p.params, p.L.resident ? S.w : nullptr,
                             S.w, p.L.kc, p.L.chunk, S.x, S.y, E);
    tile_scores(blk, S, scores, nv, E, ctr);
    // act phase
    for (int e = blk.lo; e < blk.hi; ++e) {
      if (e >= nv) continue;
      EnvSlot& q = S.slot[e];
      int8_t* m = S.map + e * hw;
      int* inv = S.inv + e * ni;
      Regs s = q.s;
      const int a = argmax_col(scores + e, E, na);
      float reward;
      bool done;
      step_env<NOV>(tab, tab, m, inv, s, a, reward, done);
      // the trainer's time limit, counted from the restore's base (:976)
      done = done || s.step_count - q.base >= p.cap;
      const size_t ti = (size_t)t * B + b0 + e;
      p.act_out[ti] = a;
      p.rew_out[ti] = reward;
      p.done_out[ti] = done ? 1 : 0;
      if (done && !pool) {
        reset_env<NOV>(tab, m, inv, s, q.seed, ctr, q.row);
      } else if (done) {
        // the next pool slot (:983-1003)
        q.n_done += 1;
        const size_t slot = (size_t)(b0 + e) * p.R + (size_t)((q.n_done - 1) % p.R);
        for (int i = 0; i < hw; ++i) m[i] = (int8_t)p.pool_map[slot * hw + i];
        for (int i = 0; i < ni; ++i) inv[i] = p.pool_inv[slot * ni + i];
        const int* sc = p.pool_sc + slot * 4;
        s = {sc[0], sc[1], sc[2], -1, sc[3], 0, 0, 0.0f, 0.0f};
        q.base = sc[3];
      }
      q.s = s;
    }
  }
  for (int e = blk.lo; e < blk.hi; ++e) {
    if (e >= nv) continue;
    const int b = b0 + e;
    const EnvSlot& q = S.slot[e];
    if (pool) p.base_out[b] = q.base;
    for (int i = 0; i < hw; ++i) p.map_out[(size_t)b * hw + i] = S.map[e * hw + i];
    for (int i = 0; i < ni; ++i) p.inv_out[(size_t)b * ni + i] = S.inv[e * ni + i];
    int* iro = p.ir_out + (size_t)b * 7;
    iro[0] = q.s.r;
    iro[1] = q.s.c;
    iro[2] = q.s.facing;
    iro[3] = q.s.selected;
    iro[4] = q.s.step_count;
    iro[5] = q.s.last_action;
    iro[6] = q.s.last_done;
    p.fr_out[(size_t)b * 2] = q.s.last_reward;
    p.fr_out[(size_t)b * 2 + 1] = q.s.last_cost;
  }
}

#if defined(__CUDACC__)

template <bool NOV>
__global__ void __launch_bounds__(256) train_rollout_kernel(const RolloutArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DevBlock blk;
  tile_setup(blk, smem, p.L, p.tab, p.n_tab, p.params);
  rollout_tile<NOV>(p, blk, smem, blockIdx.x);
}

// dims: the tower's widths [OBS_DIM, *hidden, A] (host memory, n_dims of
// them); envs, threads: the tile geometry, E envs and N threads a block.
extern "C" int ngx_train_rollout(
    const int* tab, int n_tab, const int* dims, int n_dims, const int* map_in,
    const int* ir_in, const float* fr_in, const int* inv_in,
    const float* params, int n_params, int seed, int B, int T, int block,
    int cap, int envs, int threads, int hw, int n_items, int* map_out,
    int* ir_out, float* fr_out, int* inv_out, float* obs_out, int* act_out,
    float* rew_out, unsigned char* done_out, const int* pool_map,
    const int* pool_inv, const int* pool_sc, int R, const int* base_in,
    int* base_out, int novelty, void* stream) {
  if (block < 1 || B < 1 || T < 0 ||
      (pool_map && (R < 1 || !pool_inv || !pool_sc || !base_in || !base_out)))
    return (int)cudaErrorInvalidValue;
  TileLayout L;
  cudaError_t e = tile_launch_layout(n_tab, dims, n_dims, envs, threads, hw,
                                     n_items, true, params, n_params, L);
  if (e != cudaSuccess) return (int)e;
  RolloutArgs p = {tab, n_tab, map_in, ir_in, fr_in, inv_in, params, seed, B,
                   T, block, cap, envs, map_out, ir_out, fr_out, inv_out,
                   obs_out, act_out, rew_out, done_out, pool_map, pool_inv,
                   pool_sc, R, base_in, base_out, L};
  auto kernel = novelty ? train_rollout_kernel<true> : train_rollout_kernel<false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L.bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (B + envs - 1) / envs;
  kernel<<<grid, threads, L.bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The dynamic shared-memory bytes of a tile-MLP block (the train kernel's
// with obs_stage, 'policy''s without), 0 where the launch would be refused;
// for the record of a run.
extern "C" int ngx_tile_smem(int n_tab, const int* dims, int n_dims, int envs,
                             int hw, int n_items, int obs_stage) {
  size_t optin = 0;
  TileLayout L;
  if (smem_budget(optin) != cudaSuccess ||
      !tile_layout(n_tab, dims, n_dims, envs, hw, n_items, obs_stage != 0,
                   optin, L))
    return 0;
  return L.bytes;
}

extern "C" const char* ngx_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

#endif  // __CUDACC__
