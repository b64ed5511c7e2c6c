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
// is bound by the serial chain of each env's steps and by how many envs the
// SMs hold at once (the map and inventory take ~140 bytes of shared memory a
// thread), not by a roofline.  'policy' mode adds the MLP's multiply-adds
// (9,280 an env-step at hidden (64, 64)): operations bound it on paper.
//
// Design: 'prng' and 'input' run one thread per env for all T steps
// (env_rollout), its map in int8 shared memory and its inventory in int32
// shared memory, the tables in shared memory once per thread block.
// 'policy' runs the tile MLP of train_rollout.cu (ngx_env.cuh): a block of N
// threads owns E envs, with an env phase, an MLP phase and a score phase
// over the whole tile and an act phase each step (policy_tile).  Both address the RNG stream by
// the LOGICAL block (seed + (e / block) * 7919, row e % block), whatever the
// launch geometry.
//
// Parity hazards (see rollout.py): the reward sum is added step by step in
// float32, as the JAX kernel's fregs[:, 2] + r (:664), so each env's sum is
// bit-exact; the initial state is the ctr-0 reset (:633-636), a boundary at
// step t resets with ctr t+1, and a fresh state carries the sums over
// (:668).

#include "ngx_env.cuh"

enum ActionSource { SRC_PRNG = 0, SRC_INPUT = 1, SRC_POLICY = 2 };
enum { SALT_PRNG_ACTION = 1 };   // pallas_rollout.py:655

struct EnvRolloutArgs {
  const int* tab;
  int n_tab;
  const int* actions;     // [T, B], 'input' mode
  const float* params;    // the policy tower, 'policy' mode
  int source, seed, B, T, block, envs;
  int* map_out;
  int* ir_out;
  float* fr_out;
  int* inv_out;
  float* rsum_out;
  int* dcount_out;
  int off_inv, off_map;   // 'prng'/'input': byte offsets into dynamic smem
  TileLayout L;           // 'policy'
};

// The final state and sums of env b.
NGX_HD void write_env(const EnvRolloutArgs& p, int hw, int ni, int b,
                      const int8_t* m, const int* inv, const Regs& s,
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

// ---- 'prng' / 'input': the whole rollout of env b, one thread ------------
template <bool NOV>
NGX_HD void env_rollout(const EnvRolloutArgs& p, const int* tab, int8_t* m,
                        int* inv, int b) {
  uint32_t seed, row;
  env_stream(p.seed, p.block, b, seed, row);
  Regs s;
  reset_env<NOV>(tab, m, inv, s, seed, 0u, row);
  float rsum = 0.0f;
  int dcount = 0;
  for (int t = 0; t < p.T; ++t) {
    const uint32_t ctr = (uint32_t)t + 1u;   // action draw and reset: t+1
    const int a = p.source == SRC_INPUT
                      ? p.actions[(size_t)t * p.B + b]
                      : rng_randint(seed, ctr, SALT_PRNG_ACTION, row, 0, tab[tb::A]);
    float reward;
    bool done;
    step_env<NOV>(tab, m, inv, s, a, reward, done);
    rsum += reward;
    dcount += done ? 1 : 0;
    if (done) reset_env<NOV>(tab, m, inv, s, seed, ctr, row);
  }
  write_env(p, tab[tb::H] * tab[tb::H], tab[tb::I], b, m, inv, s, rsum, dcount);
}

// ---- 'policy': the whole rollout of tile `tile`, the block's threads -----
// (after tile_setup; envs tile*E .. tile*E + E - 1)
template <bool NOV, class Blk>
NGX_HD void policy_tile(const EnvRolloutArgs& p, const Blk& blk,
                        unsigned char* smem, int tile) {
  const Tile S(smem, p.L);
  const int* tab = S.tab;
  const int E = p.envs, b0 = tile * E;
  const int nv = p.B - b0 < E ? p.B - b0 : E;   // a ragged last tile
  const int hw = tab[tb::H] * tab[tb::H], ni = tab[tb::I], na = tab[tb::A];
  for (int e = blk.lo; e < blk.hi; ++e) {
    if (e >= nv) continue;
    EnvSlot& q = S.slot[e];
    env_stream(p.seed, p.block, b0 + e, q.seed, q.row);
    reset_env<NOV>(tab, S.map + e * hw, S.inv + e * ni, q.s, q.seed, 0u, q.row);
    q.rsum = 0.0f;
    q.dcount = 0;
  }
  for (int t = 0; t < p.T; ++t) {
    const uint32_t ctr = (uint32_t)t + 1u;   // action draw and reset: t+1
    tile_obs(blk, S, nv, E, nullptr);
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
      step_env<NOV>(tab, m, inv, s, a, reward, done);
      q.rsum += reward;
      q.dcount += done ? 1 : 0;
      if (done) reset_env<NOV>(tab, m, inv, s, q.seed, ctr, q.row);
      q.s = s;
    }
  }
  for (int e = blk.lo; e < blk.hi; ++e)
    if (e < nv)
      write_env(p, hw, ni, b0 + e, S.map + e * hw, S.inv + e * ni,
                S.slot[e].s, S.slot[e].rsum, S.slot[e].dcount);
}

#if defined(__CUDACC__)

template <bool NOV>
__global__ void __launch_bounds__(256) rollout_kernel(const EnvRolloutArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* t = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < p.n_tab; i += blockDim.x) t[i] = p.tab[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  int* inv = reinterpret_cast<int*>(smem + p.off_inv) + threadIdx.x * t[tb::I];
  int8_t* m = reinterpret_cast<int8_t*>(smem + p.off_map) +
              threadIdx.x * t[tb::H] * t[tb::H];
  env_rollout<NOV>(p, t, m, inv, b);
}

template <bool NOV>
__global__ void __launch_bounds__(256) policy_rollout_kernel(const EnvRolloutArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DevBlock blk;
  tile_setup(blk, smem, p.L, p.tab, p.n_tab, p.params);
  policy_tile<NOV>(p, blk, smem, blockIdx.x);
}

// dims: the tower's widths [OBS_DIM, *hidden, A] (host memory, n_dims of
// them; 'policy' only); envs: the tile's envs ('policy'); threads: CUDA
// threads a block.
extern "C" int ngx_rollout(
    const int* tab, int n_tab, const int* dims, int n_dims,
    const int* actions, const float* params, int n_params, int source,
    int seed, int B, int T, int block, int envs, int threads, int hw,
    int n_items, int* map_out, int* ir_out, float* fr_out, int* inv_out,
    float* rsum_out, int* dcount_out, int novelty, void* stream) {
  if (block < 1 || B < 1 || T < 0 || source < SRC_PRNG || source > SRC_POLICY)
    return (int)cudaErrorInvalidValue;
  EnvRolloutArgs p = {tab, n_tab, actions, params, source, seed, B, T, block,
                      envs, map_out, ir_out, fr_out, inv_out, rsum_out,
                      dcount_out, 0, 0, TileLayout{}};
  cudaError_t e;
  size_t bytes;
  int grid;
  void (*kernel)(EnvRolloutArgs);
  if (source == SRC_POLICY) {
    e = tile_launch_layout(n_tab, dims, n_dims, envs, threads, hw, n_items,
                           false, params, n_params, p.L);
    if (e != cudaSuccess) return (int)e;
    bytes = p.L.bytes;
    grid = (B + envs - 1) / envs;
    kernel = novelty ? policy_rollout_kernel<true> : policy_rollout_kernel<false>;
  } else {
    // the table, then each thread's inventory (int32) and map (int8)
    if (threads < 1 || threads > 256) return (int)cudaErrorInvalidValue;
    size_t optin = 0;
    e = smem_budget(optin);
    if (e != cudaSuccess) return (int)e;
    p.off_inv = (int)align16((size_t)n_tab * 4);
    p.off_map = p.off_inv + (int)align16((size_t)threads * n_items * 4);
    bytes = (size_t)p.off_map + (size_t)threads * hw;
    if (bytes > optin) return (int)cudaErrorInvalidValue;
    grid = (B + threads - 1) / threads;
    kernel = novelty ? rollout_kernel<true> : rollout_kernel<false>;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
