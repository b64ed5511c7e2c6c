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
// The env, RNG, lidar, MLP and Gumbel device code is shared with rollout.cu
// in ngx_env.cuh.  Parity hazards (see train_rollout.py and ngx_env.cuh):
// uint32 arithmetic is native here; the Gumbel score uses logf (not __logf)
// and the MLP sums in another order than torch's matmul, so an action can
// differ from the twin only at a near-tie of the top two scores.  Built
// without -use_fast_math.

#include "ngx_env.cuh"

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
  // pool mode (pool_map non-null): [B, R, HW], [B, R, I], [B, R, 4] (row,
  // col, facing, step_count), the cap base in and out [B]
  const int* pool_map;
  const int* pool_inv;
  const int* pool_sc;
  int R;
  const int* base_in;
  int* base_out;
  int off_params, off_inv, off_map;   // byte offsets into dynamic smem
};

// ---- the whole rollout of env b ------------------------------------------
template <bool NOV>
NGX_HD void rollout_env(const RolloutArgs& p, const int* tab,
                        const float* params, int8_t* m, int* inv, int b) {
  const int hw = tab[tb::H] * tab[tb::H], ni = tab[tb::I], B = p.B, od = tab[tb::OBS_DIM];
  uint32_t seed, row;
  env_stream(p.seed, p.block, b, seed, row);
  for (int i = 0; i < hw; ++i) m[i] = (int8_t)p.map_in[(size_t)b * hw + i];
  for (int i = 0; i < ni; ++i) inv[i] = p.inv_in[(size_t)b * ni + i];
  const int* ir = p.ir_in + (size_t)b * 7;
  Regs s = {ir[0], ir[1], ir[2], ir[3], ir[4], ir[5], ir[6],
            p.fr_in[(size_t)b * 2], p.fr_in[(size_t)b * 2 + 1]};
  float* buf0 = p.scratch + b;
  float* buf1 = p.scratch + (size_t)p.maxw * B + b;
  const bool pool = p.pool_map != nullptr;
  int base = pool ? p.base_in[b] : 0;
  int n_done = 0;
  for (int t = 0; t < p.T; ++t) {
    const uint32_t ctr = (uint32_t)t + 1u;   // action draw and reset: t+1
    const size_t tb = (size_t)t * B + b;
    const int a = policy_act(tab, params, m, inv, s, buf0, buf1, B,
                             p.obs_out + tb * od, seed, ctr, row);
    float reward;
    bool done;
    step_env<NOV>(tab, m, inv, s, a, reward, done);
    // the trainer's time limit, counted from the restore's base (:976)
    done = done || s.step_count - base >= p.cap;
    p.act_out[tb] = a;
    p.rew_out[tb] = reward;
    p.done_out[tb] = done ? 1 : 0;
    if (!done) continue;
    if (!pool) {
      reset_env<NOV>(tab, m, inv, s, seed, ctr, row);
      continue;
    }
    // the next pool slot (:983-1003)
    n_done += 1;
    const size_t slot = (size_t)b * p.R + (size_t)((n_done - 1) % p.R);
    for (int i = 0; i < hw; ++i) m[i] = (int8_t)p.pool_map[slot * hw + i];
    for (int i = 0; i < ni; ++i) inv[i] = p.pool_inv[slot * ni + i];
    const int* sc = p.pool_sc + slot * 4;
    s = {sc[0], sc[1], sc[2], -1, sc[3], 0, 0, 0.0f, 0.0f};
    base = sc[3];
  }
  if (pool) p.base_out[b] = base;
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

template <bool NOV>
__global__ void __launch_bounds__(256) train_rollout_kernel(const RolloutArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int* tab;
  const float* params;
  int* inv;
  int8_t* m;
  block_setup(smem, p.tab, p.n_tab, p.params, p.n_params, p.params_in_smem,
              p.off_params, p.off_inv, p.off_map, tab, params, inv, m);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  rollout_env<NOV>(p, tab, params, m, inv, b);
}

extern "C" int ngx_train_rollout(
    const int* tab, int n_tab, const int* map_in, const int* ir_in,
    const float* fr_in, const int* inv_in, const float* params, int n_params,
    int seed, int B, int T, int block, int cap, int threads, int hw,
    int n_items, float* scratch, int maxw, int* map_out, int* ir_out,
    float* fr_out, int* inv_out, float* obs_out, int* act_out, float* rew_out,
    unsigned char* done_out, const int* pool_map, const int* pool_inv,
    const int* pool_sc, int R, const int* base_in, int* base_out,
    int novelty, void* stream) {
  if (threads < 1 || threads > 256 || block < 1 || B < 1 || T < 0 ||
      (pool_map && (R < 1 || !pool_inv || !pool_sc || !base_in || !base_out)))
    return (int)cudaErrorInvalidValue;
  SmemLayout L;
  cudaError_t e = smem_layout(n_tab, n_params, threads, n_items, hw, L);
  if (e != cudaSuccess) return (int)e;
  RolloutArgs p = {tab, n_tab, map_in, ir_in, fr_in, inv_in, params, n_params,
                   L.params_in_smem, seed, B, T, block, cap, scratch, maxw,
                   map_out, ir_out, fr_out, inv_out, obs_out, act_out, rew_out,
                   done_out, pool_map, pool_inv, pool_sc, R, base_in, base_out,
                   (int)L.off_params, (int)L.off_inv, (int)L.off_map};
  auto kernel = novelty ? train_rollout_kernel<true> : train_rollout_kernel<false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)L.bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (B + threads - 1) / threads;
  kernel<<<grid, threads, L.bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* ngx_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

#endif  // __CUDACC__
