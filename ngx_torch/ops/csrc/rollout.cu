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
// (9,280 an env-step at hidden (64, 64)) through a global [k][B] scratch.
//
// Design: the same as train_rollout.cu, whose device code (ngx_env.cuh) it
// shares — one thread owns one env for all T steps, its map in int8 shared
// memory and its inventory in int32 shared memory, the tables (and the
// weights, where they fit) in shared memory once per thread block, and the
// RNG stream addressed by the LOGICAL block (seed + (e / block) * 7919,
// row e % block) whatever blockDim is.
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
  int n_params;
  int params_in_smem;
  int source, seed, B, T, block;
  float* scratch;         // [2, maxw, B], 'policy' mode
  int maxw;
  int* map_out;
  int* ir_out;
  float* fr_out;
  int* inv_out;
  float* rsum_out;
  int* dcount_out;
  int off_params, off_inv, off_map;   // byte offsets into dynamic smem
};

// ---- the whole rollout of env b ------------------------------------------
template <bool NOV>
NGX_HD void env_rollout(const EnvRolloutArgs& p, const int* tab,
                        const float* params, int8_t* m, int* inv, int b) {
  const int hw = tab[tb::H] * tab[tb::H], ni = tab[tb::I];
  uint32_t seed, row;
  env_stream(p.seed, p.block, b, seed, row);
  Regs s;
  reset_env<NOV>(tab, m, inv, s, seed, 0u, row);
  float rsum = 0.0f;
  int dcount = 0;
  for (int t = 0; t < p.T; ++t) {
    const uint32_t ctr = (uint32_t)t + 1u;   // action draw and reset: t+1
    int a;
    if (p.source == SRC_INPUT)
      a = p.actions[(size_t)t * p.B + b];
    else if (p.source == SRC_PRNG)
      a = rng_randint(seed, ctr, SALT_PRNG_ACTION, row, 0, tab[tb::A]);
    else
      a = policy_act(tab, params, m, inv, s, p.scratch + b,
                     p.scratch + (size_t)p.maxw * p.B + b, p.B, nullptr,
                     seed, ctr, row);
    float reward;
    bool done;
    step_env<NOV>(tab, m, inv, s, a, reward, done);
    rsum += reward;
    dcount += done ? 1 : 0;
    if (done) reset_env<NOV>(tab, m, inv, s, seed, ctr, row);
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
  p.rsum_out[b] = rsum;
  p.dcount_out[b] = dcount;
}

#if defined(__CUDACC__)

template <bool NOV>
__global__ void __launch_bounds__(256) rollout_kernel(const EnvRolloutArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int* tab;
  const float* params;
  int* inv;
  int8_t* m;
  block_setup(smem, p.tab, p.n_tab, p.params, p.n_params, p.params_in_smem,
              p.off_params, p.off_inv, p.off_map, tab, params, inv, m);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  env_rollout<NOV>(p, tab, params, m, inv, b);
}

extern "C" int ngx_rollout(
    const int* tab, int n_tab, const int* actions, const float* params,
    int n_params, int source, int seed, int B, int T, int block, int threads,
    int hw, int n_items, float* scratch, int maxw, int* map_out, int* ir_out,
    float* fr_out, int* inv_out, float* rsum_out, int* dcount_out,
    int novelty, void* stream) {
  if (threads < 1 || threads > 256 || block < 1 || B < 1 || T < 0 ||
      source < SRC_PRNG || source > SRC_POLICY)
    return (int)cudaErrorInvalidValue;
  SmemLayout L;
  cudaError_t e = smem_layout(n_tab, n_params, threads, n_items, hw, L);
  if (e != cudaSuccess) return (int)e;
  EnvRolloutArgs p = {tab, n_tab, actions, params, n_params, L.params_in_smem,
                      source, seed, B, T, block, scratch, maxw, map_out,
                      ir_out, fr_out, inv_out, rsum_out, dcount_out,
                      (int)L.off_params, (int)L.off_inv, (int)L.off_map};
  auto kernel = novelty ? rollout_kernel<true> : rollout_kernel<false>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)L.bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (B + threads - 1) / threads;
  kernel<<<grid, threads, L.bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
