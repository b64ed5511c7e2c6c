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
// stepping env e for all T steps, the maps in int8 and the inventories in
// int32 shared memory, the table in shared memory once per block and its
// header slots by value in the constant bank (SpecHdr; 1-2% faster than
// reading them from the shared table, PERF.md).  After each step a ballot
// names the envs it finished and the warp resets them together (ngx_env.cuh
// warp_reset: the placements spread over groups of lanes, the edits' scores
// hashed once); a step that finished none costs the vote.  At the end the warp writes its
// envs' maps, inventories and registers as contiguous spans of the outputs,
// neighbouring lanes on neighbouring addresses.  'policy' runs the tile MLP
// of train_rollout.cu (ngx_env.cuh): a block of N threads owns E envs, with
// an env phase, an MLP phase and a score phase over the whole tile and an
// act phase each step (policy_tile).  Both address the RNG stream by the
// LOGICAL block (seed + (e / block) * 7919, row e % block), whatever the
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

// Shared memory of a 'prng'/'input' block of `warps` warps, byte offsets
// and strides: the table, then per warp its 32 maps (int8; at least 1,152
// bytes, which stage the registers at the end), its 32 inventories and
// `rows` rows of hw edit scores (none without reset edits).
struct WarpLayout {
  int off_map, map_stride, off_inv, off_score, score_stride, bytes;
};

NGX_HD WarpLayout warp_layout(int n_tab, int hw, int ni, int rows, int warps) {
  WarpLayout L;
  L.off_map = (int)align16((size_t)n_tab * 4);
  L.map_stride = (int)align16(32 * hw > 32 * 9 * 4 ? 32 * hw : 32 * 9 * 4);
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

// After warp_reset at ctr: the fresh registers of each env of `mask`, set
// by its own lane from its stream (sd, rw).
template <class W, class Hdr>
NGX_HD void fresh_regs(const W& w, const Hdr& hd, const int* tab,
                       unsigned mask, uint32_t ctr,
                       const Lanes<uint32_t, W::N>& sd,
                       const Lanes<uint32_t, W::N>& rw, Lanes<Regs, W::N>& s) {
  for (int L = w.lo; L < w.hi; ++L) {
    if (!((mask >> L) & 1u)) continue;
    int acell, facing;
    reset_draw(hd, tab, sd[L], ctr, rw[L], acell, facing);
    s[L] = Regs{acell / hd[tb::H], acell % hd[tb::H], facing, -1, 0, 0, 0,
                0.0f, 0.0f};
  }
}

// ---- 'prng' / 'input': the whole rollout of envs b0 .. b0 + 31, a warp ---
// smap, sinv, score: the warp's maps, inventories and edit-score rows.  In
// a ragged last warp the lanes past the batch step throwaway envs of their
// own, left out of the votes and the outputs: no lane test on the step's
// chain.  INPUT: the actions come from p.actions ('input'), else from the
// counter RNG ('prng').
template <bool NOV, bool INPUT, class W, class Hdr>
NGX_HD void warp_rollout(const EnvRolloutArgs& p, const W& w, const Hdr& hd,
                         const int* tab, int8_t* smap, int* sinv,
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
      const int a = INPUT ? (L < nv ? p.actions[(size_t)t * p.B + b0 + L] : 0)
                          : rng_randint(sd[L], ctr, SALT_PRNG_ACTION, rw[L], 0, na);
      float reward;
      bool d;
      step_env<NOV>(hd, tab, smap + L * hw, sinv + L * ni, s[L], a, reward, d);
      rsum[L] += reward;
      dcount[L] += d ? 1 : 0;
      done[L] = d;
    }
    const unsigned mask = w.ballot(done) & live;
    if (mask) {
      warp_reset<NOV>(w, tab, smap, sinv, score, mask, p.lanes, p.seed,
                      p.block, b0, ctr);
      fresh_regs(w, hd, tab, mask, ctr, sd, rw, s);
    }
  }
  // the outputs as contiguous spans: the maps and inventories from shared
  // memory, then the registers staged in the maps' place
  w.sync();
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
      step_env<NOV>(tab, tab, m, inv, s, a, reward, done);
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

// The checks and the shared-memory layout of a 'prng'/'input' launch within
// the card's opt-in budget (warp_fit).
static inline cudaError_t warp_launch_layout(int n_tab, int hw, int ni,
                                             bool edits, int threads,
                                             int& lanes, WarpLayout& W) {
  if (threads < 32 || threads > 256 || threads % 32 || lanes < 1 ||
      lanes > 32 || (lanes & (lanes - 1)))
    return cudaErrorInvalidValue;
  size_t optin = 0;
  const cudaError_t e = smem_budget(optin);
  if (e != cudaSuccess) return e;
  return warp_fit(n_tab, hw, ni, edits, threads / 32, optin, lanes, W)
             ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool NOV, bool INPUT>
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
  warp_rollout<NOV, INPUT>(
      p, w, hd, t,
      reinterpret_cast<int8_t*>(smem + p.W.off_map + warp * p.W.map_stride),
      reinterpret_cast<int*>(smem + p.W.off_inv) + warp * 32 * hd[tb::I],
      reinterpret_cast<uint32_t*>(smem + p.W.off_score + warp * p.W.score_stride),
      b0);
}

template <bool NOV>
__global__ void __launch_bounds__(256) policy_rollout_kernel(const EnvRolloutArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DevBlock blk;
  tile_setup(blk, smem, p.L, p.tab, p.n_tab, p.params);
  policy_tile<NOV>(p, blk, smem, blockIdx.x);
}

// hdr: the table's header slots (host memory, tb::N_TAB + 1 of them); dims:
// the tower's widths [OBS_DIM, *hidden, A] (host memory, n_dims of them;
// 'policy' only); envs: the tile's envs ('policy'); threads: CUDA threads a
// block (a multiple of 32 in 'prng'/'input'); lanes: the fewest lanes that
// reset one env ('prng'/'input').
extern "C" int ngx_rollout(
    const int* tab, int n_tab, const int* hdr, const int* dims, int n_dims,
    const int* actions, const float* params, int n_params, int source,
    int seed, int B, int T, int block, int envs, int threads, int lanes,
    int hw, int n_items, int* map_out, int* ir_out, float* fr_out,
    int* inv_out, float* rsum_out, int* dcount_out, int novelty,
    void* stream) {
  if (block < 1 || B < 1 || T < 0 || source < SRC_PRNG || source > SRC_POLICY)
    return (int)cudaErrorInvalidValue;
  EnvRolloutArgs p = {tab, n_tab, actions, params, source, seed, B, T, block,
                      envs, lanes, map_out, ir_out, fr_out, inv_out, rsum_out,
                      dcount_out, WarpLayout{}, TileLayout{}};
  cudaError_t e;
  size_t bytes;
  int grid;
  if (source == SRC_POLICY) {
    e = tile_launch_layout(n_tab, dims, n_dims, envs, threads, hw, n_items,
                           false, params, n_params, p.L);
    if (e != cudaSuccess) return (int)e;
    bytes = p.L.bytes;
    grid = (B + envs - 1) / envs;
    auto kernel = novelty ? policy_rollout_kernel<true> : policy_rollout_kernel<false>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
  }
  if (!hdr) return (int)cudaErrorInvalidValue;
  SpecHdr hd;
  std::memcpy(hd.v, hdr, sizeof(hd.v));
  if (hd[tb::N_TAB] != n_tab || hd[tb::H] * hd[tb::H] != hw ||
      hd[tb::I] != n_items)
    return (int)cudaErrorInvalidValue;
  e = warp_launch_layout(n_tab, hw, n_items, novelty && hd[tb::NEDIT] > 0,
                         threads, p.lanes, p.W);
  if (e != cudaSuccess) return (int)e;
  bytes = p.W.bytes;
  grid = (B + threads - 1) / threads;
  const bool input = source == SRC_INPUT;
  auto kernel = novelty ? (input ? rollout_kernel<true, true> : rollout_kernel<true, false>)
                        : (input ? rollout_kernel<false, true> : rollout_kernel<false, false>);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(p, hd);
  return (int)cudaGetLastError();
}

// The dynamic shared-memory bytes of a 'prng'/'input' block (0 where the
// launch would be refused) and, in *lanes, the fewest lanes a reset then
// takes; for the record of a run.
extern "C" int ngx_rollout_smem(int n_tab, int hw, int n_items, int edits,
                                int threads, int* lanes) {
  WarpLayout W;
  return warp_launch_layout(n_tab, hw, n_items, edits != 0, threads, *lanes,
                            W) == cudaSuccess ? W.bytes : 0;
}

#endif  // __CUDACC__
