"""The acting rollout's plain twin (ngx_torch/ops/train_rollout.py) against
the TPU kernel make_pallas_train_rollout in interpret mode, ActorCritic
against flax, and the CUDA source's device code built for the host."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ngx
from ngx.ops import pallas_rollout as P
from ngx.rl.models import ActorCritic as FlaxActorCritic
import ngx_torch as nt
from ngx_torch.core.state import EnvState
from ngx_torch.ops import train_rollout as TR
from ngx_torch.ops._build import CSRC, declare
from ngx_torch.ops.rng import block_streams
from ngx_torch.ops.tables import HEADER, c_ints, tower_buffer
from ngx_torch.rl.models import ActorCritic

# one torch thread per test process: xdist runs several on the CPU, where
# more threads only contend (the port's suite runs twice as fast)
torch.set_num_threads(1)

POGO = "NovelGridworld-Pogostick-v1"
# an action may differ between two implementations of the MLP only where
# the top-2 Gumbel scores are this close (float32 sums in another order)
TIE_GAP = 1e-4


def _flax_params(obs_dim, n_actions, hidden, seed):
    model = FlaxActorCritic(n_actions=n_actions, hidden=hidden)
    params = model.init(jax.random.key(seed), jnp.zeros((1, obs_dim)))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _layers(obs_dim, n_actions, hidden, params):
    m = ActorCritic(obs_dim, n_actions, hidden).load_flax_params(params)
    return [(w.detach(), b.detach()) for w, b in m.pi_layers()]


def _assert_agree(a, b, layers, seed, block):
    """compare_rollouts plus: every action mismatch is a near-tie."""
    first, bad = TR.compare_rollouts(a, b)
    assert bad == [], bad
    T = a[2].shape[0]
    seeds, rows = block_streams(seed, a[2].shape[1], block)
    mism = (first < T).nonzero()[:, 0].tolist()
    for e in mism:
        t = int(first[e])
        logits = TR.mlp_logits(a[1][t, e][None], layers)
        top2 = torch.topk(TR.gumbel_scores(logits, seeds[e:e + 1], t + 1,
                                           rows[e:e + 1])[0], 2).values
        assert float(top2[0] - top2[1]) < TIE_GAP, (e, t, top2)
    assert len(mism) <= 0.01 * a[2].shape[1], len(mism)
    return first


def _start_state(sp, B, cap, seed):
    """Counter-reset states whose episode clocks are spread so that cap
    truncations (native auto-resets) fire inside a short rollout."""
    st = P.make_xla_pool_reset(sp, B)(seed, 0)
    clock = np.random.RandomState(seed).randint(0, cap, size=B)
    return st.replace(step_count=jnp.asarray(clock, jnp.int32),
                      last_done=st.last_done.astype(bool))


def test_header_matches_cuda_enum():
    src = (CSRC / "ngx_env.cuh").read_text()
    body = re.search(r"namespace tb \{\s*enum : int \{(.*?)\};", src,
                     re.S).group(1)
    assert tuple(re.findall(r"\b[A-Z_][A-Z0-9_]*\b", body)) == HEADER


def test_has_novelty_marks_the_specs_with_novelty_code():
    """The kernels compile the novelty branches in only where has_novelty
    holds: never for a preset, always for a novelty with code of its own
    (the table-valued ones, breakincrease, extractincdec and remapaction,
    need none)."""
    from ngx_torch.ops.tables import has_novelty
    from test_torch_spec import NOVELTIES, SUPPORTED, novelty_specs

    for env_id in SUPPORTED:
        sp = nt.make_spec(env_id)
        assert not has_novelty(sp) and not has_novelty(nt.lidar_in_front(sp))
    table_only = {"breakincrease", "extractincdec", "remapaction"}
    for env_id, novelty in NOVELTIES:
        sp = novelty_specs(nt, env_id, (novelty,))
        assert has_novelty(sp) == (novelty[0] not in table_only), novelty


def test_actor_critic_matches_flax():
    sp = ngx.transforms.lidar_in_front(ngx.make_spec(POGO))
    obs_dim, A = 63, sp.n_actions
    for hidden in ((64, 64), (16,)):
        model, params = _flax_params(obs_dim, A, hidden, 1)
        x = np.random.RandomState(0).randint(0, 9, (50, obs_dim)).astype(
            np.float32)
        lj, vj = model.apply(params, jnp.asarray(x))
        m = ActorCritic(obs_dim, A, hidden).load_flax_params(params)
        lt, vt = m(torch.as_tensor(x))
        np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                                   atol=1e-5)
        np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vj),
                                   atol=1e-5)
    # the init is flax's lecun_normal: truncated at 2 std, zero biases
    m = ActorCritic(obs_dim, A, (64, 64), generator=torch.Generator()
                    .manual_seed(0))
    w = m.pi_0.weight.detach()
    std = (1 / obs_dim) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std and float(m.pi_0.bias.detach().abs().max()) == 0
    assert abs(float(w.std()) / (1 / obs_dim) ** 0.5 - 1) < 0.05


def test_plain_twin_matches_pallas_kernel():
    """B=256 in two RNG blocks of 128, T=8, episode clocks set so that about
    a tenth of the envs cross a native auto-reset inside the rollout."""
    sp = ngx.transforms.lidar_in_front(ngx.make_spec(POGO))
    spt = nt.lidar_in_front(nt.make_spec(POGO))
    B, T, block, cap, seed = 256, 8, 128, 80, 2 ** 31 - 11
    st = _start_state(sp, B, cap, 4)
    _, params = _flax_params(63, sp.n_actions, (64, 64), 1)
    run = P.make_pallas_train_rollout(sp, B, T, block=block, cap=cap,
                                      interpret=True)
    want = jax.jit(lambda s, x, p: run(s, x, p))(seed, st, params)
    want = (EnvState.from_ngx(want[0]),) + tuple(
        torch.as_tensor(np.array(x)) for x in want[1:])
    layers = _layers(63, sp.n_actions, (64, 64), params)
    got = TR.train_rollout_plain(spt, EnvState.from_ngx(st), layers, seed,
                                 T, block=block, cap=cap)
    first = _assert_agree(want, got, layers, seed, block)
    done = want[4]
    assert int(done.sum()) >= 10, int(done.sum())
    # resets inside the compared prefix, and their next obs compared too
    steps = torch.arange(T)[:, None]
    assert int((done & (steps < first[None, :] - 1)).sum()) >= 10


def test_wrapper_on_cpu_runs_the_twin():
    spt = nt.lidar_in_front(nt.make_spec("NovelGridworld-Bow-v1"))
    st = nt.counter_reset(spt, 3, 0, 128, device="cpu")
    m = ActorCritic(63, spt.n_actions, (16, 16),
                    generator=torch.Generator().manual_seed(2))
    layers = [(w.detach(), b.detach()) for w, b in m.pi_layers()]
    n0 = dict(TR.train_rollout.launches)
    a = TR.train_rollout(spt, st, layers, 5, 6, block=128, cap=4)
    b = TR.train_rollout_plain(spt, st, layers, 5, 6, block=128, cap=4)
    assert TR.train_rollout.launches == n0
    first, bad = TR.compare_rollouts(a, b)
    assert bad == [] and bool((first == 6).all())
    assert a[1].dtype == torch.float32 and a[4].dtype == torch.bool
    assert a[1].shape == (6, 128, 63) and int(a[4].sum()) >= 128


# The CUDA sources' device code built for the host with g++, behind the same
# C entry points as the CUDA library, so the launch wrappers
# (ngx_torch.ops.train_rollout.launch, ngx_torch.ops.rollout.launch) drive it
# on the CPU.  The tile-MLP entry points drive tiles of E envs through the
# kernels' own time loop on a HostBlock (its phases run every thread index in
# order, its barriers do nothing) in a buffer laid out as the card's shared
# memory, with the card's opt-in budget, so the weights stream in chunks
# exactly where they would on the card; 'prng' and 'input' run the kernel's
# warps in turn on a HostWarp (each phase runs the 32 lanes in order, the
# warp's collectives are loops) in one warp's shared-memory layout.
# tests/test_torch_rollout.py builds it too.
HOST_SHIM = r"""
#include "train_rollout.cu"
#include "rollout.cu"
#include <vector>

// the H100's opt-in shared memory per block (cudaDevAttrMaxSharedMemoryPerBlockOptin)
static const size_t SMEM_BUDGET = 232448;

struct HostSmem {
  std::vector<vec4> buf;
  explicit HostSmem(int bytes) : buf(bytes / 16 + 1) {}
  unsigned char* data() { return reinterpret_cast<unsigned char*>(buf.data()); }
};

static bool tile_ok(int envs, int threads) {
  return envs >= 4 && envs % 4 == 0 && threads >= envs && threads <= 256;
}

extern "C" int ngx_train_rollout(
    const int* tab, int n_tab, const int* dims, int n_dims, const int* map_in,
    const int* ir_in, const float* fr_in, const int* inv_in,
    const float* params, int n_params, int seed, int B, int T, int block,
    int cap, int envs, int threads, int hw, int n_items, int* map_out,
    int* ir_out, float* fr_out, int* inv_out, float* obs_out, int* act_out,
    float* rew_out, unsigned char* done_out, const int* pool_map,
    const int* pool_inv, const int* pool_sc, int R, const int* base_in,
    int* base_out, int novelty, void*) {
  TileLayout L;
  if (!tile_ok(envs, threads) ||
      !tile_layout(n_tab, dims, n_dims, envs, hw, n_items, true, SMEM_BUDGET, L) ||
      L.n_params != n_params)
    return 1;
  RolloutArgs p = {tab, n_tab, map_in, ir_in, fr_in, inv_in, params, seed, B,
                   T, block, cap, envs, map_out, ir_out, fr_out, inv_out,
                   obs_out, act_out, rew_out, done_out, pool_map, pool_inv,
                   pool_sc, R, base_in, base_out, L};
  HostSmem smem(L.bytes);
  const HostBlock blk(threads);
  for (int tile = 0; tile * envs < B; ++tile) {
    tile_setup(blk, smem.data(), L, tab, n_tab, params);
    novelty ? rollout_tile<true>(p, blk, smem.data(), tile)
            : rollout_tile<false>(p, blk, smem.data(), tile);
  }
  return 0;
}

static SpecHdr host_hdr(const int* hdr) {
  SpecHdr hd;
  std::memcpy(hd.v, hdr, sizeof(hd.v));
  return hd;
}

// One warp's shared memory (the kernel's layout at one warp a block, with
// the score rows of `lanes` a reset) and its three regions.
struct HostWarpSmem {
  WarpLayout L;
  HostSmem smem;
  HostWarpSmem(int n_tab, int hw, int ni, bool edits, int lanes)
      : L(warp_layout(n_tab, hw, ni, edits ? 32 / lanes : 0, 1)), smem(L.bytes) {}
  int8_t* map() { return reinterpret_cast<int8_t*>(smem.data() + L.off_map); }
  int* inv() { return reinterpret_cast<int*>(smem.data() + L.off_inv); }
  uint32_t* score() { return reinterpret_cast<uint32_t*>(smem.data() + L.off_score); }
};

// The warp rollout of variant v (warp_variant), as the kernel's.
template <bool NOV>
static auto host_warp_fn(int v)
    -> decltype(&warp_rollout<NOV, WV_PRNG, HostWarp, SpecHdr>) {
  switch (v) {
    case WV_INPUT: return warp_rollout<NOV, WV_INPUT, HostWarp, SpecHdr>;
    case WV_HASH: return warp_rollout<NOV, WV_HASH, HostWarp, SpecHdr>;
    case WV_FIXED: return warp_rollout<NOV, WV_FIXED, HostWarp, SpecHdr>;
    case WV_NO_RESET: return warp_rollout<NOV, WV_NO_RESET, HostWarp, SpecHdr>;
    case WV_PACKED: return warp_rollout<NOV, WV_PACKED, HostWarp, SpecHdr>;
    default: return warp_rollout<NOV, WV_PRNG, HostWarp, SpecHdr>;
  }
}

extern "C" int ngx_rollout(
    const int* tab, int n_tab, const int* hdr, const int* dims, int n_dims,
    const int* actions, const float* params, int n_params, int source,
    int action_rng, int auto_reset, int seed, int B, int T, int block,
    int envs, int threads, int lanes, int hw, int n_items, int* map_out,
    int* ir_out, float* fr_out, int* inv_out, float* rsum_out,
    int* dcount_out, int* packed_out, int novelty, void*) {
  EnvRolloutArgs p = {tab, n_tab, actions, params, source, seed, B, T, block,
                      envs, lanes, map_out, ir_out, fr_out, inv_out, rsum_out,
                      dcount_out, WarpLayout{}, TileLayout{}, packed_out};
  if (source != SRC_POLICY) {
    // the warps of the kernel in turn, each through the card's phases
    const int v = warp_variant(source, action_rng, auto_reset, packed_out != nullptr);
    if (v < 0 || threads < 32 || threads > 256 || threads % 32 || lanes < 1 ||
        lanes > 32 || (lanes & (lanes - 1)))
      return 1;
    const SpecHdr hd = host_hdr(hdr);
    const bool edits = novelty && hd[tb::NEDIT] > 0;
    if (!warp_fit(n_tab, hw, n_items, edits, threads / 32, SMEM_BUDGET,
                  p.lanes, p.W))
      return 1;
    HostWarpSmem sm(n_tab, hw, n_items, edits, p.lanes);
    const HostWarp w;
    auto run = novelty ? host_warp_fn<true>(v) : host_warp_fn<false>(v);
    for (int b0 = 0; b0 < B; b0 += 32)
      run(p, w, hd, tab, sm.map(), sm.inv(), sm.score(), b0);
    return 0;
  }
  if (action_rng != RNG_COUNTER || !auto_reset || packed_out ||
      !tile_ok(envs, threads) ||
      !tile_layout(n_tab, dims, n_dims, envs, hw, n_items, false, SMEM_BUDGET, p.L) ||
      p.L.n_params != n_params)
    return 1;
  HostSmem smem(p.L.bytes);
  const HostBlock blk(threads);
  for (int tile = 0; tile * envs < B; ++tile) {
    tile_setup(blk, smem.data(), p.L, tab, n_tab, params);
    novelty ? policy_tile<true>(p, blk, smem.data(), tile)
            : policy_tile<false>(p, blk, smem.data(), tile);
  }
  return 0;
}

extern "C" int ngx_tile_smem(int n_tab, const int* dims, int n_dims, int envs,
                             int hw, int n_items, int obs_stage) {
  TileLayout L;
  return tile_layout(n_tab, dims, n_dims, envs, hw, n_items, obs_stage != 0,
                     SMEM_BUDGET, L) ? L.bytes : 0;
}

extern "C" int ngx_rollout_smem(int n_tab, int hw, int n_items, int edits,
                                int threads, int* lanes) {
  WarpLayout W;
  return warp_fit(n_tab, hw, n_items, edits != 0, threads / 32, SMEM_BUDGET,
                  *lanes, W) ? W.bytes : 0;
}

extern "C" const char* ngx_error_string(int) { return "host build"; }

extern "C" int ngx_ceil_percent(int count, int p) { return ceil_percent(count, p); }

// The warp reset alone: the envs of `mask` among b0 .. b0 + 31 reset at ctr
// by the card's phases (warp_reset), their state written to rows 0..31 of
// the outputs (the others' rows untouched).
extern "C" void ngx_warp_reset(const int* tab, int n_tab, const int* hdr,
                               int seed, int block, int b0, int ctr,
                               unsigned mask, int lanes, int novelty,
                               int* map_out, int* ir_out, float* fr_out,
                               int* inv_out) {
  const SpecHdr hd = host_hdr(hdr);
  const int hw = hd[tb::H] * hd[tb::H], ni = hd[tb::I];
  HostWarpSmem sm(n_tab, hw, ni, novelty && hd[tb::NEDIT] > 0, lanes);
  novelty ? warp_reset<true>(HostWarp(), tab, sm.map(), sm.inv(), sm.score(),
                             mask, lanes, seed, block, b0, (uint32_t)ctr)
          : warp_reset<false>(HostWarp(), tab, sm.map(), sm.inv(), sm.score(),
                              mask, lanes, seed, block, b0, (uint32_t)ctr);
  for (int e = 0; e < 32; ++e) {
    if (!((mask >> e) & 1u)) continue;
    for (int i = 0; i < hw; ++i) map_out[e * hw + i] = sm.map()[e * hw + i];
    for (int i = 0; i < ni; ++i) inv_out[e * ni + i] = sm.inv()[e * ni + i];
    uint32_t sd, rw;
    int acell, facing;
    env_stream(seed, block, b0 + e, sd, rw);
    reset_draw(hd, tab, sd, (uint32_t)ctr, rw, acell, facing);
    const Regs s = {acell / hd[tb::H], acell % hd[tb::H], facing, -1, 0, 0, 0,
                    0.0f, 0.0f};
    const int ir[7] = {s.r, s.c, s.facing, s.selected, s.step_count,
                       s.last_action, s.last_done};
    for (int i = 0; i < 7; ++i) ir_out[e * 7 + i] = ir[i];
    fr_out[e * 2] = s.last_reward;
    fr_out[e * 2 + 1] = s.last_cost;
  }
}

// The group first maximum: lane l's candidate (u24[l], idx[l]), none where
// idx[l] < 0; out[l] the index that wins in l's group of g lanes, -1 where
// the group has no candidate.
extern "C" void ngx_first_max(const unsigned* u24, const int* idx, int g,
                              int* out) {
  Lanes<Key, 32> key;
  for (int l = 0; l < 32; ++l) key[l] = idx[l] < 0 ? 0 : first_max_key(u24[l], idx[l]);
  HostWarp().group_max(key, g);
  for (int l = 0; l < 32; ++l) out[l] = key[l] ? first_max_index(key[l]) : -1;
}

// The two selections on given scores (NOT_ELIGIBLE off the eligible cells):
// the groups' bisection over stored scores, every group of g lanes on its
// own copy of the row (the first group's threshold returned), and the
// per-lane one that calls a score function every round.
extern "C" unsigned ngx_group_threshold(const unsigned* score, int hw, int n,
                                        int g) {
  std::vector<unsigned> rows((size_t)(32 / g) * hw);
  Lanes<const uint32_t*, 32> row;
  Lanes<int, 32> nn;
  Lanes<uint32_t, 32> thr;
  for (int l = 0; l < 32; ++l) {
    row[l] = rows.data() + (l / g) * hw;
    nn[l] = n;
  }
  for (size_t i = 0; i < rows.size(); ++i) rows[i] = score[i % hw];
  group_threshold(HostWarp(), row, hw, g, nn, thr);
  for (int l = 0; l < 32; ++l)
    if (thr[l] != thr[0]) return 0;   // a group disagrees
  return thr[0];
}

extern "C" unsigned ngx_edit_threshold(const unsigned* score, int hw, int n) {
  return edit_threshold(hw, n, [score](int cell) { return score[cell]; });
}

// The tile MLP alone: nv envs' obs rows x [nv][dims[0]] through the tower
// (tower_buffer's layout) on one tile of E envs and N threads within a
// shared-memory budget; the logits go to out [nv][A].  The columns of the
// missing envs of a ragged tile hold NaN.  Returns the chunk rows (0 where
// the weights are resident), -1 where nothing fits.
extern "C" int ngx_tile_mlp(const int* dims, int n_dims, const float* tower,
                            const float* x, int nv, int E, int N, long budget,
                            float* out) {
  std::vector<int> tab(tb::N_TAB + n_dims, 0);
  tab[tb::NH] = n_dims - 2;
  tab[tb::O_DIMS] = tb::N_TAB;
  for (int i = 0; i < n_dims; ++i) tab[tb::N_TAB + i] = dims[i];
  TileLayout L;
  if (!tile_ok(E, N) ||
      !tile_layout((int)tab.size(), dims, n_dims, E, 0, 0, false, budget, L))
    return -1;
  HostSmem smem(L.bytes);
  const HostBlock blk(N);
  tile_setup(blk, smem.data(), L, tab.data(), (int)tab.size(), tower);
  const Tile S(smem.data(), L);
  for (int k = 0; k < dims[0]; ++k)
    for (int e = 0; e < E; ++e)
      S.x[k * E + e] = e < nv ? x[e * dims[0] + k] : NAN;
  const float* lg = tile_mlp(blk, S.tab, tower, L.resident ? S.w : nullptr,
                             S.w, L.kc, L.chunk, S.x, S.y, E);
  const int na = dims[n_dims - 1];
  for (int e = 0; e < nv; ++e)
    for (int a = 0; a < na; ++a) out[e * na + a] = lg[a * E + e];
  return L.resident ? 0 : L.kc;
}

// The plain reference: one env at a time, each output bias[j] and then fmaf
// over k ascending, tanhf on the hidden layers; the tower unpadded
// [W0 (dout x din), b0, W1, b1, ...].
extern "C" void ngx_mlp_reference(const int* dims, int n_dims,
                                  const float* params, const float* x, int nv,
                                  float* out) {
  for (int e = 0; e < nv; ++e) {
    std::vector<float> a(x + (size_t)e * dims[0], x + (size_t)(e + 1) * dims[0]);
    const float* w = params;
    for (int l = 0; l + 1 < n_dims; ++l) {
      const int din = dims[l], dout = dims[l + 1];
      std::vector<float> y(dout);
      for (int j = 0; j < dout; ++j) {
        float acc = w[din * dout + j];
        for (int k = 0; k < din; ++k) acc = fmaf(w[j * din + k], a[k], acc);
        y[j] = l + 2 < n_dims ? tanhf(acc) : acc;
      }
      w += din * dout + dout;
      a = y;
    }
    for (int j = 0; j < dims[n_dims - 1]; ++j) out[e * dims[n_dims - 1] + j] = a[j];
  }
}
"""


def build_host_lib(directory):
    """Compile the shim into ``directory`` and load it with the CUDA
    library's signatures; skips the test where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' device code for the host")
    (directory / "shim.cpp").write_text(HOST_SHIM)
    so = directory / "libhost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(CSRC), "-o", str(so),
                    str(directory / "shim.cpp")],
                   check=True, capture_output=True, timeout=300)
    return declare(ctypes.CDLL(str(so)))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The CUDA sources' device code (RNG, reset, step, lidar, MLP, Gumbel
    argmax, the per-env time loop) compiled for the host with g++."""
    return build_host_lib(tmp_path_factory.mktemp("host_kernel"))


@pytest.mark.parametrize("env_id,hidden,block", [
    (POGO, (64, 64), 256), ("NovelGridworld-Bow-v0", (256, 256), 128),
    ("NovelGridworld-v6", (8,), 128), ("NovelGridworld-v5", (64, 64), 128)])
def test_kernel_device_code_matches_twin(host_lib, env_id, hidden, block):
    """The wrapper's launch path (table buffer, state packing, output
    unpacking) into the kernel's device code, against the twin, through
    native resets."""
    spt = nt.lidar_in_front(nt.make_spec(env_id))
    B, T, cap, seed = 512, 24, 100, -123457
    st = nt.counter_reset(spt, 99, 0, B, device="cpu")
    st = st.replace(step_count=torch.as_tensor(
        np.random.RandomState(0).randint(0, cap, B), dtype=torch.int32))
    obs_dim = int(nt.make_step(spt).get_obs(st).shape[1])
    m = ActorCritic(obs_dim, spt.n_actions, hidden,
                    generator=torch.Generator().manual_seed(7))
    layers = [(w.detach(), b.detach()) for w, b in m.pi_layers()]
    got = TR.launch(host_lib, spt, st, layers, seed, T, block, cap, None)
    want = TR.train_rollout_plain(spt, st, layers, seed, T, block, cap)
    _assert_agree(want, got, layers, seed, block)
    assert int(want[4].sum()) > B // 10


def test_novelty_instantiation_changes_no_plain_result(host_lib,
                                                       monkeypatch):
    """A spec without novelty through the kernel built with the novelty
    branches gives, bit for bit, what the one built without them gives:
    the flag only drops code that such a spec never takes."""
    spt = nt.lidar_in_front(nt.make_spec("NovelGridworld-v3"))
    B, T, cap, seed = 256, 24, 10, 77
    st = nt.counter_reset(spt, 5, 0, B, device="cpu")
    m = ActorCritic(_obs_dim(spt), spt.n_actions, (16, 16),
                    generator=torch.Generator().manual_seed(3))
    layers = [(w.detach(), b.detach()) for w, b in m.pi_layers()]
    plain = TR.launch(host_lib, spt, st, layers, seed, T, 128, cap, None)
    monkeypatch.setattr(TR, "has_novelty", lambda sp: True)
    novel = TR.launch(host_lib, spt, st, layers, seed, T, 128, cap, None)
    first, bad = TR.compare_rollouts(plain, novel)
    assert bad == [] and bool((first == T).all())
    assert int(plain[4].sum()) > B


def _novelty_pair(*novelty):
    """One novelty on Pogostick-v1 under LidarInFront: ngx's spec and the
    port's."""
    return (ngx.transforms.lidar_in_front(
                ngx.inject_novelty(ngx.make_spec(POGO), *novelty)),
            nt.lidar_in_front(nt.inject_novelty(nt.make_spec(POGO), *novelty)))


def _obs_dim(spt):
    state = nt.counter_reset(spt, 0, 0, 1, device="cpu")
    return int(nt.make_step(spt).get_obs(state).shape[1])


def _pallas_twin_case(novelty, B, T, cap, hidden, reset_source, R=4):
    """The Pallas kernel (interpret mode) and the plain twin from the same
    state, flax weights, seed and, in pool mode, pool (ngx's
    make_xla_pool_reset, env b's slot r at row b*R + r)."""
    sp, spt = _novelty_pair(*novelty)
    block, seed = 128, 2 ** 31 - 77
    st = _start_state(sp, B, cap, 4)
    obs_dim = _obs_dim(spt)
    _, params = _flax_params(obs_dim, sp.n_actions, hidden, 1)
    layers = _layers(obs_dim, sp.n_actions, hidden, params)
    run = P.make_pallas_train_rollout(sp, B, T, block=block, cap=cap,
                                      hidden=hidden, interpret=True,
                                      reset_source=reset_source,
                                      pool_slots=R)
    if reset_source == "pool":
        pool = P.make_xla_pool_reset(sp, B * R)(31, 0)
        pool_j = jax.tree_util.tree_map(
            lambda x: x.reshape((B, R) + x.shape[1:]), pool)
        want = jax.jit(run)(seed, st, params, pool_j,
                            jnp.zeros((B,), jnp.int32))
        got = TR.train_rollout_plain(
            spt, EnvState.from_ngx(st), layers, seed, T, block=block,
            cap=cap, pool=EnvState.from_ngx(pool),
            base=torch.zeros((B,), dtype=torch.int32))
    else:
        want = jax.jit(run)(seed, st, params)
        got = TR.train_rollout_plain(spt, EnvState.from_ngx(st), layers,
                                     seed, T, block=block, cap=cap)
    want = (EnvState.from_ngx(want[0]),) + tuple(
        torch.as_tensor(np.array(x)) for x in want[1:])
    first = _assert_agree(want, got, layers, seed, block)
    return want, first


def test_pool_twin_matches_pallas_kernel():
    """Pool mode on firewall easy, B 128, T 30, R 4, cap 10, hidden (16,
    16): per env everything, base_out included, up to its first action
    mismatch; boundaries crossed (three a env: cap truncations and deaths
    on the fire wall)."""
    want, first = _pallas_twin_case(("firewall", "easy"), 128, 30, 10,
                                    (16, 16), "pool", 4)
    done = want[4]
    steps = torch.arange(30)[:, None]
    assert int((done & (steps < first[None, :] - 1)).sum()) >= 128
    assert want[5].dtype == torch.int32 and want[5].shape == (128,)


def test_native_twin_on_novelty_matches_pallas_kernel():
    """Native mode on fence easy: the in-kernel reset with the fence edit at
    every boundary."""
    want, first = _pallas_twin_case(("fence", "easy", "oak"), 128, 12, 6,
                                    (16, 16), "native")
    steps = torch.arange(12)[:, None]
    assert int((want[4] & (steps < first[None, :] - 1)).sum()) >= 64


def _pool_inputs(spt, B, R, cap):
    """A start state and a pool whose step counts and bases are spread, so
    that the cap counts from a nonzero base (a chain restore's)."""
    rs = np.random.RandomState(3)
    st = nt.counter_reset(spt, 99, 0, B, device="cpu")
    base = torch.as_tensor(rs.randint(0, 5, B), dtype=torch.int32)
    st = st.replace(step_count=base + torch.as_tensor(
        rs.randint(0, cap, B), dtype=torch.int32))
    pool = nt.counter_reset(spt, 1234, 0, B * R, device="cpu")
    pool = pool.replace(step_count=torch.as_tensor(
        rs.randint(0, 20, B * R), dtype=torch.int32))
    return st, pool, base


@pytest.mark.parametrize("novelty,reset_source", [
    (("fence", "medium", "oak"), "pool"), (("firewall", "hard"), "pool"),
    (("fence", "easy", "oak"), "native"),
    (("axetobreak", "medium", "iron"), "native")])
def test_novelty_device_code_matches_twin(host_lib, novelty, reset_source):
    """The train kernel's device code on novelty specs against the twin:
    pool mode (restores, slot cycling, the base) and native mode (the reset
    edits at every boundary)."""
    _, spt = _novelty_pair(*novelty)
    B, T, R, cap, block, seed = 512, 30, 3, 6, 128, 4242
    st, pool, base = _pool_inputs(spt, B, R, cap)
    if reset_source == "native":
        st, pool, base = st.replace(step_count=st.step_count - base), None, \
            None
    m = ActorCritic(_obs_dim(spt), spt.n_actions, (32, 32),
                    generator=torch.Generator().manual_seed(7))
    layers = [(w.detach(), b.detach()) for w, b in m.pi_layers()]
    got = TR.launch(host_lib, spt, st, layers, seed, T, block, cap, None,
                    pool, base)
    want = TR.train_rollout_plain(spt, st, layers, seed, T, block, cap,
                                  pool, base)
    first = _assert_agree(want, got, layers, seed, block)
    assert int(want[4].sum()) > B
    if reset_source == "pool":
        assert int((want[4].sum(0) > R).sum()) > 0     # slots cycled
        assert bool((want[5][first == T] > 0).any())   # bases from the pool


# the tile MLP's widths: din 63 / 8 / 256 into dout 17 / 64 / 256
TOWERS = ((63, 64, 64, 17), (8, 256, 17), (256, 64, 256), (63, 256, 256, 17))
TILE_E, TILE_N = 32, 128
ENV_SLOT_BYTES = 60     # sizeof(EnvSlot): Regs (9 words) and 6 words more


def _align16(n):
    return (n + 15) // 16 * 16


@pytest.mark.parametrize("tile", ["full", "ragged"])
@pytest.mark.parametrize("weights", ["resident", "streamed"])
@pytest.mark.parametrize("dims", TOWERS)
def test_tile_mlp_matches_sequential_fmaf(host_lib, dims, weights, tile):
    """The shared tile MLP (tile_layout, tile_setup, tile_mlp on one tile
    of 32 envs and 128 threads) against a plain one-env-at-a-time fmaf
    loop, bit for bit, on random weights and integer obs below 256: with
    the weights resident in shared memory and streamed in chunks of 5 rows
    (the last chunk of a layer ragged), on a full tile and on a ragged one
    whose missing envs' columns hold NaN."""
    rs = np.random.RandomState(sum(dims))
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        w = rs.standard_normal((dout, din)) / np.sqrt(din)
        b = 0.1 * rs.standard_normal(dout)
        layers.append((torch.as_tensor(w, dtype=torch.float32),
                       torch.as_tensor(b, dtype=torch.float32)))
    nv = TILE_E if tile == "full" else TILE_E - 5
    x = torch.as_tensor(rs.randint(0, 256, (nv, dims[0])),
                        dtype=torch.float32)
    flat = torch.cat([t.reshape(-1) for wb in layers for t in wb])
    tower = tower_buffer(layers).contiguous()
    kc = 5
    if weights == "resident":
        budget = 1 << 24
    else:
        # the layout's fixed part (table, two tiles, env slots), then two
        # chunk buffers of kc rows of the widest padded layer
        n_tab = len(HEADER) - 1 + len(dims)
        budget = (_align16(n_tab * 4) + 2 * _align16(max(dims) * TILE_E * 4)
                  + _align16(TILE_E * ENV_SLOT_BYTES)
                  + 2 * kc * max((d + 3) // 4 * 4 for d in dims[1:]) * 4)
    host_lib.ngx_tile_mlp.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_long,
                                                     ctypes.c_void_p]
    host_lib.ngx_mlp_reference.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    host_lib.ngx_mlp_reference.restype = None
    got = torch.full((nv, dims[-1]), float("nan"))
    want = torch.full((nv, dims[-1]), float("nan"))
    rows = host_lib.ngx_tile_mlp(c_ints(dims), len(dims), tower.data_ptr(),
                                 x.data_ptr(), nv, TILE_E, TILE_N, budget,
                                 got.data_ptr())
    host_lib.ngx_mlp_reference(c_ints(dims), len(dims), flat.data_ptr(),
                               x.data_ptr(), nv, want.data_ptr())
    assert rows == (0 if weights == "resident" else kc)
    assert torch.isfinite(want).all()
    assert np.array_equal(got.numpy().view(np.int32),
                          want.numpy().view(np.int32))
    # and it is the tower: torch's matmul sums in another order
    np.testing.assert_allclose(got.numpy(), TR.mlp_logits(x, layers).numpy(),
                               rtol=1e-4, atol=1e-3)


def _tile_case(mode, B, T=16):
    """A short rollout on the host-built kernels in one of the three tile
    modes, from fixed inputs (B envs, not a multiple of the tile when B
    is); returns a function of the library and its plain twin's run."""
    from ngx_torch.ops import rollout as R

    novelty = ("fence", "medium", "oak") if mode == "pool" else None
    spt = nt.lidar_in_front(
        nt.inject_novelty(nt.make_spec(POGO), *novelty) if novelty
        else nt.make_spec(POGO))
    m = ActorCritic(_obs_dim(spt), spt.n_actions, (32, 32),
                    generator=torch.Generator().manual_seed(5))
    layers = [(w.detach(), b.detach()) for w, b in m.pi_layers()]
    seed, block, cap, dev = 991, 40, 6, torch.device("cpu")
    if mode == "policy":
        return (lambda lib: R.launch(lib, spt, B, T, seed, block, "policy",
                                     None, layers, dev, None),
                lambda: R.rollout_plain(spt, B, T, seed, block, "policy",
                                        pi_layers=layers, device=dev),
                layers, seed, block)
    st, pool, base = _pool_inputs(spt, B, 3, cap)
    if mode == "native":
        st, pool, base = st.replace(step_count=st.step_count - base), None, \
            None
    return (lambda lib: TR.launch(lib, spt, st, layers, seed, T, block, cap,
                                  None, pool, base),
            lambda: TR.train_rollout_plain(spt, st, layers, seed, T, block,
                                           cap, pool, base),
            layers, seed, block)


@pytest.mark.parametrize("mode", ["native", "pool", "policy"])
def test_ragged_tile_matches_twin(host_lib, mode):
    """B 200, not a multiple of the 32-env tile: the last tile's 8 envs
    against the twin as much as every other, in each tile mode."""
    B = 200
    run, plain, layers, seed, block = _tile_case(mode, B)
    got, want = run(host_lib), plain()
    if mode == "policy":
        same = torch.ones(B, dtype=torch.bool)
        for k, v in want[0].__dict__.items():
            same &= (getattr(got[0], k) == v).reshape(B, -1).all(1)
        same &= (got[1] == want[1]) & (got[2] == want[2])
        assert int((~same).sum()) <= 0.01 * B
        assert bool(same[B - B % TILE_E:].all())
        return
    first = _assert_agree(want, got, layers, seed, block)
    assert bool((first[B - B % TILE_E:] == got[2].shape[0]).all())
    assert int(want[4].sum()) > B


@pytest.mark.parametrize("geometry", [(16, 16), (16, 64), (64, 256)])
def test_tile_geometry_changes_no_result(host_lib, monkeypatch, geometry):
    """The tile geometry (E envs, N threads a block) changes no output bit
    in any tile mode: the RNG block is logical and every output sums in
    one order."""
    from ngx_torch.ops import rollout as R

    outs = {}
    for mode in ("native", "pool", "policy"):
        run = _tile_case(mode, 200)[0]
        outs[mode] = [run(host_lib)]
        monkeypatch.setattr(TR, "ENVS", geometry[0])
        monkeypatch.setattr(TR, "THREADS", geometry[1])
        monkeypatch.setattr(R, "POLICY_ENVS", geometry[0])
        monkeypatch.setitem(R.THREADS, "policy", geometry[1])
        outs[mode].append(run(host_lib))
        monkeypatch.undo()
    for mode, (a, b) in outs.items():
        for x, y in zip(a, b):
            pairs = ([(getattr(x, k), getattr(y, k)) for k in x.__dict__]
                     if hasattr(x, "map") else [(x, y)])
            for u, v in pairs:
                assert torch.equal(u, v), mode


def test_ceil_percent_device_code(host_lib):
    """The device code's float64 ceil-percent against numpy's, for every
    count 0..400 and p 1..99."""
    for count in range(401):
        want = np.ceil(count * (np.arange(1, 100) / 100)).astype(int)
        got = [host_lib.ngx_ceil_percent(count, p) for p in range(1, 100)]
        assert got == want.tolist(), count
