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
from ngx_torch.ops.tables import HEADER
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
    st = nt.counter_reset(spt, 3, 0, 128)
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
# on the CPU; each entry point loops over the envs with one call of the
# kernel's per-env function.  tests/test_torch_rollout.py builds it too.
HOST_SHIM = r"""
#include "train_rollout.cu"
#include "rollout.cu"
#include <vector>

extern "C" int ngx_train_rollout(
    const int* tab, int n_tab, const int* map_in, const int* ir_in,
    const float* fr_in, const int* inv_in, const float* params, int n_params,
    int seed, int B, int T, int block, int cap, int, int hw, int n_items,
    float* scratch, int maxw, int* map_out, int* ir_out, float* fr_out,
    int* inv_out, float* obs_out, int* act_out, float* rew_out,
    unsigned char* done_out, const int* pool_map, const int* pool_inv,
    const int* pool_sc, int R, const int* base_in, int* base_out,
    int novelty, void*) {
  RolloutArgs p = {tab, n_tab, map_in, ir_in, fr_in, inv_in, params,
                   n_params, 0, seed, B, T, block, cap, scratch, maxw,
                   map_out, ir_out, fr_out, inv_out, obs_out, act_out,
                   rew_out, done_out, pool_map, pool_inv, pool_sc, R,
                   base_in, base_out, 0, 0, 0};
  std::vector<int8_t> m(hw);
  std::vector<int> inv(n_items);
  for (int b = 0; b < B; ++b)
    novelty ? rollout_env<true>(p, tab, params, m.data(), inv.data(), b)
            : rollout_env<false>(p, tab, params, m.data(), inv.data(), b);
  return 0;
}

extern "C" int ngx_rollout(
    const int* tab, int n_tab, const int* actions, const float* params,
    int n_params, int source, int seed, int B, int T, int block, int,
    int hw, int n_items, float* scratch, int maxw, int* map_out, int* ir_out,
    float* fr_out, int* inv_out, float* rsum_out, int* dcount_out,
    int novelty, void*) {
  EnvRolloutArgs p = {tab, n_tab, actions, params, n_params, 0, source,
                      seed, B, T, block, scratch, maxw, map_out, ir_out,
                      fr_out, inv_out, rsum_out, dcount_out, 0, 0, 0};
  std::vector<int8_t> m(hw);
  std::vector<int> inv(n_items);
  for (int b = 0; b < B; ++b)
    novelty ? env_rollout<true>(p, tab, params, m.data(), inv.data(), b)
            : env_rollout<false>(p, tab, params, m.data(), inv.data(), b);
  return 0;
}

extern "C" const char* ngx_error_string(int) { return "host build"; }

extern "C" int ngx_ceil_percent(int count, int p) { return ceil_percent(count, p); }
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
    st = nt.counter_reset(spt, 99, 0, B)
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
    st = nt.counter_reset(spt, 5, 0, B)
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
    return int(nt.make_step(spt).get_obs(nt.counter_reset(spt, 0, 0, 1))
               .shape[1])


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
    st = nt.counter_reset(spt, 99, 0, B)
    base = torch.as_tensor(rs.randint(0, 5, B), dtype=torch.int32)
    st = st.replace(step_count=base + torch.as_tensor(
        rs.randint(0, cap, B), dtype=torch.int32))
    pool = nt.counter_reset(spt, 1234, 0, B * R)
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


def test_ceil_percent_device_code(host_lib):
    """The device code's float64 ceil-percent against numpy's, for every
    count 0..400 and p 1..99."""
    for count in range(401):
        want = np.ceil(count * (np.arange(1, 100) / 100)).astype(int)
        got = [host_lib.ngx_ceil_percent(count, p) for p in range(1, 100)]
        assert got == want.tolist(), count
