"""The env-stepping rollout (ngx_torch/ops/rollout.py): its plain twin against
the TPU kernel make_pallas_rollout in interpret mode, in all three action
modes, and the CUDA source's device code built for the host against the
twin: the warp's phases ('prng', 'input'), its k-of-32 reset, its first
maximum and its n-smallest selection."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ngx
from ngx.ops import pallas_rollout as P
from ngx.rl.models import ActorCritic as FlaxActorCritic
import ngx_torch as nt
from ngx_torch.core.reset import ResetTables, reset_rows
from ngx_torch.ops import _build
from ngx_torch.ops import rollout as R
from ngx_torch.ops.rng import block_streams
from ngx_torch.ops.tables import has_novelty, host_header, kernel_tables
from ngx_torch.rl.models import ActorCritic

from test_torch_spec import NOVELTIES, STACKED, novelty_specs
from test_torch_train_rollout import build_host_lib

# one torch thread per test process: xdist runs several on the CPU, where
# more threads only contend (the port's suite runs twice as fast)
torch.set_num_threads(1)

ALL_ENVS = tuple(ngx.SPEC_BUILDERS)
# the JAX interpret calls stay at B <= 64, T <= 64 (1-4 s each on a CPU)
B, T, BLOCK, SEED = 64, 64, 32, 5
LEGACY_WITH_RESETS = ("NovelGridworld-v2", "NovelGridworld-v3",
                      "NovelGridworld-v4")


def _assert_state_equal(want, got):
    """Every leaf of ngx's EnvState equals the port's, bit for bit."""
    for k, v in got.to_numpy().items():
        np.testing.assert_array_equal(np.asarray(getattr(want, k)), v,
                                      err_msg=k)


def _pallas(sp, batch, steps, block, source, seed, actions=None,
            params=None):
    run = P.make_pallas_rollout(sp, batch, steps, block=block,
                                action_source=source, interpret=True,
                                policy_params=params)
    if source == "input":
        return jax.jit(run)(seed, jnp.asarray(actions))
    return jax.jit(run)(seed)


def _check_run(want, got, steps):
    """run()'s results: the state bit for bit, n_done exactly, and the mean
    reward at rtol 1e-6 — the batch sum runs in another order than JAX's;
    each env's running sum is bit-exact."""
    st, mean_j, n_j = want
    state, mean_t, n_t = got
    _assert_state_equal(st, state)
    assert int(n_j) == int(n_t)
    np.testing.assert_allclose(float(mean_t), float(mean_j), rtol=1e-6)
    assert mean_t.dtype == torch.float32


@pytest.mark.parametrize("env_id", ALL_ENVS)
def test_input_mode_matches_pallas(env_id):
    sp, spt = ngx.make_spec(env_id), nt.make_spec(env_id)
    acts = np.random.RandomState(1).randint(sp.n_actions, size=(T, B))
    acts = acts.astype(np.int32)
    want = _pallas(sp, B, T, BLOCK, "input", SEED, actions=acts)
    run = R.make_rollout(spt, B, T, block=BLOCK, action_source="input",
                         device="cpu")
    _check_run(want, run(SEED, torch.as_tensor(acts)), T)
    if env_id in LEGACY_WITH_RESETS:
        assert int(want[2]) > 0


@pytest.mark.parametrize("env_id", [
    "NovelGridworld-Pogostick-v1", "NovelGridworld-Pogostick-v0",
    "NovelGridworld-v2", "NovelGridworld-v3", "NovelGridworld-v4"])
def test_prng_mode_matches_pallas(env_id):
    """The counter-RNG actions (salt 1) and the in-kernel auto-reset, the
    v3 wall coin and the Pogostick-v0 tap included."""
    sp, spt = ngx.make_spec(env_id), nt.make_spec(env_id)
    want = _pallas(sp, B, T, BLOCK, "prng", SEED)
    _check_run(want, R.make_rollout(spt, B, T, block=BLOCK,
                                    device="cpu")(SEED), T)
    if env_id in LEGACY_WITH_RESETS:
        assert int(want[2]) > 0


def test_policy_mode_matches_pallas():
    """flax weights carried across with ActorCritic.load_flax_params; at
    this size no action sits at a near-tie, so the runs agree exactly."""
    env_id, batch, steps, block = "NovelGridworld-Pogostick-v1", 32, 8, 16
    sp = ngx.transforms.lidar_in_front(ngx.make_spec(env_id))
    spt = nt.lidar_in_front(nt.make_spec(env_id))
    obs_dim = 63
    params = FlaxActorCritic(n_actions=sp.n_actions, hidden=(64, 64)).init(
        jax.random.key(3), jnp.zeros((1, obs_dim)))
    params = jax.tree_util.tree_map(np.asarray, params)
    want = _pallas(sp, batch, steps, block, "policy", SEED, params=params)
    model = ActorCritic(obs_dim, sp.n_actions, (64, 64)).load_flax_params(
        params)
    layers = [(w.detach(), b.detach()) for w, b in model.pi_layers()]
    run = R.make_rollout(spt, batch, steps, block=block,
                         action_source="policy", pi_layers=layers,
                         device="cpu")
    got = run(SEED)
    _check_run(want, got, steps)
    assert int(got[0].step_count.min()) > 0


def test_zero_steps_is_the_reset():
    """steps = 0 returns each block's ctr-0 counter reset, mean 0, no
    episode end (tests/test_pallas.py:45 relies on it)."""
    env_id = "NovelGridworld-v3"
    sp, spt = ngx.make_spec(env_id), nt.make_spec(env_id)
    want = _pallas(sp, B, 0, BLOCK, "prng", SEED)
    got = R.make_rollout(spt, B, 0, block=BLOCK, device="cpu")(SEED)
    _check_run(want, got, 0)
    assert float(got[1]) == 0.0 and int(got[2]) == 0
    first = nt.counter_reset(spt, SEED, 0, BLOCK, device="cpu")
    for k, v in first.to_numpy().items():
        np.testing.assert_array_equal(got[0].to_numpy()[k][:BLOCK], v)


def test_wrapper_on_cpu_runs_the_twin():
    spt = nt.make_spec("NovelGridworld-v4")
    n0 = dict(R.rollout.launches)
    st, rsum, dcount = R.rollout(spt, 128, 6, 11, block=64, device="cpu")
    assert R.rollout.launches == n0
    st2, rsum2, dcount2 = R.rollout_plain(spt, 128, 6, 11, block=64)
    assert torch.equal(rsum, rsum2) and torch.equal(dcount, dcount2)
    assert torch.equal(st.map, st2.map)
    with pytest.raises(ValueError):
        R.rollout(spt, 100, 6, 11, block=64, device="cpu")   # not whole blocks
    with pytest.raises(ValueError):
        R.rollout(spt, 128, 6, 11, block=64, action_source="input",
                  actions=torch.zeros((5, 128), dtype=torch.int32),
                  device="cpu")
    with pytest.raises(ValueError):
        R.rollout(spt, 128, 6, 11, block=64, action_source="policy",
                  device="cpu")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory.mktemp("host_rollout"))


@pytest.mark.parametrize("source", R.SOURCES)
@pytest.mark.parametrize("env_id", ["NovelGridworld-Pogostick-v0",
                                    "NovelGridworld-v3"])
def test_device_code_matches_twin(host_lib, env_id, source):
    """The wrapper's launch path (tables, action stream, weights, output
    unpacking) into rollout.cu's device code, against the twin.  'prng' and
    'input' agree bit for bit; 'policy' may differ only in the envs whose
    action met a near-tie of the Gumbel score (the MLP sums in another
    order), at most 1% of them."""
    spt = nt.make_spec(env_id)
    if source == "policy":
        spt = nt.lidar_in_front(spt)
    batch, steps, block, seed = 512, 32, 128, -77
    dev = torch.device("cpu")
    acts = layers = None
    if source == "input":
        acts = torch.as_tensor(np.random.RandomState(2).randint(
            spt.n_actions, size=(steps, batch)), dtype=torch.int32)
    if source == "policy":
        obs_dim = int(nt.make_step(spt).get_obs(
            nt.counter_reset(spt, 0, 0, 1, device="cpu")).shape[1])
        m = ActorCritic(obs_dim, spt.n_actions, (64, 64),
                        generator=torch.Generator().manual_seed(4))
        layers = [(w.detach(), b.detach()) for w, b in m.pi_layers()]
    got = R.launch(host_lib, spt, batch, steps, seed, block, source, acts,
                   layers, dev, None)
    want = R.rollout_plain(spt, batch, steps, seed, block, source, acts,
                           layers, dev)
    same = torch.ones(batch, dtype=torch.bool)
    for k, v in want[0].to_numpy().items():
        g = got[0].to_numpy()[k]
        same &= torch.as_tensor((g == v).reshape(batch, -1).all(1))
    same &= (got[1] == want[1]) & (got[2] == want[2])
    n_bad = int((~same).sum())
    assert n_bad <= (0.01 * batch if source == "policy" else 0), n_bad
    if env_id == "NovelGridworld-v3":
        assert int(want[2].sum()) > 0       # episode ends and resets


@pytest.mark.parametrize("source", ["input", "prng"])
@pytest.mark.parametrize("novelty", [("firewall", "hard"),
                                     ("fence", "medium", "oak")])
def test_novelty_modes_match_pallas(novelty, source):
    """The rollout's twin on novelty specs against the TPU kernel: the
    novelty step, and the reset edits at ctr 0 and at every boundary."""
    env_id = "NovelGridworld-Pogostick-v1"
    sp = novelty_specs(ngx, env_id, (novelty,))
    spt = novelty_specs(nt, env_id, (novelty,))
    acts = None
    if source == "input":
        acts = np.random.RandomState(2).randint(sp.n_actions, size=(T, B))
        acts = acts.astype(np.int32)
    want = _pallas(sp, B, T, BLOCK, source, SEED, actions=acts)
    run = R.make_rollout(spt, B, T, block=BLOCK, action_source=source,
                         device="cpu")
    got = run(SEED, None if acts is None else torch.as_tensor(acts))
    _check_run(want, got, T)
    if novelty[0] == "firewall":
        assert int(want[2]) > 0                  # deaths, then resets


@pytest.mark.parametrize("env_id,novs", [
    ("NovelGridworld-Pogostick-v1", (("fence", "medium", "oak"),)),
    ("NovelGridworld-Pogostick-v0", ()), ("NovelGridworld-v3", ())])
def test_pool_reset_is_make_xla_pool_reset(host_lib, env_id, novs):
    """The trainer's pool generator: the rollout at T 0 in one RNG block of
    n envs gives make_xla_pool_reset(spec, n)(seed) row for row, on the
    CPU and in the kernel's device code — the fence edit, Pogostick-v0's
    tap and v3's wall coin (the specs whose boundaries take the pool)."""
    sp, spt = novelty_specs(ngx, env_id, novs), novelty_specs(nt, env_id, novs)
    n, seed = 512, 2 ** 31 - 9
    want = P.make_xla_pool_reset(sp, n)(seed)
    host = R.launch(host_lib, spt, n, 0, seed, n, "prng", None, None,
                    torch.device("cpu"), None)[0]
    n0 = R.pool_reset.launches
    for got in (R.pool_reset(spt, n, seed, device="cpu"), host):
        _assert_state_equal(want, got)
    assert R.pool_reset.launches == n0           # the CPU launches nothing


@pytest.mark.parametrize("env_id,novelty",
                         NOVELTIES + ((STACKED[0], None),))
def test_novelty_device_code_matches_twin(host_lib, env_id, novelty):
    """rollout.cu's 'input' mode on the 13 novelty specs and the stacked
    one: the shared device step and reset against the twin, bit for bit."""
    novs = STACKED[1] if novelty is None else (novelty,)
    spt = novelty_specs(nt, env_id, novs)
    batch, steps, block, seed = 256, 32, 64, 321
    acts = torch.as_tensor(np.random.RandomState(5).randint(
        spt.n_actions, size=(steps, batch)), dtype=torch.int32)
    dev = torch.device("cpu")
    got = R.launch(host_lib, spt, batch, steps, seed, block, "input", acts,
                   None, dev, None)
    want = R.rollout_plain(spt, batch, steps, seed, block, "input", acts,
                           device=dev)
    _assert_state_equal(want[0], got[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_library_path_hashes_every_csrc_file(tmp_path):
    """A change to the shared header (not a SOURCES file) names a new
    library, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = _build.library_path(csrc)
    assert before == _build.library_path(csrc)
    with open(csrc / "ngx_env.cuh", "a") as f:
        f.write("\n// touched\n")
    assert _build.library_path(csrc) != before
    assert _build.library_path() == _build.library_path(_build.CSRC)


# The redesigned 'prng' / 'input' path (csrc/rollout.cu warp_rollout and
# csrc/ngx_env.cuh warp_reset) in the host build: a batch that is not a
# multiple of the 32-env warp, in whole RNG blocks (B 300, block 150).
RAGGED_B, RAGGED_BLOCK = 300, 150


def _launch_vs_twin(lib, spt, source, steps, seed, batch=RAGGED_B,
                    block=RAGGED_BLOCK):
    acts = None
    if source == "input":
        acts = torch.as_tensor(np.random.RandomState(seed % 1000).randint(
            spt.n_actions, size=(steps, batch)), dtype=torch.int32)
    dev = torch.device("cpu")
    got = R.launch(lib, spt, batch, steps, seed, block, source, acts, None,
                   dev, None)
    want = R.rollout_plain(spt, batch, steps, seed, block, source, acts,
                           device=dev)
    _assert_state_equal(want[0], got[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    return want


@pytest.mark.parametrize("env_id", ALL_ENVS)
def test_warp_input_mode_matches_twin(host_lib, env_id):
    """'input' on every preset through the warp's phases: every state
    field, each env's float32 reward sum and its done count bit for bit,
    the last warp 12 envs wide."""
    want = _launch_vs_twin(host_lib, nt.make_spec(env_id), "input", 40, 17)
    if env_id in LEGACY_WITH_RESETS:
        assert int(want[2].sum()) > 0


@pytest.mark.parametrize("env_id", [
    "NovelGridworld-Pogostick-v1", "NovelGridworld-Pogostick-v0",
    "NovelGridworld-v2", "NovelGridworld-v3", "NovelGridworld-v4"])
def test_warp_prng_mode_matches_twin(host_lib, env_id):
    """'prng' (counter-RNG actions, auto-resets by the warp) on the five
    envs of test_prng_mode_matches_pallas, and steps = 0 (the ctr-0 reset
    alone)."""
    spt = nt.make_spec(env_id)
    want = _launch_vs_twin(host_lib, spt, "prng", 48, -31)
    if env_id in LEGACY_WITH_RESETS:
        assert int(want[2].sum()) > 0
    _launch_vs_twin(host_lib, spt, "prng", 0, 8)


def _warp_reset(lib, spt, seed, block, b0, ctr, mask, lanes):
    """The host build's warp reset of the envs of ``mask`` among b0 ..
    b0 + 31: their rows of (map, int registers, float registers, inv)."""
    tab = kernel_tables(spt)
    hw, ni = spt.map_size ** 2, spt.n_items
    outs = (np.zeros((32, hw), np.int32), np.zeros((32, 7), np.int32),
            np.zeros((32, 2), np.float32), np.zeros((32, ni), np.int32))
    lib.ngx_warp_reset.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_uint, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.ngx_warp_reset.restype = None
    lib.ngx_warp_reset(tab.ctypes.data, tab.size, host_header(spt, ()), seed,
                       block, b0, ctr, mask, lanes, int(has_novelty(spt)),
                       *[o.ctypes.data for o in outs])
    return outs


WARP_SPECS = tuple((e, None) for e in ALL_ENVS) + NOVELTIES + (STACKED,)


@pytest.mark.parametrize("k", [1, 7, 32])
@pytest.mark.parametrize("env_id,novelty", WARP_SPECS)
def test_warp_reset_k_of_32_matches_reset_rows(host_lib, env_id, novelty, k):
    """k of a warp's 32 envs reset at once (groups of 32 / next_pow2(k)
    lanes, and of at least 4 and 32 lanes) against reset_rows on the same
    streams: the placements, Pogostick-v0's tap, v3's coin and the edits.
    The warp straddles two RNG blocks (block 48)."""
    novs = () if novelty is None else (
        novelty if isinstance(novelty[0], tuple) else (novelty,))
    spt = novelty_specs(nt, env_id, novs)
    seed, block, b0, ctr = 1009 * k, 48, 32, 5 + k
    lanes_set = np.random.RandomState(k).choice(32, k, replace=False)
    mask = int(sum(1 << int(e) for e in lanes_set))
    b = torch.as_tensor(b0 + np.sort(lanes_set), dtype=torch.int64)
    seeds, rows = block_streams(seed, b0 + 32, block)
    want = reset_rows(ResetTables(spt), seeds[b], ctr, rows[b])
    ir = torch.stack([want.agent[:, 0], want.agent[:, 1], want.facing,
                      want.selected, want.step_count, want.last_action,
                      want.last_done.to(torch.int32)], 1)
    fr = torch.stack([want.last_reward, want.last_cost], 1)
    first = None
    for lanes in (1, 4, 32):
        got = _warp_reset(host_lib, spt, seed, block, b0, ctr, mask, lanes)
        rows_got = [torch.as_tensor(o[np.sort(lanes_set)]) for o in got]
        for g, w in zip(rows_got, (want.map, ir, fr, want.inventory)):
            assert torch.equal(g, w.to(g.dtype)), (lanes, g.dtype)
        if first is None:
            first = got
        for a, c in zip(got, first):
            assert np.array_equal(a, c)


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
def test_first_max_reduction_ties_take_the_lowest_index(host_lib, g):
    """The group first maximum of (u, index) candidates: the largest u,
    and among equal u the lowest index — forced ties, indices from 0 to
    1,599 (the tap's 4*HW at HW 400, past 256 and 2^9), lanes with no
    candidate."""
    lib = host_lib
    lib.ngx_first_max.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                           ctypes.c_void_p]
    lib.ngx_first_max.restype = None
    rs = np.random.RandomState(g)
    for trial in range(200):
        u = rs.randint(0, 4 if trial % 2 else 1 << 24, 32).astype(np.uint32)
        if trial % 3 == 0:
            u[:] = (1 << 24) - 1                  # one tie over every lane
        idx = rs.choice(1600, 32, replace=False).astype(np.int32)
        idx[rs.rand(32) < 0.2] = -1
        out = np.zeros(32, np.int32)
        lib.ngx_first_max(u.ctypes.data, idx.ctypes.data, g, out.ctypes.data)
        for l0 in range(0, 32, g):
            cand = [(int(u[l]), -int(idx[l])) for l in range(l0, l0 + g)
                    if idx[l] >= 0]
            want = -max(cand)[1] if cand else -1
            assert (out[l0:l0 + g] == want).all(), (trial, l0)


@pytest.mark.parametrize("hw", [64, 100, 256, 400])
def test_warp_selection_matches_edit_threshold(host_lib, hw):
    """The reset groups' n-smallest selection (every score hashed once, the
    bisection on the stored scores; groups of 1, 4 and 32 lanes) against
    edit_threshold's set and against sorting, on random distinct 30-bit
    scores with cells out of the edit marked, for every n from 0 to the
    count."""
    lib = host_lib
    lib.ngx_edit_threshold.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int]
    lib.ngx_edit_threshold.restype = ctypes.c_uint
    lib.ngx_group_threshold.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    lib.ngx_group_threshold.restype = ctypes.c_uint
    rs = np.random.RandomState(hw)
    lane = max(8, (hw - 1).bit_length())
    score = ((rs.randint(0, 1 << (30 - lane), hw) << lane)
             | np.arange(hw)).astype(np.uint32)
    score[rs.rand(hw) < 0.3] = 0xFFFFFFFF           # not eligible
    count = int((score != 0xFFFFFFFF).sum())
    order = np.sort(score[score != 0xFFFFFFFF])
    for n in range(count + 1):
        want = set(np.nonzero(score <= order[n - 1])[0]) if n else set()
        for g in (1, 4, 32):
            thr = lib.ngx_group_threshold(score.ctypes.data, hw, n, g)
            assert thr > 0, (n, g)
            got = set(np.nonzero(score < thr)[0]) if n else set()
            assert got == want, (n, g)
        if n:
            ref = lib.ngx_edit_threshold(score.ctypes.data, hw, n)
            assert set(np.nonzero(score < ref)[0]) == want, n


@pytest.mark.parametrize("map_size", [10, 16, 20])
def test_rollout_smem_layout_fits_the_card(host_lib, map_size):
    """The 'prng'/'input' block's shared memory (csrc/rollout.cu
    warp_layout, warp_fit) at 128 threads: the table, 4 warps of 32 maps
    (at least 1,152 bytes each, the registers' staging) and inventories,
    and for a spec with reset edits one score row a reset group, halved
    with the fewest lanes a reset takes doubled until the card's 227 KB
    hold the block."""
    budget = 232448
    for novs in ((), (("fence", "medium", "oak"),)):
        spt = novelty_specs(nt, "NovelGridworld-Pogostick-v1", novs,
                            map_size=map_size)
        tab, hw, ni = kernel_tables(spt), map_size ** 2, spt.n_items
        edits = int(bool(novs))
        lanes = ctypes.c_int(1)
        nbytes = host_lib.ngx_rollout_smem(tab.size, hw, ni, edits, 128,
                                           ctypes.byref(lanes))
        a16 = lambda n: (n + 15) // 16 * 16
        rows = 32 // lanes.value if edits else 0
        want = (a16(tab.size * 4) + 4 * a16(max(32 * hw, 1152))
                + a16(4 * 32 * ni * 4) + 4 * a16(rows * hw * 4))
        assert 0 < nbytes == want <= budget, (novs, nbytes, want)
        # the fewest lanes: 1, unless 32 score rows a warp do not fit
        full = want - 4 * a16(rows * hw * 4) + 4 * a16(32 * hw * 4)
        assert (lanes.value == 1) == (not edits or full <= budget)
