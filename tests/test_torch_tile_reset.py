"""The tile kernels' reset phase (csrc/ngx_env.cuh tile_finish): after each
step of the train kernel (native resets or pool restores) and of 'policy',
the block's warps share the envs that the step finished, each warp resetting
its share together through warp_reset, or copying their pool slots.

The kernels' device code built for the host with g++ (the shim of
tests/test_torch_train_rollout.py, whose HostBlock runs the reset phase's
warps in turn on HostWarps) against the plain twins at B 300 (a ragged last
tile at every tile size), T 16, hidden (16, 16), on reset-heavy specs:
NovelGridworld-v3 (the wall coin), Pogostick-v0 (the tap), fence hard
stacked with an additem (two reset edits) and Pogostick-v1 with 55 stacked
additems (64 item ids, 55 edits: the int8 cell's widest).  Cap 1 ends every
env's episode on every step (k = E envs a tile), cap 3 a spread share of
them.  Each tile size (8, 16 and 32 envs; 8 warps, so 1, 2 and 4 score rows
a warp) gives the same outputs bit for bit; against the twin the policy
parts follow the near-tie rule (every output equal up to an env's first
action mismatch, at a Gumbel near-tie).  'policy' is also held bit for bit
against the train kernel from its ctr-0 state with the cap off, and its
ctr-0 state against reset_rows.  A tile in which most warps have no env to
reset gives what one warp alone gives.
About 35 s on one xdist worker under the tier-1 command (which gives a file
one), the host build included.
"""

import numpy as np
import pytest
import torch

import ngx_torch as nt
from ngx_torch.core.reset import ResetTables, reset_rows
from ngx_torch.ops import rollout as R
from ngx_torch.ops import tables as TB
from ngx_torch.ops import train_rollout as TR
from ngx_torch.ops import threefry as TF
from ngx_torch.ops.rng import block_streams
from ngx_torch.rl.models import ActorCritic

from test_torch_rollout import _assert_state_equal
from test_torch_step import wide_specs
from test_torch_train_rollout import _assert_agree, build_host_lib

torch.set_num_threads(1)

POGO = "NovelGridworld-Pogostick-v1"
B, T, HIDDEN, BLOCK, SLOTS, SEED = 300, 16, (16, 16), 150, 2, 2 ** 31 - 5
CPU = torch.device("cpu")
TILES = (8, 16, 32)

BUILDERS = {
    "v3": lambda: nt.make_spec("NovelGridworld-v3"),
    "Pogostick-v0": lambda: nt.make_spec("NovelGridworld-Pogostick-v0"),
    "fence hard + additem": lambda: nt.inject_novelty(
        nt.inject_novelty(nt.make_spec(POGO), "fence", "hard", "oak"),
        "additem", "easy", "thing0"),
    "64 ids": lambda: wide_specs(nt, n_add=55),
}
_specs, _layer_cache, _runs = {}, {}, {}


def spec(name):
    """The port's spec of ``name`` under LidarInFront, built once."""
    if name not in _specs:
        _specs[name] = nt.lidar_in_front(BUILDERS[name]())
    return _specs[name]


def layers(name):
    if name not in _layer_cache:
        sp = spec(name)
        m = ActorCritic.from_key(TF.key(11), TB.lidar_obs_dim(sp),
                                 sp.n_actions, HIDDEN)
        _layer_cache[name] = [(w.detach(), b.detach())
                              for w, b in m.pi_layers()]
    return _layer_cache[name]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory.mktemp("host_tile_reset"))


def _geometry(monkeypatch, envs, threads=256):
    monkeypatch.setattr(TR, "ENVS", envs)
    monkeypatch.setattr(TR, "THREADS", threads)
    monkeypatch.setattr(R, "POLICY_ENVS", envs)
    monkeypatch.setitem(R.THREADS, "policy", threads)


def _train_inputs(sp, mode, cap):
    """The start state (episode clocks spread below the cap) and, in pool
    mode, a pool of SLOTS rows an env and bases, some nonzero."""
    rs = np.random.RandomState(cap)
    st = nt.counter_reset(sp, 99, 0, B, device="cpu")
    clock = torch.as_tensor(rs.randint(0, cap, B), dtype=torch.int32)
    if mode == "native":
        return st.replace(step_count=clock), {}
    base = torch.as_tensor(rs.randint(0, 5, B), dtype=torch.int32)
    pool = nt.counter_reset(sp, 1234, 0, B * SLOTS, device="cpu")
    pool = pool.replace(step_count=torch.as_tensor(
        rs.randint(0, 20, B * SLOTS), dtype=torch.int32))
    return st.replace(step_count=base + clock), dict(pool=pool, base=base)


def _train_runs(name, mode, cap):
    """The twin's rollout and its inputs, built once per case."""
    key = (name, mode, cap)
    if key not in _runs:
        sp = spec(name)
        st, kw = _train_inputs(sp, mode, cap)
        want = TR.train_rollout_plain(sp, st, layers(name), SEED, T, BLOCK,
                                      cap, **kw)
        _runs[key] = (st, kw, want, {})
    return _runs[key]


def _equal(a, b):
    """Two rollouts' outputs bit for bit."""
    for x, y in zip(a, b):
        pairs = ([(getattr(x, k), getattr(y, k)) for k in x.__dict__]
                 if hasattr(x, "map") else [(x, y)])
        for u, v in pairs:
            assert torch.equal(u, v)


@pytest.mark.parametrize("envs", TILES)
@pytest.mark.parametrize("cap", [1, 3])
@pytest.mark.parametrize("mode", ["native", "pool"])
@pytest.mark.parametrize("name", list(BUILDERS))
def test_train_kernel_reset_phase_matches_twin(host_lib, monkeypatch, name,
                                               mode, cap, envs):
    """The train kernel's reset phase (native resets, or pool restores with
    the slots cycling and bases carried) against the twin, and every tile
    size bit for bit against the others."""
    st, kw, want, got_by_tile = _train_runs(name, mode, cap)
    _geometry(monkeypatch, envs)
    got = TR.launch(host_lib, spec(name), st, layers(name), SEED, T, BLOCK,
                    cap, None, **kw)
    _assert_agree(want, got, layers(name), SEED, BLOCK)
    done = want[4]
    if cap == 1:
        assert bool(done.all())            # k = E in every tile, every step
    else:
        assert 0.2 * B * T < int(done.sum()) < B * T
    if mode == "pool":
        assert int((done.sum(0) > SLOTS).sum()) > 0   # the slots cycled
    got_by_tile[envs] = got
    for other in got_by_tile.values():
        _equal(other, got)


@pytest.mark.parametrize("envs", TILES)
@pytest.mark.parametrize("name", list(BUILDERS))
def test_policy_reset_phase_matches_twin(host_lib, monkeypatch, name, envs):
    """'policy' (the ctr-0 reset of every env, then the done resets, in the
    reset phase) bit for bit against the train kernel from its ctr-0 state
    with the cap off (its reward sums the step-by-step float32 sum of the
    train kernel's rewards, its done counts theirs), and against the twin
    at most 1% of envs differing, at near-ties."""
    sp, lay = spec(name), layers(name)
    _geometry(monkeypatch, envs)
    got = R.launch(host_lib, sp, B, T, SEED, BLOCK, "policy", None, lay, CPU,
                   None)
    seeds, rows = block_streams(SEED, B, BLOCK)
    start = reset_rows(ResetTables(sp), seeds, 0, rows)
    train = TR.launch(host_lib, sp, start, lay, SEED, T, BLOCK, 2 ** 30,
                      None)
    _assert_state_equal(train[0], got[0])
    rsum = torch.zeros(B, dtype=torch.float32)
    for t in range(T):
        rsum = rsum + train[3][t]
    assert torch.equal(got[1], rsum)
    assert torch.equal(got[2], train[4].sum(0).to(got[2].dtype))
    if name == "v3":                       # its dead ends come within T
        assert int(got[2].sum()) > B // 10
    want = R.rollout_plain(sp, B, T, SEED, BLOCK, "policy", pi_layers=lay,
                           device=CPU)
    same = torch.ones(B, dtype=torch.bool)
    for k, v in want[0].__dict__.items():
        same &= (getattr(got[0], k) == v).reshape(B, -1).all(1)
    same &= (got[1] == want[1]) & (got[2] == want[2])
    assert int((~same).sum()) <= 0.01 * B


@pytest.mark.parametrize("envs", TILES)
@pytest.mark.parametrize("name", list(BUILDERS))
def test_policy_ctr0_state_is_reset_rows(host_lib, monkeypatch, name, envs):
    """'policy' at T 0: the reset phase's ctr-0 reset of every env of every
    tile (the last one ragged) is reset_rows on the same streams, bit for
    bit, with zero sums and counts."""
    sp = spec(name)
    _geometry(monkeypatch, envs)
    got = R.launch(host_lib, sp, B, 0, SEED, BLOCK, "policy", None,
                   layers(name), CPU, None)
    seeds, rows = block_streams(SEED, B, BLOCK)
    _assert_state_equal(reset_rows(ResetTables(sp), seeds, 0, rows), got[0])
    assert not bool(got[1].any()) and not bool(got[2].any())


# envs of two tiles of 32 whose clocks end at step 0 (cap 10): 1 in the
# first tile, 3 in the second, so 7 and 5 of the 8 warps reset nothing
IDLE_ENVS = (5, 33, 34, 41)


@pytest.mark.parametrize("mode", ["native", "pool"])
def test_idle_warps_change_no_result(host_lib, monkeypatch, mode):
    """A step on which fewer envs finish than the block has warps: the warps
    with none reset nothing, and the result is what one warp alone (32
    threads) and two give, bit for bit, and the twin's by the near-tie
    rule."""
    sp, lay, n, cap = spec("fence hard + additem"), layers(
        "fence hard + additem"), 64, 10
    st = nt.counter_reset(sp, 5, 0, n, device="cpu")
    clock = torch.zeros(n, dtype=torch.int32)
    clock[list(IDLE_ENVS)] = cap - 1
    kw = {}
    if mode == "pool":
        kw = dict(pool=nt.counter_reset(sp, 77, 0, n * SLOTS, device="cpu"),
                  base=torch.zeros(n, dtype=torch.int32))
    st = st.replace(step_count=clock)
    outs = []
    for threads in (256, 64, 32):
        _geometry(monkeypatch, 32, threads)
        outs.append(TR.launch(host_lib, sp, st, lay, SEED, 4, BLOCK, cap,
                              None, **kw))
        monkeypatch.undo()
    assert outs[0][4][0].nonzero()[:, 0].tolist() == list(IDLE_ENVS)
    for other in outs[1:]:
        _equal(outs[0], other)
    want = TR.train_rollout_plain(sp, st, lay, SEED, 4, BLOCK, cap, **kw)
    _assert_agree(want, outs[0], lay, SEED, BLOCK)
