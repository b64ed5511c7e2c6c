"""The port's counter RNG and counter reset (ngx_torch/ops/rng.py,
ngx_torch/core/reset.py) bit-exact against the TPU kernel's
(ngx/ops/pallas_rollout.py:103-142, :181-468), run as plain XLA on CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ngx
from ngx.ops import pallas_rollout as P
import ngx_torch as nt
from ngx_torch.core import spec as S
from ngx_torch.ops import rng

from test_reset_distribution import check_reset_invariants
from test_torch_spec import STACKED, novelty_specs

# one torch thread per test process: xdist runs several on the CPU, where
# more threads only contend (the port's suite runs twice as fast)
torch.set_num_threads(1)

# seeds near the int32 edges: seed + blk*7919 wraps for blk >= 1
SEEDS = (0, 7, 2 ** 31 - 1, 2 ** 31 - 5000, -2 ** 31, -1)
BLOCKS = (0, 1, 3, 271)


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_u01_randint_bit_exact(seed):
    rows, cols = 40, 23
    r = torch.arange(rows, dtype=torch.int64)
    c = torch.arange(cols, dtype=torch.int64)
    for blk in BLOCKS:
        # the TPU kernel's per-block seed: an int32 add that wraps (:1071)
        s_j = jnp.int32(seed) + jnp.int32(blk) * jnp.int32(7919)
        s_t = seed + blk * 7919
        for ctr, salt in ((0, 2), (1, 5), (64, 16), (2 ** 31 - 1, 41)):
            c_j = jnp.int32(ctr)
            np.testing.assert_array_equal(
                np.asarray(P._bits(s_j, c_j, salt, (rows, cols)), np.int64),
                rng._bits(s_t, ctr, salt, r, c).numpy())
            np.testing.assert_array_equal(
                np.asarray(P._u01(s_j, c_j, salt, (rows, cols))),
                rng._u01(s_t, ctr, salt, r, c).numpy())
            np.testing.assert_array_equal(
                np.asarray(P._randint(s_j, c_j, salt, (rows, cols), 17)),
                rng._randint(s_t, ctr, salt, r, c, 17).numpy())


def test_block_streams():
    seed, n, block = 2 ** 31 - 3, 1000, 128
    seeds, rows = rng.block_streams(seed, n, block)
    for e in (0, 127, 128, 999):
        blk = e // block
        want = np.asarray(jnp.int32(seed) + jnp.int32(blk) * jnp.int32(7919))
        assert int(seeds[e]) == int(want.astype(np.uint32))
        assert int(rows[e]) == e % block
    # per-env tensor seeds give the same bits as the block's scalar seed
    cols = torch.arange(5, dtype=torch.int64)
    np.testing.assert_array_equal(
        rng._bits(seeds[256:384], 3, 5, rows[256:384], cols).numpy(),
        rng._bits(seed + 2 * 7919, 3, 5, torch.arange(128), cols).numpy())


@pytest.mark.parametrize("env_id", ["NovelGridworld-Pogostick-v1",
                                    "NovelGridworld-Bow-v1",
                                    "NovelGridworld-v3",
                                    "NovelGridworld-Pogostick-v0"])
def test_counter_reset_bit_exact(env_id):
    """Pogostick-v1 and Bow-v1: the placements and the start inventory;
    v3 adds the wall coin (salt 40), Pogostick-v0 the tap pre-placement
    (salts 41-44)."""
    sp, spt = ngx.make_spec(env_id), nt.make_spec(env_id)
    n = 300
    for seed, ctr in ((7, 0), (2 ** 31 - 1, 5), (-5, 64)):
        want = P.make_xla_pool_reset(sp, n)(seed, ctr)
        got = nt.counter_reset(spt, seed, ctr, n, device="cpu").to_numpy()
        for k, v in got.items():
            w = np.asarray(getattr(want, k))
            if k == "last_done":       # int32 in the kernel's packed state
                w = w.astype(bool)
            assert w.dtype == v.dtype, k
            np.testing.assert_array_equal(w, v, err_msg=f"{k} {seed} {ctr}")
        # the reset edits fired: walls in front of some agents (v3), a tap
        # on every map (Pogostick-v0)
        m = got["map"].reshape(n, -1)
        if spt.reset_wall_coin:
            fr = got["agent"] + S.FACING_DELTAS[got["facing"]]
            front = m[np.arange(n), fr[:, 0] * spt.map_size + fr[:, 1]]
            assert 0 < int((front == spt.items.index("wall")).sum()) < n
        if spt.reset_place_tap:
            assert ((m == spt.items.index("tree_tap")).sum(1) == 1).all()


def _assert_reset_equal(sp, spt, n, seed, ctr):
    want = P.make_xla_pool_reset(sp, n)(seed, ctr)
    got = nt.counter_reset(spt, seed, ctr, n, device="cpu").to_numpy()
    for k, v in got.items():
        w = np.asarray(getattr(want, k))
        if k == "last_done":
            w = w.astype(bool)
        np.testing.assert_array_equal(w, v, err_msg=f"{k} {seed} {ctr}")
    return got


# the percent-fill edits: (env, novelties, map size, the item they write,
# the exact count per map where the fill is deterministic)
EDIT_CASES = (
    ("NovelGridworld-Pogostick-v1", (("fence", "easy", "oak"),), 10,
     "oak_fence", None),
    ("NovelGridworld-Pogostick-v1", (("fence", "medium", "oak"),), 10,
     "oak_fence", None),
    ("NovelGridworld-Pogostick-v1", (("fence", "hard", "oak"),), 10,
     "oak_fence", None),
    ("NovelGridworld-Pogostick-v1", (("additem", "medium", "crate"),), 10,
     "crate", None),
    ("NovelGridworld-Pogostick-v1", (("replaceitem", "medium", "tree_log",
                                      "stone"),), 10, "stone", None),
    # p = 99 of the 36 border walls: ceil -> all 36 (60 at map size 16,
    # past the 8-bit lane boundary of the selection score)
    ("NovelGridworld-Pogostick-v1", (("firewall", "hard"),), 10,
     "fire_wall", 36),
    ("NovelGridworld-Pogostick-v1", (("firewall", "hard"),), 16,
     "fire_wall", 60),
    ("NovelGridworld-Pogostick-v1", (("crate", "hard"),), 10, "crate", None),
    (STACKED[0], STACKED[1], 10, "oak_fence", None),
)


@pytest.mark.parametrize("env_id,novs,size,item,exact", EDIT_CASES)
def test_counter_reset_edits_bit_exact(env_id, novs, size, item, exact):
    """The percent-fill reset edits, in injection order after the
    placements: bit-exact against make_xla_pool_reset (the TPU kernel's
    reset) at two seeds and counters, and the edit's item on the maps."""
    sp = novelty_specs(ngx, env_id, novs, map_size=size)
    spt = novelty_specs(nt, env_id, novs, map_size=size)
    n = 200
    for seed, ctr in ((11, 0), (-2 ** 31 + 3, 17)):
        got = _assert_reset_equal(sp, spt, n, seed, ctr)
        count = (got["map"] == spt.items.index(item)).sum(1)
        assert count.sum() > 0, item
        if exact is not None:
            assert (count == exact).all()


def test_ceil_percent_exhaustive():
    """n = ceil(count * p / 100) as the reference computes it in float64
    (numpy), for every count 0..400 (map size 20) and p 1..99: the integer
    form with the correction pairs, against numpy."""
    from ngx_torch.core.reset import ceil_percent, ceil_percent_pairs

    count = torch.arange(401, dtype=torch.int64)[:, None]
    p = torch.arange(1, 100, dtype=torch.int64)[None, :]
    want = np.ceil(count.numpy() * (p.numpy() / 100)).astype(np.int64)
    got = ceil_percent(count, p, ceil_percent_pairs(400))
    np.testing.assert_array_equal(got.numpy(), want)
    assert ceil_percent_pairs(100) == tuple(
        (c, q) for c, q in ceil_percent_pairs(400) if c <= 100)
    assert len(ceil_percent_pairs(100)) > 0


def test_counter_reset_defaults_to_the_card():
    """Like every entry point, counter_reset runs on the card unless asked
    for the CPU: where there is no card it raises and names
    device='cpu', never falling back."""
    spec = nt.make_spec("NovelGridworld-Pogostick-v1")
    if torch.cuda.is_available():
        assert nt.counter_reset(spec, 0, 0, 4).map.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nt.counter_reset(spec, 0, 0, 4)


def test_counter_reset_invariants():
    spec = nt.make_spec("NovelGridworld-Pogostick-v1")
    n = 4000
    st = nt.counter_reset(spec, 123, 0, n, device="cpu").to_numpy()
    check_reset_invariants(spec, st["map"].reshape(n, 10, 10), st["agent"],
                           st["facing"], n)


@pytest.mark.parametrize("reset_obs", [False, True])
def test_vec_auto_reset(reset_obs):
    """make_vec: done and capped envs carry the counter reset of their RNG
    block at this step's counter; the obs is the terminal one, or the reset
    one with reset_obs."""
    from ngx_torch.core.reset import ResetTables, reset_rows
    from ngx_torch.vector import make_vec

    spec = nt.lidar_in_front(nt.make_spec("NovelGridworld-Bow-v1"))
    B, cap, seed, ctr, block = 256, 5, 9, 3, 128
    st = nt.counter_reset(spec, 1, 0, B, device="cpu")
    st = st.replace(step_count=torch.as_tensor(
        np.random.RandomState(0).randint(0, cap, B), dtype=torch.int32))
    a = torch.as_tensor(np.random.RandomState(1).randint(spec.n_actions,
                                                         size=B))
    vec = make_vec(spec, episode_cap=cap, reset_obs=reset_obs)
    carried, obs, r, done, _ = vec.step(st, a, seed, ctr, block)
    stepped, _, r0, d0, _ = nt.make_step(spec, with_obs=False)(st, a)
    assert torch.equal(r, r0)
    assert torch.equal(done, d0 | (stepped.step_count >= cap))
    assert 0 < int(done.sum()) < B
    seeds, rows = rng.block_streams(seed, B, block)
    fresh = reset_rows(ResetTables(spec), seeds, ctr, rows).to_numpy()
    got, plain = carried.to_numpy(), stepped.to_numpy()
    d = done.numpy()
    for k, v in got.items():
        np.testing.assert_array_equal(v[d], fresh[k][d], err_msg=k)
        np.testing.assert_array_equal(v[~d], plain[k][~d], err_msg=k)
    get_obs = nt.make_step(spec).get_obs
    assert torch.equal(obs, get_obs(carried if reset_obs else stepped))
