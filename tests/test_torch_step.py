"""The port's batched plain step (ngx_torch/core/step.py) and observations
(ngx_torch/ops/rays.py: LidarInFront, the legacy V0 and INV lidars, AgentMap)
bit-exact against jax.vmap(ngx make_step) and the TPU kernel's in-kernel
lidar (ngx/ops/pallas_rollout.py:471)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ngx
from ngx.ops import pallas_rollout as P
import ngx_torch as nt
from ngx_torch.core import spec as S
from ngx_torch.core.state import EnvState

from test_torch_spec import NOVELTIES, STACKED, novelty_specs

# one torch thread per test process: xdist runs several on the CPU, where
# more threads only contend (the port's suite runs twice as fast)
torch.set_num_threads(1)

SUPPORTED = ("NovelGridworld-Pogostick-v1", "NovelGridworld-v6",
             "NovelGridworld-Bow-v0", "NovelGridworld-Bow-v1")
# the legacy template (craft variants and nags, fused place+extract, the
# front-item goal, dead-end recipes) and Pogostick-v0, each under its own
# observation: the V0 or INV lidar, or the Dict
LEGACY = ("NovelGridworld-v0", "NovelGridworld-v1", "NovelGridworld-v2",
          "NovelGridworld-v3", "NovelGridworld-v4", "NovelGridworld-v5",
          "NovelGridworld-Pogostick-v0")


def _start_states(sp, B, seed, goal_items=True):
    """Counter-reset states with random inventories, so crafting, placing
    and the inventory goal all fire inside 200 random steps;
    ``goal_items=False`` starts every env without its goal items."""
    st = P.make_xla_pool_reset(sp, B)(seed, 0)
    inv = np.random.RandomState(seed).randint(0, 6, size=(B, sp.n_items))
    if not goal_items:
        inv[:, np.asarray(sp.goal_counts) > 0] = 0
    return st.replace(inventory=jnp.asarray(inv, jnp.int32),
                      last_done=st.last_done.astype(bool))


def _assert_obs_equal(want, got, msg):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(),
                                          err_msg=f"{k} {msg}")
    else:
        np.testing.assert_array_equal(np.asarray(want), got.numpy(),
                                      err_msg=msg)


def _assert_steps_bit_exact(sp, spt, B, T, goal_items=True, bias=(),
                            record=None):
    """T random steps of B envs through jax.vmap(ngx make_step) and the
    port's batched step: state, reward, done, info and obs bit for bit.
    ``bias``: action ids drawn for half of the envs each step (the rest
    uniform); ``record``, a list, gets ``(state before, action, info)`` of
    every step.  Returns the counts of crafts and of done steps."""
    st = _start_states(sp, B, 3, goal_items)
    ts = EnvState.from_ngx(st)
    jstep = jax.jit(jax.vmap(ngx.make_step(sp)))
    tstep = nt.make_step(spt)
    rng = np.random.RandomState(0)
    n_craft = n_goal = 0
    for t in range(T):
        a = rng.randint(sp.n_actions, size=B).astype(np.int32)
        if bias:
            pick = rng.rand(B) < 0.5
            a[pick] = np.asarray(bias, np.int32)[rng.randint(len(bias),
                                                             size=B)][pick]
        if record is not None:
            before = ts.to_numpy()
        st, obs_j, r_j, d_j, info_j = jstep(st, jnp.asarray(a))
        ts, obs_t, r_t, d_t, info_t = tstep(ts, torch.as_tensor(a))
        got = ts.to_numpy()
        for k, v in got.items():
            np.testing.assert_array_equal(np.asarray(getattr(st, k)), v,
                                          err_msg=f"{k} t={t}")
        np.testing.assert_array_equal(np.asarray(r_j), r_t.numpy())
        np.testing.assert_array_equal(np.asarray(d_j), d_t.numpy())
        for k in ("result", "step_cost", "msg_code", "msg_arg"):
            np.testing.assert_array_equal(np.asarray(getattr(info_j, k)),
                                          getattr(info_t, k).numpy(),
                                          err_msg=f"info.{k} t={t}")
        _assert_obs_equal(obs_j, obs_t, f"obs t={t}")
        n_craft += int((info_t.msg_code == ngx.core.spec.MSG_CRAFTED).sum())
        n_goal += int(d_t.sum())
        if record is not None:
            record.append((before, a, {k: getattr(info_t, k).numpy() for k in
                                       ("result", "msg_code", "msg_arg")},
                           ts.to_numpy()))
    return n_craft, n_goal


@pytest.mark.parametrize("env_id", SUPPORTED)
def test_step_bit_exact(env_id):
    sp = ngx.transforms.lidar_in_front(ngx.make_spec(env_id))
    spt = nt.lidar_in_front(nt.make_spec(env_id))
    n_craft, n_goal = _assert_steps_bit_exact(sp, spt, 256, 200)
    assert n_craft > 0 and n_goal > 0, (n_craft, n_goal)


@pytest.mark.parametrize("env_id", LEGACY)
def test_legacy_step_bit_exact(env_id):
    _, n_done = _assert_steps_bit_exact(
        ngx.make_spec(env_id), nt.make_spec(env_id), 128, 200,
        goal_items=False)
    assert n_done > 0


def _front(before, H):
    """The item in front of each agent in a recorded pre-step state."""
    fr = before["agent"] + S.FACING_DELTAS[before["facing"]]
    inb = ((fr >= 0) & (fr < H)).all(1)
    idx = np.where(inb, fr[:, 0] * H + fr[:, 1], 0)
    return np.where(inb, before["map"][np.arange(len(idx)), idx], 0)


def _fired(name, spt, record):
    """How often the novelty's own family acted in a recorded run: the
    message codes, or the events in the state, that only it produces."""
    A, I, H = spt.actions, spt.items, spt.map_size
    n = 0
    for before, a, info, after in record:
        ok, msg = info["result"], info["msg_code"]
        front = _front(before, H)
        inv_gain = after["inventory"] - before["inventory"]
        is_break = a == A.index("Break")
        if name == "addchop":
            n += int(((a == A.index("Chop")) & ok).sum())
        elif name == "addjump":
            n += int(((a == A.index("Jump")) & ok).sum())
        elif name in ("additem", "fence"):       # the edit's item, broken
            item = I.index("fence" if name == "additem" else "oak_fence")
            n += int((is_break & ok & (front == item)).sum())
        elif name == "axe":                        # breaks with the axe
            n += int((is_break & ok & (before["selected"] ==
                                       I.index("wooden_axe"))).sum())
        elif name == "axetobreak":
            n += int((msg == S.MSG_NEED_AXE).sum())
        elif name == "breakincrease":              # tree_log yields 2
            tree = I.index("tree_log")
            n += int((is_break & (front == tree)
                      & (inv_gain[:, tree] == 2)).sum())
        elif name == "crate":                      # contents granted
            n += int((is_break & (front == I.index("crate"))
                      & (inv_gain.sum(1) > 1)).sum())
        elif name == "extractincdec":              # string yield 2, not 4
            n += int(((a == A.index("Extract_string")) & ok
                      & (inv_gain[:, I.index("string")] == 2)).sum())
        elif name == "fencerestriction":           # gated, and the +2 tail
            n += int(((msg == S.MSG_FENCE_RESTRICTION)).sum()) * int(
                ((after["step_count"] - before["step_count"]) == 2).any())
        elif name == "firewall":
            n += int((msg == S.MSG_DIED_FIREWALL).sum())
        elif name == "remapaction":
            n += int((msg == S.MSG_CRAFTED).sum())
        elif name == "replaceitem":                # the stone is a wall now
            n += int(((msg == S.MSG_CANNOT_BREAK)
                      & (info["msg_arg"] == I.index("stone"))).sum())
        elif name == "stacked":                    # the axe grabbed
            n += int((inv_gain[:, I.index("wooden_axe")] > 0).sum()) * int(
                (is_break & ok & (front == I.index("oak_fence"))).any())
    return n


_BIAS = {"addchop": ("Chop",), "addjump": ("Jump",),
         "axe": ("Select_wooden_axe", "Break"),
         "axetobreak": ("Select_iron_axe", "Break"),
         "extractincdec": ("Extract_string",)}


@pytest.mark.parametrize("env_id,novelty",
                         NOVELTIES + ((STACKED[0], None),))
def test_novelty_step_bit_exact(env_id, novelty):
    """200 steps of 256 envs from ngx's counter reset (the edits applied)
    on each novelty spec: the step bit-exact, with the actions biased
    toward the novelty's own (select the axe, Break, Chop, Jump, turns and
    moves), and its family seen acting."""
    novs = STACKED[1] if novelty is None else (novelty,)
    name = "stacked" if novelty is None else novelty[0]
    sp = ngx.transforms.lidar_in_front(novelty_specs(ngx, env_id, novs))
    spt = nt.lidar_in_front(novelty_specs(nt, env_id, novs))
    bias = _BIAS.get(name, ()) + ("Break", "Forward", "Left", "Right")
    record = []
    _assert_steps_bit_exact(sp, spt, 256, 200, goal_items=False,
                            bias=[spt.actions.index(x) for x in bias],
                            record=record)
    assert _fired(name, spt, record) > 0, name


@pytest.mark.parametrize("env_id", ["NovelGridworld-Pogostick-v1",
                                    "NovelGridworld-Bow-v0"])
def test_dict_obs_bit_exact(env_id):
    sp, spt = ngx.make_spec(env_id), nt.make_spec(env_id)
    st = _start_states(sp, 64, 5)
    want = jax.vmap(ngx.make_step(sp).get_obs)(st)
    got = nt.make_step(spt).get_obs(EnvState.from_ngx(st))
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())


@pytest.mark.parametrize("env_id", ["NovelGridworld-v3",
                                    "NovelGridworld-Pogostick-v1"])
def test_agent_map_obs_bit_exact(env_id):
    """The AgentMap rewrite's 11x11 window, zero outside the map."""
    sp = ngx.transforms.agent_map(ngx.make_spec(env_id))
    spt = nt.agent_map(nt.make_spec(env_id))
    st = _start_states(sp, 64, 6)
    want = jax.vmap(ngx.make_step(sp).get_obs)(st)
    _assert_obs_equal(want, nt.make_step(spt).get_obs(EnvState.from_ngx(st)),
                      env_id)


def test_lidar_matches_kernel_lidar():
    """The port's lidar against the TPU kernel's in-kernel LidarInFront,
    traced as plain jnp (pallas_rollout.py:471-530)."""
    sp = ngx.transforms.lidar_in_front(
        ngx.make_spec("NovelGridworld-Pogostick-v1"))
    spt = nt.lidar_in_front(nt.make_spec("NovelGridworld-Pogostick-v1"))
    B = 128
    st = _start_states(sp, B, 9)
    # walk the agents around so the beams see varied maps and facings
    jstep = jax.jit(jax.vmap(ngx.make_step(sp)))
    rng = np.random.RandomState(1)
    tab = P._build_lidar_tables(sp)
    kernel_obs = jax.jit(P._make_lidar_obs_fn(sp, tab, B))
    get_obs = nt.make_step(spt).get_obs
    for _ in range(20):
        st = jstep(st, jnp.asarray(rng.randint(3, size=B), jnp.int32))[0]
        np.testing.assert_array_equal(
            np.asarray(kernel_obs(st)),
            get_obs(EnvState.from_ngx(st)).to(torch.float32).numpy())


def wide_specs(pkg, env_id="NovelGridworld-Pogostick-v1", n_add=30):
    """``env_id`` with ``n_add`` stacked additem novelties (new items
    ``thing0``.. : 39 item ids on Pogostick-v1), built by ``pkg`` (ngx or
    the port): past the CUDA kernels' 32 item ids, which ngx's plain step
    runs."""
    sp = pkg.make_spec(env_id)
    for k in range(n_add):
        sp = pkg.inject_novelty(sp, "additem", "easy", f"thing{k}")
    return sp


def noop_specs(pkg, env_id="NovelGridworld-Pogostick-v1", action="Left"):
    """``env_id`` with ``action``'s op set to NOOP (ngx's ``OP_NOOP``, which
    no reference spec has)."""
    sp = pkg.make_spec(env_id)
    op = np.asarray(sp.action_op).copy()
    op[sp.actions_id[action]] = S.OP_NOOP
    return sp.replace(action_op=op)


@pytest.mark.parametrize("case", ["39 items", "NOOP"])
def test_plain_step_takes_what_ngx_takes(case):
    """More than 32 item ids and the NOOP op: the port's plain step bit for
    bit ngx's, obs included; the NOOP action seen succeeding."""
    build = wide_specs if case == "39 items" else noop_specs
    sp = ngx.transforms.lidar_in_front(build(ngx))
    spt = nt.lidar_in_front(build(nt))
    assert (spt.n_items == 39) if case == "39 items" else \
        S.OP_NOOP in spt.action_op
    nt.check_supported(spt)
    record = []
    _assert_steps_bit_exact(sp, spt, 128, 100, goal_items=False,
                            bias=[spt.actions_id["Left"]], record=record)
    if case == "NOOP":
        left = spt.actions_id["Left"]
        n = sum(int(((a == left) & info["result"]
                     & (after["facing"] == before["facing"])).sum())
                for before, a, info, after in record)
        assert n > 0


# a facing outside 0-3 (a corrupt state): ngx reads its facing tables by
# one-hot, so the delta is zero, a turn gives 0 and the lidar reads ngx's
# clamped row
@pytest.mark.parametrize("facing", [4, 5, -1])
def test_step_from_a_corrupt_facing_matches_ngx(facing):
    sp = ngx.transforms.lidar_in_front(
        ngx.inject_novelty(ngx.make_spec("NovelGridworld-Pogostick-v1"),
                           "addjump"))
    spt = nt.lidar_in_front(
        nt.inject_novelty(nt.make_spec("NovelGridworld-Pogostick-v1"),
                          "addjump"))
    B = 16
    st = _start_states(sp, B, 4)
    st = st.replace(facing=jnp.full((B,), facing, jnp.int32))
    ts = EnvState.from_ngx(st)
    jstep = jax.jit(jax.vmap(ngx.make_step(sp)))
    tstep = nt.make_step(spt)
    for name in ("Forward", "Left", "Right", "Jump", "Break"):
        a = np.full((B,), spt.actions_id[name], np.int32)
        want = jstep(st, jnp.asarray(a))
        got = tstep(ts, torch.as_tensor(a))
        for k, v in got[0].to_numpy().items():
            np.testing.assert_array_equal(np.asarray(getattr(want[0], k)), v,
                                          err_msg=f"{k} {name}")
        _assert_obs_equal(want[1], got[1], f"obs {name}")
        np.testing.assert_array_equal(np.asarray(want[2]), got[2].numpy())
        for k in ("result", "step_cost", "msg_code", "msg_arg"):
            np.testing.assert_array_equal(np.asarray(getattr(want[4], k)),
                                          getattr(got[4], k).numpy(),
                                          err_msg=f"info.{k} {name}")
        turned = name in ("Left", "Right")
        assert (got[0].facing == (0 if turned else facing)).all(), name


def test_goal_front_read_from_a_corrupt_facing_matches_ngx():
    """NovelGridworld-v0's goal reads the cell in front after the action
    (ngx/core/step.py:597-599): from a facing outside 0-3, ngx's zero delta
    (the agent's own cell)."""
    sp, spt = ngx.make_spec("NovelGridworld-v0"), \
        nt.make_spec("NovelGridworld-v0")
    B = 32
    st = _start_states(sp, B, 2, goal_items=False)
    st = st.replace(facing=jnp.asarray(np.tile([4, 5, -1, 7], B // 4),
                                       jnp.int32))
    a = np.asarray(np.arange(B) % sp.n_actions, np.int32)
    want = jax.jit(jax.vmap(ngx.make_step(sp)))(st, jnp.asarray(a))
    got = nt.make_step(spt)(EnvState.from_ngx(st), torch.as_tensor(a))
    for k, v in got[0].to_numpy().items():
        np.testing.assert_array_equal(np.asarray(getattr(want[0], k)), v,
                                      err_msg=k)
    _assert_obs_equal(want[1], got[1], "obs")
    np.testing.assert_array_equal(np.asarray(want[2]), got[2].numpy())
    np.testing.assert_array_equal(np.asarray(want[3]), got[3].numpy())


def test_wide_spec_reset_and_vec_match_ngx():
    """The 39-item spec's reset and auto-resetting ``VecEnv``: ``reset_rows``
    bit for bit ngx's ``make_xla_pool_reset`` (the 30 edits' items on the
    maps), and 20 ``VecEnv.step`` calls (cap 8, so every env resets twice)
    bit for bit ngx's step with the done envs replaced by ngx's
    ``make_xla_pool_reset`` rows at the step's counter (one RNG block)."""
    from ngx_torch.core.reset import ResetTables, reset_rows
    from ngx_torch.vector import make_vec

    sp = ngx.transforms.lidar_in_front(wide_specs(ngx))
    spt = nt.lidar_in_front(wide_specs(nt))
    B, T, cap, seed = 64, 20, 8, -2 ** 31 + 7
    pool = P.make_xla_pool_reset(sp, B)

    def ngx_reset(ctr):
        st = pool(seed, ctr)
        return st.replace(last_done=st.last_done.astype(bool))

    def assert_state(want, got, msg):
        for k, v in got.to_numpy().items():
            np.testing.assert_array_equal(np.asarray(getattr(want, k)), v,
                                          err_msg=f"{k} {msg}")

    st = ngx_reset(0)
    ts = reset_rows(ResetTables(spt), seed, 0, torch.arange(B))
    assert_state(st, ts, "reset")
    m = ts.map.numpy()
    assert ((m >= 9).sum(1) > 0).all() and len(np.unique(m)) > 32

    jstep = jax.jit(jax.vmap(ngx.make_step(sp)))
    vec = make_vec(spt, episode_cap=cap)
    rng = np.random.RandomState(2)
    n_reset = 0
    for t in range(T):
        a = rng.randint(sp.n_actions, size=B).astype(np.int32)
        st, _, r_j, d_j, _ = jstep(st, jnp.asarray(a))
        done = np.asarray(d_j | (st.step_count >= cap))
        if done.any():
            fresh = ngx_reset(t + 1)
            st = jax.tree_util.tree_map(
                lambda x, y: jnp.where(
                    jnp.asarray(done).reshape((B,) + (1,) * (x.ndim - 1)),
                    y, x), st, fresh)
        ts, obs, r_t, d_t, _ = vec.step(ts, torch.as_tensor(a), seed, t + 1)
        assert_state(st, ts, f"t={t}")
        np.testing.assert_array_equal(np.asarray(r_j), r_t.numpy())
        np.testing.assert_array_equal(done, d_t.numpy())
        n_reset += int(done.sum())
    assert n_reset >= 2 * B
