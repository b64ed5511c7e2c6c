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
from ngx_torch.core.state import EnvState

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


def _assert_steps_bit_exact(sp, spt, B, T, goal_items=True):
    """T random steps of B envs through jax.vmap(ngx make_step) and the
    port's batched step: state, reward, done, info and obs bit for bit.
    Returns the counts of crafts and of done steps."""
    st = _start_states(sp, B, 3, goal_items)
    ts = EnvState.from_ngx(st)
    jstep = jax.jit(jax.vmap(ngx.make_step(sp)))
    tstep = nt.make_step(spt)
    rng = np.random.RandomState(0)
    n_craft = n_goal = 0
    for t in range(T):
        a = rng.randint(sp.n_actions, size=B).astype(np.int32)
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
