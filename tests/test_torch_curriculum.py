"""The port's curriculum chain (ngx_torch/rl/curriculum.py) on the CPU:
the state adapter against ngx.rl.curriculum's, the chained reset's draws
and stage policies, and the chain trainer's carry, pool refresh and
backends.  The chain, its evaluation and its train step from ngx's keys
against ngx's are tests/test_torch_keyed_chain.py."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ngx
from ngx.rl import curriculum as JC
import ngx_torch as nt
from ngx_torch.core.state import EnvState
from ngx_torch.ops import threefry as TF
from ngx_torch.rl import curriculum as TC
from ngx_torch.rl import train as Tt
from ngx_torch.rl.models import ActorCritic
from ngx_torch.utils.checkpoint import restore_checkpoint

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CHAIN = ["NovelGridworld-v2", "NovelGridworld-v3", "NovelGridworld-v4",
         "NovelGridworld-v5"]
POGO = "NovelGridworld-Pogostick-v1"
FENCE = ("fence", "medium", "oak")


def _specs(env_id):
    if env_id == "fence":
        return (ngx.inject_novelty(ngx.make_spec(POGO), *FENCE),
                nt.inject_novelty(nt.make_spec(POGO), *FENCE))
    return ngx.make_spec(env_id), nt.make_spec(env_id)


def _assert_states_equal(got: EnvState, want):
    """Every field bit for bit; ``want`` a port state or ngx's."""
    if not isinstance(want, EnvState):
        want = EnvState.from_ngx(want)
    for k, v in want.__dict__.items():
        assert torch.equal(getattr(got, k), v), k


@pytest.mark.parametrize("src,dst", [
    ("NovelGridworld-v2", "NovelGridworld-v3"),
    ("NovelGridworld-v3", "NovelGridworld-v4"),
    ("NovelGridworld-v4", "NovelGridworld-v5"),
    ("NovelGridworld-v5", "NovelGridworld-v4"),
    (POGO, "fence"), ("fence", POGO)])
def test_adapter_matches_ngx(src, dst):
    """Bit for bit against ngx's adapter on states whose every field is
    random: items (and the fence's oak_fence, absent from Pogostick-v1)
    re-indexed by name, inventories gathered by name, the last action by
    name (an action absent from the destination maps to 0)."""
    (sj, st), (dj, dt) = _specs(src), _specs(dst)
    B, rs = 64, np.random.RandomState(7)
    hw = st.map_size ** 2
    leaves = {
        "map": rs.randint(0, st.n_items, (B, hw)).astype(np.int32),
        "agent": rs.randint(1, st.map_size - 1, (B, 2)).astype(np.int32),
        "facing": rs.randint(0, 4, B).astype(np.int32),
        "inventory": rs.randint(0, 600, (B, st.n_items)).astype(np.int32),
        "selected": rs.randint(-1, st.n_items, B).astype(np.int32),
        "step_count": rs.randint(0, 300, B).astype(np.int32),
        "last_action": rs.randint(0, st.n_actions, B).astype(np.int32),
        "last_reward": rs.randn(B).astype(np.float32),
        "last_cost": rs.rand(B).astype(np.float32),
        "last_done": rs.rand(B) < 0.5,
    }
    want = jax.vmap(JC.make_state_adapter(sj, dj))(ngx.EnvState(
        **{k: jnp.asarray(v) for k, v in leaves.items()}))
    got = TC.make_state_adapter(st, dt)(EnvState(
        **{k: torch.as_tensor(v) for k, v in leaves.items()}))
    _assert_states_equal(got, want)
    if src != dst and "fence" in (src, dst):
        assert sj.items != dj.items


def test_chain_reset_draws_and_stage_policies():
    """Stage 0 is ngx's native reset over ``split(k0, B)`` with ``k0`` the
    first half of the key (a chain of one env plays no stage), the rows
    restored are valid, an int seed is ``key(int)``, and a stage policy
    given as a state dict plays as the module it came from."""
    B, cap = 32, 12
    chain, spec = TC.make_chain_reset(CHAIN[:2], [None], B, cap=cap,
                                      device="cpu")
    state, obs = chain(5)
    assert state.map.shape == (B, spec.map_size ** 2)
    assert torch.equal(obs, nt.make_step(spec).get_obs(state).float())
    assert bool((state.selected == -1).all()) and not bool(
        state.last_done.any())
    assert int(state.step_count.max()) <= cap
    again, _ = chain(TF.key(5))
    _assert_states_equal(again, state)
    sp0 = nt.lidar_in_front(nt.make_spec(CHAIN[0]))
    k0, _ = TF.split(TF.key(5))
    start, _ = nt.make_reset(sp0, "cpu")(TF.split(k0, B))
    stage0, _ = TC.make_chain_reset(CHAIN[:1], [], B, cap=cap,
                                    device="cpu")
    _assert_states_equal(stage0(5)[0], start)
    model = ActorCritic.from_key(TF.key(2), 71, sp0.n_actions, (16, 16))
    runs = []
    for p in (model, model.state_dict()):
        c, _ = TC.make_chain_reset(CHAIN[:2], [p], B, cap=cap,
                                   device="cpu")
        runs.append(c(9)[0])
    _assert_states_equal(runs[0], runs[1])


def test_train_chain_carry_refresh_and_backends():
    """init's carry is ngx's layout with B draws from the P-row pool and
    base = their step counts; refresh_pool swaps only the pool; a step
    times its phases, the permutations' draw among them; 'xla' runs the
    unfused loop from the same carry (no kernel, its own [T, B] pool
    draws), 'auto' never takes it, and an unknown backend raises."""
    cfg = Tt.PPOConfig(env_id=CHAIN[1], num_envs=128, rollout_steps=6,
                       num_minibatches=2, epochs=1, hidden=(16, 16),
                       episode_cap=5)
    with pytest.raises(ValueError, match="rollout_backend"):
        TC.make_train_chain(cfg, CHAIN[:2], [None], rollout_backend="mosaic",
                            device="cpu")
    init_x, step_x = TC.make_train_chain(cfg, CHAIN[:2], [None],
                                         rollout_backend="xla",
                                         pool_size=16, device="cpu")
    assert step_x.rollout_backend == "xla"
    carry_x = step_x.refresh_pool(init_x(0), 11)
    step_x.phases = {}
    carry_x, m_x = step_x(carry_x, 1)
    assert sorted(step_x.phases) == ["acting", "gae", "permutation",
                                     "recompute", "update"]
    assert all(np.isfinite(float(v)) for v in m_x.values())
    assert int(m_x["episodes"]) >= 128 and len(carry_x) == 7
    init, step = TC.make_train_chain(cfg, CHAIN[:2], [None], pool_size=16,
                                     device="cpu")
    assert step.rollout_backend == "pallas"
    carry = init(0)
    ts, st, obs, ret, base, pool, pool_obs = carry
    assert pool.batch == 16 and st.batch == 128
    assert torch.equal(base, st.step_count)
    rows = [int(((pool.map == st.map[b]).all(1)
                 & (pool.step_count == st.step_count[b])).nonzero()[0])
            for b in range(4)]
    assert all(torch.equal(obs[b], pool_obs[r]) for b, r in enumerate(rows))
    fresh = step.refresh_pool(carry, 11)
    assert all(a is b for a, b in zip(fresh[:5], carry[:5]))
    assert not torch.equal(fresh[5].map, pool.map)
    step.phases = {}
    carry, m = step(fresh, 1)
    assert sorted(step.phases) == ["acting", "gae", "permutation",
                                   "recompute", "update"]
    assert all(np.isfinite(float(v)) for v in m.values())
    assert len(carry) == 7 and carry[5] is fresh[5]
    # the trained model takes cfg.hidden; a state-dict stage keeps the
    # converted agent's (64, 64)
    stage = restore_checkpoint(str(ROOT / "trained_agents_torch/chain" /
                                   CHAIN[0] / "best.pt"))["params"]
    init64, _ = TC.make_train_chain(cfg, CHAIN[:2], [stage], pool_size=16,
                                    device="cpu")
    assert init64(0)[0].model.hidden == (16, 16)
