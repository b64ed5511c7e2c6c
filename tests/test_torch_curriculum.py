"""The port's curriculum chain (ngx_torch/rl/curriculum.py) against
ngx.rl.curriculum on the CPU: the state adapter, the chained reset, the
chain evaluation and one chain train step.

The chain is not yet on ngx's draws (ngx_torch.ops.threefry reproduces
them; ROADMAP), so each test replays ngx's key schedule here and injects the resulting start states, actions,
pool rows, rollout seed and permutations into the port; the two never
share a seed."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ngx
from ngx.rl import curriculum as JC
from ngx.rl.models import ActorCritic as FlaxActorCritic
from ngx.transforms import lidar_in_front
import ngx_torch as nt
from ngx_torch.core.state import EnvState
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


def _ngx_chain_draws(env_ids, batch, cap, key):
    """ngx's chain(key) draws for random stages (curriculum.py:124-135):
    the stage-0 reset and each stage's uniform actions."""
    specs = [lidar_in_front(ngx.make_spec(e)) for e in env_ids]
    k0, key = jax.random.split(key)
    state0, _ = jax.jit(jax.vmap(ngx.make_reset(specs[0])))(
        jax.random.split(k0, batch))
    acts = []
    for k in range(len(specs) - 1):
        key, k_roll = jax.random.split(key)
        n = specs[k].n_actions
        acts.append(np.asarray(jax.jit(jax.vmap(
            lambda kt: jax.random.randint(kt, (batch,), 0, n)))(
                jax.random.split(k_roll, cap))))
    return state0, acts


def test_chain_reset_matches_ngx():
    """make_chain_reset on CHAIN[:3] with random stages, bit for bit
    against ngx's chain(key) from ngx's start states and actions: each env
    frozen at its first done, adapted, and the last stage's obs."""
    B, cap = 48, 20
    chain_j, _ = JC.make_chain_reset(CHAIN[:3], [None, None], B, cap=cap)
    key = jax.random.key(3)
    want_state, want_obs = jax.jit(chain_j)(key)
    state0, acts = _ngx_chain_draws(CHAIN[:3], B, cap, key)
    chain_t, spec = TC.make_chain_reset(CHAIN[:3], [None, None], B, cap=cap,
                                        device="cpu")
    got_state, got_obs = chain_t(0, start=EnvState.from_ngx(state0),
                                 actions=[torch.as_tensor(a) for a in acts])
    _assert_states_equal(got_state, want_state)
    assert got_obs.dtype == torch.float32
    assert torch.equal(got_obs, torch.as_tensor(np.asarray(want_obs),
                                                dtype=torch.float32))
    assert spec.env_id == CHAIN[2]
    # the stages ran: most envs carry steps into the last stage
    assert float((got_state.step_count > 0).float().mean()) > 0.9


def test_chain_reset_draws_and_stage_policies():
    """Without injected draws: stage 0 is the counter reset under the
    generator's first seed, the rows restored are valid, and a stage
    policy given as a state dict plays as the module it came from."""
    B, cap = 32, 12
    chain, spec = TC.make_chain_reset(CHAIN[:2], [None], B, cap=cap,
                                      device="cpu")
    state, obs = chain(5)
    assert state.map.shape == (B, spec.map_size ** 2)
    assert torch.equal(obs, nt.make_step(spec).get_obs(state).float())
    assert bool((state.selected == -1).all()) and not bool(
        state.last_done.any())
    assert int(state.step_count.max()) <= cap
    g = torch.Generator().manual_seed(5)
    seed0 = int(torch.randint(0, TC._SEED_HI, (), generator=g))
    start = nt.counter_reset(nt.lidar_in_front(nt.make_spec(CHAIN[0])),
                             seed0, 0, B, device="cpu")
    again, _ = chain(5, start=start)
    _assert_states_equal(again, state)
    sp0 = nt.lidar_in_front(nt.make_spec(CHAIN[0]))
    model = ActorCritic(71, sp0.n_actions, (16, 16),
                        generator=torch.Generator().manual_seed(2))
    runs = []
    for p in (model, model.state_dict()):
        c, _ = TC.make_chain_reset(CHAIN[:2], [p], B, cap=cap,
                                   device="cpu")
        runs.append(c(9)[0])
    _assert_states_equal(runs[0], runs[1])


def _flax_params(obs_dim, n_actions, hidden, seed):
    model = FlaxActorCritic(n_actions=n_actions, hidden=hidden)
    return model, jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.key(seed), jnp.zeros((1, obs_dim))))


def test_evaluate_chain_matches_ngx():
    """evaluate_chain's metrics equal ngx's from ngx's chain draws and its
    final-stage actions, replayed here from ngx's key schedule
    (curriculum.py:181-217): the fresh budget from the restore, the
    first-done bookkeeping and the goal-only solve."""
    E, cap, hidden, seed = 64, 24, (16, 16), 4
    spec = lidar_in_front(ngx.make_spec(CHAIN[2]))
    model, params = _flax_params(71, spec.n_actions, hidden, 1)
    want = JC.evaluate_chain(CHAIN[:3], [None, None], params, episodes=E,
                             cap=cap, hidden=hidden, seed=seed)
    k0, k1 = jax.random.split(jax.random.key(seed))
    state0, stage_acts = _ngx_chain_draws(CHAIN[:3], E, cap, k0)
    stage_acts = [torch.as_tensor(a) for a in stage_acts]
    # the chain's result, which test_chain_reset_matches_ngx holds bit for
    # bit against ngx's
    chain_t, _ = TC.make_chain_reset(CHAIN[:3], [None, None], E, cap,
                                     device="cpu")
    state_t, obs_t = chain_t(0, EnvState.from_ngx(state0), stage_acts)
    state = ngx.EnvState(**{k: jnp.asarray(v)
                            for k, v in state_t.to_numpy().items()})
    obs = jnp.asarray(obs_t.numpy())
    step = jax.vmap(ngx.make_step(spec))
    base = state.step_count

    @jax.jit
    def body(carry, kt):
        state, obs, keep = carry
        logits, _ = model.apply(params, obs.astype(jnp.float32))
        a = jax.random.categorical(kt, logits)
        ns, nobs, _, done, _ = step(state, a)
        keep = keep | done | (ns.step_count - base >= cap)
        state = jax.tree_util.tree_map(
            lambda o, n: jnp.where(keep.reshape(keep.shape + (1,) * (
                n.ndim - 1)), o, n), state, ns)
        return (state, jnp.where(keep[:, None], obs, nobs), keep), a

    _, acts = jax.lax.scan(body, (state, obs, jnp.zeros((E,), bool)),
                           jax.random.split(k1, cap))
    m = ActorCritic(71, spec.n_actions, hidden).load_flax_params(params)
    got = TC.evaluate_chain(
        CHAIN[:3], [None, None], m, episodes=E, cap=cap, seed=0,
        device="cpu", start=EnvState.from_ngx(state0),
        stage_actions=stage_acts,
        actions=torch.as_tensor(np.asarray(acts)))
    assert got["solve_rate"] == want["solve_rate"]
    assert got["done_rate"] == want["done_rate"]
    np.testing.assert_allclose(got["mean_return"], want["mean_return"],
                               rtol=1e-6)
    assert want["done_rate"] > 0.5
    # and without injected draws it runs its own, on the counter RNG
    own = TC.evaluate_chain(CHAIN[:3], [None, None], m, episodes=E, cap=cap,
                            seed=1, device="cpu")
    assert set(own) == set(want) and all(np.isfinite(list(own.values())))


def test_train_chain_step_matches_ngx():
    """One make_train_chain step against ngx's (rollout_backend 'pallas':
    the Pallas kernel in interpret mode) from ngx's init, on a pool whose
    inventories reach above 255: the rollout (final state, obs and bases)
    bit for bit from the same seed, pool rows and base, the episode tallies
    exactly, the losses within test_torch_ppo's tolerance."""
    B, T, cap, P, hidden = 128, 8, 6, 32, (16, 16)
    cfg_j = JC.PPOConfig(env_id=CHAIN[2], num_envs=B, rollout_steps=T,
                         num_minibatches=2, epochs=1, hidden=hidden,
                         episode_cap=cap, solve_shaped=True)
    cfg_t = Tt.PPOConfig(**{k: getattr(cfg_j, k) for k in
                            cfg_j.__dataclass_fields__})
    init_j, step_j = JC.make_train_chain(cfg_j, CHAIN[:3], [None, None],
                                         rollout_backend="pallas",
                                         pool_size=P)
    carry_j = init_j(jax.random.key(0))
    # chain-terminal inventories can be large (three stages of crafting):
    # lift the pool's to 300+ so the restored obs hold values above 255
    pool = carry_j[5]
    big = pool.replace(inventory=pool.inventory + 300)
    carry_j = carry_j[:5] + (big, carry_j[6])
    key = jax.random.key(1)
    _, k_roll, k_upd = jax.random.split(key, 3)
    k_seed, k_idx = jax.random.split(k_roll)
    roll_seed = int(jax.random.randint(k_seed, (), 0,
                                       jnp.iinfo(jnp.int32).max))
    pool_idx = np.asarray(jax.random.randint(k_idx, (B, Tt.POOL_SLOTS), 0,
                                             P))
    perms = [np.asarray(jax.random.permutation(k, B * T))
             for k in jax.random.split(k_upd, cfg_j.epochs)]
    carry_j2, m_j = jax.jit(step_j)(carry_j, key)

    ts_j, st_j, obs_j, ret_j, base_j, pool_j, pobs_j = carry_j
    model = ActorCritic(71, 4, hidden).load_flax_params(
        jax.tree_util.tree_map(np.asarray, ts_j.params))
    ts = Tt.TrainState(model, torch.optim.Adam(model.parameters(),
                                               lr=cfg_t.lr, eps=1e-5))
    carry_t = (ts, EnvState.from_ngx(st_j), torch.as_tensor(np.asarray(obs_j)),
               torch.as_tensor(np.asarray(ret_j)),
               torch.as_tensor(np.asarray(base_j)), EnvState.from_ngx(pool_j),
               torch.as_tensor(np.asarray(pobs_j)))
    _, step_t = TC.make_train_chain(cfg_t, CHAIN[:3], [None, None],
                                    pool_size=P, device="cpu")
    carry_t2, m_t = step_t(carry_t, 0, roll_seed=roll_seed,
                           pool_idx=pool_idx, perms=perms)

    _assert_states_equal(carry_t2[1], carry_j2[1])
    assert torch.equal(carry_t2[2], torch.as_tensor(np.asarray(carry_j2[2])))
    assert torch.equal(carry_t2[4], torch.as_tensor(np.asarray(carry_j2[4])))
    assert float(carry_t2[2].max()) > 255      # obs exact above 255
    np.testing.assert_allclose(carry_t2[3].numpy(), np.asarray(carry_j2[3]),
                               rtol=1e-6)
    m_j = {k: float(v) for k, v in m_j.items()}
    m_t = {k: float(v) for k, v in m_t.items()}
    assert sorted(m_t) == sorted(m_j)
    for k in ("episodes", "ep_count", "ep_solved", "ep_len_sum"):
        assert m_t[k] == m_j[k], k
    for k in ("ep_return_sum", "mean_reward", "v_loss", "entropy"):
        np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(m_t["pg_loss"], m_j["pg_loss"], atol=1e-6)
    assert m_t["episodes"] >= B
    # the base carried, never reset to zero: bases come from pool rows
    assert bool((carry_t2[4] > 0).any())


def test_train_chain_xla_step_matches_ngx():
    """One make_train_chain step with rollout_backend 'xla' against ngx's
    XLA chain step from ngx's init, its key schedule replayed (each step's
    categorical noise as jax.random.gumbel of its k_act and its uniform
    pool rows from k_pool; the epochs' permutations): the final state bit
    for bit — the restored last_action, last_reward and last_cost carried
    from the pool rows, not zeroed — the obs and bases exactly, the
    tallies exactly, the losses within test_torch_ppo's tolerance.  Cap 4
    from a fresh restore puts restores at the last step."""
    B, T, cap, P, hidden = 128, 8, 4, 32, (16, 16)
    cfg_j = JC.PPOConfig(env_id=CHAIN[2], num_envs=B, rollout_steps=T,
                         num_minibatches=2, epochs=1, hidden=hidden,
                         episode_cap=cap, solve_shaped=True)
    cfg_t = Tt.PPOConfig(**{k: getattr(cfg_j, k) for k in
                            cfg_j.__dataclass_fields__})
    init_j, step_j = JC.make_train_chain(cfg_j, CHAIN[:3], [None, None],
                                         rollout_backend="xla",
                                         pool_size=P)
    carry_j = init_j(jax.random.key(0))
    # give the pool rows nonzero last_* fields, so a zeroing restore shows
    pool = carry_j[5]
    n = pool.step_count.shape[0]
    pool = pool.replace(
        last_action=(jnp.arange(n, dtype=jnp.int32) % 4) + 0,
        last_reward=jnp.arange(n, dtype=jnp.float32) * 0.5 + 1.0,
        last_cost=-jnp.arange(n, dtype=jnp.float32) - 2.0)
    carry_j = carry_j[:5] + (pool, carry_j[6])
    key = jax.random.key(1)
    _, k_roll, k_upd = jax.random.split(key, 3)
    noise, idx = [], []
    for kt in jax.random.split(k_roll, T):
        k_act, k_pool = jax.random.split(kt)
        noise.append(np.asarray(jax.random.gumbel(k_act, (B, 4))))
        idx.append(np.asarray(jax.random.randint(k_pool, (B,), 0, P)))
    perms = [np.asarray(jax.random.permutation(k, B * T))
             for k in jax.random.split(k_upd, cfg_j.epochs)]
    carry_j2, m_j = jax.jit(step_j)(carry_j, key)

    ts_j, st_j, obs_j, ret_j, base_j, pool_j, pobs_j = carry_j
    model = ActorCritic(71, 4, hidden).load_flax_params(
        jax.tree_util.tree_map(np.asarray, ts_j.params))
    ts = Tt.TrainState(model, torch.optim.Adam(model.parameters(),
                                               lr=cfg_t.lr, eps=1e-5))
    carry_t = (ts, EnvState.from_ngx(st_j), torch.as_tensor(np.asarray(obs_j)),
               torch.as_tensor(np.asarray(ret_j)),
               torch.as_tensor(np.asarray(base_j)), EnvState.from_ngx(pool_j),
               torch.as_tensor(np.asarray(pobs_j)))
    _, step_t = TC.make_train_chain(cfg_t, CHAIN[:3], [None, None],
                                    rollout_backend="xla", pool_size=P,
                                    device="cpu")
    carry_t2, m_t = step_t(carry_t, 0, pool_idx=np.stack(idx), perms=perms,
                           gumbel=torch.as_tensor(np.stack(noise)))

    _assert_states_equal(carry_t2[1], carry_j2[1])
    assert torch.equal(carry_t2[2], torch.as_tensor(np.asarray(carry_j2[2])))
    assert torch.equal(carry_t2[4], torch.as_tensor(np.asarray(carry_j2[4])))
    np.testing.assert_allclose(carry_t2[3].numpy(), np.asarray(carry_j2[3]),
                               rtol=1e-6)
    m_j = {k: float(v) for k, v in m_j.items()}
    m_t = {k: float(v) for k, v in m_t.items()}
    assert sorted(m_t) == sorted(m_j)
    for k in ("episodes", "ep_count", "ep_solved", "ep_len_sum"):
        assert m_t[k] == m_j[k], k
    for k in ("ep_return_sum", "mean_reward", "v_loss", "entropy"):
        np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(m_t["pg_loss"], m_j["pg_loss"], atol=1e-6)
    # restores happened, and carried the rows' last_* fields (an env
    # restored at the last step holds its pool row's last_reward >= 1,
    # where the kernel's restore writes 0)
    assert m_t["episodes"] >= B
    assert bool((carry_t2[1].last_reward >= 1.0).any())


def test_train_chain_carry_refresh_and_backends():
    """init's carry is ngx's layout with B draws from the P-row pool and
    base = their step counts; refresh_pool swaps only the pool; a step
    times its phases; 'xla' runs the unfused loop from the same carry (no
    kernel, its own [T, B] pool draws), 'auto' never takes it, and an
    unknown backend raises."""
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
    assert sorted(step_x.phases) == ["acting", "gae", "recompute", "update"]
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
    assert sorted(step.phases) == ["acting", "gae", "recompute", "update"]
    assert all(np.isfinite(float(v)) for v in m.values())
    assert len(carry) == 7 and carry[5] is fresh[5]
    # the trained model takes cfg.hidden; a state-dict stage keeps the
    # converted agent's (64, 64)
    stage = restore_checkpoint(str(ROOT / "trained_agents_torch/chain" /
                                   CHAIN[0] / "best.pt"))["params"]
    init64, _ = TC.make_train_chain(cfg, CHAIN[:2], [stage], pool_size=16,
                                    device="cpu")
    assert init64(0)[0].model.hidden == (16, 16)
