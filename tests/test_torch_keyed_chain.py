"""The port's curriculum chain on ngx's keys (ngx_torch/rl/curriculum.py)
against ngx.rl.curriculum from the same ``jax.random`` key on the CPU,
with nothing injected: the chain NovelGridworld-v2 -> v5 at P 128, cap 20,
and the chain v2 -> v4 at the smaller shapes of each case below.

Bit for bit: the chain's start states and obs, one ``make_train_chain``
step's states, obs and bases, its kernel seed (derived here from the key
as ngx's jitted step derives it), pool rows and epoch permutations, and
``refresh_pool``'s pool.  The parameters: the init's within the 3 ulp
spread of ``truncated_normal`` (``PERF.md``), after the update at
tests/test_torch_ppo.py's rtol 1e-5 / atol 1e-6.  ngx's 'pallas' step runs
its Pallas kernel in interpret mode, the port's the kernel's plain twin.

A policy's actions are ``categorical`` over its logits, which differ from
flax's by float rounding, so an action can flip where two Gumbel-perturbed
logits lie nearer than that: the first-mismatch rule (``PERF.md`` section
2) lets at most 1% of the envs differ, here at most 1 of 128.  On these
keys none does."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ngx
from ngx.core.state import zeros_state
from ngx.rl import curriculum as JC
from ngx.rl.models import ActorCritic as FlaxActorCritic
from ngx.transforms import lidar_in_front
from ngx.utils.checkpoint import restore_pytree
from ngx_torch.ops import threefry as TF
from ngx_torch.rl import curriculum as TC
from ngx_torch.rl import train as Tt
from ngx_torch.rl.models import ActorCritic
from ngx_torch.utils.checkpoint import restore_checkpoint

from test_torch_keyed_train import INIT_ULP, _metrics_match, _params_close
from test_torch_native_reset import _rows_differing

# one torch thread per test process: xdist runs several on the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CHAIN = ["NovelGridworld-v2", "NovelGridworld-v3", "NovelGridworld-v4",
         "NovelGridworld-v5"]
P, CAP = 128, 20
# the first-mismatch rule: at most 1% of the envs at a Gumbel near-tie
MAX_TIE_ENVS = P // 100
I32_MAX = 2 ** 31 - 1
STEPS = 3
CFG = dict(env_id=CHAIN[-1], num_envs=256, rollout_steps=8,
           num_minibatches=2, epochs=2, hidden=(16, 16), episode_cap=CAP)


def _flax_stage(obs_dim, n_actions, seed):
    """A flax-initialised stage policy (16, 16): ngx's params and the
    port's module holding the same weights."""
    params = jax.tree_util.tree_map(np.asarray, FlaxActorCritic(
        n_actions=n_actions, hidden=(16, 16)).init(
            jax.random.key(seed), jnp.zeros((1, obs_dim))))
    return params, ActorCritic(obs_dim, n_actions, (16, 16)).load_flax_params(
        params)


def _trained_chain():
    """The chain's stage agents and the v5 solver: ngx's checkpoints and the
    port's conversions of them."""
    names = [f"chain/{e}" for e in CHAIN[:-1]] + ["chain_solver_v5"]
    flax = [jax.tree_util.tree_map(np.asarray, restore_pytree(
        str(ROOT / "trained_agents" / n / "best"))["params"]) for n in names]
    port = [restore_checkpoint(str(ROOT / "trained_agents_torch" / n /
                                   "best.pt"))["params"] for n in names]
    return flax, port


@pytest.fixture(scope="module")
def ngx_init():
    """ngx's chain trainer's init on ``key(0)``, the same on both acting
    backends: its pool is ngx's ``chain(k_env)`` with ``k_env =
    split(key(0), 3)[0]`` (random stages), compiled once for the file."""
    cfg = JC.PPOConfig(**CFG, solve_shaped=True)
    init, _ = JC.make_train_chain(cfg, CHAIN, [None] * 3,
                                  rollout_backend="xla", pool_size=P)
    return init(jax.random.key(0))


@pytest.mark.parametrize("stages", ["random", "policy", "random-v2-v4"])
def test_keyed_chain_reset_matches_ngx(stages, ngx_init):
    """``make_chain_reset``: stage 0 ngx's native reset, random stages'
    ``randint`` actions (from ``split(key(0), 3)[0]``, against the pool of
    ngx's trainer init), and (``policy``, from ``key(5)``) a
    flax-initialised v3 policy's ``categorical`` ones: the start states and
    obs of v5 equal ngx's, rows differing within the first-mismatch rule
    (0 for random stages).  ``random-v2-v4``: the chain v2 -> v4 with two
    random stages at B 48 from ``key(3)``, bit for bit."""
    if stages == "random-v2-v4":
        B = 48
        chain_j, _ = JC.make_chain_reset(CHAIN[:3], [None, None], B, cap=CAP)
        want_state, want_obs = jax.jit(chain_j)(jax.random.key(3))
        chain_t, spec = TC.make_chain_reset(CHAIN[:3], [None, None], B,
                                            cap=CAP, device="cpu")
        got_state, got_obs = chain_t(TF.key(3))
        assert spec.env_id == CHAIN[2]
        n_bad, fields = _rows_differing(want_state, got_state)
        assert n_bad == 0, fields
        assert got_obs.dtype == torch.float32
        np.testing.assert_array_equal(got_obs.numpy(), np.asarray(want_obs))
        # the stages ran: most envs carry steps into the last stage
        assert float((got_state.step_count > 0).float().mean()) > 0.9
        return
    params_j, params_t = [None] * 3, [None] * 3
    key = jax.random.split(jax.random.key(0), 3)[0]
    if stages == "policy":
        sp = lidar_in_front(ngx.make_spec(CHAIN[1]))
        obs_dim = int(ngx.make_step(sp).get_obs(zeros_state(sp)).shape[-1])
        params_j[1], params_t[1] = _flax_stage(obs_dim, sp.n_actions, 2)
        key = jax.random.key(5)
        chain_j, _ = JC.make_chain_reset(CHAIN, params_j, P, cap=CAP,
                                         hidden=(16, 16))
        state_j, obs_j = jax.jit(chain_j)(key)
    else:
        state_j, obs_j = ngx_init[5], ngx_init[6]
    chain_t, spec = TC.make_chain_reset(CHAIN, params_t, P, cap=CAP,
                                        device="cpu")
    key_t = torch.as_tensor(np.array(jax.random.key_data(key)),
                            dtype=torch.int64)
    state_t, obs_t = chain_t(key_t)
    assert spec.env_id == CHAIN[-1]
    n_bad, fields = _rows_differing(state_j, state_t)
    obs_bad = int((np.asarray(obs_j) != obs_t.numpy()).any(1).sum())
    assert n_bad <= (0 if stages == "random" else MAX_TIE_ENVS), fields
    assert obs_bad <= n_bad
    # the stages ran: most envs carry steps into the last stage
    assert float((state_t.step_count > 0).float().mean()) > 0.9
    if stages == "policy":                   # an int is key(int)
        again, _ = chain_t(5)
        assert _rows_differing(state_t, again)[0] == 0


@pytest.mark.parametrize("case", ["trained", "init-v2-v4"])
def test_keyed_evaluate_chain_matches_ngx(case):
    """``evaluate_chain`` with the chain's trained stage agents and the v5
    solver, 128 episodes, cap 100, seed 3: ngx's dict.  ``init-v2-v4``: the
    chain v2 -> v4 with random stages and a flax-initialised (16, 16) final
    policy, 64 episodes, cap 24, seed 4: the fresh budget from the restore,
    the first-done bookkeeping and the goal-only solve, the rates exactly
    and the mean return within rtol 1e-6."""
    if case == "init-v2-v4":
        sp = lidar_in_front(ngx.make_spec(CHAIN[2]))
        params_j, params_t = _flax_stage(71, sp.n_actions, 1)
        want = JC.evaluate_chain(CHAIN[:3], [None, None], params_j,
                                 episodes=64, cap=24, hidden=(16, 16),
                                 seed=4)
        got = TC.evaluate_chain(CHAIN[:3], [None, None], params_t,
                                episodes=64, cap=24, seed=4, device="cpu")
        assert sorted(got) == sorted(want)
        assert got["solve_rate"] == want["solve_rate"]
        assert got["done_rate"] == want["done_rate"]
        np.testing.assert_allclose(got["mean_return"], want["mean_return"],
                                   rtol=1e-6)
        assert want["done_rate"] > 0.5
        return
    flax, port = _trained_chain()
    want = JC.evaluate_chain(CHAIN, flax[:-1], flax[-1], episodes=128,
                             cap=100, seed=3)
    got = TC.evaluate_chain(CHAIN, port[:-1], port[-1], episodes=128,
                            cap=100, seed=3, device="cpu")
    assert got == want
    assert want["solve_rate"] > 0.5


def _ngx_step_draws(cfg, key, backend, P=P):
    """The kernel seed, pool rows and permutations of ngx's chain step on
    ``key`` (``ngx/rl/curriculum.py:315-369``) over a pool of ``P`` rows,
    derived as its jitted step derives them."""
    B, T = cfg.num_envs, cfg.rollout_steps
    _, k_roll, k_upd = jax.random.split(key, 3)
    if backend == "pallas":
        k_seed, k_idx = jax.random.split(k_roll)
        seed = int(jax.random.randint(k_seed, (), 0, I32_MAX))
        rows = np.asarray(jax.random.randint(k_idx, (B, Tt.POOL_SLOTS), 0,
                                             P))
    else:
        seed = None
        rows = np.stack([np.asarray(jax.random.randint(
            jax.random.split(kt)[1], (B,), 0, P))
            for kt in jax.random.split(k_roll, T)])
    perms = [np.asarray(jax.random.permutation(k, B * T))
             for k in jax.random.split(k_upd, cfg.epochs)]
    return seed, rows, perms


def _short_chain_step(backend):
    """One step of the chain v2 -> v4 (B 128, T 8, P 32, one epoch) from
    ngx's init and the port's on ``key(0)``, each pool altered alike, the
    step on ``key(1)``; returns both carries, both metrics and the port's
    step.  On the kernel (cap 6) the pool's inventories are lifted by 300,
    so the restored obs hold values above 255; under 'xla' (cap 4 from a
    fresh restore puts restores at the last step) the pool rows get nonzero
    ``last_*`` fields, so a zeroing restore would show."""
    B, P_ = 128, 32
    cfg = dict(env_id=CHAIN[2], num_envs=B, rollout_steps=8,
               num_minibatches=2, epochs=1, hidden=(16, 16),
               episode_cap=6 if backend == "pallas" else 4, solve_shaped=True)
    init_j, step_j = JC.make_train_chain(JC.PPOConfig(**cfg), CHAIN[:3],
                                         [None, None],
                                         rollout_backend=backend,
                                         pool_size=P_)
    init_t, step_t = TC.make_train_chain(Tt.PPOConfig(**cfg), CHAIN[:3],
                                         [None, None],
                                         rollout_backend=backend,
                                         pool_size=P_, device="cpu")
    carry_j, carry_t = init_j(jax.random.key(0)), init_t(TF.key(0))
    for i in (1, 5):
        assert _rows_differing(carry_j[i], carry_t[i])[0] == 0
    _params_close(carry_t[0].model, carry_j[0].params, "init", INIT_ULP)
    # the rest of the step on the same weights, as the other cases' init
    carry_t[0].model.load_flax_params(
        jax.tree_util.tree_map(np.asarray, carry_j[0].params))
    pool_j, pool_t = carry_j[5], carry_t[5]
    if backend == "pallas":
        pool_j = pool_j.replace(inventory=pool_j.inventory + 300)
        pool_t = pool_t.replace(inventory=pool_t.inventory + 300)
    else:
        n = pool_t.batch
        fields = dict(last_action=np.arange(n, dtype=np.int32) % 4,
                      last_reward=np.arange(n, dtype=np.float32) * 0.5 + 1.0,
                      last_cost=-np.arange(n, dtype=np.float32) - 2.0)
        pool_j = pool_j.replace(**{k: jnp.asarray(v)
                                   for k, v in fields.items()})
        pool_t = pool_t.replace(**{k: torch.as_tensor(v)
                                   for k, v in fields.items()})
    carry_j = carry_j[:5] + (pool_j, carry_j[6])
    carry_t = carry_t[:5] + (pool_t, carry_t[6])
    carry_j, m_j = jax.jit(step_j)(carry_j, jax.random.key(1))
    carry_t, m_t = step_t(carry_t, TF.key(1))
    seed, rows, perms = _ngx_step_draws(JC.PPOConfig(**cfg),
                                        jax.random.key(1), backend, P_)
    assert step_t.seeds == (seed, None)
    np.testing.assert_array_equal(step_t.pool_rows.numpy(), rows)
    for got, want in zip(step_t.perms, perms):
        np.testing.assert_array_equal(got.numpy(), want)
    return carry_j, carry_t, m_j, m_t


@pytest.mark.parametrize("case", ["pallas", "xla", "pallas-v2-v4-inventory",
                                  "xla-v2-v4-last-fields"])
def test_keyed_train_chain_step_matches_ngx(case, ngx_init):
    """``make_train_chain``'s init on ``key(0)`` and three
    steps, step ``u`` on ``fold_in(key, u + 1)``, against ngx's (B 256, T
    8, hidden (16, 16), solve-shaped; 'pallas': ngx's kernel interpreted,
    the port's twin): the init's pool, rows, state, obs and bases, then
    each step's kernel seed, pool rows, permutations, state, obs and bases
    bit for bit; the
    parameters at init within 3 ulp and after the update within rtol
    1e-5 / atol 1e-6; the episode tallies exactly.  The ``-v2-v4`` cases
    take one step of the shorter chain (:func:`_short_chain_step`): the
    final state, obs and bases bit for bit — on the kernel with obs above
    255, under 'xla' with the restored ``last_*`` fields carried from the
    pool rows, not zeroed — the tallies exactly, the returns and losses
    within test_torch_ppo's tolerance."""
    backend = case.split("-")[0]
    if case != backend:
        carry_j, carry_t, m_j, m_t = _short_chain_step(backend)
        n_bad, fields = _rows_differing(carry_j[1], carry_t[1])
        assert n_bad == 0, f"{case}: {n_bad} envs differ in {fields}"
        for i in (2, 4):                         # last obs, base
            np.testing.assert_array_equal(carry_t[i].numpy(),
                                          np.asarray(carry_j[i]))
        np.testing.assert_allclose(carry_t[3].numpy(),
                                   np.asarray(carry_j[3]), rtol=1e-6)
        m_j = {k: float(v) for k, v in m_j.items()}
        m_t = {k: float(v) for k, v in m_t.items()}
        assert sorted(m_t) == sorted(m_j)
        for k in ("episodes", "ep_count", "ep_solved", "ep_len_sum"):
            assert m_t[k] == m_j[k], k
        for k in ("ep_return_sum", "mean_reward", "v_loss", "entropy"):
            np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(m_t["pg_loss"], m_j["pg_loss"], atol=1e-6)
        assert m_t["episodes"] >= 128
        if backend == "pallas":
            assert float(carry_t[2].max()) > 255      # obs exact above 255
            # the base carried, never reset to zero: bases come from rows
            assert bool((carry_t[4] > 0).any())
        else:
            # an env restored at the last step holds its pool row's
            # last_reward >= 1, where the kernel's restore writes 0
            assert bool((carry_t[1].last_reward >= 1.0).any())
        return
    cfg_j = JC.PPOConfig(**CFG, solve_shaped=True)
    cfg_t = Tt.PPOConfig(**CFG, solve_shaped=True)
    _, step_j = JC.make_train_chain(cfg_j, CHAIN, [None] * 3,
                                    rollout_backend=backend, pool_size=P)
    init_t, step_t = TC.make_train_chain(cfg_t, CHAIN, [None] * 3,
                                         rollout_backend=backend,
                                         pool_size=P, device="cpu")
    key = jax.random.key(0)
    carry_j = ngx_init
    carry_t = init_t(TF.key(0))
    for i, what in ((1, "state"), (5, "pool")):
        n_bad, fields = _rows_differing(carry_j[i], carry_t[i])
        assert n_bad == 0, f"init {what}: {n_bad} rows differ in {fields}"
    for i in (2, 4, 6):                      # obs, base, pool obs
        np.testing.assert_array_equal(carry_t[i].numpy(),
                                      np.asarray(carry_j[i]))
    _params_close(carry_t[0].model, carry_j[0].params, "init", INIT_ULP)

    run_j = jax.jit(step_j)
    episodes = 0
    for u in range(STEPS):
        k_u = jax.random.fold_in(key, u + 1)
        carry_j, m_j = run_j(carry_j, k_u)
        carry_t, m_t = step_t(carry_t, TF.fold_in(TF.key(0), u + 1))
        what = f"{backend} step {u}"
        seed, rows, perms = _ngx_step_draws(cfg_j, k_u, backend)
        assert step_t.seeds == (seed, None), what
        np.testing.assert_array_equal(step_t.pool_rows.numpy(), rows,
                                      err_msg=what)
        for got, want in zip(step_t.perms, perms):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
        n_bad, fields = _rows_differing(carry_j[1], carry_t[1])
        assert n_bad == 0, f"{what}: {n_bad} envs differ in {fields}"
        for i in (2, 4):                         # last obs, base
            np.testing.assert_array_equal(carry_t[i].numpy(),
                                          np.asarray(carry_j[i]),
                                          err_msg=what)
        np.testing.assert_allclose(carry_t[3].numpy(),
                                   np.asarray(carry_j[3]), rtol=1e-6)
        _params_close(carry_t[0].model, carry_j[0].params, what)
        _metrics_match(m_t, m_j, what)
        episodes += int(m_t["episodes"])
    # the cap (20 steps from each restore) ends every episode in step 3,
    # so every env restores from the pool at least once
    assert episodes >= cfg_t.num_envs


def test_keyed_refresh_pool_matches_ngx(ngx_init):
    """``refresh_pool(carry, key)`` on ngx's keys re-runs the chain on the
    key, as ngx's does (its ``refresh_pool`` is ``chain(key)`` swapped into
    the carry, ``ngx/rl/curriculum.py:425-430``): on ``k_env`` the new pool
    and its obs are those of ngx's trainer init, bit for bit, the rest of
    the carry untouched."""
    _, step_t = TC.make_train_chain(Tt.PPOConfig(**CFG), CHAIN, [None] * 3,
                                    rollout_backend="xla", pool_size=P,
                                    device="cpu")
    k_env = TF.split(TF.key(0), 3)[0]
    carry = (None,) * 5
    step_t.phases = {}
    got = step_t.refresh_pool(carry + (None, None), k_env)
    assert got[:5] == carry and list(step_t.phases) == ["refresh"]
    assert _rows_differing(ngx_init[5], got[5])[0] == 0
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(ngx_init[6]))


@pytest.mark.parametrize("rng", ["philox", "counter"])
def test_keyed_chain_refuses_an_unknown_rng(rng):
    """``make_train_chain`` keeps ``rng`` for callers that pass
    ``'threefry'``; any other value, the removed counter form included,
    raises."""
    cfg = Tt.PPOConfig(**CFG)
    with pytest.raises(ValueError, match="the counter form was removed"):
        TC.make_train_chain(cfg, CHAIN, [None] * 3, pool_size=8,
                            device="cpu", rng=rng)
