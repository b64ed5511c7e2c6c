"""The port's batched evaluation (ngx_torch/rl/evaluate.py), its vector
env's reset and rollout (ngx_torch/vector) and behaviour cloning
(ngx_torch/rl/bc.py) against ngx on the CPU.

Evaluation is not yet on ngx's draws (ngx_torch.ops.threefry reproduces
them; ROADMAP): each test replays ngx's key schedule here and injects the start states, actions and minibatch
indices it yields into the port."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ngx
from ngx.rl import bc as JB
from ngx.rl import evaluate as JE
from ngx.rl.models import ActorCritic as FlaxActorCritic
from ngx.transforms import lidar_in_front
from ngx.utils.checkpoint import restore_pytree
from ngx.vector import make_vec as make_vec_j
import ngx_torch as nt
from ngx_torch.core.state import EnvState
from ngx_torch.ops.rollout import rollout_plain
from ngx_torch.rl import bc as TB
from ngx_torch.rl import evaluate as TE
from ngx_torch.rl.models import ActorCritic
from ngx_torch.vector import Trajectory, make_vec

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
POGO = "NovelGridworld-Pogostick-v1"


def _ngx_eval_draws(spec, params, model, episodes, cap, key):
    """ngx's make_eval draws (evaluate.py:55-84): the reset states and the
    action of every step, replayed from its key schedule."""
    spec = lidar_in_front(spec)
    vec = make_vec_j(spec)
    k0, k1 = jax.random.split(key)
    state0, obs0 = jax.jit(vec.reset)(jax.random.split(k0, episodes))
    if params is None:          # uniform actions: no state needed
        acts = jax.jit(jax.vmap(lambda kt: jax.random.randint(
            jax.random.split(kt)[0], (episodes,), 0, spec.n_actions)))(
                jax.random.split(k1, cap))
        return state0, np.asarray(acts)

    @jax.jit
    def body(carry, key_t):
        state, obs = carry
        k_act, k_reset = jax.random.split(key_t)
        logits, _ = model.apply(params, obs.astype(jnp.float32))
        a = jax.random.categorical(k_act, logits)
        state, obs, _, _, _ = vec.step(state, a,
                                       jax.random.split(k_reset, episodes))
        return (state, obs), a

    _, acts = jax.lax.scan(body, (state0, obs0), jax.random.split(k1, cap))
    return state0, np.asarray(acts)


@pytest.mark.parametrize("policy", ["random", "trained"])
def test_make_eval_matches_ngx(policy):
    """make_eval's metrics equal ngx's on ngx's start states and actions:
    first-done bookkeeping (return, length, solve only until an episode's
    first done), the goal-only solve and the cap as the loop length.  The
    trained policy is the chain's v3 agent, which solves v3."""
    env_id, E, cap, seed = "NovelGridworld-v3", 64, 40, 2
    spec = ngx.make_spec(env_id)
    model = FlaxActorCritic(n_actions=spec.n_actions, hidden=(64, 64))
    params = None
    if policy == "trained":
        params = jax.tree_util.tree_map(np.asarray, restore_pytree(str(
            ROOT / "trained_agents/chain" / env_id / "best"))["params"])
    key = jax.random.key(seed)
    want = JE.make_eval(spec, cap=cap)(params, key, E)
    state0, acts = _ngx_eval_draws(spec, params, model, E, cap, key)
    got = TE.make_eval(nt.make_spec(env_id), cap=cap, device="cpu")(
        None if params is None else
        ActorCritic(71, spec.n_actions).load_flax_params(params),
        0, E, start=EnvState.from_ngx(state0),
        actions=torch.as_tensor(acts))
    assert sorted(got) == sorted(want)
    for k in ("solve_rate", "done_rate", "mean_length"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["mean_return"], want["mean_return"],
                               rtol=1e-6)
    if policy == "trained":
        assert want["solve_rate"] > 0.5
    assert want["done_rate"] > 0


def test_evaluate_checkpoint_reads_the_port_file():
    """evaluate_checkpoint on the converted Pogostick-v1 solver (hidden
    (256, 256) from the file's config): the trained agent solves, the
    random baseline does not; both on the port's own counter-RNG draws."""
    out = TE.evaluate_checkpoint(
        POGO, str(ROOT / "trained_agents_torch"
                  / "NovelGridworld-Pogostick-v1_solver" / "best.pt"),
        episodes=32, cap=100, seed=0, device="cpu")
    assert sorted(out) == ["random", "trained"]
    assert out["trained"]["solve_rate"] >= 0.9, out
    assert 20 < out["trained"]["mean_length"] < 60, out
    assert out["random"]["solve_rate"] == 0.0 and \
        out["random"]["mean_return"] < 0, out
    state_dict = torch.load(ROOT / "trained_agents_torch"
                            / "NovelGridworld-Pogostick-v1_solver"
                            / "best.pt", weights_only=True)["params"]
    again = TE.make_eval(nt.make_spec(POGO), device="cpu")(state_dict, 0,
                                                           32)
    assert again == out["trained"]


def test_make_eval_apply_logits_and_wrap_lidar():
    """apply_logits swaps in another forward pass (the same module through
    it gives the same metrics), and wrap_lidar=False evaluates on the
    spec's own observation (NovelGridworld-v1's legacy lidar)."""
    spec = nt.make_spec("NovelGridworld-v4")
    model = ActorCritic(71, spec.n_actions, (16, 16),
                        generator=torch.Generator().manual_seed(1))
    want = TE.make_eval(spec, cap=30, device="cpu")(model, 3, 32)
    got = TE.make_eval(spec, cap=30, device="cpu",
                       apply_logits=lambda p, o: p(o)[0])(model, 3, 32)
    assert got == want
    v1 = nt.make_spec("NovelGridworld-v1")
    obs_dim = int(make_vec(v1).reset(0, 1, device="cpu")[1].shape[1])
    assert obs_dim != int(make_vec(nt.lidar_in_front(v1)).reset(
        0, 1, device="cpu")[1].shape[1])
    legacy = ActorCritic(obs_dim, v1.n_actions, (16, 16))
    out = TE.make_eval(v1, cap=20, wrap_lidar=False,
                       device="cpu")(legacy.state_dict(), 0, 16)
    assert 0 <= out["done_rate"] <= 1 and out["mean_length"] > 0


@pytest.mark.parametrize("env_id", ["NovelGridworld-v2", "NovelGridworld-v3",
                                    POGO])
def test_vec_reset_and_rollout_are_the_prng_twin(env_id):
    """VecEnv.reset is the counter reset, and VecEnv.rollout with uniform
    actions from it is the 'prng' rollout twin (the kernel's semantics):
    the same final state, the same reward sums (added step by step) and
    done counts, in RNG blocks of 32; Pogostick-v1's dict observation is
    stacked leaf by leaf."""
    spec = nt.make_spec(env_id)
    B, T, block, seed = 96, 40, 32, 123
    vec = make_vec(spec)
    state, obs = vec.reset(seed, B, block, device="cpu")
    want_obs = vec.get_obs(state)
    if isinstance(obs, dict):
        assert all(torch.equal(obs[k], v) for k, v in want_obs.items())
    else:
        assert torch.equal(obs, want_obs)
    want0 = rollout_plain(spec, B, 0, seed, block,
                          device=torch.device("cpu"))[0]
    for k, v in want0.__dict__.items():
        assert torch.equal(getattr(state, k), v), k
    final, traj = vec.rollout(state, seed, None, T, block)
    want, rsum, dcount = rollout_plain(spec, B, T, seed, block,
                                       device=torch.device("cpu"))
    for k, v in want.__dict__.items():
        assert torch.equal(getattr(final, k), v), k
    acc = torch.zeros(B)
    for t in range(T):
        acc = acc + traj.rewards[t]
    assert torch.equal(acc, rsum)
    assert torch.equal(traj.dones.sum(0).to(torch.int32), dcount)
    assert isinstance(traj, Trajectory) and traj.actions.shape == (T, B)
    assert traj.step_costs.shape == (T, B)
    if env_id == POGO:
        assert traj.obs["map"].shape == (T, B, 10, 10)
    else:
        assert traj.obs.shape[:2] == (T, B)
        assert int(dcount.sum()) > 0       # the resets were exercised


def test_vec_rollout_matches_ngx_until_the_first_done():
    """VecEnv.rollout against ngx's from the same states under the same
    policy of the state: each env's trajectory (obs, action, reward, done,
    step cost) equal up to and including its first done (after it, the two
    packages' fresh resets differ by design)."""
    env_id, B, T = "NovelGridworld-v5", 32, 30
    spj, spt = lidar_in_front(ngx.make_spec(env_id)), \
        nt.lidar_in_front(nt.make_spec(env_id))
    vec_j = make_vec_j(spj, episode_cap=25)
    state_j, _ = jax.jit(vec_j.reset)(jax.random.split(jax.random.key(1), B))
    A = spj.n_actions

    def act_j(_, st):
        return (st.step_count * 7 + st.agent[:, 0] * 3 + st.facing) % A

    _, want = jax.jit(lambda s, k: vec_j.rollout(s, k, act_j, T))(
        state_j, jax.random.key(2))
    vec_t = make_vec(spt, episode_cap=25)
    _, got = vec_t.rollout(
        EnvState.from_ngx(state_j), 9,
        lambda ctr, st: (st.step_count * 7 + st.agent[:, 0] * 3
                         + st.facing) % A, T)
    dones = np.asarray(want.dones)
    first = np.where(dones.any(0), dones.argmax(0), T - 1)
    upto = np.arange(T)[:, None] <= first[None, :]
    for name in Trajectory._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        mask = upto.reshape(upto.shape + (1,) * (w.ndim - 2))
        assert np.array_equal(np.where(mask, w, 0), np.where(mask, g, 0)), \
            name
    assert dones.any(0).sum() > B // 2


def test_bc_pretrain_matches_ngx():
    """Two pretrain steps from the same params and minibatch indices: the
    weights (the policy head moves, the value head stays) and the metrics
    within 1e-6 of ngx's; Adam at torch's defaults is optax.adam's."""
    obs, actions = JB.load_demos(str(ROOT / "demos/NovelGridworld-v5.npz"))
    o_t, a_t = TB.load_demos(str(ROOT / "demos/NovelGridworld-v5.npz"))
    assert np.array_equal(obs, o_t) and np.array_equal(actions, a_t)
    model = FlaxActorCritic(n_actions=9, hidden=(16, 16))
    params = model.init(jax.random.key(3), jnp.zeros((1, obs.shape[1])))
    key, steps, bs = jax.random.key(4), 2, 64
    want, m_j = JB.pretrain(model, params, obs, actions, key=key,
                            steps=steps, batch_size=bs)
    idx = np.stack([np.asarray(jax.random.randint(k, (bs,), 0, len(obs)))
                    for k in jax.random.split(key, steps)])
    m = ActorCritic(obs.shape[1], 9, (16, 16)).load_flax_params(
        jax.tree_util.tree_map(np.asarray, params))
    v0 = m.v_out.weight.detach().clone()
    got, m_t = TB.pretrain(m, obs, actions, steps=steps, batch_size=bs,
                           idx=idx)
    pw = want["params"]
    for name, lin in got.named_children():
        np.testing.assert_allclose(lin.weight.detach().numpy().T,
                                   np.asarray(pw[name]["kernel"]), rtol=0,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(lin.bias.detach().numpy(),
                                   np.asarray(pw[name]["bias"]), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert torch.equal(got.v_out.weight, v0)
    assert sorted(m_t) == sorted(m_j)
    for k in m_j:
        np.testing.assert_allclose(m_t[k], m_j[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    # without injected indices it draws its own, and the loss falls
    _, m2 = TB.pretrain_from_npz(
        ActorCritic(obs.shape[1], 9, (16, 16),
                    generator=torch.Generator().manual_seed(0)),
        str(ROOT / "demos/NovelGridworld-v5.npz"), steps=30)
    assert m2["last_loss"] < m2["first_loss"]


def test_entry_points_default_to_the_card():
    """Without a device every new entry point runs on the card; where there
    is none it raises, and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")
    from ngx_torch.rl import curriculum as TC
    from ngx_torch.rl.train import PPOConfig

    spec = nt.make_spec(POGO)
    chain = ["NovelGridworld-v2", "NovelGridworld-v3"]
    for call in (lambda: TE.make_eval(spec),
                 lambda: make_vec(spec).reset(0, 8),
                 lambda: TC.make_chain_reset(chain, [None], 8),
                 lambda: TC.evaluate_chain(chain, [None], None, 8),
                 lambda: TC.make_train_chain(
                     PPOConfig(num_envs=128), chain, [None])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
