"""The port's batched evaluation (ngx_torch/rl/evaluate.py), its vector
env's reset and rollout (ngx_torch/vector) and behaviour cloning
(ngx_torch/rl/bc.py) on the CPU: evaluation on a checkpoint, its options
and its device default, the counter-RNG vector env against its 'prng'
twin and against ngx until a first done, and a pretrain from injected
minibatch indices against ngx's.  Evaluation from ngx's keys against
ngx's is tests/test_torch_keyed_eval.py."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ngx
from ngx.rl import bc as JB
from ngx.rl.models import ActorCritic as FlaxActorCritic
from ngx.transforms import lidar_in_front
from ngx.vector import make_vec as make_vec_j
import ngx_torch as nt
from ngx_torch.core.state import EnvState
from ngx_torch.ops import threefry as TF
from ngx_torch.ops.rollout import rollout_plain
from ngx_torch.rl import bc as TB
from ngx_torch.rl import evaluate as TE
from ngx_torch.rl.models import ActorCritic
from ngx_torch.vector import Trajectory, make_vec

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
POGO = "NovelGridworld-Pogostick-v1"


def test_evaluate_checkpoint_reads_the_port_file():
    """evaluate_checkpoint on the converted Pogostick-v1 solver (hidden
    (256, 256) from the file's config): the trained agent solves, the
    random baseline does not; both on ngx's keys from ``key(0)``."""
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
    model = ActorCritic.from_key(TF.key(1), 71, spec.n_actions, (16, 16))
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
    # without injected indices it draws its own from key(0), and the loss
    # falls
    _, m2 = TB.pretrain_from_npz(
        ActorCritic.from_key(TF.key(0), obs.shape[1], 9, (16, 16)),
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
