"""The port's evaluation and behaviour cloning on ngx's keys against ngx
on the CPU, with nothing injected: ``make_eval``
(ngx_torch/rl/evaluate.py) from ngx's key gives ngx's four metrics,
``evaluate_checkpoint`` and ``evaluate_sb2_zip`` from ngx's seed give
ngx's reports, and ``pretrain(..., key=...)`` (ngx_torch/rl/bc.py) draws
ngx's minibatches.

A policy's actions are ``categorical`` over its logits, which differ from
flax's by float rounding, so an action could flip only where two
Gumbel-perturbed logits lie nearer than that (the policy rule of
PERF.md section 2); on these keys none does and the metrics are equal."""

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
from ngx.utils.checkpoint import restore_pytree
import ngx_torch as nt
from ngx_torch.ops import threefry as TF
from ngx_torch.rl import bc as TB
from ngx_torch.rl import evaluate as TE
from ngx_torch.rl.models import ActorCritic

from test_torch_drivers import write_sb2_zip

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
POGO = "NovelGridworld-Pogostick-v1"


# (policy, env id, the agent's directory under trained_agents and
# trained_agents_torch, cap): the chain's v3 agent, which solves v3; the
# random policy on v4, where it ends about half its episodes in 100 steps;
# the chain's v5 solver on v5's native resets, which it solves in 100
EVAL_CASES = {
    "random": ("random", "NovelGridworld-v3", None, 40),
    "trained": ("trained", "NovelGridworld-v3", "chain/NovelGridworld-v3", 40),
    "random-v4": ("random", "NovelGridworld-v4", None, 100),
    "trained-v5": ("trained", "NovelGridworld-v5", "chain_solver_v5", 100),
}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_keyed_make_eval_matches_ngx(case):
    """``make_eval`` from ngx's key: 64 episodes, the uniform-random policy
    and a trained agent on v3 at cap 40, the random policy on v4 and the
    v5 solver on v5 at cap 100: ngx's four metrics, exactly."""
    policy, env_id, agent, cap = EVAL_CASES[case]
    E = 64
    spec = ngx.make_spec(env_id)
    params = params_t = None
    if policy == "trained":
        params = jax.tree_util.tree_map(np.asarray, restore_pytree(str(
            ROOT / "trained_agents" / agent / "best"))["params"])
        w = params["params"]["pi_0"]["kernel"]
        params_t = ActorCritic(w.shape[0], spec.n_actions,
                               (w.shape[1],) * 2).load_flax_params(params)
    want = JE.make_eval(spec, cap=cap)(params, jax.random.key(2), E)
    run = TE.make_eval(nt.make_spec(env_id), cap=cap, device="cpu")
    assert run(params_t, TF.key(2), E) == want
    assert run(params_t, 2, E) == want            # an int is key(int)
    if policy == "trained":
        assert want["solve_rate"] > 0.5
    assert want["done_rate"] > 0


def test_keyed_evaluate_checkpoint_matches_ngx():
    """``evaluate_checkpoint`` on the converted
    Pogostick-v1 solver (hidden (256, 256)) against ngx's on its own
    checkpoint, 32 episodes, seed 3: the trained agent on ``key(3)``, the
    random baseline on ``fold_in(key(3), 1)`` — ngx's report."""
    want = JE.evaluate_checkpoint(
        POGO, str(ROOT / "trained_agents" / f"{POGO}_solver" / "best"),
        episodes=32, cap=100, seed=3)
    got = TE.evaluate_checkpoint(
        POGO, str(ROOT / "trained_agents_torch" / f"{POGO}_solver"
                  / "best.pt"), episodes=32, cap=100, seed=3, device="cpu")
    assert got == want
    assert want["trained"]["solve_rate"] >= 0.9


def test_keyed_evaluate_sb2_zip_matches_ngx(tmp_path):
    """``evaluate_sb2_zip`` on a test-built SB2 zip (v0's
    own 10-wide lidar obs) against ngx's from the same seed."""
    path = write_sb2_zip(str(tmp_path / "v0.zip"), 10, 3, seed=1)
    want = JE.evaluate_sb2_zip("NovelGridworld-v0", path, episodes=32,
                               cap=20, seed=5)
    got = TE.evaluate_sb2_zip("NovelGridworld-v0", path, episodes=32,
                              cap=20, seed=5, device="cpu")
    assert got == want


def test_keyed_bc_pretrain_matches_ngx():
    """``pretrain(key=...)`` from ngx's params and key, 3 steps of 64 rows:
    ngx's minibatch rows, so the weights (the policy head moves, the
    value head stays) and the metrics within 1e-6 of ngx's, as
    tests/test_torch_evaluate.py holds the injected form."""
    obs, actions = JB.load_demos(str(ROOT / "demos/NovelGridworld-v5.npz"))
    model = FlaxActorCritic(n_actions=9, hidden=(16, 16))
    params = model.init(jax.random.key(3), jnp.zeros((1, obs.shape[1])))
    steps, bs = 3, 64
    want, m_j = JB.pretrain(model, params, obs, actions,
                            key=jax.random.key(4), steps=steps,
                            batch_size=bs)
    m = ActorCritic(obs.shape[1], 9, (16, 16)).load_flax_params(
        jax.tree_util.tree_map(np.asarray, params))
    v0 = m.v_out.weight.detach().clone()
    got, m_t = TB.pretrain(m, obs, actions, steps=steps, batch_size=bs,
                           key=TF.key(4))
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


@pytest.mark.parametrize("entry, rng", [
    ("make_eval", "philox"), ("make_eval", "counter"),
    ("make_train", "philox"), ("make_train", "counter")])
def test_keyed_eval_refuses_an_unknown_rng(entry, rng):
    """``make_eval`` and ``make_train`` keep ``rng`` for callers that pass
    ``'threefry'``; any other value, the removed counter form included,
    raises."""
    from ngx_torch.rl.train import PPOConfig, make_train

    build = {"make_eval": lambda: TE.make_eval(nt.make_spec(POGO),
                                               device="cpu", rng=rng),
             "make_train": lambda: make_train(PPOConfig(num_envs=128),
                                              device="cpu", rng=rng)}[entry]
    with pytest.raises(ValueError, match="the counter form was removed"):
        build()
    assert callable(TE.make_eval(nt.make_spec(POGO), device="cpu",
                                 rng="threefry"))
