"""The port's scripted experts (ngx_torch/rl/experts.py) and
``evaluate_expert`` (ngx_torch/rl/evaluate.py) against ngx's on the CPU.

The experts are pure functions of the facade's host views, and the mirror
reset replays ngx's ``np.random`` draws, so on the same seeds the port's
expert must choose ngx's action at every step and ``evaluate_expert`` must
return ngx's dict exactly."""

import numpy as np
import pytest
import torch

import ngx.compat as C
from ngx.rl.evaluate import evaluate_expert as evaluate_expert_j
from ngx.rl.experts import EXPERTS as EXPERTS_J, get_expert as get_expert_j
import ngx_torch.compat as TC
from ngx_torch.rl.evaluate import evaluate_expert
from ngx_torch.rl.experts import EXPERTS, get_expert

torch.set_num_threads(1)

ENV_IDS = sorted(EXPERTS_J)


def expert_episodes(M, get, env_id, episodes, **kw):
    """Each episode's (action, reward, done) sequence under the expert,
    episode ``ep`` reset after ``np.random.seed(1000 + ep)``."""
    env = M.make(env_id, **kw)
    expert = get(env_id)
    out = []
    for ep in range(episodes):
        np.random.seed(1000 + ep)
        env.reset()
        seq = []
        for _ in range(100):
            a = expert(env)
            _, r, done, _ = env.step(a)
            seq.append((a, r, done))
            if done:
                break
        out.append(seq)
    return out


def test_experts_cover_ngx_envs():
    assert sorted(EXPERTS) == ENV_IDS
    with pytest.raises(KeyError, match="no scripted expert"):
        get_expert("NovelGridworld-v7")


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_expert_actions_match_ngx(env_id):
    got = expert_episodes(TC, get_expert, env_id, 4, device="cpu")
    want = expert_episodes(C, get_expert_j, env_id, 4)
    assert got == want
    assert all(type(a) is int for seq in got for a, _, _ in seq)


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_evaluate_expert_matches_ngx(env_id):
    got = evaluate_expert(env_id, episodes=8, seed=1, device="cpu")
    assert got == evaluate_expert_j(env_id, episodes=8, seed=1)
    assert got["solve_rate"] > 0
