"""Batched policy evaluation in plain torch, on ngx's keys: ``episodes``
episodes of at most ``cap`` steps with first-done bookkeeping, a done env
auto-reset from the native reset on its key.

Frozen from the port's ``rl/evaluate.py`` (the keyed path of
``make_eval`` and ``play_first_done``)."""

from __future__ import annotations

import torch

from .frozen.ops import threefry as TF
from .frozen.vector import KeyedVecEnv


def play_first_done(step, act, state, obs, cap: int, reward_done: float):
    n, device = obs.shape[0], obs.device
    ret = torch.zeros((n,), dtype=torch.float32, device=device)
    length = torch.zeros((n,), dtype=torch.int32, device=device)
    done_ever = torch.zeros((n,), dtype=torch.bool, device=device)
    solved = torch.zeros_like(done_ever)
    for t in range(cap):
        new, new_obs, r, done = step(state, act(t, obs), t)
        active = ~done_ever
        ret = ret + torch.where(active, r, 0.0)
        length = length + active.to(torch.int32)
        solved = solved | (active & done & (r > 0.5 * reward_done))
        done_ever = done_ever | done
        state, obs = new, new_obs
        if bool(done_ever.all()):
            break
    return {"mean_return": float(ret.mean()),
            "solve_rate": float(solved.to(torch.float32).mean()),
            "done_rate": float(done_ever.to(torch.float32).mean()),
            "mean_length": float(length.to(torch.float32).mean())}


def make_eval(spec, cap: int, device):
    """``run(model, key, episodes) -> metrics``: ``k0, k1 = split(key)``,
    the start states the native reset over ``split(k0, episodes)``, and at
    step ``t`` of ``split(k1, cap)`` split in two, ``categorical`` of the
    model's logits on the first key and the done rows' resets on
    ``split(second key, episodes)``.  ``logits``, a list, collects each
    step's logits."""
    vec = KeyedVecEnv(spec)

    def run(model, key, episodes: int, logits=None):
        k0, k1 = TF.split(TF.as_key(key, device))
        state, obs = vec.reset(TF.split(k0, episodes))
        keys = TF.split(TF.split(k1, cap), 2)

        def act(t, obs):
            with torch.no_grad():
                out = model(obs.to(torch.float32))[0]
            if logits is not None:
                logits.append(out)
            return TF.categorical(keys[t, 0], out)

        def step(state, a, t):
            state, obs, r, done, _ = vec.step_rows(
                state, a, lambda idx: TF.split_at(keys[t, 1], idx))
            return state, obs, r, done

        return play_first_done(step, act, state, obs, cap, spec.reward_done)

    return run
