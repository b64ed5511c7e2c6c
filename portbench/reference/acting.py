"""The acting rollout in plain torch: the trainer's LidarInFront obs, tanh
MLP actor, Gumbel-argmax on the counter RNG, the env step, the episode cap
and the boundary's fresh state (a counter reset, or the next slot of the
env's pool).

Frozen from the port's ``ops/train_rollout.py`` (``mlp_logits``,
``gumbel_scores``, ``restore`` and the loop of ``train_rollout_plain``),
with one change: :func:`act` can take the actions it is handed (the
program's) in place of its own draw, and then reports how far each handed
action's Gumbel score lies below the best score, instead of choosing."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .frozen.core.reset import ResetTables, reset_rows
from .frozen.core.state import EnvState
from .frozen.core.step import make_step
from .frozen.ops.rng import _u01, block_streams

SALT_ACTION = 5


def mlp_logits(x, pi_layers):
    """The policy tower's logits (tanh hidden layers)."""
    for w, b in pi_layers[:-1]:
        x = torch.tanh(F.linear(x, w, b))
    return F.linear(x, *pi_layers[-1])


def gumbel_scores(logits, seeds, ctr, rows):
    """``logits - log(-log(u + 1e-10) + 1e-10)`` in float32, ``u`` the
    counter-RNG uniforms of ``(seed, ctr, salt 5, row, action)``."""
    cols = torch.arange(logits.shape[-1], dtype=torch.int64,
                        device=logits.device)
    u = _u01(seeds, ctr, SALT_ACTION, rows, cols)
    return logits - torch.log(-torch.log(u + 1e-10) + 1e-10)


def restore(pool: EnvState, slot) -> EnvState:
    """Pool rows ``slot`` as fresh states: map, inventory, agent, facing and
    step_count from the pool; selected -1, the last action, reward, cost
    and done cleared."""
    n = slot.shape[0]
    zi = torch.zeros((n,), dtype=torch.int32, device=slot.device)
    zf = torch.zeros((n,), dtype=torch.float32, device=slot.device)
    return EnvState(
        map=pool.map[slot], agent=pool.agent[slot], facing=pool.facing[slot],
        inventory=pool.inventory[slot], selected=zi - 1,
        step_count=pool.step_count[slot], last_action=zi, last_reward=zf,
        last_cost=zf.clone(), last_done=torch.zeros_like(zi, dtype=torch.bool))


@torch.no_grad()
def act(spec, state: EnvState, pi_layers, seed: int, steps: int, block: int,
        cap: int, pool: EnvState = None, base=None, given=None):
    """``steps`` acting steps from ``state``.

    Without ``given``: the reference's own rollout, ``(state, obs_t,
    action, reward, done, base, gap=0)``.  With ``given`` (a program's
    ``(obs_t, action, reward, done)``): the env is stepped with the given
    actions and the result counts, beside the same tuple, how many obs
    rows, rewards and dones of the given trajectory differ from the
    reference's (``mismatch``), and ``gap``, the widest distance by which
    a given action's Gumbel score lies below the reference's best score
    of that step."""
    step = make_step(spec, with_obs=False)
    B, dev = state.batch, state.device
    seeds, rows = block_streams(seed, B, block, dev)
    if pool is not None:
        R = pool.batch // B
        base = (torch.zeros((B,), dtype=torch.int32, device=dev)
                if base is None else base.to(torch.int32).clone())
        n_done = torch.zeros((B,), dtype=torch.int64, device=dev)
    else:
        tab = ResetTables(spec)
        base = torch.zeros((B,), dtype=torch.int32, device=dev)
    obs = step.get_obs(state)
    obs_t = torch.empty((steps, B, obs.shape[1]), dtype=torch.float32,
                        device=dev)
    act_t = torch.empty((steps, B), dtype=torch.int32, device=dev)
    rew = torch.empty((steps, B), dtype=torch.float32, device=dev)
    done = torch.empty((steps, B), dtype=torch.bool, device=dev)
    gap = torch.zeros((), dtype=torch.float32, device=dev)
    mismatch = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(steps):
        ctr = t + 1
        obs_t[t] = obs.to(torch.float32)
        scores = gumbel_scores(mlp_logits(obs_t[t], pi_layers), seeds, ctr,
                               rows)
        if given is None:
            a = torch.argmax(scores, dim=1)
        else:
            mismatch += (given[0][t] != obs_t[t]).any(-1).sum()
            a = given[1][t].long()
            chosen = scores.gather(1, a[:, None])[:, 0]
            gap = torch.maximum(gap, (scores.max(1).values - chosen).max())
        state, _, r, d, _ = step(state, a)
        d = d | (state.step_count - base >= cap)
        if given is not None:
            mismatch += (given[2][t] != r).sum() + (given[3][t] != d).sum()
        idx = d.nonzero()[:, 0]
        if idx.numel():
            if pool is None:
                fresh = reset_rows(tab, seeds[idx], ctr, rows[idx])
            else:
                n_done[idx] += 1
                slot = idx * R + (n_done[idx] - 1) % R
                fresh = restore(pool, slot)
                base[idx] = fresh.step_count
            state = state.put(idx, fresh)
        obs = step.get_obs(state)
        act_t[t], rew[t], done[t] = a.to(torch.int32), r, d
    out = dict(state=state, obs_t=obs_t, action=act_t, reward=rew,
               done=done, base=base, gap=gap)
    if given is not None:
        out["mismatch"] = mismatch
    return out
