"""The curriculum chain's stage play in plain torch, on ngx's keys: stage 0
drawn by the native reset, each earlier stage played by its frozen policy
(or uniform actions) for up to ``cap`` steps with every env frozen at its
first done, then adapted into the next stage by item and action name.

Frozen from the port's ``rl/curriculum.py`` (``make_state_adapter`` and
the keyed path of ``make_chain_reset``) and ``rl/evaluate.py``
(``as_policy``)."""

from __future__ import annotations

import re

import numpy as np
import torch

from .frozen.core.reset import make_reset
from .frozen.core.state import EnvState
from .frozen.core.step import make_step
from .frozen.ops import threefry as TF
from .frozen.presets import make_spec
from .frozen.rl.models import ActorCritic
from .frozen.transforms import lidar_in_front


def as_policy(params, device):
    """A state dict as an :class:`ActorCritic` on ``device`` (widths read
    from the weights); None stays None."""
    if params is None:
        return None
    n_hidden = sum(1 for k in params if re.fullmatch(r"pi_\d+\.weight", k))
    model = ActorCritic(
        params["pi_0.weight"].shape[1], params["pi_out.weight"].shape[0],
        [params[f"pi_{i}.weight"].shape[0] for i in range(n_hidden)])
    model.load_state_dict(params)
    return model.to(device)


def make_state_adapter(src_spec, dst_spec):
    map_remap = np.zeros((src_spec.n_items,), np.int64)
    for i, n in enumerate(src_spec.items):
        map_remap[i] = dst_spec.items.index(n) if n in dst_spec.items else 0
    inv_gather = np.full((dst_spec.n_items,), -1, np.int64)
    for j, n in enumerate(dst_spec.items):
        if n in src_spec.items:
            inv_gather[j] = src_spec.items.index(n)
    act_remap = np.zeros((src_spec.n_actions,), np.int64)
    for i, n in enumerate(src_spec.actions):
        act_remap[i] = (dst_spec.actions.index(n)
                        if n in dst_spec.actions else 0)

    def adapt(st: EnvState) -> EnvState:
        dev = st.device
        gather = torch.as_tensor(inv_gather, device=dev)
        inv = torch.where(gather >= 0, st.inventory[:, gather.clamp(min=0)],
                          0)
        zeros = torch.zeros_like(st.step_count)
        return EnvState(
            map=torch.as_tensor(map_remap, device=dev)[st.map.long()].to(
                torch.int32),
            agent=st.agent, facing=st.facing, inventory=inv.to(torch.int32),
            selected=zeros - 1, step_count=st.step_count,
            last_action=torch.as_tensor(act_remap, device=dev)[
                st.last_action.long()].to(torch.int32),
            last_reward=st.last_reward,
            last_cost=torch.zeros_like(st.last_reward),
            last_done=torch.zeros_like(st.last_done))

    return adapt


def make_chain(env_ids, stage_params, batch: int, cap: int, device):
    """``(chain, spec)``: ``chain(key) -> (state, obs float32)`` of the last
    stage, ``spec`` its LidarInFront spec.  ``k0, key = split(key)``;
    stage 0 is the native reset over ``split(k0, batch)``; each played
    stage takes ``key, k_roll = split(key)`` and at step ``t`` key ``t``
    of ``split(k_roll, cap)``: ``randint`` for a None stage,
    ``categorical`` of the policy's logits otherwise."""
    specs = [lidar_in_front(make_spec(e)) for e in env_ids]
    steps = [make_step(sp, with_obs=False) for sp in specs]
    policies = [as_policy(p, device) for p in stage_params[:len(specs) - 1]]
    adapters = [make_state_adapter(specs[k], specs[k + 1])
                for k in range(len(specs) - 1)]
    reset0 = make_reset(specs[0], device)

    def play(k, state, draw):
        frozen = torch.zeros((batch,), dtype=torch.bool, device=device)
        for t in range(cap):
            new, _, _, done, _ = steps[k](state, draw(t, state))
            state = state.where(frozen, new)
            frozen = frozen | done
            if bool(frozen.all()):
                break
        return state

    def keyed_draw(k, k_roll):
        policy, n_actions = policies[k], specs[k].n_actions
        keys = TF.split(k_roll, cap)

        def draw(t, state):
            if policy is None:
                return TF.randint(keys[t], (batch,), 0, n_actions)
            with torch.no_grad():
                logits = policy(steps[k].get_obs(state).to(torch.float32))[0]
            return TF.categorical(keys[t], logits)
        return draw

    def chain(key):
        k0, key = TF.split(TF.as_key(key, device))
        state, _ = reset0(TF.split(k0, batch))
        for k in range(len(specs) - 1):
            key, k_roll = TF.split(key)
            state = adapters[k](play(k, state, keyed_draw(k, k_roll)))
        return state, steps[-1].get_obs(state).to(torch.float32)

    return chain, specs[-1]
