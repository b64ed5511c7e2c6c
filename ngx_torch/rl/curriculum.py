"""Batched curriculum training — the port of ``ngx/rl/curriculum.py``: the
reference's restore-chaining sweep (``tests/train_last_agent.py:72-94``)
with every chain batched.

* :func:`make_state_adapter` (``:46``) — the restore deep-copy as a pure
  ``EnvState -> EnvState`` map between two specs, re-indexed by item and
  action NAME.
* :func:`make_chain_reset` (``:98``) — P chains in lockstep: stage 0 drawn
  by :func:`~ngx_torch.ops.rollout.pool_reset` (the rollout kernel at T 0 on
  the card), each earlier stage played by its frozen policy for up to
  ``cap`` steps with every env frozen at its first done, then adapted into
  the next stage.  The stage play is plain torch on the device, as ngx's is
  an XLA ``lax.scan`` (``:132-150``), run once per pool refresh.
* :func:`evaluate_chain` (``:160``) — the chain, then the final policy for
  a fresh ``cap``-step budget counted from the restore.
* :func:`make_train_chain` (``:227``) — PPO on the last stage, where every
  episode boundary restores a chain-terminal state drawn from a carried
  pool; the acting loop is the train kernel's pool mode
  (:func:`~ngx_torch.ops.train_rollout.train_rollout`, ngx's
  ``rollout_backend='pallas'``, ``:343-363``) with the cap counted from a
  carried ``base``, or, with ``rollout_backend='xla'``, the unfused loop
  of ngx's XLA path (``:315-341``): one uniform pool row per env a step.

Parity hazards with ``ngx``:

* RNG: the chain is not yet on ngx's draws (ROADMAP): ngx draws with
  ``jax.random`` keys (the stage-0 ``make_reset`` keys, ``randint``,
  ``categorical``, the pool rows).  Here stage 0 is the counter reset, a stage's actions are the counter RNG's
  (:func:`~ngx_torch.rl.evaluate.sample_actions`: Gumbel-argmax, salt 5,
  for a policy; uniform, salt 1, for None), and the pool rows come from a
  ``torch.Generator``.  Each entry point takes the draws as optional
  arguments, so that a test replays ngx's.
* A pool restore zeroes ``last_action``, ``last_reward`` and
  ``last_cost``, as the kernel's pool mode does (ngx's 'pallas' path);
  the 'xla' backend carries them, as ngx's XLA path does (``ADVICE.md:3``).
  None feeds obs, reward or done.
* Obs are float32 and inventories int32, so a chain-terminal inventory
  above 255 stays exact; ngx's ``spec_start_states=False`` (``:284-290``)
  exists for its bf16 obs only.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.state import EnvState
from ..core.step import make_step
from ..ops.rng import block_streams
from ..ops.rollout import pool_reset
from ..ops.tables import resolve_device
from ..ops.train_rollout import train_rollout
from ..presets import make_spec
from ..transforms import lidar_in_front
from .evaluate import as_policy, play_first_done, sample_actions
from .models import ActorCritic
from .train import (_SEED_HI, POOL_SLOTS, PPOConfig, PhaseTimer,
                    TrainState, acting_backend, make_learner,
                    pick_trainer_block, rollout_unfused)



def make_state_adapter(src_spec, dst_spec):
    """``adapt(state) -> state`` from ``src_spec`` into ``dst_spec``: the
    reference's restore deep-copy (``novel_gridworld_v2_env.py:77-97``).
    Map items are re-indexed by name (an item absent from ``dst_spec``
    becomes 0, air), the inventory is gathered by name (0 where ``src_spec``
    has no such item), the last action is re-indexed by name (0 where
    ``dst_spec`` has none); agent, facing, ``step_count`` and
    ``last_reward`` carry over; ``selected`` becomes -1, ``last_cost`` 0 and
    ``last_done`` False."""
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
    assert src_spec.map_size == dst_spec.map_size, \
        (src_spec.map_size, dst_spec.map_size)

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


def make_chain_reset(env_ids: Sequence[str], stage_params: Sequence,
                     batch: int, cap: int = 100, device="cuda"):
    """Build ``chain(seed, start=None, actions=None) -> (state[batch],
    obs[batch] float32)`` for the LAST env id, and return ``(chain,
    spec)`` with the last stage's LidarInFront spec.

    ``stage_params[k]`` drives stage k: an :class:`ActorCritic`, its state
    dict, or None for uniform random actions.  Each
    of the first n-1 stages plays up to ``cap`` steps from its start; each
    env freezes at its first done (its state stops changing), then the
    batch is adapted into the next stage.  ``seed`` seeds a
    ``torch.Generator`` that draws the stage-0 seed, then one action seed
    per stage.  ``start`` (a stage-0 :class:`EnvState`) and ``actions``
    (``int[n-1, cap, batch]``) replace the stage-0 draw and the stages'
    actions: hooks for a test that replays ngx's draws.  ``device``
    defaults to the card and raises where there is none."""
    device = resolve_device(device)
    specs = [lidar_in_front(make_spec(e)) for e in env_ids]
    assert len(stage_params) >= len(specs) - 1, \
        "need params (or None) for every stage except the last"
    steps = [make_step(sp, with_obs=False) for sp in specs]
    policies = [as_policy(p, device) for p in stage_params[:len(specs) - 1]]
    adapters = [make_state_adapter(specs[k], specs[k + 1])
                for k in range(len(specs) - 1)]

    def play(k, state, seed, acts):
        """Stage k from ``state``: up to ``cap`` steps, each env frozen at
        its first done."""
        step, policy, n_actions = steps[k], policies[k], specs[k].n_actions
        logits_fn = None if policy is None else (lambda o: policy(o)[0])
        seeds, rows = block_streams(seed, batch, batch, device)
        frozen = torch.zeros((batch,), dtype=torch.bool, device=device)
        for t in range(cap):
            if acts is not None:
                a = acts[t].to(device)
            else:
                obs = step.get_obs(state) if policy is not None else None
                a = sample_actions(logits_fn, obs, seeds, t + 1, rows,
                                   n_actions)
            new, _, _, done, _ = step(state, a)
            state = state.where(frozen, new)
            frozen = frozen | done
            if bool(frozen.all()):
                break            # every env is frozen: nothing changes
        return state

    def chain(seed: int, start: EnvState = None, actions=None):
        g = torch.Generator().manual_seed(int(seed))
        seed0 = int(torch.randint(0, _SEED_HI, (), generator=g))
        state = (pool_reset(specs[0], batch, seed0, device)
                 if start is None else start.to(device))
        for k in range(len(specs) - 1):
            stage_seed = int(torch.randint(0, _SEED_HI, (), generator=g))
            state = play(k, state, stage_seed,
                         None if actions is None else actions[k])
            state = adapters[k](state)
        return state, steps[-1].get_obs(state).to(torch.float32)

    return chain, specs[-1]


def evaluate_chain(env_ids: Sequence[str], stage_params: Sequence,
                   final_params, episodes: int = 128, cap: int = 100,
                   seed: int = 0, device="cuda", start=None,
                   stage_actions=None, actions=None):
    """Evaluate a chain-trained LAST-stage policy under the protocol it was
    trained for (the reference's, ``train_last_agent.py:95-117``): the
    chain (:func:`make_chain_reset`), then ``final_params`` (as a stage
    policy) for a fresh ``cap``-step budget counted from the restore:
    done is ``done | step_count - base >= cap`` with ``base`` the restored
    ``step_count``.  Solved is a goal termination (a terminal reward above
    ``reward_done / 2``) inside the budget; after an env's first done its
    state and obs are kept.  Returns ``mean_return``, ``solve_rate`` and
    ``done_rate`` (floats).  ``seed`` seeds a ``torch.Generator`` that
    draws the chain's seed, then the final stage's action seed;
    ``start``, ``stage_actions`` (the chain's ``actions``) and ``actions``
    (``int[cap, episodes]``) replace the draws, for a test."""
    device = resolve_device(device)
    chain, spec = make_chain_reset(env_ids, stage_params, episodes, cap,
                                   device)
    step = make_step(spec, with_obs=False)
    g = torch.Generator().manual_seed(int(seed))
    chain_seed = int(torch.randint(0, _SEED_HI, (), generator=g))
    act_seed = int(torch.randint(0, _SEED_HI, (), generator=g))
    state, obs = chain(chain_seed, start, stage_actions)
    model = as_policy(final_params, device)
    logits_fn = None if model is None else (lambda o: model(o)[0])
    seeds, rows = block_streams(act_seed, episodes, episodes, device)
    base = state.step_count

    def act(t, obs):
        return (actions[t].to(device) if actions is not None else
                sample_actions(logits_fn, obs, seeds, t + 1, rows,
                               spec.n_actions))

    def budget_step(state, a, t):
        new, _, r, done, _ = step(state, a)
        done = done | (new.step_count - base >= cap)
        return new, step.get_obs(new).to(torch.float32), r, done

    out = play_first_done(budget_step, act, state, obs, cap,
                          spec.reward_done, hold=True)
    del out["mean_length"]       # ngx's evaluate_chain reports none
    return out


def make_train_chain(cfg: PPOConfig, env_ids: Sequence[str],
                     stage_params: Sequence, rollout_backend: str = "auto",
                     bc_data=None, pool_size: int = None, device="cuda"):
    """``(init, train_step)`` for PPO on the LAST env of ``env_ids``, where
    every reset, initial and at episode boundaries, restores a fresh
    chain-terminal state (the reference's trained env resets through the
    restore branch, ``train_last_agent.py:77-87``).

    The chain (:func:`make_chain_reset`, ``cap = cfg.episode_cap``, the
    stage policies ``stage_params``) fills a pool of ``P = pool_size or
    min(B, 1024)`` rows.  ``init(seed)`` draws the B envs from the pool with
    replacement and sets each env's cap ``base`` to its ``step_count``.
    ``train_step(carry, seed)`` expands the pool to ``POOL_SLOTS`` = R
    independent row draws per env (env b's slot r at row ``b*R + r``, the
    kernel's layout), runs the acting kernel in pool mode from the carried
    ``base`` and carries its ``base_out``, then learns as
    :func:`~ngx_torch.rl.train.make_train` does (``solve_shaped``,
    ``bc_data``), counting episode lengths from ``step_count - base``.
    The carry is ``(ts, env_state, obs, ep_ret, base, pool, pool_obs)``,
    ngx's layout.  ``train_step.refresh_pool(carry, seed)`` re-runs the
    chain and replaces ``pool`` and ``pool_obs``; the caller paces it (the
    CLI once every ``-updates_per_launch`` updates).

    Seeds are Python ints, each seeding a ``torch.Generator``: ``init``'s
    draws the chain's seed, the rows, then the model's init;
    ``train_step``'s the rollout seed, the pool rows, then the minibatch
    permutations.  ``train_step``'s ``roll_seed``, ``pool_idx``
    (``int[B, R]``; ``int[T, B]`` under 'xla') and ``perms`` replace those
    draws, for a test, and under 'xla' ``gumbel`` (float32 ``[T, B, A]``)
    replaces the action draw's noise.  Setting ``train_step.phases`` to a
    dict times each step by phase (``refresh``, ``acting``, ``recompute``,
    ``gae``, ``update``; see :class:`~ngx_torch.rl.train.PhaseTimer`).

    ``rollout_backend``: ``'auto'`` and ``'pallas'`` run the CUDA kernel
    (its plain twin on the CPU); ``'xla'`` runs ngx's XLA path
    (``ngx/rl/curriculum.py:315-341``) unfused in torch: each step the
    model's logits, Gumbel-argmax on the kernel's counter RNG, the plain
    step, and at ``done | step_count - base >= cap`` the WHOLE pool row
    restored — ``last_action``, ``last_reward`` and ``last_cost`` carried,
    where the kernel zeroes them — from one uniform row draw per env and
    step, with its obs ``pool_obs[idx]`` and ``base`` its ``step_count``.
    ``train_step.rollout_backend`` names the backend taken."""
    backend = acting_backend(rollout_backend)
    B, T, R = cfg.num_envs, cfg.rollout_steps, POOL_SLOTS
    if B % 128 != 0:
        raise ValueError(f"per-device batch {B} is not a multiple of the "
                         "128-env block")
    P = pool_size or min(B, 1024)
    device = resolve_device(device)
    chain, spec = make_chain_reset(env_ids, stage_params, P,
                                   cap=cfg.episode_cap, device=device)
    step1 = make_step(spec, with_obs=False)
    get_obs = step1.get_obs
    block = pick_trainer_block(B)
    learn = make_learner(cfg, spec, bc_data=bc_data)

    def init(seed: int):
        g = torch.Generator().manual_seed(int(seed))
        chain_seed = int(torch.randint(0, _SEED_HI, (), generator=g))
        pool, pool_obs = chain(chain_seed)
        idx = torch.randint(0, P, (B,), generator=g).to(device)
        env_state, obs = pool.take(idx), pool_obs[idx]
        model = ActorCritic(obs.shape[1], spec.n_actions, cfg.hidden,
                            generator=g).to(device)
        opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, eps=1e-5)
        ep_ret = torch.zeros((B,), dtype=torch.float32, device=device)
        return (TrainState(model, opt), env_state, obs, ep_ret,
                env_state.step_count, pool, pool_obs)

    def train_step(carry, seed: int, *, roll_seed=None, pool_idx=None,
                   perms=None, gumbel=None):
        mark = PhaseTimer(train_step.phases, device)
        ts, env_state, obs, ep_ret, base, pool, pool_obs = carry
        g = torch.Generator().manual_seed(int(seed))
        drawn = int(torch.randint(0, _SEED_HI, (), generator=g))
        idx = torch.randint(0, P, (T, B) if backend == "xla" else (B, R),
                            generator=g)
        roll_seed = drawn if roll_seed is None else int(roll_seed)
        idx = torch.as_tensor(np.asarray(idx if pool_idx is None
                                         else pool_idx),
                              dtype=torch.int64).to(device)
        # steps already taken in each env's current episode, counted from
        # its restore — seeds the episode-length tally
        pre_count = env_state.step_count - base
        if backend == "xla":
            # ngx's XLA chain step (:315-341): idx[t] is the pool row each
            # env restores at step t, the whole row, its obs pool_obs[idx]
            bases = [base]

            def restore_step(st, a, t):
                ns, _, r, d, _ = step1(st, a)
                d = d | (ns.step_count - bases[0] >= cfg.episode_cap)
                fresh = pool.take(idx[t])
                o = torch.where(d[:, None], pool_obs[idx[t]],
                                get_obs(ns).to(torch.float32))
                bases[0] = torch.where(d, fresh.step_count, bases[0])
                return fresh.where(d, ns), o, r, d

            env_state, obs_t, action, reward, done, last_obs = \
                rollout_unfused(ts.model, restore_step, env_state, obs,
                                roll_seed, T, block, gumbel)
            base = bases[0]
            mark("acting")
        else:
            pool_r = pool.take(idx.reshape(-1))
            pi_layers = [(w.detach(), b.detach())
                         for w, b in ts.model.pi_layers()]
            env_state, obs_t, action, reward, done, base = train_rollout(
                spec, env_state, pi_layers, roll_seed, T, block=block,
                cap=cfg.episode_cap, pool=pool_r, base=base)
            mark("acting")
            last_obs = get_obs(env_state).to(torch.float32)
        run, metrics = learn(ts, (obs_t, action, reward, done), last_obs,
                             ep_ret, pre_count, mark, generator=g,
                             perms=perms)
        return (ts, env_state, last_obs, run, base, pool, pool_obs), metrics

    def refresh_pool(carry, seed: int):
        """Re-run the chain under ``seed`` and swap the carried pool."""
        mark = PhaseTimer(train_step.phases, device)
        pool, pool_obs = chain(seed)
        mark("refresh")
        return carry[:5] + (pool, pool_obs)

    train_step.refresh_pool = refresh_pool
    train_step.rollout_backend = backend
    train_step.phases = None
    return init, train_step
