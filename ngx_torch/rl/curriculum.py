"""Batched curriculum training — the port of ``ngx/rl/curriculum.py``: the
reference's restore-chaining sweep (``tests/train_last_agent.py:72-94``)
with every chain batched.

* :func:`make_state_adapter` (``:46``) — the restore deep-copy as a pure
  ``EnvState -> EnvState`` map between two specs, re-indexed by item and
  action NAME.
* :func:`make_chain_reset` (``:98``) — P chains in lockstep: stage 0
  drawn (ngx's native reset on ngx's keys), each earlier stage played by
  its frozen policy for up to
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

* RNG: every entry point draws as ngx does from ngx's ``jax.random`` keys
  (:mod:`ngx_torch.ops.threefry`): the stage-0 ``make_reset`` keys,
  ``randint`` and ``categorical`` actions, the pool rows, the kernel's seed
  and the epochs' permutations, so the states are ngx's bit for bit and a
  policy's actions up to Gumbel near-ties (its logits round otherwise than
  flax's).
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

from ..core.reset import make_reset
from ..core.state import EnvState
from ..core.step import make_step
from ..ops import threefry as TF
from ..ops import categorical as CK
from ..ops.tables import resolve_device
from ..ops.train_rollout import train_rollout
from ..presets import make_spec
from ..transforms import lidar_in_front
from ..utils import trace
from .evaluate import as_policy, play_first_done
from .models import ActorCritic
from .train import (POOL_SLOTS, PPOConfig, TrainState, acting_backend,
                    draw_seed, epoch_perms, keys_only, make_learner,
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
    """Build the chained reset for the LAST env id and return ``(chain,
    spec)`` with the last stage's LidarInFront spec; ``chain(key)`` gives
    ``(state[batch], obs[batch] float32)``.

    ``stage_params[k]`` drives stage k: an :class:`ActorCritic`, its state
    dict, or None for uniform random actions.  Each
    of the first n-1 stages plays up to ``cap`` steps from its start; each
    env freezes at its first done (its state stops changing), then the
    batch is adapted into the next stage.  ``device`` defaults to the card
    and raises where there is none.

    ``chain(key)`` draws as ngx's (``ngx/rl/curriculum.py:119-157``) from
    ngx's key (a key tensor, or an int for ``key(int)``): ``k0, key =
    split(key)``; stage 0 is ngx's native reset over ``split(k0, batch)``;
    each played stage takes ``key, k_roll = split(key)`` and at step ``t``
    key ``t`` of ``split(k_roll, cap)``: ``randint(k_t, (batch,), 0, A)``
    for a None stage, ``categorical(k_t, logits)`` for a policy (one launch
    of the categorical kernel on the card, :mod:`ngx_torch.ops.categorical`).
    The states equal ngx's bit for bit, a policy's up to a Gumbel near-tie
    between its logits and flax's."""
    device = resolve_device(device)
    specs = [lidar_in_front(make_spec(e)) for e in env_ids]
    assert len(stage_params) >= len(specs) - 1, \
        "need params (or None) for every stage except the last"
    steps = [make_step(sp, with_obs=False) for sp in specs]
    policies = [as_policy(p, device) for p in stage_params[:len(specs) - 1]]
    adapters = [make_state_adapter(specs[k], specs[k + 1])
                for k in range(len(specs) - 1)]
    reset0 = make_reset(specs[0], device)

    def play(k, state, draw):
        """Stage k from ``state``: up to ``cap`` steps of the actions
        ``draw(t, state)``, each env frozen at its first done.  The span
        ``ngx_torch.chain.stage`` counts the ``steps`` played and the
        ``kernel_draws``, the steps whose actions the categorical kernel
        drew."""
        step = steps[k]
        frozen = torch.zeros((batch,), dtype=torch.bool, device=device)
        with trace.span("ngx_torch.chain.stage") as stage:
            played, drawn = 0, CK.launches
            for t in range(cap):
                played += 1
                new, _, _, done, _ = step(state, draw(t, state))
                state = state.where(frozen, new)
                frozen = frozen | done
                if bool(frozen.all()):
                    break        # every env is frozen: nothing changes
            stage.count("steps", played)
            stage.count("kernel_draws", CK.launches - drawn)
        return state

    def stage_draw(k, k_roll):
        policy, n_actions = policies[k], specs[k].n_actions
        # the cap's step keys are split ahead, so the early stop in play
        # (every env frozen) leaves every draw it makes ngx's
        keys = TF.split(k_roll, cap)

        def draw(t, state):
            if policy is None:
                return TF.randint(keys[t], (batch,), 0, n_actions)
            with torch.no_grad():
                logits = policy(steps[k].get_obs(state).to(torch.float32))[0]
            return CK.categorical(keys[t], logits)
        return draw

    def chain(key):
        k0, key = TF.split(TF.as_key(key, device))
        state, _ = reset0(TF.split(k0, batch))
        for k in range(len(specs) - 1):
            key, k_roll = TF.split(key)
            state = adapters[k](play(k, state, stage_draw(k, k_roll)))
        return state, steps[-1].get_obs(state).to(torch.float32)

    return chain, specs[-1]


def evaluate_chain(env_ids: Sequence[str], stage_params: Sequence,
                   final_params, episodes: int = 128, cap: int = 100,
                   seed=0, device="cuda"):
    """Evaluate a chain-trained LAST-stage policy under the protocol it was
    trained for (the reference's, ``train_last_agent.py:95-117``): the
    chain (:func:`make_chain_reset`), then ``final_params`` (as a stage
    policy) for a fresh ``cap``-step budget counted from the restore:
    done is ``done | step_count - base >= cap`` with ``base`` the restored
    ``step_count``.  Solved is a goal termination (a terminal reward above
    ``reward_done / 2``) inside the budget; after an env's first done its
    state and obs are kept.  Returns ``mean_return``, ``solve_rate`` and
    ``done_rate`` (floats).

    The draws are ngx's (``ngx/rl/curriculum.py:180-224``) from
    ``key(seed)`` (``seed`` an int, or a key tensor): ``k0, k1 =
    split(key)``, the chain on ``k0``, and at step ``t`` of ``split(k1,
    cap)`` ``categorical(k_t, logits)`` (``randint`` for None): ngx's
    dict, up to Gumbel near-ties between the logits and flax's."""
    device = resolve_device(device)
    chain, spec = make_chain_reset(env_ids, stage_params, episodes, cap,
                                   device)
    step = make_step(spec, with_obs=False)
    model = as_policy(final_params, device)
    k0, k1 = TF.split(TF.as_key(seed, device))
    state, obs = chain(k0)
    keys = TF.split(k1, cap)

    def act(t, obs):
        if model is None:
            return TF.randint(keys[t], (episodes,), 0, spec.n_actions)
        with torch.no_grad():
            return CK.categorical(keys[t], model(obs)[0])
    base = state.step_count

    def budget_step(state, a, t):
        new, _, r, done, _ = step(state, a)
        done = done | (new.step_count - base >= cap)
        return new, step.get_obs(new).to(torch.float32), r, done

    # play_first_done stops once every env is done; the step keys are split
    # ahead, so no draw it makes moves
    out = play_first_done(budget_step, act, state, obs, cap,
                          spec.reward_done, hold=True)
    del out["mean_length"]       # ngx's evaluate_chain reports none
    return out


def make_train_chain(cfg: PPOConfig, env_ids: Sequence[str],
                     stage_params: Sequence, rollout_backend: str = "auto",
                     bc_data=None, pool_size: int = None, device="cuda",
                     rng: str = "threefry"):
    """``(init, train_step)`` for PPO on the LAST env of ``env_ids``, where
    every reset, initial and at episode boundaries, restores a fresh
    chain-terminal state (the reference's trained env resets through the
    restore branch, ``train_last_agent.py:77-87``).  ``rng`` accepts
    ``'threefry'`` only (:func:`~ngx_torch.rl.train.keys_only`).

    The chain (:func:`make_chain_reset`, ``cap = cfg.episode_cap``, the
    stage policies ``stage_params``) fills a pool of ``P = pool_size or
    min(B, 1024)`` rows.  ``init`` draws the B envs from the pool with
    replacement and sets each env's cap ``base`` to its ``step_count``.
    ``train_step`` expands the pool to ``POOL_SLOTS`` = R independent row
    draws per env (env b's slot r at row ``b*R + r``, the kernel's
    layout), runs the acting kernel in pool mode from the carried ``base``
    and carries its ``base_out``, then learns as
    :func:`~ngx_torch.rl.train.make_train` does (``solve_shaped``,
    ``bc_data``), counting episode lengths from ``step_count - base``.
    The carry is ``(ts, env_state, obs, ep_ret, base, pool, pool_obs)``,
    ngx's layout.  ``train_step.refresh_pool(carry, key)`` re-runs the
    chain on ``key`` and replaces ``pool`` and ``pool_obs``; the caller
    paces it (the CLI once every ``-updates_per_launch`` updates).

    The draws are ngx's (``ngx/rl/curriculum.py:292-430``) from ngx's keys
    (a key tensor, or an int for ``key(int)``).  ``init(key)``: ``k_env,
    k_net, k_idx = split(key, 3)``, the chain on ``k_env``, the rows
    ``randint(k_idx, (B,), 0, P)``, the parameters
    :meth:`ActorCritic.from_key` of ``k_net``.  ``train_step(carry,
    key)``: ``_, k_roll, k_upd = split(key, 3)``; on the kernel ``k_seed,
    k_idx = split(k_roll)``, its seed ``randint(k_seed, (), 0, 2^31 - 1)``
    and the pool rows ``randint(k_idx, (B, R), 0, P)``; under 'xla' at
    step ``t`` of ``split(k_roll, T)`` ``k_act, k_pool = split(k_t)``,
    ``categorical(k_act, logits)`` and the rows ``randint(k_pool, (B,), 0,
    P)``; the update's orders :func:`~ngx_torch.rl.train.epoch_perms` of
    ``k_upd``.  ``train_step.seeds`` holds the last step's ``(kernel seed,
    None)`` (None under 'xla'), ``train_step.pool_rows`` its rows and
    ``train_step.perms`` its permutations.  From the same key the states,
    seeds, rows and permutations are ngx's bit for bit, the parameters up
    to float rounding.

    A step is tiled by the spans ``ngx_torch.train.acting``,
    ``.permutation``, ``.recompute``, ``.gae`` and ``.update``, with its
    keyed draws in nested ``ngx_torch.train.draw`` spans, and
    ``refresh_pool`` is ``ngx_torch.train.refresh``, each stage in it an
    ``ngx_torch.chain.stage``; they are recorded inside a
    ``torch.profiler`` session (:mod:`ngx_torch.utils.trace`).  Setting
    ``train_step.phases`` to a dict times each step by phase (``refresh``,
    ``acting``, ``permutation``, ``recompute``, ``gae``, ``update``; see
    :class:`~ngx_torch.utils.trace.Phases`).

    ``rollout_backend``: ``'auto'`` and ``'pallas'`` run the CUDA kernel
    (its plain twin on the CPU); ``'xla'`` runs ngx's XLA path
    (``ngx/rl/curriculum.py:315-341``) unfused in torch: each step the
    model's logits, ``categorical`` (the argmax under the step's
    ``gumbel(k_act)`` noise, :func:`~ngx_torch.rl.train.rollout_unfused`),
    the plain step, and at ``done | step_count - base >= cap`` the WHOLE
    pool row restored — ``last_action``, ``last_reward`` and ``last_cost``
    carried, where the kernel zeroes them — from one uniform row draw per
    env and step, with its obs ``pool_obs[idx]`` and ``base`` its
    ``step_count``.  ``train_step.rollout_backend`` names the backend
    taken."""
    backend = acting_backend(rollout_backend)
    keys_only(rng)
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

    def init(key):
        k_env, k_net, k_idx = TF.split(TF.as_key(key), 3)
        pool, pool_obs = chain(k_env)
        idx = TF.randint(k_idx.to(device), (B,), 0, P).long()
        model = ActorCritic.from_key(k_net, pool_obs.shape[1],
                                     spec.n_actions, cfg.hidden).to(device)
        env_state, obs = pool.take(idx), pool_obs[idx]
        opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, eps=1e-5)
        ep_ret = torch.zeros((B,), dtype=torch.float32, device=device)
        return (TrainState(model, opt), env_state, obs, ep_ret,
                env_state.step_count, pool, pool_obs)

    def act(ts, env_state, obs, base, pool, pool_obs, idx, roll_seed,
            gumbel):
        """The acting phase: ``(env_state, obs_t, action, reward, done,
        last_obs, base)``.  ``idx``: the pool rows, ``int[B, R]`` on the
        kernel, ``int[T, B]`` (row of env b at step t) under 'xla', where
        ``gumbel`` is the loop's noise."""
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

            acted = rollout_unfused(ts.model, restore_step, env_state, obs,
                                    gumbel)
            return acted + (bases[0],)
        pool_r = pool.take(idx.reshape(-1))
        pi_layers = [(w.detach(), b.detach())
                     for w, b in ts.model.pi_layers()]
        env_state, obs_t, action, reward, done, base = train_rollout(
            spec, env_state, pi_layers, roll_seed, T, block=block,
            cap=cfg.episode_cap, pool=pool_r, base=base)
        return (env_state, obs_t, action, reward, done,
                get_obs(env_state).to(torch.float32), base)

    def train_step(carry, key):
        with trace.Phases(step.phases, device) as phase:
            phase("ngx_torch.train.acting")
            ts, env_state, obs, ep_ret, base, pool, pool_obs = carry
            gumbel = roll_seed = None
            with trace.span("ngx_torch.train.draw"):
                _, k_roll, k_upd = TF.split(TF.as_key(key), 3)
                if backend == "xla":
                    k_act, k_pool = TF.split(
                        TF.split(k_roll.to(device), T)).unbind(-2)
                    gumbel = TF.gumbel(k_act, (B, spec.n_actions))
                    idx = TF.randint(k_pool, (B,), 0, P).long()
                else:
                    k_seed, k_idx = TF.split(k_roll)
                    roll_seed = draw_seed(k_seed)
                    idx = TF.randint(k_idx.to(device), (B, R), 0, P).long()
            step.seeds, step.pool_rows = (roll_seed, None), idx
            # steps already taken in each env's current episode, counted
            # from its restore — seeds the episode-length tally
            pre_count = env_state.step_count - base
            acted = act(ts, env_state, obs, base, pool, pool_obs, idx,
                        roll_seed, gumbel)
            phase("ngx_torch.train.permutation")
            with trace.span("ngx_torch.train.draw"):
                step.perms = epoch_perms(cfg, k_upd, T * B, device)
            env_state, obs_t, action, reward, done, last_obs, base = acted
            run, metrics = learn(ts, (obs_t, action, reward, done), last_obs,
                                 ep_ret, pre_count, phase, step.perms)
            return (ts, env_state, last_obs, run, base, pool,
                    pool_obs), metrics

    def refresh_pool(carry, key):
        """Re-run the chain on ``key`` and swap the carried pool: the
        phase ``ngx_torch.train.refresh``."""
        with trace.Phases(step.phases, device) as phase:
            phase("ngx_torch.train.refresh")
            pool, pool_obs = chain(key)
        return carry[:5] + (pool, pool_obs)

    step = train_step
    step.refresh_pool = refresh_pool
    step.rollout_backend = backend
    step.phases = None
    step.seeds = step.pool_rows = step.perms = None
    return init, step
