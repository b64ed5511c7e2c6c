"""Batched environments with auto-reset — the port of ``ngx/vector``'s
``make_vec`` (``ngx/vector/__init__.py:39``), ``Trajectory`` (``:31``) and
``throughput_fn`` (``:119``).

The batch is one :class:`~ngx_torch.core.state.EnvState` with a leading env
axis.  Resets are the counter-RNG reset (:mod:`ngx_torch.core.reset`), so a
reset draw is addressed by ``(seed, ctr, row)`` instead of a ``jax.random``
key: :meth:`VecEnv.reset` takes a seed, :meth:`VecEnv.step` the acting
loop's ``seed``, step counter and RNG block, and a done env's fresh state is
the one the CUDA kernel draws for the same env at the same step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.reset import ResetTables, reset_rows
from ..core.step import make_step
from ..ops.rng import _randint, block_streams, hash_actions  # noqa: F401
from ..ops.rollout import ACTION_RNGS, SALT_PRNG_ACTION
from ..ops.tables import resolve_device


class Trajectory(NamedTuple):
    """Time-major stacked rollout output (T leading, then batch)."""
    obs: object
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    step_costs: torch.Tensor


class VecEnv:
    """``make_vec(spec, episode_cap=..., reset_obs=...)``'s batched env.

    ``step`` auto-resets finished envs: when an env reports done, its carried
    state is a fresh reset draw.  ``episode_cap`` adds the trainer's
    time-limit truncation: envs whose post-step ``step_count`` reaches the
    cap read as done and auto-reset.  With ``reset_obs=False`` the returned
    obs is the terminal observation; ``reset_obs=True`` (SB2-VecEnv
    semantics, what the reference trains under, reference
    tests/train.py:104-122) returns the reset observation at a boundary, so
    ``obs == get_obs(carried_state)`` on every step."""

    def __init__(self, spec, episode_cap: Optional[int] = None,
                 reset_obs: bool = False):
        self.spec = spec
        self.episode_cap = episode_cap
        self.reset_obs = reset_obs
        self._step = make_step(spec, with_obs=False)
        self.get_obs = self._step.get_obs
        self._reset_tables = ResetTables(spec)

    def reset(self, seed: int, batch: int, block: Optional[int] = None,
              device="cuda"):
        """``(state, obs)``: ``batch`` fresh states, the counter reset at
        ``ctr = 0`` of the RNG streams ``(seed + blk*7919, env % block)``
        (one block of ``batch`` envs by default).  ``device`` defaults to
        the card and raises where there is none."""
        seeds, rows = block_streams(seed, batch, block or batch,
                                    resolve_device(device))
        state = reset_rows(self._reset_tables, seeds, 0, rows)
        return state, self.get_obs(state)

    def step(self, state, actions, seed: int, ctr: int,
             block: Optional[int] = None):
        """One step of every env; a done env restarts from the reset draw
        ``(seed + blk*7919, ctr, env % block)``."""
        new_state, _, reward, done, info = self._step(state, actions)
        if self.episode_cap is not None:
            done = done | (new_state.step_count >= self.episode_cap)
        carried = new_state
        idx = done.nonzero()[:, 0]
        if idx.numel():
            seeds, rows = block_streams(seed, state.batch, block or state.batch,
                                        state.device)
            fresh = reset_rows(self._reset_tables, seeds[idx], ctr, rows[idx])
            carried = new_state.put(idx, fresh)
        obs = self.get_obs(carried if self.reset_obs else new_state)
        return carried, obs, reward, done, info

    def rollout(self, state, seed: int, policy, T: int,
                block: Optional[int] = None):
        """``(state, Trajectory)`` after ``T`` steps from ``state``; step
        ``t`` has ``ctr = t + 1``, and its resets are :meth:`step`'s under
        ``seed`` and ``block``.  ``policy(ctr, state) -> actions[B]``;
        ``None`` draws uniform actions on the counter RNG,
        ``_randint(seed, ctr, salt 1, row, col 0) % A`` — the 'prng'
        kernel's, so from :meth:`reset`'s state under the same seed and
        block the rollout is :func:`throughput_fn`'s."""
        if T < 1:
            raise ValueError(f"a rollout of {T} steps")
        B = state.batch
        seeds, rows = block_streams(seed, B, block or B, state.device)
        col0 = torch.zeros((1,), dtype=torch.int64, device=state.device)
        out = []
        for t in range(T):
            ctr = t + 1
            if policy is None:
                actions = _randint(seeds, ctr, SALT_PRNG_ACTION, rows, col0,
                                   self.spec.n_actions)[:, 0]
            else:
                actions = policy(ctr, state)
            state, obs, reward, done, info = self.step(state, actions, seed,
                                                       ctr, block)
            out.append((obs, actions.to(torch.int32), reward, done,
                        info.step_cost))
        obs, actions, rewards, dones, costs = zip(*out)
        if isinstance(obs[0], dict):
            obs = {k: torch.stack([o[k] for o in obs]) for k in obs[0]}
        else:
            obs = torch.stack(obs)
        return state, Trajectory(obs, torch.stack(actions),
                                 torch.stack(rewards), torch.stack(dones),
                                 torch.stack(costs))


def make_vec(spec, *, episode_cap: Optional[int] = None,
             reset_obs: bool = False) -> VecEnv:
    return VecEnv(spec, episode_cap=episode_cap, reset_obs=reset_obs)


def throughput_fn(spec, batch: int, steps: int, action_rng: str = "counter",
                  auto_reset: bool = True, packed: bool = False,
                  device="cuda"):
    """``run(seed) -> (state, mean_reward)``: ``steps`` random-action steps of
    ``batch`` auto-resetting envs with nothing stored per step — the
    env-stepping benchmark (BASELINE.json's env-steps/s metric).

    It is the ``'prng'`` mode of :func:`ngx_torch.ops.rollout.make_rollout`:
    on a CUDA ``device`` the rollout kernel, on the CPU its plain twin.  Unlike
    ngx's, which draws with ``jax.random`` threefry keys (which torch cannot
    reproduce), the actions and the resets come from the counter RNG: the
    action of step ``t`` is ``_randint(seed, t+1, salt 1, row, 0) % A`` and
    every reset is the counter reset, in RNG blocks of 512 envs (or the whole
    batch where it is not a multiple of 512).  The mean is over ``batch *
    steps`` env-steps.  ``device`` defaults to the card and raises where
    there is none.

    ngx's ablations (``ngx/vector/__init__.py:119-204``), one at a time, as
    the kernel's variants: ``action_rng='hash'`` is ngx's counter hash of
    the env index and the step (:func:`hash_actions`, bit for bit),
    ``'fixed'`` action 0; ``auto_reset=False`` lets done envs step on from
    their terminal state; ``packed=True`` has the kernel write its final
    state in :func:`~ngx_torch.core.state.make_state_packers`' words, the
    same state bit for bit.  ngx's default, ``'threefry'``, cannot be
    reproduced and raises."""
    from ..ops.rollout import make_rollout

    if action_rng not in ACTION_RNGS:
        raise ValueError(
            f"action_rng {action_rng!r}: the port draws actions with "
            f"'counter' (its default, the counter RNG in place of ngx's "
            f"threefry, which torch cannot reproduce), 'hash' or 'fixed'")
    block = 512 if batch % 512 == 0 else batch
    run = make_rollout(spec, batch, steps, block=block, action_source="prng",
                       device=device, action_rng=action_rng,
                       auto_reset=auto_reset, packed=packed)

    def throughput(seed: int):
        state, mean_reward, _ = run(seed)
        return state, mean_reward

    return throughput
