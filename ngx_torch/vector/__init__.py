"""Batched environments with auto-reset — the port of ``ngx/vector``'s
``make_vec`` (``ngx/vector/__init__.py:39``) and ``throughput_fn`` (``:119``).

The batch is one :class:`~ngx_torch.core.state.EnvState` with a leading env
axis.  Resets are the counter-RNG reset (:mod:`ngx_torch.core.reset`), so a
reset draw is addressed by ``(seed, ctr, row)`` instead of a ``jax.random``
key: :meth:`VecEnv.step` takes the acting loop's ``seed``, step counter and
RNG block, and a done env's fresh state is the one the CUDA kernel draws for
the same env at the same step.
"""

from __future__ import annotations

from typing import Optional

from ..core.reset import ResetTables, reset_rows
from ..core.step import make_step
from ..ops.rng import block_streams


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


def make_vec(spec, *, episode_cap: Optional[int] = None,
             reset_obs: bool = False) -> VecEnv:
    return VecEnv(spec, episode_cap=episode_cap, reset_obs=reset_obs)


def throughput_fn(spec, batch: int, steps: int, device="cuda"):
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
    there is none."""
    from ..ops.rollout import make_rollout

    block = 512 if batch % 512 == 0 else batch
    run = make_rollout(spec, batch, steps, block=block, action_source="prng",
                       device=device)

    def throughput(seed: int):
        state, mean_reward, _ = run(seed)
        return state, mean_reward

    return throughput
