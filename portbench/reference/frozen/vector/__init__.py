"""Frozen copy of the port's ``vector.KeyedVecEnv`` (``make_vec(...,
rng='threefry')``), the batched env on ngx's keys, cut to the reset and
the step with its done rows' resets that keyed evaluation uses.

A done env's carried state is its row of ngx's native reset over the
step's keys; only the done rows are drawn, since a row's reset depends on
its key alone."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.reset import ResetTables, native_reset_state
from ..core.step import make_step


class KeyedVecEnv:
    """``reset(keys)`` and ``step_rows(state, actions, reset_keys)`` of the
    port's keyed ``VecEnv``, on the device of the keys and states it is
    given.  A key batch is an int64 ``[B, 2]`` tensor of
    ``jax.random.key_data`` words."""

    def __init__(self, spec, episode_cap: Optional[int] = None,
                 reset_obs: bool = False):
        self.spec = spec
        self.episode_cap = episode_cap
        self.reset_obs = reset_obs
        self._step = make_step(spec, with_obs=False)
        self.get_obs = self._step.get_obs
        self._reset_tables = ResetTables(spec)

    def reset(self, keys):
        """``(state, obs)``: ``jax.vmap(make_reset(spec))(keys)``, on the
        keys' device."""
        keys = torch.as_tensor(keys).to(torch.int64)
        if keys.dim() != 2 or keys.shape[1] != 2:
            raise ValueError(f"reset takes keys [B, 2], got "
                             f"{tuple(keys.shape)}")
        state = native_reset_state(self._reset_tables, keys)
        return state, self.get_obs(state)

    def step_rows(self, state, actions, reset_keys):
        """One step of every env: ``(state, obs, reward, done, info)``.
        ``reset_keys(idx) -> keys[len(idx), 2]`` gives the keys of the done
        rows ``idx`` alone (``split_at`` of the step's reset key, where ngx
        splits it over the whole batch).  The obs is the terminal one, or
        with ``reset_obs`` the carried state's."""
        new_state, _, reward, done, info = self._step(state, actions)
        if self.episode_cap is not None:
            done = done | (new_state.step_count >= self.episode_cap)
        carried = new_state
        idx = done.nonzero()[:, 0]
        if idx.numel():
            carried = new_state.put(
                idx, native_reset_state(self._reset_tables, reset_keys(idx)))
        obs = self.get_obs(carried if self.reset_obs else new_state)
        return carried, obs, reward, done, info
