"""Env stepping in plain torch: ``batch`` auto-resetting envs, each from its
counter reset at ``ctr = 0``, stepped ``steps`` times with the counter RNG's
uniform actions (salt 1); a done env takes the counter reset at ``ctr =
t + 1``.

Frozen from the port's ``ops/rollout.py`` (``rollout_plain`` in 'prng'
mode) and ``make_rollout``'s mean."""

from __future__ import annotations

import torch

from .frozen.core.reset import ResetTables, reset_rows
from .frozen.core.step import make_step
from .frozen.ops.rng import _randint, block_streams

SALT_PRNG_ACTION = 1


@torch.no_grad()
def run(spec, batch: int, steps: int, seed: int, block: int, device,
        sum_dtype=torch.float32):
    """``(state, mean_reward)``: the mean is the per-env running reward sums
    (added step by step) over ``batch * steps``.  ``sum_dtype`` is the
    running sum's type: float32 as stated, lower only for the control."""
    seeds, rows = block_streams(seed, batch, block, device)
    tab = ResetTables(spec)
    step = make_step(spec, with_obs=False)
    state = reset_rows(tab, seeds, 0, rows)
    col0 = torch.zeros((1,), dtype=torch.int64, device=device)
    rsum = torch.zeros((batch,), dtype=sum_dtype, device=device)
    for t in range(steps):
        ctr = t + 1
        a = _randint(seeds, ctr, SALT_PRNG_ACTION, rows, col0,
                     spec.n_actions)[:, 0]
        state, _, r, done, _ = step(state, a)
        rsum = rsum + r.to(sum_dtype)
        idx = done.nonzero()[:, 0]
        if len(idx):
            state = state.put(idx, reset_rows(tab, seeds[idx], ctr, rows[idx]))
    return state, rsum.to(torch.float32).sum() / max(batch * steps, 1)
