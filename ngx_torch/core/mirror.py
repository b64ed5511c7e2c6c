"""Host-side mirror of the reference's reset RNG — the port's numpy copy of
``ngx/core/mirror.py:23-141`` (importing any ``ngx`` module imports jax).

The reference generates maps with a variable-length rejection loop over a
mutating Python list, drawing from NumPy's *global* legacy RNG
(``pogostick_v1_env.py:86-181``).  This module replays that draw order
exactly on the host: seed ``np.random`` with the seed the reference would
use and :func:`mirror_reset` gives the reference's start state bit for bit,
as a ``[1]``-batched :class:`~ngx_torch.core.state.EnvState` on the asked-for
device.  The counter reset (:mod:`ngx_torch.core.reset`) shares its
distribution and is what the batched paths use; this mirror serves the
single-env facade (:mod:`ngx_torch.compat`) and users who need the
reference's episodes.
"""

from __future__ import annotations

import numpy as np

from . import spec as S
from .state import state_from_numpy

_DIRECTION_KEYS = ["NORTH", "SOUTH", "WEST", "EAST"]


def mirror_reset(sp: S.EnvSpec, rng=np.random, device="cuda"):
    """Replays the exact reference reset draw order. Caller controls the RNG
    state (e.g. ``np.random.seed(s)`` first, as with the reference).
    ``device`` defaults to the card and raises where there is none."""
    H = sp.map_size
    wall = sp.items.index("wall")

    # v3 draws its random starting inventory FIRST (novel_gridworld_v3_env.py:111-114)
    inv = np.zeros((sp.n_items,), np.int64)
    if sp.start_inv_lo is not None:
        lo = np.asarray(sp.start_inv_lo)
        hi = np.asarray(sp.start_inv_hi)
        for i in range(sp.n_items):
            if hi[i] > lo[i]:
                inv[i] = rng.randint(low=int(lo[i]), high=int(hi[i]) + 1, size=1)[0]
            else:
                inv[i] = lo[i]

    m = np.zeros((H - 2, H - 2), dtype=int)
    m = np.pad(m, pad_width=1, mode="constant", constant_values=wall)

    available = [(r, c) for r in range(2, H - 2) for c in range(2, H - 2)]

    idx = rng.choice(len(available), size=1)[0]
    agent = available[idx]

    facing = _DIRECTION_KEYS.index(rng.choice(_DIRECTION_KEYS, size=1)[0])

    # add_item_to_map rejection loop — pogostick_v1_env.py:159-181
    for item_id, qty in zip(sp.spawn_items, sp.spawn_qty):
        count = 0
        while count < qty:
            assert available, "Cannot place items, increase map size!"
            idx = rng.choice(len(available), size=1)[0]
            r, c = available[idx]
            if (r, c) == agent:
                available.pop(idx)
                continue
            if (m[r][c] == 0 and m[r - 1][c] == 0 and m[r + 1][c] == 0
                    and m[r][c - 1] == 0 and m[r][c + 1] == 0):
                m[r][c] = int(item_id)
                count += 1
            available.pop(idx)

    # v3: 50% wall in front of the agent (novel_gridworld_v3_env.py:148-152)
    if sp.reset_wall_coin:
        d = S.FACING_DELTAS[facing]
        fr, fc = agent[0] + d[0], agent[1] + d[1]
        if rng.binomial(1, 0.5) == 1 and m[fr][fc] == 0:
            m[fr][fc] = wall

    # Pogostick-v0 tap pre-placement retry loop (pogostick_v0_env.py:155-178)
    if sp.reset_place_tap:
        tree = sp.items.index("tree_log")
        tap = sp.items.index("tree_tap")
        result = np.array(np.where(m == tree))
        assert len(result[0]) > 1, "Need tree_log in map to place tree_tap"
        while True:
            direction = rng.choice(_DIRECTION_KEYS)
            tree_idx = rng.choice(len(result[0]))
            r, c = result[0][tree_idx], result[1][tree_idx]
            tr, tc = {
                "NORTH": (r - 1, c), "SOUTH": (r + 1, c),
                "WEST": (r, c - 1), "EAST": (r, c + 1),
            }[direction]
            if 0 <= tr <= H - 1 and 0 <= tc <= H - 1 and m[tr][tc] == 0 \
                    and (tr, tc) != agent:
                m[tr][tc] = tap
            if len(np.where(m == tap)[0]) > 0:
                break

    # novelty reset transforms, in injection order (inner wrapper first —
    # each reference wrapper edits the map after its inner reset returned)
    for edit in sp.reset_edits:
        if edit[0] == "fence":
            _, fence_id, lo, hi = edit
            _mirror_fence(m, agent, fence_id, lo, hi, wall, rng)
        elif edit[0] == "additem":
            _, item_id, lo, hi = edit
            _mirror_percent(m, agent, m == 0, item_id, lo, hi, rng)
        else:
            _, from_id, to_id, lo, hi = edit
            _mirror_percent(m, agent, m == from_id, to_id, lo, hi, rng)

    if sp.reset_inv_set is not None:
        setv = np.asarray(sp.reset_inv_set)
        inv = np.where(setv >= 0, setv, inv)

    return state_from_numpy(sp, m, agent, facing, inv, device=device)


def _mirror_percent(m, agent, eligible, item_id, lo, hi, rng):
    """AddItem/ReplaceItem reset: shuffle eligible cells, overwrite the first
    ceil(n*p%) of them (novelty_wrappers.py:1013-1034, 1126-1148)."""
    result = np.array(np.where(eligible))
    indices = np.arange(len(result[0]))
    rng.shuffle(indices)
    result[0] = result[0][indices]
    result[1] = result[1][indices]
    p = rng.randint(low=lo, high=hi, size=1)[0]
    for i in range(int(np.ceil(len(result[0]) * (p / 100)))):
        r, c = result[0][i], result[1][i]
        if (r, c) != agent:
            m[r][c] = item_id


def _mirror_fence(m, agent, fence_id, lo, hi, wall, rng):
    """Fence reset (novelty_wrappers.py:868-889)."""
    result = np.array(np.where((m != 0) & (m != wall)))
    indices = np.arange(len(result[0]))
    rng.shuffle(indices)
    result[0] = result[0][indices]
    result[1] = result[1][indices]
    p = rng.randint(low=lo, high=hi, size=1)[0]
    for i in range(int(np.ceil(len(result[0]) * (p / 100)))):
        r, c = result[0][i], result[1][i]
        for rr in (r - 1, r, r + 1):
            for cc in (c - 1, c, c + 1):
                if m[rr][cc] == 0 and (rr, cc) != agent:
                    m[rr][cc] = fence_id
