"""The counter-RNG procedural reset — the port's only reset.

Port of the TPU kernel's block reset (``ngx/ops/pallas_rollout.py:181-447``,
``_make_reset_block``) as run standalone by ``make_xla_pool_reset``
(``:450``): the plain placements, the v3 wall coin, the Pogostick-v0 tap
pre-placement and the start inventory, in that order.  Every draw
is a murmur3 counter hash (:mod:`ngx_torch.ops.rng`), so the same
``(seed, ctr, row)`` gives the same state here, in the CUDA kernel and in
the JAX kernel.  ``ngx/core/reset.py`` draws with ``jax.random`` threefry
keys, which torch cannot reproduce; the two resets share one distribution
(tests/test_torch_rng_reset.py checks the invariants).

Parity hazard — exact selection: a placement picks the max of ``u01`` over
the valid cells, ties broken by the minimum index (``:293-303``).  A cell is
valid when it and its 4 neighbours are air, it lies in the 2-margin interior
and it is not the agent's cell (``:321-331``).  The tap pre-placement scores
four direction planes and takes the first maximum over their direction-major
concatenation (``:356-378``), so a cell next to k trees carries weight k.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spec as S
from .state import EnvState
from ..ops.rng import _randint, _u01, _bits

# salts of the reset draws (pallas_rollout.py:312-330, :421-424)
SALT_AGENT, SALT_FACING, SALT_INV, SALT_PLACE0 = 2, 3, 4, 16
SALT_COIN, SALT_TAP0 = 40, 41     # :347, :368 (one tap salt per direction)


class ResetTables:
    """The spec's reset tables (numpy), shared by the plain reset and the
    CUDA kernel's table buffer."""

    def __init__(self, sp):
        S.check_supported(sp)
        H, I = sp.map_size, sp.n_items
        self.H, self.I = H, I
        self.wall = sp.items.index("wall") if "wall" in sp.items else 0
        self.wall_coin = bool(sp.reset_wall_coin)
        self.place_tap = bool(sp.reset_place_tap)
        self.tree = sp.items.index("tree_log") if "tree_log" in sp.items else -1
        self.tap = sp.items.index("tree_tap") if "tree_tap" in sp.items else -1
        base = np.zeros((H, H), np.int32)
        base[0, :] = base[-1, :] = base[:, 0] = base[:, -1] = self.wall
        self.base_flat = base.reshape(-1)
        interior = np.zeros((H, H), bool)
        interior[2:H - 2, 2:H - 2] = True
        self.interior_flat = interior.reshape(-1)
        self.interior_ids = np.nonzero(self.interior_flat)[0].astype(np.int32)
        self.placements = np.repeat(np.asarray(sp.spawn_items, np.int32),
                                    np.asarray(sp.spawn_qty, np.int32))
        self.inv_lo = np.asarray(sp.start_inv_lo if sp.start_inv_lo is not None
                                 else np.zeros((I,), np.int32), np.int32)
        inv_hi = np.asarray(sp.start_inv_hi if sp.start_inv_hi is not None
                            else self.inv_lo, np.int32)
        self.inv_span = inv_hi - self.inv_lo + 1
        self.random_inv = bool((inv_hi != self.inv_lo).any())
        self.inv_set = (np.asarray(sp.reset_inv_set, np.int32)
                        if sp.reset_inv_set is not None
                        else np.full((I,), -1, np.int32))


def reset_rows(tab: ResetTables, seed, ctr, rows) -> EnvState:
    """Fresh states for the RNG streams ``(seed, ctr, row)``.

    ``seed``: a Python int or an int64 tensor ``[n]`` of per-env block seeds
    (:func:`ngx_torch.ops.rng.block_streams`); ``ctr``: the step counter (0
    for the initial reset, ``t+1`` at a boundary of step ``t``); ``rows``:
    int64 ``[n]`` rows within the RNG block."""
    dev = rows.device
    n = rows.shape[0]
    H, I = tab.H, tab.I
    HW = H * H
    col0 = torch.zeros((1,), dtype=torch.int64, device=dev)

    def const(a, dt=torch.int64):
        return torch.as_tensor(a).to(dtype=dt, device=dev)

    # agent cell: uniform over the 2-margin interior (pogostick_v1_env.py:141-145)
    aidx = _randint(seed, ctr, SALT_AGENT, rows, col0,
                    len(tab.interior_ids))[:, 0]
    acell = const(tab.interior_ids)[aidx]
    facing = _randint(seed, ctr, SALT_FACING, rows, col0, 4)[:, 0]

    m = const(tab.base_flat).expand(n, HW).clone()
    cells = torch.arange(HW, dtype=torch.int64, device=dev)
    ok_cell = const(tab.interior_flat, torch.bool)[None, :] \
        & (cells[None, :] != acell[:, None])
    for j, item in enumerate(tab.placements.tolist()):
        # cell + all 4 neighbors air (pogostick_v1_env.py:171-173); interior
        # cells have all 4 neighbors in bounds
        air = (m == 0).reshape(n, H, H)
        nb4 = torch.zeros_like(air)
        nb4[:, 1:-1, 1:-1] = (air[:, :-2, 1:-1] & air[:, 2:, 1:-1]
                              & air[:, 1:-1, :-2] & air[:, 1:-1, 2:])
        valid = (air & nb4).reshape(n, HW) & ok_cell
        u = _u01(seed, ctr, SALT_PLACE0 + j, rows, cells)
        score = torch.where(valid, u, torch.full_like(u, -1.0))
        pick = torch.argmax(score, dim=1)        # first max == min index
        hit = valid.any(dim=1)
        old = m.gather(1, pick[:, None])[:, 0]
        m = m.scatter(1, pick[:, None],
                      torch.where(hit, item, old)[:, None])

    if tab.wall_coin:
        # v3: the top hash bit as a coin puts a wall in front of the agent,
        # only onto air (novel_gridworld_v3_env.py:148-152); the agent sits
        # two cells from the border, so the front cell is in the map
        delta = const(S.FACING_DELTAS)[facing]
        fcell = acell + delta[:, 0] * H + delta[:, 1]
        coin = (_bits(seed, ctr, SALT_COIN, rows, col0)[:, 0] >> 31) > 0
        front = m.gather(1, fcell[:, None])[:, 0]
        m = m.scatter(1, fcell[:, None],
                      torch.where(coin & (front == 0), tab.wall, front)[:, None])

    if tab.place_tap:
        # Pogostick-v0: one tree_tap on an air cell (not the agent's) next to
        # a tree (pogostick_v0_env.py:155-178); plane d holds the cells one
        # step in direction d from a tree
        tree = (m == tab.tree).reshape(n, H, H)
        air_ok = ((m == 0) & (cells[None, :] != acell[:, None])).reshape(n, H, H)
        scores = []
        for d, (dr, dc) in enumerate(S.FACING_DELTAS.tolist()):
            here = torch.zeros_like(tree)
            here[:, max(dr, 0):H + min(dr, 0), max(dc, 0):H + min(dc, 0)] = \
                tree[:, max(-dr, 0):H + min(-dr, 0), max(-dc, 0):H + min(-dc, 0)]
            u = _u01(seed, ctr, SALT_TAP0 + d, rows, cells)
            scores.append(torch.where((here & air_ok).reshape(n, HW), u,
                                      torch.full_like(u, -1.0)))
        score = torch.cat(scores, dim=1)                  # [n, 4*HW]
        best = score.amax(dim=1)
        pick = torch.argmax(score, dim=1) % HW            # first max
        old = m.gather(1, pick[:, None])[:, 0]
        m = m.scatter(1, pick[:, None],
                      torch.where(best >= 0, tab.tap, old)[:, None])

    inv = const(tab.inv_lo).expand(n, I)
    if tab.random_inv:
        bits = _bits(seed, ctr, SALT_INV, rows,
                     torch.arange(I, dtype=torch.int64, device=dev))
        inv = inv + (bits >> 1) % const(tab.inv_span)[None, :]
    setv = const(tab.inv_set)[None, :]
    inv = torch.where(setv >= 0, setv, inv)

    zi = torch.zeros((n,), dtype=torch.int32, device=dev)
    zf = torch.zeros((n,), dtype=torch.float32, device=dev)
    return EnvState(
        map=m.to(torch.int32),
        agent=torch.stack([acell // H, acell % H], dim=1).to(torch.int32),
        facing=facing.to(torch.int32),
        inventory=inv.to(torch.int32),
        selected=zi - 1,
        step_count=zi,
        last_action=zi.clone(),
        last_reward=zf,
        last_cost=zf.clone(),
        last_done=torch.zeros((n,), dtype=torch.bool, device=dev),
    )


def counter_reset(spec, seed: int, ctr: int, n: int, device=None) -> EnvState:
    """``n`` fresh states from one RNG stream: rows ``0..n-1`` under
    ``seed`` — the same states as ngx's ``make_xla_pool_reset(spec,
    n)(seed, ctr)``."""
    rows = torch.arange(n, dtype=torch.int64, device=device)
    return reset_rows(ResetTables(spec), int(seed), int(ctr), rows)
