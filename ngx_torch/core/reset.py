"""The port's two procedural resets: the counter-RNG reset of the kernels,
and ngx's native reset on ``jax.random`` keys.

The counter reset (:func:`reset_rows`, :func:`counter_reset`) ports the TPU
kernel's block reset (``ngx/ops/pallas_rollout.py:181-447``,
``_make_reset_block``) as run standalone by ``make_xla_pool_reset``
(``:450``): the plain placements, the v3 wall coin, the Pogostick-v0 tap
pre-placement, the novelty percent-fill edits and the start inventory, in
that order.  Every draw is a murmur3 counter hash
(:mod:`ngx_torch.ops.rng`), so the same ``(seed, ctr, row)`` gives the same
state here, in the CUDA kernel and in the JAX kernel.

The native reset (:func:`make_reset`, :func:`native_reset_state`) is ngx's
``make_reset`` (``ngx/core/reset.py:30-221``) on threefry keys
(:mod:`ngx_torch.ops.threefry`): the same key gives ngx's state and obs bit
for bit.  Its draws, in ngx's order: ``split(key, 7)``; the agent cell and
the facing (``randint``); one ``categorical`` a placement over the free
cells, on ``split(k_items, n)``; the random start inventory (``randint``
with per-item bounds); v3's wall coin (``bernoulli``); Pogostick-v0's tap
over ``[4, H, H]`` candidate planes; each novelty edit on ``fold_in(k_edits,
j)``, ranking ``uniform`` scores with a stable argsort (equal float scores
occur at large batches; the lower cell index ranks first, as in
``jnp.argsort``).  On a CUDA device it is one launch of the reset kernel
(:mod:`ngx_torch.ops.native_reset`), whose plain twin, and the CPU's path,
is :func:`native_reset_plain`.  The two resets share one distribution
(tests/test_torch_rng_reset.py checks the invariants).

The rest of this docstring is the counter reset's.

Parity hazard — exact selection: a placement picks the max of ``u01`` over
the valid cells, ties broken by the minimum index (``:293-303``).  A cell is
valid when it and its 4 neighbours are air, it lies in the 2-margin interior
and it is not the agent's cell (``:321-331``).  The tap pre-placement scores
four direction planes and takes the first maximum over their direction-major
concatenation (``:356-378``), so a cell next to k trees carries weight k.

Parity hazards of the percent-fill edits (``:380-419``), applied in
injection order:

* Edit ``j`` draws its percent ``p = randint(salt 100+4j, hi-lo) + lo`` at
  column 0 and fills ``n = ceil(count * p / 100)`` of its ``count``
  eligible cells, where the reference computes the ceil in float64:
  ``n = (count*p + 99) // 100``, plus one on :func:`ceil_percent_pairs`.
* The ``n`` cells are the ``min(n, count)`` smallest scores among the
  eligible cells, with ``score = ((bits >> (32-U)) << LANE) | cell`` from
  salt ``101+4j`` (``:265-291``): the lane index in the low bits makes the
  scores distinct, so any exact smallest-n gives the bisection's set.
* The agent's cell is eligible for additem and replace (it is air on the
  map) but is dropped after the selection, so fewer than ``n`` cells may
  change; a fence center is a cell that is neither air nor wall, and its
  3x3 dilation writes onto air that is not the agent's cell.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spec as S
from .state import EnvState
from ..ops import threefry as TF
from ..ops.rng import _randint, _u01, _bits
from ..utils import debug

# salts of the reset draws (pallas_rollout.py:312-330, :421-424)
SALT_AGENT, SALT_FACING, SALT_INV, SALT_PLACE0 = 2, 3, 4, 16
SALT_COIN, SALT_TAP0 = 40, 41     # :347, :368 (one tap salt per direction)
SALT_EDIT0, SALT_EDIT_STRIDE = 100, 4     # :397 (+1: the edit's selection)
# reset-edit kinds as the kernels' table holds them: a fence (centers among
# the non-air non-wall cells, 3x3 dilation onto air) or a fill (cells holding
# item ``a`` become item ``b``: additem is a fill of air, replace of its item)
EDIT_FENCE, EDIT_FILL = 0, 1


def ceil_percent_pairs(max_count: int):
    """(count, p) pairs in [0, max_count] x [1, 100) where the reference's
    float64 ``int(np.ceil(count * (p / 100)))`` (novelty_wrappers.py:881,
    1025, 1139) exceeds the exact ``ceil(count*p/100)``: the float64 value
    of p/100 rounds the product just above an exact multiple (25 * 0.28 ->
    7.000000000000001 -> 8).  A copy of ``ngx/core/reset.py:224``."""
    pairs = []
    for count in range(max_count + 1):
        for p in range(1, 100):
            if int(np.ceil(count * (p / 100))) != (count * p + 99) // 100:
                pairs.append((count, p))
    return tuple(pairs)


def lane_bits(hw: int) -> int:
    """The low bits of a selection score that hold the cell index
    (``pallas_rollout.py:261``): 8, or more for maps above 256 cells."""
    return max(8, (hw - 1).bit_length())


class ResetTables:
    """The spec's reset tables (numpy), shared by the plain reset and the
    CUDA kernel's table buffer."""

    def __init__(self, sp):
        S.check_supported(sp)
        H, I = sp.map_size, sp.n_items
        self.spec = sp
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
        # the percent-fill edits, in injection order: rows (kind, a, b, lo,
        # hi), and the ceil-percent correction pairs of this map size
        edits = []
        for e in sp.reset_edits:
            if e[0] == "fence":
                edits.append((EDIT_FENCE, 0, e[1], e[2], e[3]))
            elif e[0] == "additem":
                edits.append((EDIT_FILL, 0, e[1], e[2], e[3]))
            else:                                      # replace
                edits.append((EDIT_FILL, e[1], e[2], e[3], e[4]))
        self.edits = np.asarray(edits, np.int32).reshape(-1, 5)
        self.cpairs = np.asarray(ceil_percent_pairs(H * H) if edits else (),
                                 np.int32).reshape(-1, 2)
        self.lane_bits = lane_bits(H * H)


def ceil_percent(count, p, pairs):
    """``int(np.ceil(count * (p / 100)))`` in float64, as exact integer ops
    on int64 tensors: the integer ceil plus one on ``pairs``
    (:func:`ceil_percent_pairs`)."""
    n = (count * p + 99) // 100
    for c_, p_ in np.asarray(pairs).reshape(-1, 2).tolist():
        n = n + ((count == c_) & (p == p_)).long()
    return n


def _select_n(eligible, n, seed, ctr, salt, rows, lane):
    """Bool ``[n_env, HW]``: the ``min(n, count)`` eligible cells of each
    row with the smallest scores (pallas_rollout.py:265-291), nothing where
    that is 0."""
    HW = eligible.shape[1]
    cells = torch.arange(HW, dtype=torch.int64, device=eligible.device)
    bits = _bits(seed, ctr, salt, rows, cells)
    score = ((bits >> (32 - (30 - lane))) << lane) | cells[None, :]
    n = torch.minimum(n, eligible.sum(dim=1))
    ranked = torch.where(eligible, score, 2 ** 31).sort(dim=1).values
    thr = ranked.gather(1, (n - 1).clamp(min=0)[:, None])
    return eligible & (score <= thr) & (n > 0)[:, None]


def _free_cells(m, ok_cell, H):
    """Bool ``[n, HW]``: the cells where a placement may go — the cell and
    its 4 neighbours air (pogostick_v1_env.py:171-173), and ``ok_cell``
    (the 2-margin interior, not the agent's cell), whose cells have all 4
    neighbours in the map."""
    n = m.shape[0]
    air = (m == 0).reshape(n, H, H)
    nb4 = torch.zeros_like(air)
    nb4[:, 1:-1, 1:-1] = (air[:, :-2, 1:-1] & air[:, 2:, 1:-1]
                          & air[:, 1:-1, :-2] & air[:, 1:-1, 2:])
    return (air & nb4).reshape(n, H * H) & ok_cell


def _tap_cells(m, tab, not_agent):
    """Bool ``[n, 4, HW]``: plane d holds the air cells (not the agent's)
    one step in direction d from a tree — Pogostick-v0's tap candidates
    (pogostick_v0_env.py:155-178), direction-major as both resets pick
    from them."""
    n, H = m.shape[0], tab.H
    tree = (m == tab.tree).reshape(n, H, H)
    planes = []
    for dr, dc in S.FACING_DELTAS.tolist():
        here = torch.zeros_like(tree)
        here[:, max(dr, 0):H + min(dr, 0), max(dc, 0):H + min(dc, 0)] = \
            tree[:, max(-dr, 0):H + min(-dr, 0), max(-dc, 0):H + min(-dc, 0)]
        planes.append(here.reshape(n, H * H))
    return torch.stack(planes, dim=1) & ((m == 0) & not_agent)[:, None, :]


def _fence_blocks(centers, m, H):
    """Each center's 3x3 block, onto air (add_fence_around,
    pogostick_v1_env.py:524-536): bool ``[n, HW]``."""
    n = m.shape[0]
    c3 = torch.nn.functional.pad(centers.reshape(n, 1, H, H).float(),
                                 (1, 1, 1, 1))
    dil = torch.nn.functional.max_pool2d(c3, 3, stride=1)
    return (dil.reshape(n, H * H) > 0) & (m == 0)


def _fresh_state(m, acell, facing, inv, tab) -> EnvState:
    """A reset's ``EnvState`` from its map, agent cell, facing and
    inventory (int64 ``[n, ...]``), the start inventory's grants applied."""
    n, dev, H = m.shape[0], m.device, tab.H
    setv = torch.as_tensor(tab.inv_set).to(dtype=torch.int64,
                                           device=dev)[None, :]
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
        valid = _free_cells(m, ok_cell, H)
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
        # Pogostick-v0: one tree_tap next to a tree, the first maximal
        # score over the four direction planes
        cand = _tap_cells(m, tab, cells[None, :] != acell[:, None])
        u = torch.stack([_u01(seed, ctr, SALT_TAP0 + d, rows, cells)
                         for d in range(4)], dim=1)
        score = torch.where(cand, u, torch.full_like(u, -1.0)).reshape(
            n, 4 * HW)
        best = score.amax(dim=1)
        pick = torch.argmax(score, dim=1) % HW            # first max
        old = m.gather(1, pick[:, None])[:, 0]
        m = m.scatter(1, pick[:, None],
                      torch.where(best >= 0, tab.tap, old)[:, None])

    for j, (kind, a, b, lo, hi) in enumerate(tab.edits.tolist()):
        salt = SALT_EDIT0 + SALT_EDIT_STRIDE * j
        p = _randint(seed, ctr, salt, rows, col0, hi - lo)[:, 0] + lo
        eligible = ((m != 0) & (m != tab.wall)) if kind == EDIT_FENCE \
            else m == a
        sel = _select_n(eligible, ceil_percent(eligible.sum(dim=1), p,
                                               tab.cpairs),
                        seed, ctr, salt + 1, rows, tab.lane_bits)
        not_agent = cells[None, :] != acell[:, None]
        if kind == EDIT_FENCE:
            sel = _fence_blocks(sel, m, H)
        m = torch.where(sel & not_agent, b, m)

    inv = const(tab.inv_lo).expand(n, I)
    if tab.random_inv:
        bits = _bits(seed, ctr, SALT_INV, rows,
                     torch.arange(I, dtype=torch.int64, device=dev))
        inv = inv + (bits >> 1) % const(tab.inv_span)[None, :]
    return _fresh_state(m, acell, facing, inv, tab)


def counter_reset(spec, seed: int, ctr: int, n: int,
                  device="cuda") -> EnvState:
    """``n`` fresh states from one RNG stream: rows ``0..n-1`` under
    ``seed`` — the same states as ngx's ``make_xla_pool_reset(spec,
    n)(seed, ctr)``.  ``device`` defaults to the card and raises where
    there is none; pass ``device="cpu"`` for the CPU.  Under
    ``NGX_DEBUG=1`` the states' invariants are checked (ngx's
    ``make_reset`` hook, ``reset.py:209-215``)."""
    from ..ops.tables import resolve_device

    rows = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    state = reset_rows(ResetTables(spec), int(seed), int(ctr), rows)
    if debug.enabled():
        debug.kernel_asserts(spec, state, "reset")
    return state


def native_reset_state(tab: ResetTables, keys) -> EnvState:
    """ngx's native reset (``ngx/core/reset.py:114-205``) of each key of
    ``keys`` (int64 ``[n, 2]``, the words of ``jax.random.key_data``), on
    the keys' device: the state of ``jax.vmap(ngx.make_reset(spec))(keys)``
    without its obs.  On a CUDA device it is one launch of the reset kernel
    (:func:`ngx_torch.ops.native_reset.native_reset`), on the CPU its plain
    twin :func:`native_reset_plain`."""
    if keys.device.type == "cuda":
        from ..ops.native_reset import native_reset
        return native_reset(tab.spec, keys)
    return native_reset_plain(tab, keys)


def native_reset_where(tab: ResetTables, state: EnvState, done, keys=None,
                       parent=None, offset: int = 0) -> EnvState:
    """A step's carried state: row ``b`` of ``state`` where ``done[b]`` is
    false, else ngx's native reset of its key — ``keys[b]`` (``[B, 2]``),
    or row ``b + offset`` of ``split(parent, N)`` for any ``N`` past it
    (:func:`~ngx_torch.ops.threefry.split_at`; ``parent`` a key ``[2]``).
    On a CUDA device the reset kernel writes it in one launch, with no host
    read; on the CPU the done rows are found, drawn by
    :func:`native_reset_plain` and put in."""
    if state.device.type == "cuda":
        from ..ops.native_reset import native_reset
        return native_reset(tab.spec, keys, parent=parent, offset=offset,
                            state=state, done=done)
    idx = done.nonzero()[:, 0]
    if not idx.numel():
        return state
    rows = keys[idx] if keys is not None else TF.split_at(parent,
                                                          idx + offset)
    return state.put(idx, native_reset_plain(tab, rows))


def native_reset_plain(tab: ResetTables, keys) -> EnvState:
    """:func:`native_reset_state` in plain torch, on the keys' device: the
    CPU's path and the reset kernel's twin."""
    dev = keys.device
    n = keys.shape[0]
    H, I = tab.H, tab.I
    HW = H * H

    def const(a, dt=torch.int64):
        return torch.as_tensor(a).to(dtype=dt, device=dev)

    (k_agent, k_face, k_items, k_inv, k_coin, k_tap,
     k_edits) = TF.split(keys, 7).unbind(1)
    aidx = TF.randint(k_agent, (), 0, len(tab.interior_ids)).long()
    acell = const(tab.interior_ids)[aidx]
    facing = TF.randint(k_face, (), 0, 4).long()
    cells = torch.arange(HW, dtype=torch.int64, device=dev)
    not_agent = cells[None, :] != acell[:, None]
    neg_inf = torch.tensor(float("-inf"), device=dev)
    zero = torch.tensor(0.0, device=dev)

    def put(m, cell, value):
        return m.scatter(1, cell[:, None], value[:, None])

    def at(m, cell):
        return m.gather(1, cell[:, None])[:, 0]

    m = const(tab.base_flat).expand(n, HW).clone()
    if len(tab.placements):
        # one uniform draw over the free cells a placement (:86-113)
        k_place = TF.split(k_items, len(tab.placements))
        ok_cell = const(tab.interior_flat, torch.bool)[None, :] & not_agent
        for j, item in enumerate(tab.placements.tolist()):
            valid = _free_cells(m, ok_cell, H)
            pick = TF.categorical(k_place[:, j],
                                  torch.where(valid, zero, neg_inf))
            old = at(m, pick)
            m = put(m, pick, torch.where(valid.any(dim=1), item, old))

    if tab.random_inv:
        inv = TF.randint(k_inv, (I,), tab.inv_lo,
                         tab.inv_lo + tab.inv_span).long()
    else:
        inv = const(tab.inv_lo).expand(n, I)

    if tab.wall_coin:
        # v3: a wall in front of the agent on a coin, only onto air (:132-137)
        delta = const(S.FACING_DELTAS)[facing]
        fcell = acell + delta[:, 0] * H + delta[:, 1]
        front = at(m, fcell)
        coin = TF.bernoulli(k_coin, 0.5)
        m = put(m, fcell, torch.where(coin & (front == 0), tab.wall, front))

    if tab.place_tap:
        # Pogostick-v0: one tap, uniform over the (direction, cell) pairs
        # (:139-173)
        flat = _tap_cells(m, tab, not_agent).reshape(n, 4 * HW)
        pick = TF.categorical(k_tap, torch.where(flat, zero, neg_inf)) % HW
        m = put(m, pick, torch.where(flat.any(dim=1), tab.tap, at(m, pick)))

    for j, (kind, a, b, lo, hi) in enumerate(tab.edits.tolist()):
        # _percent_fill_fence / _percent_place (:248-290) on fold_in(k, j)
        k_p, k_shuf = TF.split(TF.fold_in(k_edits, j), 2).unbind(1)
        eligible = ((m != 0) & (m != tab.wall)) if kind == EDIT_FENCE \
            else m == a
        p = TF.randint(k_p, (), lo, hi).long()
        n_sel = ceil_percent(eligible.sum(dim=1), p, tab.cpairs)
        u = TF.uniform(k_shuf, (H, H)).reshape(n, HW)
        scores = torch.where(eligible, u, torch.tensor(float("inf"),
                                                       device=dev))
        order = torch.argsort(scores, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(1, order,
                                                cells.expand(n, HW))
        sel = eligible & (rank < n_sel[:, None])
        if kind == EDIT_FENCE:
            sel = _fence_blocks(sel, m, H)
        m = torch.where(sel & not_agent, b, m)
    return _fresh_state(m, acell, facing, inv, tab)


def make_reset(spec, device="cuda"):
    """``reset(keys) -> (state, obs)``: ngx's ``make_reset(spec)`` batched
    over keys, equal to ``jax.vmap(ngx.make_reset(spec))(keys)`` bit for
    bit.  ``keys``: int64 ``[B, 2]``, the words of ``jax.random.key_data``
    (:mod:`ngx_torch.ops.threefry` ``key`` / ``split`` make them), moved to
    ``device``.  ``device`` defaults to the card and raises where there is
    none; pass ``device="cpu"`` for the CPU.  Built under ``NGX_DEBUG=1``,
    each reset checks its states' invariants (ngx's hook,
    ``reset.py:209-215``)."""
    from ..ops.tables import resolve_device
    from .step import make_step

    dev = resolve_device(device)
    tab = ResetTables(spec)
    get_obs = make_step(spec, with_obs=False).get_obs
    check = debug.enabled()

    def reset(keys):
        keys = torch.as_tensor(keys).to(device=dev, dtype=torch.int64)
        if keys.dim() != 2 or keys.shape[1] != 2:
            raise ValueError(f"reset takes keys [B, 2], got "
                             f"{tuple(keys.shape)}")
        state = native_reset_state(tab, keys)
        if check:
            debug.kernel_asserts(spec, state, "reset")
        return state, get_obs(state)

    reset.device = dev
    return reset
