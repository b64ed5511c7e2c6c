"""Scripted experts — demo generators for BC warm-starts; the port's numpy
copy of ``ngx/rl/experts.py`` (importing any ``ngx`` module imports jax).

The reference records *human* expert demonstrations
(``tests/record_expert_demonstrations.py``); these are the automated
equivalent: host-side policies over the compat facade
(:mod:`ngx_torch.compat`, whose properties read one host snapshot of the
state) that actually solve the tasks, used by ``ngx_torch.cli.record_demos
-policy expert`` to produce the ExpertDataset ``.npz`` that
``ngx_torch.rl.bc`` consumes.

Covered: all 11 envs.  The pogo-stick craft chain (Pogostick-v0/v1, v6, and
v5's fused/table-gated variant — break trees, craft planks/sticks, craft the
tap at the table, place it next to a tree, extract rubber, craft the pogo
stick), the bow chain (Bow-v0/v1), and the legacy single-goal envs v0–v4
(face the table / break 3 trees / craft-to-quota / craft-at-table / fused
place+extract).  The experts are pure functions of the live env state — no
memory — so they recover from any intermediate state.  They solve every
solvable episode; the one source of unsolvable episodes is v3's random
starting inventory (plank<5 and stick<4 affords neither recipe — ~12.5% of
resets, novel_gridworld_v3_env.py:45-47).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..core.spec import TURN_LEFT, FACING_DELTAS


def _bfs_next(env, goals):
    """First move (dr, dc) along a shortest air-cell path from the agent to
    any cell in ``goals`` (set of (r, c)); None if unreachable/already there."""
    m = env.map
    H = m.shape[0]
    start = tuple(env.agent_location)
    if start in goals:
        return None
    prev = {start: None}
    q = deque([start])
    while q:
        cur = q.popleft()
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            nxt = (cur[0] + dr, cur[1] + dc)
            if nxt in prev or not (0 <= nxt[0] < H and 0 <= nxt[1] < H):
                continue
            if nxt in goals:
                prev[nxt] = cur
                node = nxt
                while prev[node] != start:
                    node = prev[node]
                return (node[0] - start[0], node[1] - start[1])
            if m[nxt] == 0:                      # walkable == air
                prev[nxt] = cur
                q.append(nxt)
    return None


def _face_or_move(env, want_delta):
    """Action id that turns toward / moves along ``want_delta`` (dr, dc)."""
    A = env.actions_id
    want = next(f for f in range(4)
                if tuple(FACING_DELTAS[f]) == tuple(want_delta))
    f = env.agent_facing_id
    if f == want:
        return A["Forward"]
    return A["Left"] if int(TURN_LEFT[f]) == want else A["Right"]


def _goto_adjacent_and(env, targets, action_name):
    """Navigate until the agent faces a cell in ``targets``, then emit
    ``action_name``.  Returns an action id, or None if no target reachable."""
    A = env.actions_id
    r, c = env.agent_location
    for f in range(4):
        dr, dc = FACING_DELTAS[f]
        if (r + dr, c + dc) in targets:
            if env.agent_facing_id == f:
                return A[action_name]
            return (A["Left"] if int(TURN_LEFT[env.agent_facing_id]) == f
                    else A["Right"])
    step = _bfs_next(env, targets)
    if step is None:
        return None
    return _face_or_move(env, step)


def _cells_of(env, item):
    m = env.map
    iid = env.items_id.get(item)
    if iid is None:
        return set()
    return {tuple(x) for x in np.argwhere(m == iid)}


def _tap_spots(env, trees):
    """Air cells 4-adjacent to a tree — valid tree_tap placement targets
    (is_block_in_front_next_to, pogostick_v1_env.py:391-411)."""
    m = env.map
    H = m.shape[0]
    spots = set()
    for (tr, tc) in trees:
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            rr, cc = tr + dr, tc + dc
            if 0 <= rr < H and 0 <= cc < H and m[rr, cc] == 0:
                spots.add((rr, cc))
    return spots


def _place_into_spot(env, spots, place_name):
    """Action that works toward placing into one of ``spots``.  Facing (or
    navigating to) a spot the agent is NOT standing on comes first — placing
    into an adjacent spot works fine from atop another spot, which also
    breaks the ping-pong between two mutually adjacent spots.  Only when the
    agent's own cell is the sole spot does it step off (next tick it faces
    the vacated cell and places)."""
    here = tuple(env.agent_location)
    others = spots - {here}
    if others:
        a = _goto_adjacent_and(env, others, place_name)
        if a is not None:
            return a
    if here in spots:
        m = env.map
        r, c = here
        for f in range(4):
            dr, dc = FACING_DELTAS[f]
            if m[r + dr, c + dc] == 0:
                return _face_or_move(env, (dr, dc))
    return None


def _pogo_chain_expert(env, place_name, extract_name, craft_anywhere) -> int:
    """One expert action for the pogo-stick craft chain.

    Craft math (pogostick_v1_env.py:56-59): pogo = 4 stick + 2 plank +
    1 rubber (at table); tap = 5 plank + 1 stick (at table); stick = 2 plank
    -> 4; plank = 1 tree_log -> 4.  On the modern envs single-ingredient
    crafts work anywhere (``craft_anywhere``); legacy v5 requires the table
    in front for every craft (CRAFT_LEGACY_TABLE_FIRST) and fuses
    place+extract into one action (``place_name == extract_name``)."""
    A = env.actions_id
    inv = env.inventory_items_quantity
    plank, stick = inv.get("plank", 0), inv.get("stick", 0)
    logs, rubber = inv.get("tree_log", 0), inv.get("rubber", 0)
    tap_inv = inv.get("tree_tap", 0)
    table = _cells_of(env, "crafting_table")
    trees = _cells_of(env, "tree_log")
    taps = _cells_of(env, "tree_tap")

    # 1. endgame: craft the pogo stick at the table
    if rubber >= 1 and stick >= 4 and plank >= 2:
        a = _goto_adjacent_and(env, table, "Craft_pogo_stick")
        if a is not None:
            return a

    # 2. rubber: extract from a LIVE tap (one still 4-adjacent to a tree —
    # extraction fails otherwise, pogostick_v1_env.py:319-328), else place
    # the tap, else recover a stranded tap by breaking it, else craft one
    def _adj4(cell):
        r, c = cell
        return {(r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)}

    live_taps = {t for t in taps if _adj4(t) & trees}
    if rubber < 1:
        if live_taps:
            a = _goto_adjacent_and(env, live_taps, extract_name)
            if a is not None:
                return a
            # live tap fully enclosed by items (Pogostick-v0 spawns sticks/
            # planks that can box the pre-placed tap in): break a blocking
            # neighbor — never a tree (stranding) nor the crafting table —
            # to open an extraction spot
            m = env.map
            iid = env.items_id
            keep_ids = {0, iid.get("wall", -1), iid.get("tree_log", -1),
                        iid.get("crafting_table", -1)}
            blockers = set()
            for t in live_taps:
                for cell in _adj4(t):
                    if int(m[cell]) not in keep_ids:
                        blockers.add(cell)
            if blockers:
                a = _goto_adjacent_and(env, blockers, "Break")
                if a is not None:
                    return a
        if tap_inv >= 1 and trees:
            a = _place_into_spot(env, _tap_spots(env, trees), place_name)
            if a is not None:
                return a
        if taps and not live_taps and tap_inv < 1 and trees:
            # a stranded tap (its tree was broken): break it back into the
            # inventory, then the branch above re-places it next to a live
            # tree
            a = _goto_adjacent_and(env, taps, "Break")
            if a is not None:
                return a
        if tap_inv < 1 and plank >= 5 and stick >= 1:
            a = _goto_adjacent_and(env, table, "Craft_tree_tap")
            if a is not None:
                return a

    # 3. resource gathering.  Remaining needs: tap (5 plank + 1 stick) if not
    # secured, pogo (2 plank + 4 stick); stick crafts cost 2 plank for 4.
    tap_secured = tap_inv >= 1 or bool(taps) or rubber >= 1
    stick_target = 4 if tap_secured else 5
    plank_target = 2 if tap_secured else 7
    plank_for_sticks = 2 * -(-max(stick_target - stick, 0) // 4)
    plank_goal = plank_target + plank_for_sticks

    def craft(name):
        if craft_anywhere:
            return A[name]
        return _goto_adjacent_and(env, table, name)

    if plank >= plank_goal and stick < stick_target:
        a = craft("Craft_stick")
        if a is not None:
            return a
    if plank < plank_goal:
        if logs >= 1:
            a = craft("Craft_plank")
            if a is not None:
                return a
        # keep one tree standing for the tap, and NEVER break a live tap's
        # adjacent tree before rubber is secured (breaking it strands the
        # tap — the round-4 measured expert failure mode on Pogostick-v0)
        protected = set()
        if rubber < 1:
            for t in taps:
                protected |= _adj4(t) & trees
        candidates = trees - protected
        breakable = (candidates if (tap_secured or len(trees) > 1)
                     and candidates else set())
        if breakable:
            a = _goto_adjacent_and(env, breakable, "Break")
            if a is not None:
                return a
    # fallback: wander (turn rather than push into a blocked cell)
    a = _goto_adjacent_and(env, table, "Left")
    return a if a is not None else A["Left"]


def pogostick_expert(env) -> int:
    """Pogostick-v1 / v6: separate place & extract, crafts anywhere for
    single-ingredient recipes (multi-ingredient routed to the table)."""
    return _pogo_chain_expert(env, "Place_tree_tap", "Extract_rubber",
                              craft_anywhere=True)


def v5_expert(env) -> int:
    """NovelGridworld-v5: fused Place_tree_tap_Extract_rubber, every craft
    requires the table in front (CRAFT_LEGACY_TABLE_FIRST,
    novel_gridworld_v5_env.py:355-434)."""
    fused = "Place_tree_tap_Extract_rubber"
    return _pogo_chain_expert(env, fused, fused, craft_anywhere=False)


def bow_expert(env) -> int:
    """Bow-v0/v1: bow = 3 stick + 3 string at the table; string extracted
    from wool (4 per extract); stick/plank single-ingredient crafts
    (bow_v0_env.py:55-57,293-304)."""
    A = env.actions_id
    inv = env.inventory_items_quantity
    plank, stick = inv.get("plank", 0), inv.get("stick", 0)
    string, logs = inv.get("string", 0), inv.get("tree_log", 0)
    table = _cells_of(env, "crafting_table")

    if stick >= 3 and string >= 3:
        a = _goto_adjacent_and(env, table, "Craft_bow")
        if a is not None:
            return a
    if string < 3:
        wool = _cells_of(env, "wool")
        if wool:                                   # Bow-v1: extract from wool
            a = _goto_adjacent_and(env, wool, "Extract_string")
            if a is not None:
                return a
        cells = _cells_of(env, "string")           # Bow-v0: break string blocks
        if cells:
            a = _goto_adjacent_and(env, cells, "Break")
            if a is not None:
                return a
    if stick < 3:
        if plank >= 2:
            return A["Craft_stick"]
        if logs >= 1:
            return A["Craft_plank"]
        trees = _cells_of(env, "tree_log")
        if trees:                                  # Bow-v1: craft from trees
            a = _goto_adjacent_and(env, trees, "Break")
            if a is not None:
                return a
        cells = _cells_of(env, "stick")            # Bow-v0: break stick blocks
        if cells:
            a = _goto_adjacent_and(env, cells, "Break")
            if a is not None:
                return a
    a = _goto_adjacent_and(env, table, "Left")
    return a if a is not None else A["Left"]


def v0_expert(env) -> int:
    """v0: walk to the crafting table and face it (done condition,
    novel_gridworld_v0_env.py:237-239)."""
    table = _cells_of(env, "crafting_table")
    a = _goto_adjacent_and(env, table, "Forward")
    # facing the table already triggers done post-step; Forward is harmless
    return a if a is not None else env.actions_id["Left"]


def v1_expert(env) -> int:
    """v1: break trees until tree_log >= 3 (goal,
    novel_gridworld_v1_env.py:264; Break +10 on tree, :246-257)."""
    trees = _cells_of(env, "tree_log")
    a = _goto_adjacent_and(env, trees, "Break") if trees else None
    return a if a is not None else env.actions_id["Left"]


def v2_expert(env) -> int:
    """v2: craft to 8 plank + 8 stick from the starting 3 tree_log
    (novel_gridworld_v2_env.py:44,49,260).  Both recipes are
    single-ingredient (plank: 1 log -> 4; stick: 2 plank -> 4) so no table
    navigation exists — the action set is crafts only.  Craft planks until
    the pool covers the 8-plank goal plus 2 per remaining stick craft, THEN
    sticks (also dodging the stick-before-8-plank nag, v2:315-325)."""
    A = env.actions_id
    inv = env.inventory_items_quantity
    plank, stick, logs = (inv.get("plank", 0), inv.get("stick", 0),
                          inv.get("tree_log", 0))
    need_stick_crafts = -(-max(8 - stick, 0) // 4)
    plank_goal = 8 + 2 * need_stick_crafts
    if plank < plank_goal and logs >= 1:
        return A["Craft_plank"]
    if stick < 8 and plank >= 2:
        return A["Craft_stick"]
    # dead end (the env will flag it, v2:263-266) — any action
    return A["Craft_plank"]


def v3_expert(env) -> int:
    """v3: craft a tree_tap (5 plank + 1 stick) or a pogo_stick (4 stick +
    2 plank + 1 rubber) at the table — whichever the random starting
    inventory (plank~U[2,10], stick~U[1,8], rubber=1,
    novel_gridworld_v3_env.py:45-47) affords.  Both recipes are
    multi-ingredient, so the table must be in front (v3:360-369).  Episodes
    with plank<5 and stick<4 are unsolvable by construction (no
    inventory-growing action exists) — the expert ceiling is ~87.5%."""
    A = env.actions_id
    inv = env.inventory_items_quantity
    plank, stick, rubber = (inv.get("plank", 0), inv.get("stick", 0),
                            inv.get("rubber", 0))
    table = _cells_of(env, "crafting_table")
    if plank >= 5 and stick >= 1:
        a = _goto_adjacent_and(env, table, "Craft_tree_tap")
        if a is not None:
            return a
    if stick >= 4 and plank >= 2 and rubber >= 1:
        a = _goto_adjacent_and(env, table, "Craft_pogo_stick")
        if a is not None:
            return a
    return A["Left"]


def v4_expert(env) -> int:
    """v4: one fused Place_tree_tap_Extract_rubber while facing an air cell
    4-adjacent to a tree reaches the rubber goal immediately
    (novel_gridworld_v4_env.py:277-305,312); if a tap is already on the map
    (restore chaining), extract by facing it instead (:299-303)."""
    A = env.actions_id
    fused = "Place_tree_tap_Extract_rubber"
    taps = _cells_of(env, "tree_tap")
    if taps:
        a = _goto_adjacent_and(env, taps, fused)
        if a is not None:
            return a
    trees = _cells_of(env, "tree_log")
    a = _place_into_spot(env, _tap_spots(env, trees), fused) if trees else None
    return a if a is not None else A["Left"]


EXPERTS = {
    "NovelGridworld-v0": v0_expert,
    "NovelGridworld-v1": v1_expert,
    "NovelGridworld-v2": v2_expert,
    "NovelGridworld-v3": v3_expert,
    "NovelGridworld-v4": v4_expert,
    "NovelGridworld-v5": v5_expert,
    "NovelGridworld-v6": pogostick_expert,
    "NovelGridworld-Bow-v0": bow_expert,
    "NovelGridworld-Bow-v1": bow_expert,
    "NovelGridworld-Pogostick-v0": pogostick_expert,
    "NovelGridworld-Pogostick-v1": pogostick_expert,
}


def get_expert(env_id: str):
    if env_id not in EXPERTS:
        raise KeyError(f"no scripted expert for {env_id}; "
                       f"available: {sorted(EXPERTS)}")
    return EXPERTS[env_id]
