"""Presets for the "legacy" env template: NovelGridworld-v0 … v5.

The port's copy of ``ngx/presets/legacy.py`` (tests/test_torch_spec.py holds
the two equal).

Legacy envs have small fixed action dicts, no step-cost economy, no
selected-item/entities machinery, and lidar-array observations
(novel_gridworld_v1_env.py:25-65).  All of that is just different spec data —
the same step kernel runs them.
"""

from __future__ import annotations

import numpy as np

from ..core import spec as S
from ..core.spec import EnvSpec, set_items_id, recipes_to_arrays

_LEGACY_ITEMS = ("crafting_table", "plank", "pogo_stick", "rubber", "stick",
                 "tree_log", "tree_tap", "wall")
# legacy v2-v5 recipe book (novel_gridworld_v5_env.py:51-56)
_LEGACY_RECIPES = {
    "pogo_stick": {"input": {"stick": 4, "plank": 2, "rubber": 1}, "output": {"pogo_stick": 1}},
    "stick": {"input": {"plank": 2}, "output": {"stick": 4}},
    "plank": {"input": {"tree_log": 1}, "output": {"plank": 4}},
    "tree_tap": {"input": {"plank": 5, "stick": 1}, "output": {"tree_tap": 1}},
    "crafting_table": {"input": {"plank": 4}, "output": {"crafting_table": 1}},
}
_LIDAR_ITEMS = ("crafting_table", "tree_log", "wall")  # novel_gridworld_v1_env.py:55


def _legacy_spec(env_id, actions, spawn, goal_counts_d, goal_any,
                 deadend_items=(), craft_variant=S.CRAFT_LEGACY_TABLE_FIRST,
                 craft_nag=S.NAG_NONE, start_inv=None, start_inv_rand=None,
                 break_tree_bonus=False, reset_wall_coin=False, map_size=10,
                 obs_mode=S.OBS_LIDAR_INV, items=_LEGACY_ITEMS,
                 recipes=_LEGACY_RECIPES, num_beams=8, max_beam_range=40):
    items_t = set_items_id(set(items) | {"air"}, with_air=True)
    iid = {n: i for i, n in enumerate(items_t)}
    I = len(items_t)

    rec_names, rin, rout, multi, rin_order = recipes_to_arrays(recipes, items_t)
    R = len(rec_names)

    names, ops, args = [], [], []
    for nm, op, argn in actions:
        names.append(nm)
        ops.append(op)
        if op == S.OP_CRAFT:
            args.append(rec_names.index(argn))
        else:
            args.append(iid[argn] if argn else 0)

    unb = np.zeros((I,), bool)
    unb[0] = True
    if "wall" in iid:
        unb[iid["wall"]] = True

    # legacy Break: +10 tree_log, −10 anything else (novel_gridworld_v1_env.py:246-257)
    break_reward = np.full((I,), -10.0, dtype=np.float32)
    if break_tree_bonus and "tree_log" in iid:
        break_reward[iid["tree_log"]] = 10.0

    goal_counts = np.zeros((I,), np.int32)
    for it, q in goal_counts_d.items():
        goal_counts[iid[it]] = q

    deadend = np.zeros((R,), bool)
    for it in deadend_items:
        deadend[rec_names.index(it)] = True

    inv_lo = np.zeros((I,), np.int32)
    inv_hi = np.zeros((I,), np.int32)
    for it, q in (start_inv or {}).items():
        inv_lo[iid[it]] = q
        inv_hi[iid[it]] = q
    for it, (lo, hi) in (start_inv_rand or {}).items():
        inv_lo[iid[it]] = lo
        inv_hi[iid[it]] = hi

    A = len(names)
    return EnvSpec(
        env_id=env_id,
        map_size=map_size,
        items=items_t,
        unbreakable=unb,
        entity_mask=np.zeros((I,), bool),
        inventory_tracked=env_id != "NovelGridworld-v0",
        actions=tuple(names),
        action_op=np.asarray(ops, np.int32),
        action_arg=np.asarray(args, np.int32),
        action_cost_success=np.zeros((A,), np.float32),  # legacy: no step costs
        action_cost_fail=np.zeros((A,), np.float32),
        recipe_names=rec_names,
        recipe_input_order=rin_order,
        recipes_in=rin,
        recipes_out=rout,
        recipe_multi=multi,
        craft_cost_success=np.zeros((R,), np.float32),
        craft_cost_missing=np.zeros((R,), np.float32),
        craft_cost_no_table=np.zeros((R,), np.float32),
        craft_variant=craft_variant,
        craft_nag=craft_nag,
        craft_success_reward=10.0,
        crafting_table_id=iid.get("crafting_table", -1),
        break_reward=break_reward,
        break_yield=np.ones((I,), np.int32),
        break_cost=0.0,
        place_adjacent_item=iid.get("tree_log", -1),
        extract_amount=0,
        extract_yield_item=-1,
        extract_source_item=-1,
        goal_mode=S.GOAL_FRONT_ITEM if env_id == "NovelGridworld-v0" else S.GOAL_INVENTORY,
        goal_any=goal_any,
        goal_counts=goal_counts,
        goal_front_item=iid.get("crafting_table", -1) if env_id == "NovelGridworld-v0" else -1,
        goal_item=-1,
        deadend_recipes=deadend,
        reward_step=-1.0,
        reward_intermediate=10.0,
        reward_done=50.0,
        break_wrong_reward_default=-10.0,
        spawn_items=np.asarray([iid[n] for n, _ in spawn], np.int32),
        spawn_qty=np.asarray([q for _, q in spawn], np.int32),
        start_inv_lo=inv_lo,
        start_inv_hi=inv_hi,
        reset_wall_coin=reset_wall_coin,
        grab_entities_enabled=False,   # legacy envs have no entities machinery
        obs_mode=obs_mode,
        lidar_items=_LIDAR_ITEMS if obs_mode == S.OBS_LIDAR_INV else (),
        lidar_num_beams=num_beams,
        lidar_max_range=max_beam_range,
    )


_MOVE = (("Forward", S.OP_FORWARD, None),
         ("Left", S.OP_LEFT, None),
         ("Right", S.OP_RIGHT, None))


def novelgridworld_v0(map_size=10) -> EnvSpec:
    """Goal: face the crafting_table; 5-beam 180° lidar
    (novel_gridworld_v0_env.py:26-62,136-173,236-239)."""
    return _legacy_spec(
        "NovelGridworld-v0",
        actions=_MOVE,
        spawn=(("crafting_table", 1),),
        goal_counts_d={}, goal_any=False,
        items=("crafting_table", "wall"), recipes={},
        obs_mode=S.OBS_LIDAR_V0, num_beams=5,
        map_size=map_size,
        # hypotenuse of the interior square, frozen at construction
        # (novel_gridworld_v0_env.py:54) — later reset(map_size=N) keeps it
        max_beam_range=int(np.sqrt(2 * (map_size - 2) ** 2)),
    )


def novelgridworld_v1(map_size=10) -> EnvSpec:
    """Goal: 3 tree_log; Break ±10 (novel_gridworld_v1_env.py:37-60,246-266)."""
    return _legacy_spec(
        "NovelGridworld-v1",
        actions=_MOVE + (("Break", S.OP_BREAK, None),),
        spawn=(("crafting_table", 1), ("tree_log", 5)),
        goal_counts_d={"tree_log": 3}, goal_any=False,
        recipes={}, break_tree_bonus=True,
        map_size=map_size,
    )


def novelgridworld_v2(map_size=10) -> EnvSpec:
    """Goal: 8 plank + 8 stick; crafts only; dead-end termination; no
    crafting-table requirement (novel_gridworld_v2_env.py:42-56,236-325)."""
    return _legacy_spec(
        "NovelGridworld-v2",
        actions=(("Craft_plank", S.OP_CRAFT, "plank"),
                 ("Craft_stick", S.OP_CRAFT, "stick")),
        spawn=(("crafting_table", 1), ("tree_log", 2)),
        goal_counts_d={"plank": 8, "stick": 8}, goal_any=False,
        deadend_items=("plank", "stick"),
        craft_variant=S.CRAFT_LEGACY_NO_TABLE, craft_nag=S.NAG_V2,
        start_inv={"tree_log": 3},
        map_size=map_size,
    )


def novelgridworld_v3(map_size=10) -> EnvSpec:
    """Goal: 1 tree_tap OR 1 pogo_stick; random start inventory; 50% wall in
    front at reset (novel_gridworld_v3_env.py:42-53,148-152,301-305)."""
    return _legacy_spec(
        "NovelGridworld-v3",
        actions=_MOVE + (("Craft_tree_tap", S.OP_CRAFT, "tree_tap"),
                         ("Craft_pogo_stick", S.OP_CRAFT, "pogo_stick")),
        spawn=(("crafting_table", 1), ("tree_log", 2)),
        goal_counts_d={"tree_tap": 1, "pogo_stick": 1}, goal_any=True,
        deadend_items=("tree_tap", "pogo_stick"),
        craft_variant=S.CRAFT_LEGACY_TABLE_FIRST,
        start_inv={"rubber": 1},
        start_inv_rand={"plank": (2, 10), "stick": (1, 8)},
        reset_wall_coin=True,
        map_size=map_size,
    )


def novelgridworld_v4(map_size=10) -> EnvSpec:
    """Goal: 1 rubber via the fused Place_tree_tap_Extract_rubber action
    (novel_gridworld_v4_env.py:43-50,277-305,312-315)."""
    return _legacy_spec(
        "NovelGridworld-v4",
        actions=_MOVE + (("Place_tree_tap_Extract_rubber",
                          S.OP_FUSED_PLACE_EXTRACT, None),),
        spawn=(("crafting_table", 1), ("tree_log", 2)),
        goal_counts_d={"rubber": 1}, goal_any=False,
        craft_variant=S.CRAFT_LEGACY_TABLE_FIRST, craft_nag=S.NAG_V4,
        start_inv={"tree_tap": 1},
        map_size=map_size,
    )


def novelgridworld_v5(map_size=10) -> EnvSpec:
    """Goal: 1 pogo_stick; superset of v1-v4 actions
    (novel_gridworld_v5_env.py:48-56,270-355)."""
    return _legacy_spec(
        "NovelGridworld-v5",
        actions=_MOVE + (("Break", S.OP_BREAK, None),
                         ("Place_tree_tap_Extract_rubber",
                          S.OP_FUSED_PLACE_EXTRACT, None),
                         ("Craft_plank", S.OP_CRAFT, "plank"),
                         ("Craft_stick", S.OP_CRAFT, "stick"),
                         ("Craft_tree_tap", S.OP_CRAFT, "tree_tap"),
                         ("Craft_pogo_stick", S.OP_CRAFT, "pogo_stick")),
        spawn=(("crafting_table", 1), ("tree_log", 5)),
        goal_counts_d={"pogo_stick": 1}, goal_any=False,
        craft_variant=S.CRAFT_LEGACY_TABLE_FIRST, craft_nag=S.NAG_NONE,
        break_tree_bonus=True,
        map_size=map_size,
    )
