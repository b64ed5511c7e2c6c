"""Presets for the "modern" env template: Bow-v0/v1, Pogostick-v0/v1 and the
deprecated NovelGridworld-v6 (which is Pogostick-v1 mechanics under another id —
reference ``novel_gridworld_v6_env.py:25-30``).

The port's copy of ``ngx/presets/modern.py`` (tests/test_torch_spec.py holds
the two equal).  Every env is a pure
:class:`~ngx_torch.core.spec.EnvSpec`; the numbers cite the reference
file/lines they reproduce.
"""

from __future__ import annotations

import numpy as np

from ..core import spec as S
from ..core.spec import EnvSpec, set_items_id, recipes_to_arrays

# Modern manipulation step costs — pogostick_v1_env.py:257,268,279,294,314,316-325
COST_FORWARD = 27.906975
COST_TURN = 24.0
COST_BREAK = 3600.0
COST_PLACE = 300.0
COST_SELECT = 120.0

# Craft step costs by crafted item — pogostick_v1_env.py:433-436,447-450,463-470
# and bow_v0_env.py:406-437
CRAFT_COST_SUCCESS = {"plank": 1200.0, "stick": 2400.0, "tree_tap": 7200.0,
                      "pogo_stick": 8400.0, "bow": 8400.0}
CRAFT_COST_MISSING = {"tree_tap": 360.0, "pogo_stick": 480.0, "bow": 480.0}
CRAFT_COST_NO_TABLE = {"tree_tap": 720.0, "pogo_stick": 840.0, "bow": 840.0}

POGO_RECIPES = {
    # pogostick_v1_env.py:56-59
    "pogo_stick": {"input": {"stick": 4, "plank": 2, "rubber": 1}, "output": {"pogo_stick": 1}},
    "stick": {"input": {"plank": 2}, "output": {"stick": 4}},
    "plank": {"input": {"tree_log": 1}, "output": {"plank": 4}},
    "tree_tap": {"input": {"plank": 5, "stick": 1}, "output": {"tree_tap": 1}},
}
BOW_RECIPES = {
    # bow_v0_env.py:55-57
    "bow": {"input": {"stick": 3, "string": 3}, "output": {"bow": 1}},
    "stick": {"input": {"plank": 2}, "output": {"stick": 4}},
    "plank": {"input": {"tree_log": 1}, "output": {"plank": 4}},
}


def modern_spec(env_id, item_set, recipes, goal_item, spawn, manipulation,
                break_bonus_items, craft_success_reward, extract,
                map_size=10, reset_place_tap=False, unbreakable=("air", "wall")):
    """Build a modern-template EnvSpec.

    ``manipulation``: ordered (name, opcode, arg_name, cost_ok, cost_fail);
    ``extract``: dict(source, yield_item, amount) or None;
    ``spawn``: ordered (item, qty) — insertion order matters for reset RNG.
    """
    items = set_items_id(item_set, with_air=True)
    iid = {n: i for i, n in enumerate(items)}
    I = len(items)

    rec_names, rin, rout, multi, rin_order = recipes_to_arrays(recipes, items)
    R = len(rec_names)

    # action layout: manipulation, Craft_* sorted, Select_* sorted
    # (pogostick_v1_env.py:52-68)
    names, ops, args, c_ok, c_fail = [], [], [], [], []
    for (nm, op, argn, ok, fl) in manipulation:
        names.append(nm)
        ops.append(op)
        args.append(iid[argn] if argn else 0)
        c_ok.append(ok)
        c_fail.append(fl)
    for r, rn in enumerate(rec_names):
        names.append("Craft_" + rn)
        ops.append(S.OP_CRAFT)
        args.append(r)
        c_ok.append(0.0)
        c_fail.append(0.0)
    selectable = sorted(set(items) ^ set(unbreakable))
    for it in selectable:
        names.append("Select_" + it)
        ops.append(S.OP_SELECT)
        args.append(iid[it])
        c_ok.append(COST_SELECT)
        c_fail.append(COST_SELECT)

    unb = np.zeros((I,), bool)
    for u in unbreakable:
        unb[iid[u]] = True

    break_reward = np.full((I,), -1.0, dtype=np.float32)
    for it in break_bonus_items:
        break_reward[iid[it]] = 10.0  # reward_intermediate

    goal_counts = np.zeros((I,), np.int32)
    goal_counts[iid[goal_item]] = 1

    return EnvSpec(
        env_id=env_id,
        map_size=map_size,
        items=items,
        unbreakable=unb,
        entity_mask=np.zeros((I,), bool),
        inventory_tracked=True,
        actions=tuple(names),
        action_op=np.asarray(ops, np.int32),
        action_arg=np.asarray(args, np.int32),
        action_cost_success=np.asarray(c_ok, np.float32),
        action_cost_fail=np.asarray(c_fail, np.float32),
        recipe_names=rec_names,
        recipe_input_order=rin_order,
        recipes_in=rin,
        recipes_out=rout,
        recipe_multi=multi,
        craft_cost_success=np.asarray(
            [CRAFT_COST_SUCCESS.get(n, 0.0) for n in rec_names], np.float32),
        craft_cost_missing=np.asarray(
            [CRAFT_COST_MISSING.get(n, 0.0) for n in rec_names], np.float32),
        craft_cost_no_table=np.asarray(
            [CRAFT_COST_NO_TABLE.get(n, 0.0) for n in rec_names], np.float32),
        craft_variant=S.CRAFT_MODERN,
        craft_nag=S.NAG_NONE,
        craft_success_reward=craft_success_reward,
        crafting_table_id=iid.get("crafting_table", -1),
        break_reward=break_reward,
        break_yield=np.ones((I,), np.int32),
        break_cost=COST_BREAK,
        place_adjacent_item=iid.get("tree_log", -1),
        extract_amount=extract["amount"] if extract else 0,
        extract_yield_item=iid[extract["yield_item"]] if extract else -1,
        extract_source_item=iid[extract["source"]] if extract else -1,
        goal_mode=S.GOAL_INVENTORY,
        goal_any=False,
        goal_counts=goal_counts,
        goal_front_item=-1,
        goal_item=iid[goal_item],
        deadend_recipes=np.zeros((R,), bool),
        reward_step=-1.0,
        reward_intermediate=10.0,
        reward_done=50.0,
        break_wrong_reward_default=-1.0,
        spawn_items=np.asarray([iid[n] for n, _ in spawn], np.int32),
        spawn_qty=np.asarray([q for _, q in spawn], np.int32),
        reset_place_tap=reset_place_tap,
        obs_mode=S.OBS_DICT,
    )


_POGO_ITEMS = {"air", "crafting_table", "plank", "pogo_stick", "rubber",
               "stick", "tree_log", "tree_tap", "wall"}
_BOW_ITEMS = {"air", "bow", "crafting_table", "plank", "stick", "string",
              "tree_log", "wall", "wool"}

# pogostick_v1_env.py:53-54,295-331
_POGO_MANIP = (
    ("Forward", S.OP_FORWARD, None, COST_FORWARD, COST_FORWARD),
    ("Left", S.OP_LEFT, None, COST_TURN, COST_TURN),
    ("Right", S.OP_RIGHT, None, COST_TURN, COST_TURN),
    ("Break", S.OP_BREAK, None, COST_BREAK, COST_BREAK),
    ("Place_tree_tap", S.OP_PLACE, "tree_tap", COST_PLACE, COST_PLACE),
    ("Extract_rubber", S.OP_EXTRACT_RUBBER, None, 50000.0, 120.0),
)
# bow_v0_env.py:53,293-304
_BOW_MANIP = (
    ("Forward", S.OP_FORWARD, None, COST_FORWARD, COST_FORWARD),
    ("Left", S.OP_LEFT, None, COST_TURN, COST_TURN),
    ("Right", S.OP_RIGHT, None, COST_TURN, COST_TURN),
    ("Break", S.OP_BREAK, None, COST_BREAK, COST_BREAK),
    ("Extract_string", S.OP_EXTRACT_STRING, None, 5000.0, 120.0),
)


def pogostick_v1(map_size=10) -> EnvSpec:
    """NovelGridworld-Pogostick-v1 — pogostick_v1_env.py:26-84."""
    return modern_spec(
        "NovelGridworld-Pogostick-v1", _POGO_ITEMS, POGO_RECIPES, "pogo_stick",
        spawn=(("crafting_table", 1), ("tree_log", 5)),
        manipulation=_POGO_MANIP,
        break_bonus_items=("tree_log",),          # pogostick_v1_env.py:288-289
        craft_success_reward=10.0,                # :455
        extract={"source": "tree_tap", "yield_item": "rubber", "amount": 1},
        map_size=map_size,
    )


def pogostick_v0(map_size=10) -> EnvSpec:
    """NovelGridworld-Pogostick-v0 — pogostick_v0_env.py:44,155-178,312,479."""
    return modern_spec(
        "NovelGridworld-Pogostick-v0", _POGO_ITEMS, POGO_RECIPES, "pogo_stick",
        spawn=(("crafting_table", 1), ("stick", 4), ("plank", 2), ("tree_log", 2)),
        manipulation=_POGO_MANIP,
        break_bonus_items=("stick", "plank"),
        craft_success_reward=50.0,
        extract={"source": "tree_tap", "yield_item": "rubber", "amount": 1},
        map_size=map_size,
        reset_place_tap=True,
    )


def novelgridworld_v6(map_size=10) -> EnvSpec:
    """NovelGridworld-v6 — byte-for-byte Pogostick-v1 mechanics
    (novel_gridworld_v6_env.py)."""
    return pogostick_v1(map_size).replace(env_id="NovelGridworld-v6")


def bow_v0(map_size=10) -> EnvSpec:
    """NovelGridworld-Bow-v0 — bow_v0_env.py:39-66,286,424."""
    return modern_spec(
        "NovelGridworld-Bow-v0", _BOW_ITEMS, BOW_RECIPES, "bow",
        spawn=(("crafting_table", 1), ("stick", 3), ("string", 3)),
        manipulation=_BOW_MANIP,
        break_bonus_items=("stick", "string"),
        craft_success_reward=10.0,
        extract={"source": "wool", "yield_item": "string", "amount": 4},
        map_size=map_size,
    )


def bow_v1(map_size=10) -> EnvSpec:
    """NovelGridworld-Bow-v1 — diffs vs Bow-v0: spawn, break bonus item,
    craft-success reward (bow_v1_env.py:44,286,424)."""
    return modern_spec(
        "NovelGridworld-Bow-v1", _BOW_ITEMS, BOW_RECIPES, "bow",
        spawn=(("crafting_table", 1), ("tree_log", 3), ("wool", 2)),
        manipulation=_BOW_MANIP,
        break_bonus_items=("tree_log",),
        craft_success_reward=50.0,
        extract={"source": "wool", "yield_item": "string", "amount": 4},
        map_size=map_size,
    )
