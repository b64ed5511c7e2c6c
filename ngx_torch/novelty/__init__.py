"""The 13 novelty injections as pure EnvSpec rewrites — the port's copy of
``ngx/novelty/__init__.py`` (numpy only: importing any ``ngx`` module runs
``ngx/__init__.py``, which imports jax).

Reference: ``gym_novel_gridworlds/novelty_wrappers.py``.  :func:`inject_novelty`
returns a *new* spec; the port's plain step (:mod:`ngx_torch.core.step`), its
counter reset (:mod:`ngx_torch.core.reset`) and the CUDA kernels' shared
device code (``ngx_torch/ops/csrc/ngx_env.cuh``) evaluate every novelty
branch from the spec's tables.  ``rng`` is consumed exactly as ngx consumes
it (the crate contents are drawn at construction, the remapped action order
by shuffles), so the same ``RandomState`` gives the same spec, field by field
and by ``spec.key`` (tests/test_torch_spec.py).
"""

from __future__ import annotations

import numpy as np

from ..core import spec as S
from ..core.spec import EnvSpec
from ..transforms.actions import remap_actions

__all__ = ["inject_novelty", "NOVELTY_NAMES", "sample_crate_contents"]

NOVELTY_NAMES = ("addchop", "additem", "addjump", "axe", "axetobreak",
                 "breakincrease", "crate", "extractincdec", "fence",
                 "fencerestriction", "firewall", "remapaction", "replaceitem")

_DIFFICULTIES = ("easy", "medium", "hard")


# ---------------------------------------------------------------------------
# spec-surgery helpers
# ---------------------------------------------------------------------------

def _append_item(sp: EnvSpec, name: str, *, entity=False, unbreakable=False,
                 select_action=True) -> EnvSpec:
    """Append one item at the end of the id space, mirroring
    ``items_id.setdefault(name, len(items_id))`` (novelty_wrappers.py:21-22):
    novelty items do NOT re-sort existing ids."""
    if name in sp.items:
        raise AssertionError(f"Item to add ({name}) already exists")
    I = sp.n_items

    def ext(arr, value):
        return np.concatenate([np.asarray(arr), np.asarray([value], np.asarray(arr).dtype)])

    new_reward = (sp.reward_intermediate
                  if sp.break_blanket_reward and not unbreakable
                  else sp.break_wrong_reward_default)
    kw = dict(
        items=sp.items + (name,),
        unbreakable=ext(sp.unbreakable, unbreakable),
        entity_mask=ext(sp.entity_mask, entity),
        break_reward=ext(sp.break_reward, new_reward),
        break_yield=ext(sp.break_yield, 2 if sp.break_blanket_yield else 1),
        goal_counts=ext(sp.goal_counts, 0),
        recipes_in=np.concatenate(
            [sp.recipes_in, np.zeros((sp.n_recipes, 1), np.int32)], axis=1),
        recipes_out=np.concatenate(
            [sp.recipes_out, np.zeros((sp.n_recipes, 1), np.int32)], axis=1),
    )
    if sp.crate_contents is not None:
        kw["crate_contents"] = ext(sp.crate_contents, 0)
    if sp.start_inv_lo is not None:
        kw["start_inv_lo"] = ext(sp.start_inv_lo, 0)
    if sp.start_inv_hi is not None:
        kw["start_inv_hi"] = ext(sp.start_inv_hi, 0)
    if sp.reset_inv_set is not None:
        kw["reset_inv_set"] = ext(sp.reset_inv_set, -1)
    sp = sp.replace(**kw)
    if select_action:
        # Select_<item> appended at the end of the action table
        # (novelty_wrappers.py:24-25)
        sp = _append_action(sp, "Select_" + name, S.OP_SELECT, I, 120.0, 120.0)
    return sp


def _append_action(sp: EnvSpec, name, op, arg, cost_ok, cost_fail) -> EnvSpec:
    def ext(arr, value, dt):
        return np.concatenate([np.asarray(arr), np.asarray([value], dt)])
    return sp.replace(
        actions=sp.actions + (name,),
        action_op=ext(sp.action_op, op, np.int32),
        action_arg=ext(sp.action_arg, arg, np.int32),
        action_cost_success=ext(sp.action_cost_success, cost_ok, np.float32),
        action_cost_fail=ext(sp.action_cost_fail, cost_fail, np.float32),
    )


def _append_recipe(sp: EnvSpec, name, inputs, outputs,
                   cost_success, cost_missing, cost_no_table) -> EnvSpec:
    iid = sp.items_id
    rin = np.zeros((1, sp.n_items), np.int32)
    rout = np.zeros((1, sp.n_items), np.int32)
    for it, q in inputs.items():
        rin[0, iid[it]] = q
    for it, q in outputs.items():
        rout[0, iid[it]] = q

    def ext(arr, value, dt):
        return np.concatenate([np.asarray(arr), np.asarray([value], dt)])
    return sp.replace(
        recipe_names=sp.recipe_names + (name,),
        recipe_input_order=sp.recipe_input_order + (tuple(inputs.keys()),),
        recipes_in=np.concatenate([sp.recipes_in, rin]),
        recipes_out=np.concatenate([sp.recipes_out, rout]),
        recipe_multi=ext(sp.recipe_multi, len(inputs) > 1, bool),
        craft_cost_success=ext(sp.craft_cost_success, cost_success, np.float32),
        craft_cost_missing=ext(sp.craft_cost_missing, cost_missing, np.float32),
        craft_cost_no_table=ext(sp.craft_cost_no_table, cost_no_table, np.float32),
        deadend_recipes=ext(sp.deadend_recipes, False, bool),
    )


def _spawn_add(sp: EnvSpec, item_id: int, qty: int) -> EnvSpec:
    """items_quantity.update semantics (novelty_wrappers.py:243-249): existing
    entries keep their position with the quantity bumped; new entries append."""
    items = list(sp.spawn_items)
    qtys = list(sp.spawn_qty)
    if item_id in items:
        qtys[items.index(item_id)] += qty
    else:
        items.append(item_id)
        qtys.append(qty)
    return sp.replace(spawn_items=np.asarray(items, np.int32),
                      spawn_qty=np.asarray(qtys, np.int32))


def _inv_set(sp: EnvSpec, **by_name) -> EnvSpec:
    """Post-reset inventory overwrites (AxeEasy re-grant etc.).

    The reference applies these AFTER the wrapped env's reset returned its
    observation (novelty_wrappers.py:29-35,456-462,664-673), so an obs that
    was materialized into an array below the novelty (legacy lidar obs or a
    LidarInFront wrapper) shows the pre-grant inventory at reset — flag
    ``stale_reset_obs`` reproduces that (see EnvSpec)."""
    setv = (np.asarray(sp.reset_inv_set).copy()
            if sp.reset_inv_set is not None
            else np.full((sp.n_items,), -1, np.int32))
    for name, q in by_name.items():
        setv[sp.items.index(name)] = q
    stale = sp.obs_mode in (S.OBS_LIDAR_V0, S.OBS_LIDAR_INV,
                            S.OBS_LIDAR_FRONT)
    return sp.replace(reset_inv_set=setv, stale_reset_obs=stale)


# ---------------------------------------------------------------------------
# the 13 novelties
# ---------------------------------------------------------------------------

_AXE_COST_MULT = {"wooden": 0.5, "iron": 0.25}  # novelty_wrappers.py:66,77
_AXE_RECIPES = {"wooden": {"stick": 2, "plank": 3},
                "iron": {"stick": 2, "iron": 3}}  # :236-243


def _axe(sp, difficulty, material, breakincrease, required) -> EnvSpec:
    """axe / axetobreak family (novelty_wrappers.py:9-436, 439-844)."""
    axe = material + "_axe"
    sp = _append_item(sp, axe, entity=True)
    axe_id = sp.items.index(axe)

    if difficulty == "easy":
        # axe starts in (and is re-granted to) the inventory (:29-35,456-462)
        sp = _inv_set(sp, **{axe: 1})
    elif difficulty == "medium":
        # axe spawned on the map, auto-grabbed as an entity (:129,546-550)
        sp = _spawn_add(sp, axe_id, 1)
    else:  # hard — a recipe for the axe
        recipe = _AXE_RECIPES[material]
        for ing in recipe:  # dict order: stick first (:240-250,651-655)
            if ing not in sp.items:
                sp = _append_item(sp, ing, select_action=False)
        if required:
            # AxetoBreakHard: ingredients granted in inventory (:651-655,664-673)
            sp = _inv_set(sp, **{axe: 0}, **recipe)
        else:
            # AxeHard: ingredients spawned on the map (:240-250)
            for ing, q in recipe.items():
                sp = _spawn_add(sp, sp.items.index(ing), q)
        sp = _append_recipe(sp, axe, recipe, {axe: 1},
                            cost_success=6000.0, cost_missing=0.0,
                            cost_no_table=600.0)  # :402-429
        # Craft_<axe> appended before Select_<axe> (:252-255) — but Select was
        # already appended by _append_item, so splice Craft in front of it.
        sel_pos = sp.actions.index("Select_" + axe)
        sp = _append_action(sp, "Craft_" + axe, S.OP_CRAFT,
                            sp.n_recipes - 1, 0.0, 0.0)
        names = list(sp.actions)
        # move the Craft action to just before Select_<axe>
        craft_name = names.pop()
        names.insert(sel_pos, craft_name)
        idx = [sp.actions.index(n) for n in names]
        sp = sp.replace(
            actions=tuple(names),
            action_op=sp.action_op[idx],
            action_arg=sp.action_arg[idx],
            action_cost_success=sp.action_cost_success[idx],
            action_cost_fail=sp.action_cost_fail[idx],
        )

    return sp.replace(
        axe_mode=S.AXE_REQUIRED if required else S.AXE_BONUS,
        axe_id=axe_id,
        axe_cost_mult=_AXE_COST_MULT[material],
        axe_breakincrease=breakincrease == "true",
        # The axe wrappers re-implement the WHOLE Break path inline
        # (novelty_wrappers.py:45-110) — stacked OVER a FenceRestriction or
        # Crate the outer axe handler intercepts Break before the inner gate
        # or contents-grant runs, so both are cleared (outer wrapper wins;
        # fence/crate cells themselves stay, reset_edits is untouched).
        fence_restrict=S.FENCE_NONE, crate_id=-1,
        novelty_tag=sp.novelty_tag
        + f"|{'axetobreak' if required else 'axe'}-{difficulty}-{material}"
        + ("-bi" if breakincrease == "true" else ""),
    )


_FENCE_RANGES = {"easy": (20, 50), "medium": (50, 90), "hard": (90, 100)}
_ADDITEM_RANGES = {"easy": (1, 10), "medium": (10, 20), "hard": (20, 30)}
_CRATE_RANGES = {"easy": (99, 100), "medium": (50, 90), "hard": (10, 50)}
_REPLACE_RANGES = {"easy": (5, 20), "medium": (40, 90), "hard": (99, 100)}


def _fence(sp, difficulty, material) -> EnvSpec:
    """Fence (novelty_wrappers.py:847-889)."""
    fence = material + "_fence"
    sp = _append_item(sp, fence)
    lo, hi = _FENCE_RANGES[difficulty]
    return sp.replace(
        reset_edits=sp.reset_edits + (("fence", sp.items.index(fence), lo, hi),),
        # Fence.reset returns self.get_observation() — gym forwarding hits
        # the BASE env, bypassing any obs wrapper (novelty_wrappers.py:885)
        reset_obs_base=True,
        novelty_tag=sp.novelty_tag + f"|fence-{difficulty}-{material}",
    )


def _fence_restriction(sp, difficulty, material) -> EnvSpec:
    """FenceRestriction (novelty_wrappers.py:892-988) — composes an internal
    medium Fence regardless of difficulty (:902)."""
    sp = _fence(sp, "medium", material)
    mode = {"easy": S.FENCE_NONE, "medium": S.FENCE_MEDIUM,
            "hard": S.FENCE_HARD}[difficulty]
    return sp.replace(
        fence_restrict=mode,
        fence_id=sp.items.index(material + "_fence"),
        novelty_tag=sp.novelty_tag + f"|fencerestr-{difficulty}",
    )


def _additem(sp, difficulty, item) -> EnvSpec:
    """AddItem (novelty_wrappers.py:991-1034)."""
    sp = _append_item(sp, item)
    lo, hi = _ADDITEM_RANGES[difficulty]
    return sp.replace(
        reset_edits=sp.reset_edits + (("additem", sp.items.index(item), lo, hi),),
        # AddItem.reset returns the base env's obs (novelty_wrappers.py:1030)
        reset_obs_base=True,
        novelty_tag=sp.novelty_tag + f"|additem-{difficulty}-{item}",
    )


def sample_crate_contents(sp: EnvSpec, difficulty: str, rng=np.random) -> np.ndarray:
    """Mirror of Crate.__init__'s construction-time draw
    (novelty_wrappers.py:1048-1069): contents = ceil(p% of the goal recipe's
    total ingredient count), rejection-sampled without exceeding any per-item
    recipe quantity."""
    lo, hi = _CRATE_RANGES[difficulty]
    percent = rng.randint(low=lo, high=hi, size=1)[0]
    goal_name = sp.items[sp.goal_item]
    r = sp.recipe_names.index(goal_name)
    need = np.asarray(sp.recipes_in[r])
    # reference iterates the recipe's input dict in insertion order (:1062-1065)
    ingredients = list(sp.recipe_input_order[r])
    total = int(need.sum())
    n = int(np.ceil((percent / 100) * total))
    contents = np.zeros((sp.n_items,), np.int32)
    while n:
        item = rng.choice(ingredients, size=1)[0]
        i = sp.items.index(item)
        if contents[i] < need[i]:
            contents[i] += 1
            n -= 1
    return contents


def _crate(sp, difficulty, rng) -> EnvSpec:
    """Crate (novelty_wrappers.py:1037-1092) — composes AddItem('easy','crate');
    contents are drawn once at construction."""
    contents_before = sample_crate_contents(sp, difficulty, rng)
    sp = _additem(sp, "easy", "crate")
    contents = np.concatenate([contents_before, np.zeros((1,), np.int32)])
    return sp.replace(
        crate_id=sp.items.index("crate"),
        crate_contents=contents,
        novelty_tag=sp.novelty_tag + f"|crate-{difficulty}",
    )


def _replaceitem(sp, difficulty, old, new) -> EnvSpec:
    """ReplaceItem (novelty_wrappers.py:1095-1148)."""
    assert old in sp.items, \
        f"Item to replace ({old}) is not in the original map"
    sp = _append_item(sp, new, unbreakable=(old == "wall"))
    lo, hi = _REPLACE_RANGES[difficulty]
    return sp.replace(
        reset_edits=sp.reset_edits + (
            ("replace", sp.items.index(old), sp.items.index(new), lo, hi),),
        # ReplaceItem.reset returns env.get_observation() — the base env's
        # obs, bypassing any obs wrapper (novelty_wrappers.py:1146)
        reset_obs_base=True,
        novelty_tag=sp.novelty_tag + f"|replace-{difficulty}-{old}-{new}",
    )


def _firewall(sp, difficulty) -> EnvSpec:
    """FireWall (novelty_wrappers.py:1151-1200) — ReplaceItem(wall→fire_wall)
    plus the 4-adjacency death check (reward −reward_done//2, done)."""
    sp = _replaceitem(sp, difficulty, "wall", "fire_wall")
    return sp.replace(
        fire_item=sp.items.index("fire_wall"),
        novelty_tag=sp.novelty_tag + f"|firewall-{difficulty}",
    )


def _addchop(sp) -> EnvSpec:
    """AddChopAction (novelty_wrappers.py:1267-1337): Break that yields 2,
    always +10 on success, cost 3600×1.2."""
    sp = _append_action(sp, "Chop", S.OP_CHOP, 0, 4320.0, 4320.0)
    return sp.replace(novelty_tag=sp.novelty_tag + "|addchop")


def _addjump(sp) -> EnvSpec:
    """AddJumpAction (novelty_wrappers.py:1340-1412): move 2 cells if the
    target is air (intermediate cell not checked), cost 27.906975×2."""
    sp = _append_action(sp, "Jump", S.OP_JUMP, 0, 55.81395, 55.81395)
    return sp.replace(novelty_tag=sp.novelty_tag + "|addjump")


def _breakincrease(sp, item: str) -> EnvSpec:
    """BreakIncrease (novelty_wrappers.py:1415-1488): every successful Break
    rewards +10; the named item (or every item if '') yields 2."""
    # full shadow: the wrapper's inline Break path yields exactly 1 for any
    # item other than its own target (novelty_wrappers.py:1448-1452 `else:
    # += 1`), so an INNER yield override (e.g. a stacked breakincrease-'')
    # is discarded, not inherited — caught by the generated matrix's
    # double-breakincrease stack.
    by = np.ones_like(np.asarray(sp.break_yield))
    if item:
        assert item in sp.items, f"{item} is not in {sp.env_id}"
        by[sp.items.index(item)] = 2
    else:
        by[:] = 2
    br = np.where(np.asarray(sp.unbreakable), np.asarray(sp.break_reward),
                  np.float32(sp.reward_intermediate)).astype(np.float32)
    return sp.replace(
        break_yield=by, break_reward=br,
        # BreakIncrease re-implements the WHOLE Break path inline
        # (novelty_wrappers.py:1434-1485: cost always 3600, +10 on any
        # breakable, no axe involvement, no fence gate, no crate-contents
        # grant) — stacking it OVER an axe/axetobreak, FenceRestriction or
        # Crate novelty shadows the inner wrapper's Break handler entirely,
        # so any such override present in the spec is cleared (outer wrapper
        # wins; a crate keeps existing on the map but breaks into plain
        # crate items).
        axe_mode=S.AXE_NONE, axe_cost_mult=1.0, axe_breakincrease=False,
        fence_restrict=S.FENCE_NONE, crate_id=-1,
        break_blanket_reward=True, break_blanket_yield=(item == ""),
        novelty_tag=sp.novelty_tag + f"|breakincrease-{item}",
    )


def _extractincdec(sp, incdec: str) -> EnvSpec:
    """ExtractIncDec (novelty_wrappers.py:1491-1581): Bow string yield 8/2,
    Pogostick rubber yield 2/0."""
    if sp.env_id.startswith("NovelGridworld-Bow"):
        amount = 4 * 2 if incdec == "increase" else 4 // 2
    else:
        amount = 1 * 2 if incdec == "increase" else 0
    return sp.replace(
        extract_amount=amount,
        novelty_tag=sp.novelty_tag + f"|extract-{incdec}",
    )


# ---------------------------------------------------------------------------
# dispatcher — mirrors inject_novelty (novelty_wrappers.py:1586-1674)
# ---------------------------------------------------------------------------

def inject_novelty(spec: EnvSpec, novelty_name: str, difficulty: str = "hard",
                   novelty_arg1: str = "", novelty_arg2: str = "",
                   rng=np.random) -> EnvSpec:
    assert novelty_name in NOVELTY_NAMES, \
        "novelty_name must be one of " + str(list(NOVELTY_NAMES))
    if novelty_name in ("additem", "axe", "axetobreak", "crate", "fence",
                        "fencerestriction", "firewall", "remapaction",
                        "replaceitem"):
        assert difficulty in _DIFFICULTIES, \
            "difficulty must be one of 'easy', 'medium', 'hard'"

    if novelty_name == "addchop":
        return _addchop(spec)
    if novelty_name == "additem":
        assert novelty_arg1, \
            "For additem novelty, novelty_arg1 (name of the item to add) is needed"
        return _additem(spec, difficulty, novelty_arg1)
    if novelty_name == "addjump":
        return _addjump(spec)
    if novelty_name == "axe":
        assert novelty_arg1 in ("wooden", "iron"), \
            "For axe novelty, novelty_arg1 (attribute of axe, e.g. wooden, iron) is needed"
        if novelty_arg2:
            assert novelty_arg2 in ("true", "false"), \
                "For axe novelty, novelty_arg2 (breakincrease) must be 'true' or 'false'"
        return _axe(spec, difficulty, novelty_arg1, novelty_arg2, required=False)
    if novelty_name == "axetobreak":
        assert novelty_arg1 in ("wooden", "iron"), \
            "For axe novelty, novelty_arg1 (attribute of axe, e.g. wooden, iron) is needed"
        return _axe(spec, difficulty, novelty_arg1, "", required=True)
    if novelty_name == "breakincrease":
        return _breakincrease(spec, novelty_arg1)
    if novelty_name == "crate":
        return _crate(spec, difficulty, rng)
    if novelty_name == "extractincdec":
        assert novelty_arg1 in ("increase", "decrease"), \
            "For extractincdec novelty, novelty_arg1 ('increase', 'decrease') is needed"
        assert spec.env_id != "NovelGridworld-Bow-v0", \
            "There is nothing to extract in NovelGridworld-Bow-v0"
        if spec.env_id == "NovelGridworld-Bow-v1":
            assert novelty_arg1 == "decrease", \
                "In NovelGridworld-Bow-v1, increasing string extraction will not benefit as only 3 string are needed"
        assert not spec.env_id.startswith("NovelGridworld-Pogostick"), \
            "In NovelGridworld-Pogostick, you should not use extractincdec novelty"
        return _extractincdec(spec, novelty_arg1)
    if novelty_name == "fence":
        assert novelty_arg1, \
            "For fence novelty, novelty_arg1 (attribute of fence, e.g. oak, jungle) is needed"
        return _fence(spec, difficulty, novelty_arg1)
    if novelty_name == "fencerestriction":
        assert novelty_arg1, \
            "For fencerestriction novelty, novelty_arg1 (attribute of fence, e.g. oak, jungle) is needed"
        return _fence_restriction(spec, difficulty, novelty_arg1)
    if novelty_name == "firewall":
        return _firewall(spec, difficulty)
    if novelty_name == "remapaction":
        return remap_actions(spec, difficulty, rng)
    if novelty_name == "replaceitem":
        assert novelty_arg1 and novelty_arg2, \
            "For replaceitem novelty, novelty_arg1 (Item to replace) and novelty_arg2 (Item to replace with) are needed"
        return _replaceitem(spec, difficulty, novelty_arg1, novelty_arg2)
    raise AssertionError(novelty_name)
