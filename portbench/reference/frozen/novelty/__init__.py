"""Frozen copy of the port's ``novelty`` package, cut to the fence path: the
Fence novelty (``gym_novel_gridworlds/novelty_wrappers.py:847-889``) as a
spec rewrite.  The fence item is appended at the end of the id space with
its ``Select_`` action, and one reset edit fills ``lo``-``hi`` percent of
the items' cells with a 3x3 fence block (the reset's ``"fence"`` edit)."""

from __future__ import annotations

import numpy as np

from ..core import spec as S
from ..core.spec import EnvSpec

_FENCE_RANGES = {"easy": (20, 50), "medium": (50, 90), "hard": (90, 100)}


def _append_item(sp: EnvSpec, name: str) -> EnvSpec:
    """Append one breakable, non-entity item at the end of the id space
    (``items_id.setdefault(name, len(items_id))``, novelty_wrappers.py:
    21-22) and its ``Select_<name>`` action (:24-25)."""
    if name in sp.items:
        raise AssertionError(f"Item to add ({name}) already exists")
    I = sp.n_items

    def ext(arr, value):
        return np.concatenate([np.asarray(arr),
                               np.asarray([value], np.asarray(arr).dtype)])

    new_reward = (sp.reward_intermediate if sp.break_blanket_reward
                  else sp.break_wrong_reward_default)
    kw = dict(
        items=sp.items + (name,),
        unbreakable=ext(sp.unbreakable, False),
        entity_mask=ext(sp.entity_mask, False),
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

    def act(arr, value, dt):
        return np.concatenate([np.asarray(arr), np.asarray([value], dt)])

    return sp.replace(
        actions=sp.actions + ("Select_" + name,),
        action_op=act(sp.action_op, S.OP_SELECT, np.int32),
        action_arg=act(sp.action_arg, I, np.int32),
        action_cost_success=act(sp.action_cost_success, 120.0, np.float32),
        action_cost_fail=act(sp.action_cost_fail, 120.0, np.float32),
    )


def inject_novelty(spec: EnvSpec, novelty_name: str, difficulty: str,
                   material: str) -> EnvSpec:
    """``inject_novelty(spec, 'fence', difficulty, material)``; any other
    novelty raises."""
    if novelty_name != "fence":
        raise ValueError(f"the frozen copy holds the fence novelty alone, "
                         f"not {novelty_name!r}")
    if difficulty not in _FENCE_RANGES:
        raise ValueError(f"difficulty {difficulty!r} is not one of "
                         f"{sorted(_FENCE_RANGES)}")
    if not material:
        raise ValueError("the fence novelty needs its material (oak, ...)")
    fence = material + "_fence"
    sp = _append_item(spec, fence)
    lo, hi = _FENCE_RANGES[difficulty]
    return sp.replace(
        reset_edits=sp.reset_edits + (("fence", sp.items.index(fence), lo,
                                       hi),),
        # Fence.reset returns the base env's observation (:885)
        reset_obs_base=True,
        novelty_tag=sp.novelty_tag + f"|fence-{difficulty}-{material}",
    )
