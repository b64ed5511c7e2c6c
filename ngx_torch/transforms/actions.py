"""Action transforms — LimitActions and action remapping as spec rewrites;
the port's copy of ``ngx/transforms/actions.py`` (numpy only).

Reference: ``gym_novel_gridworlds/wrappers.py:57-85`` (LimitActions),
``pogostick_v1_env.py:476-493`` (remap_action) and
``novelty_wrappers.py:1203-1227`` (remap_action_difficulty).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from ..core import spec as S
from ..core.spec import EnvSpec


def _gather_actions(spec: EnvSpec, names: Sequence[str], tag: str) -> EnvSpec:
    """New spec whose action table is ``names`` (ids = position)."""
    idx = [spec.actions.index(n) for n in names]
    return spec.replace(
        actions=tuple(names),
        action_op=spec.action_op[idx],
        action_arg=spec.action_arg[idx],
        action_cost_success=spec.action_cost_success[idx],
        action_cost_fail=spec.action_cost_fail[idx],
        novelty_tag=spec.novelty_tag + tag,
    )


def limit_actions(spec: EnvSpec, limited: Iterable[str]) -> EnvSpec:
    """``LimitActions(env, limited_actions)`` (wrappers.py:57-85): the action
    space becomes a compact ``Discrete`` over ``sorted(limited)``; the rows of
    the action tables are gathered once."""
    limited = set(limited)
    unknown = limited - set(spec.actions)
    if unknown:
        raise ValueError(
            f"Not valid actions for {spec.env_id}: {sorted(unknown)}")
    return _gather_actions(spec, sorted(limited), "|limit" + str(len(limited)))


def _remap_names(names, rng) -> list:
    """One ``remap_action`` draw (pogostick_v1_env.py:476-493): shuffle the
    name→id assignment until it differs from the identity."""
    names = list(names)
    while True:
        shuffled = list(names)
        rng.shuffle(shuffled)
        if shuffled != names:
            return shuffled


def remap_actions(spec: EnvSpec, difficulty: str = "hard",
                  rng=np.random) -> EnvSpec:
    """The ``remapaction`` novelty (novelty_wrappers.py:1203-1227).

    easy: shuffle the manipulation block only; medium: shuffle manipulation
    and craft blocks within themselves; hard: shuffle everything.  A spec
    made by :func:`limit_actions` has no block structure left, so it gets a
    blanket shuffle, as the reference remaps the limited table regardless of
    difficulty.  ``rng`` is consumed as ngx consumes it, so the same
    ``RandomState`` gives the same spec.
    """
    ops = np.asarray(spec.action_op)
    is_craft = ops == S.OP_CRAFT
    is_select = ops == S.OP_SELECT
    manip_ids = np.flatnonzero(~is_craft & ~is_select)
    craft_ids = np.flatnonzero(is_craft)
    blocked = (list(manip_ids) == list(range(len(manip_ids)))
               and list(craft_ids) == list(
                   range(len(manip_ids), len(manip_ids) + len(craft_ids))))

    names = list(spec.actions)
    if difficulty == "easy" and blocked:
        new = _remap_names([names[i] for i in manip_ids], rng) + \
            [names[i] for i in range(len(manip_ids), len(names))]
    elif difficulty == "medium" and blocked:
        new = (_remap_names([names[i] for i in manip_ids], rng)
               + _remap_names([names[i] for i in craft_ids], rng)
               + [names[i] for i in range(len(manip_ids) + len(craft_ids),
                                          len(names))])
    else:
        new = _remap_names(names, rng)
    return _gather_actions(spec, new, "|remap-" + difficulty)
