"""The reference's ``gym_novel_gridworlds/novelty_wrappers.py`` — the port
of the JAX alias's module of that name.

The reference exposes 15 wrapper classes plus ``inject_novelty`` and
``remap_action_difficulty`` (novelty_wrappers.py:9-1674).  Here each class
name is a constructor with the reference's signature that returns a fresh
facade env on the wrapped env's device, its spec rewritten by the matching
novelty (:mod:`ngx_torch.novelty`); the difficulty is in the class name, as
in the reference (AxeEasy / AxeMedium / AxeHard, ...).

Direct construction skips ``inject_novelty``'s combination asserts, as in
the reference: ``ExtractIncDec(env, 'increase')`` on Bow-v1 is reachable
only this way (novelty_wrappers.py:1497 against :1641-1653).
"""

from .. import novelty as _N
from ..compat.wrappers import BlockItem, _rewrap, inject_novelty  # noqa: F401
from ..core.mirror import mirror_reset
from ..transforms.actions import remap_actions as _remap_actions

__all__ = [
    "inject_novelty", "remap_action_difficulty", "BlockItem",
    "AxeEasy", "AxeMedium", "AxeHard",
    "AxetoBreakEasy", "AxetoBreakMedium", "AxetoBreakHard",
    "Fence", "FenceRestriction", "AddItem", "Crate", "ReplaceItem",
    "FireWall", "AddChopAction", "AddJumpAction", "BreakIncrease",
    "ExtractIncDec",
]


def _axe(env, difficulty, axe_material, breakincrease, required):
    """The 6 axe classes (novelty_wrappers.py:9-844)."""
    spec = _N.inject_novelty(env._spec, "axetobreak" if required else "axe",
                             difficulty, axe_material, breakincrease)
    new = _direct(env, spec)
    if env.reset_mode == "mirror":
        # AxeMedium / AxetoBreakMedium / AxeHard-iron construction calls
        # add_new_items -> reset (novelty_wrappers.py:129, 552, 249),
        # consuming np.random draws that a seeded caller relies on: a
        # throwaway draw, on the env's own device
        if difficulty == "medium" or (difficulty == "hard" and not required
                                      and axe_material == "iron"):
            mirror_reset(spec, device=env.device)
    return new


def AxeEasy(env, axe_material, breakincrease="false"):
    return _axe(env, "easy", axe_material, breakincrease, required=False)


def AxeMedium(env, axe_material, breakincrease="false"):
    return _axe(env, "medium", axe_material, breakincrease, required=False)


def AxeHard(env, axe_material, breakincrease="false"):
    return _axe(env, "hard", axe_material, breakincrease, required=False)


def AxetoBreakEasy(env, axe_material):
    return _axe(env, "easy", axe_material, "", required=True)


def AxetoBreakMedium(env, axe_material):
    return _axe(env, "medium", axe_material, "", required=True)


def AxetoBreakHard(env, axe_material):
    return _axe(env, "hard", axe_material, "", required=True)


def _direct(env, spec):
    new = _rewrap(env, spec)
    new._state = None            # a novelty wrap needs a fresh reset
    return new


def Fence(env, difficulty, fence_material):
    return _direct(env, _N.inject_novelty(env._spec, "fence", difficulty,
                                          fence_material))


def FenceRestriction(env, difficulty, fence_material):
    return _direct(env, _N.inject_novelty(env._spec, "fencerestriction",
                                          difficulty, fence_material))


def AddItem(env, difficulty, item_to_add):
    return _direct(env, _N.inject_novelty(env._spec, "additem", difficulty,
                                          item_to_add))


def Crate(env, difficulty):
    return _direct(env, _N.inject_novelty(env._spec, "crate", difficulty))


def ReplaceItem(env, difficulty, item_to_replace="wall",
                item_to_replace_with="brick"):
    return _direct(env, _N.inject_novelty(env._spec, "replaceitem",
                                          difficulty, item_to_replace,
                                          item_to_replace_with))


def FireWall(env, difficulty="hard"):
    return _direct(env, _N.inject_novelty(env._spec, "firewall", difficulty))


def AddChopAction(env):
    return _direct(env, _N.inject_novelty(env._spec, "addchop"))


def AddJumpAction(env):
    return _direct(env, _N.inject_novelty(env._spec, "addjump"))


def BreakIncrease(env, itemtobreakmore=""):
    return _direct(env, _N.inject_novelty(env._spec, "breakincrease", "hard",
                                          itemtobreakmore))


def ExtractIncDec(env, incdec="decrease"):
    # direct construction: no env-id combination asserts
    return _direct(env, _N._extractincdec(env._spec, incdec))


def remap_action_difficulty(env, difficulty="hard"):
    """The reference's function form (novelty_wrappers.py:1203-1227): with a
    LimitActions below, only the limited table is reshuffled (in place,
    whatever the difficulty); otherwise the whole action table is remapped
    by difficulty, with the reference's np.random draws."""
    if env.limited_actions_id is not None:
        env.set_limited_actions_id(env.remap_action(env.limited_actions_id, 0))
        return env
    # the live state carries over (_rewrap), as in the in-place reference
    return _rewrap(env, _remap_actions(env._spec, difficulty))
