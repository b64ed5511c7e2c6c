"""EnvSpec — the static, declarative description of a NovelGridworlds environment.

The port's own numpy copy of ``ngx/core/spec.py``: importing any ``ngx.*``
module runs ``ngx/__init__.py``, which imports jax and flax, and the port
never imports jax.  ``tests/test_torch_spec.py`` holds this copy equal to
ngx's, field by field, for every preset the port supports.

Every environment is pure *data* in one frozen spec (reference
``gym_novel_gridworlds/envs/pogostick_v1_env.py:26-84`` for the "modern"
template, ``novel_gridworld_v1_env.py:25-65`` for the "legacy" one); the
batched step (:mod:`ngx_torch.core.step`) and the CUDA kernels
(:mod:`ngx_torch.ops.train_rollout`, :mod:`ngx_torch.ops.rollout`) interpret
those tables.
:func:`check_supported` names the spec features the port does not cover yet.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Facing ids — reference pogostick_v1_env.py:33
# ---------------------------------------------------------------------------
NORTH, SOUTH, WEST, EAST = 0, 1, 2, 3
DIRECTION_NAMES = ("NORTH", "SOUTH", "WEST", "EAST")
# (dr, dc) per facing id
FACING_DELTAS = np.array([[-1, 0], [1, 0], [0, -1], [0, 1]], dtype=np.int32)
# turn tables — reference pogostick_v1_env.py:258-279
TURN_LEFT = np.array([WEST, EAST, SOUTH, NORTH], dtype=np.int32)
TURN_RIGHT = np.array([EAST, WEST, NORTH, SOUTH], dtype=np.int32)

# ---------------------------------------------------------------------------
# Action opcodes.  Each discrete action id maps to (opcode, argument).
# ---------------------------------------------------------------------------
OP_NOOP = 0
OP_FORWARD = 1            # pogostick_v1_env.py:244-257
OP_LEFT = 2               # :258-268
OP_RIGHT = 3              # :269-279
OP_BREAK = 4              # :280-294
OP_PLACE = 5              # :295-314 (arg = item id to place)
OP_EXTRACT_RUBBER = 6     # :315-331
OP_EXTRACT_STRING = 7     # bow_v0_env.py:293-304 (arg = source item id, e.g. wool)
OP_CRAFT = 8              # :333-336 → craft() (arg = recipe index)
OP_SELECT = 9             # :338-347 (arg = item id)
OP_FUSED_PLACE_EXTRACT = 10  # novel_gridworld_v4_env.py:277-305
OP_CHOP = 11              # novelty_wrappers.py:1288-1307
OP_JUMP = 12              # novelty_wrappers.py:1360-1382

# Craft-variant codes (ordering / gating differences between env templates)
CRAFT_MODERN = 0          # ingredients first, then table check; costs+messages
                          # (pogostick_v1_env.py:413-474)
CRAFT_LEGACY_TABLE_FIRST = 1  # table check first, then ingredients; no costs
                              # (novel_gridworld_v3_env.py:360-400)
CRAFT_LEGACY_NO_TABLE = 2     # no table requirement at all (novel_gridworld_v2_env.py:295-325)

# Craft-nag codes (reward quirks preserved from legacy clones)
NAG_NONE = 0
NAG_V2 = 1   # stick crafted while plank<8 *after* consuming → reward stays -1
             # (novel_gridworld_v2_env.py:313-323)
NAG_V4 = 2   # stick before 8 plank / tree_tap before 8 stick (checked *before*
             # consuming) → reward -1 (novel_gridworld_v4_env.py:398-405)

# Goal modes
GOAL_INVENTORY = 0   # thresholds over inventory (ALL or ANY)
GOAL_FRONT_ITEM = 1  # block in front equals an item (novel_gridworld_v0_env.py:237-239)

# Axe novelty modes (novelty_wrappers.py AxeEasy/.../AxetoBreakHard)
AXE_NONE = 0
AXE_BONUS = 1      # axe optional; selected-axe breaks get +10 & reduced cost;
                   # without axe the break still succeeds but reward stays -1
                   # (novelty_wrappers.py:45-110)
AXE_REQUIRED = 2   # break *fails* without the axe selected (novelty_wrappers.py:472-534)

# Fence-restriction modes (novelty_wrappers.py:918-958)
FENCE_NONE = 0
FENCE_MEDIUM = 1   # perpendicular sides of the *agent* must be fence-free
FENCE_HARD = 2     # whole 3x3 around the target must be fence-free

# Observation modes of the *core* (wrapper transforms add more)
OBS_DICT = 0          # modern raw-state dict (pogostick_v1_env.py:214-228)
OBS_LIDAR_V0 = 1      # 5 beams / 180°, fill=max_beam_range (novel_gridworld_v0_env.py:136-173)
OBS_LIDAR_INV = 2     # 8 beams / 360° over lidar item subset + full inventory
                      # (novel_gridworld_v1_env.py:139-204)
OBS_LIDAR_FRONT = 3   # LidarInFront wrapper: 360° over items-{air,goal}, range
                      # = hypotenuse, + inventory minus unbreakables
                      # (observation_wrappers.py:10-80)
OBS_AGENT_MAP = 4     # AgentMap wrapper: 11x11 window + facing + inventory
                      # (observation_wrappers.py:83-129)

# Message codes for info['message'] — decoded host-side (see ngx.compat).
MSG_NONE = 0
MSG_BLOCK_IN_PATH = 1          # 'Block in path'
MSG_CANNOT_BREAK = 2           # 'Cannot break <item>'   (arg = item id)
MSG_TAP_PLACED = 3             # 'Block tree_tap placed'
MSG_BLOCK_EXISTS = 4           # 'Block <item> already exists when trying to place block'
MSG_ITEM_NOT_FOUND = 5         # 'Item not found in inventory'
MSG_NO_TREE_NEAR_TAP = 6       # 'No tree_log near tree_tap'
MSG_NO_TAP = 7                 # 'No tree_tap found'
MSG_MISSING_ITEMS = 8          # 'Missing items: ...'    (arg = recipe idx)
MSG_NEED_TABLE = 9             # 'Need to be in front of crafting_table'
MSG_CRAFTED = 10               # 'Crafted <item>'        (arg = recipe idx)
MSG_NO_WOOL = 11               # 'No wool found'
MSG_NEED_AXE = 12              # 'Cannot break without <axe> selected' (arg = axe id)
MSG_FENCE_RESTRICTION = 13     # 'Cannot break due to fence restriction'
MSG_DIED_FIREWALL = 14         # 'You died due to fire_wall'
MSG_CANNOT_CHOP = 15           # 'Cannot chop <item>'    (arg = item id)


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Full static description of one environment configuration.

    Novelty injection (:mod:`ngx_torch.novelty`) produces a *new* EnvSpec;
    ``spec.key`` is a structural fingerprint of every field.
    """

    env_id: str
    map_size: int

    # --- items ------------------------------------------------------------
    items: Tuple[str, ...]            # index == item id; items[0] == 'air'
    unbreakable: np.ndarray           # bool[I]
    entity_mask: np.ndarray           # bool[I] — auto-grabbed 3x3 around agent
    inventory_tracked: bool           # legacy v0 tracks no inventory

    # --- actions ----------------------------------------------------------
    actions: Tuple[str, ...]          # index == action id
    action_op: np.ndarray             # int32[A] opcode
    action_arg: np.ndarray            # int32[A] operand (recipe idx / item id)
    action_cost_success: np.ndarray   # float32[A]
    action_cost_fail: np.ndarray      # float32[A]

    # --- recipes ----------------------------------------------------------
    recipe_names: Tuple[str, ...]     # crafted item name per recipe index
    # ingredient names per recipe, in the reference's dict insertion order —
    # drives RNG-order-sensitive draws (Crate contents, novelty_wrappers.py:1062-1069)
    recipe_input_order: Tuple[Tuple[str, ...], ...]
    recipes_in: np.ndarray            # int32[R, I]
    recipes_out: np.ndarray           # int32[R, I]
    recipe_multi: np.ndarray          # bool[R] — >1 distinct ingredient ⇒ needs table
    craft_cost_success: np.ndarray    # float32[R]
    craft_cost_missing: np.ndarray    # float32[R]
    craft_cost_no_table: np.ndarray   # float32[R]
    craft_variant: int                # CRAFT_*
    craft_nag: int                    # NAG_*
    craft_success_reward: float       # +10 or +50 (bow_v1_env.py:424, pogostick_v0_env.py:479)
    crafting_table_id: int            # -1 if no table item

    # --- break ------------------------------------------------------------
    break_reward: np.ndarray          # float32[I] reward when item i broken
    break_yield: np.ndarray           # int32[I] items gained per break (breakincrease)
    break_cost: float

    # --- place / extract ---------------------------------------------------
    place_adjacent_item: int          # tree_log id (bonus-reward adjacency) or -1
    extract_amount: int               # rubber/string per extraction (extractincdec)
    extract_yield_item: int           # rubber or string item id, -1 if n/a
    extract_source_item: int          # tree_tap (rubber) / wool (string), -1 if n/a

    # --- goal / termination -------------------------------------------------
    goal_mode: int                    # GOAL_*
    goal_any: bool                    # ANY vs ALL over goal_counts thresholds
    goal_counts: np.ndarray           # int32[I]
    goal_front_item: int              # item id for GOAL_FRONT_ITEM
    goal_item: int                    # goal_item_to_craft id (-1 for legacy v0-v4)
    deadend_recipes: np.ndarray       # bool[R]; done when none craftable (v2/v3)

    # --- rewards ------------------------------------------------------------
    reward_step: float                # -1
    reward_intermediate: float        # +10
    reward_done: float                # +50
    break_wrong_reward_default: float  # reward when break succeeds on un-bonused item
    # A BreakIncrease novelty in the stack decides yield/reward at STEP time
    # (novelty_wrappers.py:1444-1454), so items appended by LATER novelty
    # injections inherit its rules: +10 on any breakable always, 2x yield
    # when its arg was '' (blanket mode).  These flags let _append_item
    # materialize that inheritance into the tables.
    break_blanket_reward: bool = False
    break_blanket_yield: bool = False

    # --- novelty flags -------------------------------------------------------
    axe_mode: int = AXE_NONE
    axe_id: int = -1
    axe_cost_mult: float = 1.0        # wooden 0.5 / iron 0.25 (novelty_wrappers.py:66,77)
    axe_breakincrease: bool = False
    fence_restrict: int = FENCE_NONE
    fence_id: int = -1
    crate_id: int = -1
    crate_contents: Optional[np.ndarray] = None   # int32[I]
    fire_item: int = -1               # fire_wall id (novelty_wrappers.py:1171-1189)
    grab_entities_enabled: bool = True

    # --- reset / procedural generation ----------------------------------------
    # Spawn table, in insertion order (reset places items item-by-item in
    # items_quantity order — pogostick_v1_env.py:147-148).
    spawn_items: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32))  # int32[K] item ids
    spawn_qty: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32))  # int32[K]
    # Starting inventory: quantity ~ U[lo, hi] inclusive per item
    # (fixed quantities have lo == hi; novel_gridworld_v3_env.py:45-47).
    start_inv_lo: Optional[np.ndarray] = None   # int32[I]
    start_inv_hi: Optional[np.ndarray] = None   # int32[I]
    reset_wall_coin: bool = False     # 50% wall in front (novel_gridworld_v3_env.py:148-152)
    reset_place_tap: bool = False     # tap next to random tree (pogostick_v0_env.py:155-178)
    # Ordered novelty reset map-edits, applied in INJECTION order — the
    # reference's wrapper resets run inner-first (each wrapper's reset edits
    # the map after ``self.env.reset()`` returned), so stacking e.g.
    # AddItem(ReplaceItem(env)) replays replace-then-additem.  Entries are
    # tagged tuples: ("fence", fence_id, lo, hi) / ("additem", item_id, lo,
    # hi) / ("replace", from_id, to_id, lo, hi); lo/hi are the difficulty's
    # percent range.  Same-type novelties may appear more than once (the
    # reference nests wrappers freely, novelty_wrappers.py:1586).
    reset_edits: Tuple[tuple, ...] = ()
    # post-reset inventory overrides (AxeEasy re-grant etc.,
    # novelty_wrappers.py:29-35,664-673); -1 == leave unchanged
    reset_inv_set: Optional[np.ndarray] = None  # int32[I]
    # The reference's axe-family resets mutate the inventory AFTER the inner
    # reset already materialized the observation (novelty_wrappers.py:29-35:
    # ``obs = self.env.reset()`` then ``inventory.update``), so when an
    # array-building observation sits below the novelty (legacy lidar or a
    # LidarInFront wrapper) the RETURNED reset obs shows the pre-grant
    # inventory.  Dict observations (modern raw dict, AgentMap) alias the
    # live inventory dict and therefore show the grant.  True == reproduce
    # the stale reset obs.
    stale_reset_obs: bool = False

    # --- observation ---------------------------------------------------------
    obs_mode: int = OBS_DICT
    # obs mode of the BASE env under any observation wrapper (-1 == same as
    # obs_mode).  Needed because Fence/AddItem/ReplaceItem resets return
    # ``self.get_observation()``, which gym attribute-forwarding resolves to
    # the BASE env's get_observation — bypassing any ObservationWrapper in
    # the stack (novelty_wrappers.py:885,1030,1146) — see reset_obs_base.
    base_obs_mode: int = -1
    # True == reset() returns the base env's observation (raw dict for modern
    # envs / built-in lidar for legacy) even when an observation transform is
    # active; set by the fence/additem/replaceitem novelty families.
    reset_obs_base: bool = False
    lidar_items: Tuple[str, ...] = ()   # legacy lidar item subset (v1-v5)
    lidar_num_beams: int = 8
    lidar_max_range: int = 40

    # identity used for compile caching
    novelty_tag: str = ""

    # ------------------------------------------------------------------
    @property
    def n_items(self) -> int:
        return len(self.items)

    @property
    def n_actions(self) -> int:
        return len(self.actions)

    @property
    def n_recipes(self) -> int:
        return len(self.recipe_names)

    @functools.cached_property
    def key(self) -> str:
        """Compile-cache identity: a structural fingerprint of every field,
        so ANY spec edit (novelty injection, add_new_items, spawn-table
        override at reset) maps to its own compiled kernel — tag-based keys
        would silently reuse stale kernels after untagged edits.  Computed
        once per spec (a frozen dataclass; ``replace`` makes a new one): the
        kernel wrappers look their table buffers up by it on every call."""
        h = hashlib.sha1()
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            h.update(f.name.encode())
            if isinstance(v, np.ndarray):
                h.update(str(v.dtype).encode())
                h.update(np.ascontiguousarray(v).tobytes())
            else:
                h.update(repr(v).encode())
        return f"{self.env_id}|{self.map_size}|{h.hexdigest()}"

    @property
    def items_id(self) -> Dict[str, int]:
        return {name: i for i, name in enumerate(self.items)}

    @property
    def actions_id(self) -> Dict[str, int]:
        return {name: i for i, name in enumerate(self.actions)}

    def item(self, name: str) -> int:
        return self.items.index(name)

    def replace(self, **kw) -> "EnvSpec":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Builder helpers shared by presets and novelty transforms
# ---------------------------------------------------------------------------

def set_items_id(items, with_air: bool) -> Tuple[str, ...]:
    """Replicates reference id assignment (pogostick_v1_env.py:200-212 and
    novel_gridworld_v1_env.py:186-192): alphabetical, air pinned to 0.

    Returns the items tuple indexed by id, always including 'air' at index 0.
    """
    rest = sorted(x for x in items if x != "air")
    return ("air", *rest)


def recipes_to_arrays(recipes: Dict[str, Dict], items: Tuple[str, ...]):
    """Dense recipe matrices, recipe index = sorted recipe-name order
    (matches Craft_* action generation, pogostick_v1_env.py:61-63)."""
    names = tuple(sorted(recipes.keys()))
    I = len(items)
    idx = {n: i for i, n in enumerate(items)}
    rin = np.zeros((len(names), I), dtype=np.int32)
    rout = np.zeros((len(names), I), dtype=np.int32)
    multi = np.zeros((len(names),), dtype=bool)
    in_order = []
    for r, name in enumerate(names):
        for item, q in recipes[name]["input"].items():
            rin[r, idx[item]] = q
        for item, q in recipes[name]["output"].items():
            rout[r, idx[item]] = q
        multi[r] = len(recipes[name]["input"]) > 1
        in_order.append(tuple(recipes[name]["input"].keys()))
    return names, rin, rout, multi, tuple(in_order)


# ---------------------------------------------------------------------------
# The feature set this slice of the port covers
# ---------------------------------------------------------------------------

SUPPORTED_OPS = frozenset((OP_FORWARD, OP_LEFT, OP_RIGHT, OP_BREAK, OP_PLACE,
                           OP_EXTRACT_RUBBER, OP_EXTRACT_STRING, OP_CRAFT,
                           OP_SELECT, OP_FUSED_PLACE_EXTRACT, OP_CHOP,
                           OP_JUMP))
_OP_NAMES = {OP_NOOP: "NOOP"}
_EDIT_KINDS = ("fence", "additem", "replace")


def check_supported(spec) -> None:
    """Raise ``NotImplementedError`` naming the first feature of ``spec`` that
    the port does not implement (see ROADMAP.md).

    Covered: the 11 presets (the modern and the legacy template) and the 13
    novelty injections, stacked in any order — the CHOP and JUMP ops, the axe
    modes, the fence restriction, the crate, the fire wall, grab-entities and
    the percent-fill reset edits — under their own observation or the
    LidarInFront or AgentMap rewrite.  Not covered: more than 32 item ids
    (the CUDA kernels hold each env's map as int8 in shared memory) and
    the NOOP op, which no spec of the reference has.  The plain step and the
    CUDA kernel wrappers call this, so no unsupported spec quietly takes
    another path.  Accepts any object with the EnvSpec fields (an ``ngx``
    spec too)."""
    def missing(feature):
        raise NotImplementedError(
            f"{spec.env_id}: {feature} is not ported to ngx_torch "
            "(ROADMAP.md)")

    for op in sorted(set(np.asarray(spec.action_op).tolist())):
        if op not in SUPPORTED_OPS:
            missing(f"op family {_OP_NAMES.get(op, op)}")
    for edit in spec.reset_edits:
        if edit[0] not in _EDIT_KINDS:
            missing(f"reset edit {edit[0]!r}")
    if spec.n_items > 32:
        missing("more than 32 item ids")
