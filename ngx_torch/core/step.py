"""The batched plain step — the port of ``ngx/core/step.py:57-653``: the
modern and legacy templates (craft variants and nags, fused place+extract,
the front-item goal, dead-end recipes) and the novelty families (JUMP, CHOP,
the axe modes, the fence restriction, the crate grant, grab-entities, the
fire-wall death) under every preset observation.

One call steps a ``[B]`` batch of envs: every op family is evaluated as
masked tensor arithmetic and combined with ``torch.where``, in the order of
the JAX step, so reward, ``done``, the state and :class:`StepInfo` come out
bit-exact against ``jax.vmap(ngx.core.step.make_step(spec))``
(tests/test_torch_step.py).  Map cells are read with ``gather`` and written
with one ``scatter`` of the front cell: the one-hot reads of the JAX step
were a TPU workaround.  Semantics are cited per op to the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spec as S
from .state import EnvState, StepInfo
from ..ops.rays import inventory_keep, make_lidar


class _Tables:
    """The spec's tables as tensors, built once per device."""

    def __init__(self, sp):
        I = sp.n_items
        self._np = dict(
            op=np.asarray(sp.action_op), arg=np.asarray(sp.action_arg),
            cost_ok=np.asarray(sp.action_cost_success, np.float32),
            cost_fail=np.asarray(sp.action_cost_fail, np.float32),
            unbreakable=np.asarray(sp.unbreakable, bool),
            break_reward=np.asarray(sp.break_reward, np.float32),
            break_yield=np.asarray(sp.break_yield),
            rin=np.asarray(sp.recipes_in).reshape(-1, I),
            rout=np.asarray(sp.recipes_out).reshape(-1, I),
            rmulti=np.asarray(sp.recipe_multi, bool),
            cc_ok=np.asarray(sp.craft_cost_success, np.float32),
            cc_missing=np.asarray(sp.craft_cost_missing, np.float32),
            cc_notable=np.asarray(sp.craft_cost_no_table, np.float32),
            goal=np.asarray(sp.goal_counts),
            deadend=np.asarray(sp.deadend_recipes, bool),
            entity=np.asarray(sp.entity_mask, bool),
            crate=np.asarray(sp.crate_contents if sp.crate_contents is not None
                             else np.zeros((I,), np.int32)),
            deltas=S.FACING_DELTAS, turn_left=S.TURN_LEFT,
            turn_right=S.TURN_RIGHT,
            keep=np.asarray(inventory_keep(sp), np.int64),
            # the legacy lidar obs' inventory tail: name-sorted, minus air
            # (novel_gridworld_v1_env.py:194-204)
            keep_inv=np.asarray([i for _, i in sorted(
                (n, i) for i, n in enumerate(sp.items)) if i != 0], np.int64),
        )
        self._on = {}

    def on(self, device):
        key = str(device)
        if key not in self._on:
            t = {}
            for k, v in self._np.items():
                dt = {np.dtype(bool): torch.bool,
                      np.dtype(np.float32): torch.float32}.get(v.dtype,
                                                               torch.int64)
                t[k] = torch.as_tensor(v).to(dtype=dt, device=device)
            self._on[key] = t
        return self._on[key]


def make_step(sp, with_obs: bool = True):
    """``step(state, action[B]) -> (state, obs, reward[B], done[B], info)``
    for one spec, batched.  ``with_obs=False`` returns ``obs=None``.
    ``step.get_obs(state)`` is the observation of a batched state: a dict for
    ``OBS_DICT`` and ``OBS_AGENT_MAP``, ``int32[B, OBS_DIM]`` for the lidar
    modes."""
    S.check_supported(sp)
    I, H, A = sp.n_items, sp.map_size, sp.n_actions
    HW = H * H
    R = sp.n_recipes
    tables = _Tables(sp)

    ops = set(np.asarray(sp.action_op).tolist())
    HAS_BREAK = S.OP_BREAK in ops
    HAS_EXR = S.OP_EXTRACT_RUBBER in ops
    HAS_EXS = S.OP_EXTRACT_STRING in ops
    HAS_CRAFT = S.OP_CRAFT in ops and R > 0
    HAS_FUSED = S.OP_FUSED_PLACE_EXTRACT in ops
    HAS_DEADEND = bool(np.asarray(sp.deadend_recipes).any())
    HAS_CHOP = S.OP_CHOP in ops
    HAS_JUMP = S.OP_JUMP in ops
    HAS_GRAB = sp.grab_entities_enabled and bool(
        np.asarray(sp.entity_mask).any())
    FENCE = sp.fence_restrict != S.FENCE_NONE
    # legacy craft-nag recipe/item indices (step.py:117-124)
    stick_r = sp.recipe_names.index("stick") \
        if "stick" in sp.recipe_names else -1
    tap_r = sp.recipe_names.index("tree_tap") \
        if "tree_tap" in sp.recipe_names else -1
    plank_i = sp.items.index("plank") if "plank" in sp.items else 0
    stick_i = sp.items.index("stick") if "stick" in sp.items else 0
    tap_i = sp.items.index("tree_tap") if "tree_tap" in sp.items else 0
    rubber_i = sp.items.index("rubber") if "rubber" in sp.items else 0
    f32 = torch.float32

    lidar_fn = make_lidar(sp) \
        if sp.obs_mode not in (S.OBS_DICT, S.OBS_AGENT_MAP) else None
    ext = 5   # the AgentMap window's half-width (observation_wrappers.py:102)

    def get_obs(state: EnvState):
        if sp.obs_mode == S.OBS_DICT:
            # pogostick_v1_env.py:214-228 — raw-state dict
            return {
                "map": state.map.reshape(-1, H, H),
                "agent_location": state.agent,
                "agent_facing_id": state.facing,
                "inventory_items_quantity": state.inventory,
            }
        if sp.obs_mode == S.OBS_AGENT_MAP:
            # observation_wrappers.py:102-129 — 11x11 window centred on the
            # agent, zero outside the map
            dev = state.device
            d = torch.arange(-ext, ext + 1, device=dev)
            rr = state.agent[:, 0, None, None].long() + d[None, :, None]
            cc = state.agent[:, 1, None, None].long() + d[None, None, :]
            inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < H)
            idx = torch.where(inb, rr * H + cc, 0).reshape(state.batch, -1)
            win = state.map.gather(1, idx).reshape(inb.shape)
            return {
                "agent_map": torch.where(inb, win, 0),
                "agent_facing_id": state.facing,
                "inventory_items_quantity": state.inventory,
            }
        lidar = lidar_fn(state.map, state.agent, state.facing)
        if sp.obs_mode == S.OBS_LIDAR_V0:
            return lidar
        # observation_wrappers.py:70-80 — lidar + inventory over name-sorted
        # items minus unbreakables (LidarInFront), or minus air only (the
        # legacy lidar, novel_gridworld_v1_env.py:194-204)
        t = tables.on(state.device)
        keep = t["keep"] if sp.obs_mode == S.OBS_LIDAR_FRONT else t["keep_inv"]
        return torch.cat([lidar, state.inventory[:, keep]], dim=1)

    def step(state: EnvState, action):
        dev = state.device
        t = tables.on(dev)
        m = state.map
        B = m.shape[0]
        a = action.to(device=dev, dtype=torch.int64)
        op, arg = t["op"][a], t["arg"][a]
        r, c = state.agent[:, 0].long(), state.agent[:, 1].long()
        inv = state.inventory
        f = state.facing.long()
        zero_i = torch.zeros((), dtype=torch.int64, device=dev)

        def full(v, dtype=f32):
            return torch.full((B,), v, dtype=dtype, device=dev)

        def read_at(rr, cc, mm=m):
            """mm[rr, cc], 0 (air) when out of range."""
            inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < H)
            idx = torch.where(inb, rr * H + cc, zero_i)
            return torch.where(inb, mm.gather(1, idx[:, None])[:, 0].long(),
                               zero_i)

        fr, fc = r + t["deltas"][f, 0], c + t["deltas"][f, 1]
        front_in = (fr >= 0) & (fr < H) & (fc >= 0) & (fc < H)
        front_idx = torch.where(front_in, fr * H + fc, zero_i)
        front = read_at(fr, fc)

        # ---------------- Forward / turns (pogostick_v1_env.py:244-279) ----
        is_fwd = op == S.OP_FORWARD
        fwd_ok = front == 0
        new_agent = torch.where((is_fwd & fwd_ok)[:, None],
                                torch.stack([fr, fc], 1), state.agent.long())
        new_facing = torch.where(
            op == S.OP_LEFT, t["turn_left"][f],
            torch.where(op == S.OP_RIGHT, t["turn_right"][f], f))

        # ---------------- Jump (novelty_wrappers.py:1360-1382) -------------
        # two cells ahead when that cell is in the map and air; the cell
        # between is not checked
        is_jump = op == S.OP_JUMP
        if HAS_JUMP:
            jr, jc = fr + t["deltas"][f, 0], fc + t["deltas"][f, 1]
            j_in = (jr >= 0) & (jr < H) & (jc >= 0) & (jc < H)
            jump_ok = j_in & (read_at(jr, jc) == 0)
            new_agent = torch.where((is_jump & jump_ok)[:, None],
                                    torch.stack([jr, jc], 1), new_agent)
        else:
            jump_ok = torch.zeros_like(is_jump)

        # ---------------- Break (+ axe / fence / crate folds) --------------
        is_break = op == S.OP_BREAK
        breakable = (front != 0) & ~t["unbreakable"][front]
        fence_blocked = torch.zeros_like(breakable)
        if sp.fence_restrict == S.FENCE_MEDIUM:
            # novelty_wrappers.py:933-941 — the agent's perpendicular sides
            # fence-free
            ns = (f == S.NORTH) | (f == S.SOUTH)
            side_a = torch.where(ns, read_at(r, c - 1), read_at(r - 1, c))
            side_b = torch.where(ns, read_at(r, c + 1), read_at(r + 1, c))
            fence_blocked = (side_a == sp.fence_id) | (side_b == sp.fence_id)
        elif sp.fence_restrict == S.FENCE_HARD:
            # novelty_wrappers.py:943-949 — the whole 3x3 around the target
            # fence-free
            for ddr in (-1, 0, 1):
                for ddc in (-1, 0, 1):
                    fence_blocked = fence_blocked | (
                        read_at(fr + ddr, fc + ddc) == sp.fence_id)
        if FENCE:
            # the fence itself is always breakable (novelty_wrappers.py:928-930)
            fence_blocked = fence_blocked & (front != sp.fence_id)
        break_ok = breakable & ~fence_blocked
        if sp.axe_mode != S.AXE_NONE:
            # novelty_wrappers.py:56,67 — the axe in the inventory AND
            # selected; +10 with it on any breakable, the reward stays -1
            # without it, and the cost discount applies only to a successful
            # axe break (:45-84)
            axe_sel = (inv[:, sp.axe_id] >= 1) & (state.selected == sp.axe_id)
            if sp.axe_mode == S.AXE_REQUIRED:
                break_ok = break_ok & axe_sel
            brk_reward = torch.where(axe_sel, full(sp.reward_intermediate),
                                     full(sp.reward_step))
            byield = torch.where(axe_sel & sp.axe_breakincrease, 2,
                                 1).to(torch.int64)
            brk_cost = torch.where(axe_sel & break_ok,
                                   full(sp.break_cost * sp.axe_cost_mult),
                                   full(sp.break_cost))
        else:
            axe_sel = torch.zeros_like(breakable)
            brk_reward = t["break_reward"][front]
            byield = t["break_yield"][front]
            brk_cost = full(sp.break_cost)
        # the crate grants its contents whenever Break targets it, before the
        # inner break resolves (novelty_wrappers.py:1085-1088)
        crate_add = is_break & (front == sp.crate_id) if sp.crate_id >= 0 \
            else None

        # ---------------- Chop (novelty_wrappers.py:1288-1307) -------------
        is_chop = op == S.OP_CHOP
        chop_ok = breakable

        # neighbors of the front cell (is_block_in_front_next_to,
        # pogostick_v1_env.py:391-411)
        adj = sp.place_adjacent_item
        next_to_tree = ((read_at(fr - 1, fc) == adj)
                        | (read_at(fr + 1, fc) == adj)
                        | (read_at(fr, fc - 1) == adj)
                        | (read_at(fr, fc + 1) == adj))

        # ---------------- Place (pogostick_v1_env.py:295-314) --------------
        # item-typed args index the inventory (clamped: other ops carry
        # recipe indices or 0 there, and their reads are masked out)
        arg_i = arg.clamp(0, I - 1)
        inv_arg = inv.gather(1, arg_i[:, None])[:, 0]
        is_place = op == S.OP_PLACE
        have_place = inv_arg >= 1
        place_ok = have_place & (front == 0)

        # ---------------- Extract rubber (pogostick_v1_env.py:315-331) -----
        is_exr = op == S.OP_EXTRACT_RUBBER
        exr_at_tap = front == sp.extract_source_item
        exr_ok = exr_at_tap & next_to_tree

        # ---------------- Extract string (bow_v0_env.py:293-304) -----------
        is_exs = op == S.OP_EXTRACT_STRING
        exs_ok = front == sp.extract_source_item

        # ---------------- Fused place+extract (v4:277-305, v5:291-319) -----
        is_fused = op == S.OP_FUSED_PLACE_EXTRACT
        if HAS_FUSED:
            taps_on_map = (m == tap_i).sum(dim=1)
            fused_place = ((taps_on_map == 0) & (inv[:, tap_i] >= 1)
                           & next_to_tree & (front == 0))
            fused_extract = (taps_on_map == 1) & next_to_tree & (front == tap_i)
        else:
            fused_place = fused_extract = torch.zeros_like(is_fused)

        # ---------------- Craft (pogostick_v1_env.py:413-474 + legacy) -----
        is_craft = op == S.OP_CRAFT
        craft_reward = full(sp.reward_step)
        if HAS_CRAFT:
            rec = arg.clamp(0, R - 1)
            need, rec_out = t["rin"][rec], t["rout"][rec]       # [B, I]
            have_all = (inv >= need).all(dim=1)
            multi = t["rmulti"][rec]
            at_table = front == sp.crafting_table_id
            if sp.craft_variant == S.CRAFT_MODERN:
                craft_missing = ~have_all
                craft_notable = have_all & multi & ~at_table
            elif sp.craft_variant == S.CRAFT_LEGACY_TABLE_FIRST:
                # novel_gridworld_v3_env.py:360-400: the table check first
                craft_notable = multi & ~at_table
                craft_missing = ~craft_notable & ~have_all
            else:
                # CRAFT_LEGACY_NO_TABLE (novel_gridworld_v2_env.py:295-325)
                craft_notable = torch.zeros_like(have_all)
                craft_missing = ~have_all
            craft_ok = ~craft_missing & ~craft_notable
            if sp.craft_nag == S.NAG_V2:
                # plank checked AFTER consumption (novel_gridworld_v2_env.py:306-323)
                plank_after = inv[:, plank_i] + rec_out[:, plank_i] \
                    - need[:, plank_i]
                nag = (rec == stick_r) & (plank_after < 8)
            elif sp.craft_nag == S.NAG_V4:
                # checked BEFORE consuming (novel_gridworld_v4_env.py:398-405)
                nag = (((rec == stick_r) & (inv[:, plank_i] < 8))
                       | ((rec == tap_r) & (inv[:, stick_i] < 8)))
            else:
                nag = torch.zeros_like(craft_ok)
            craft_reward = torch.where(
                craft_ok & ~nag, full(sp.craft_success_reward), craft_reward)
        else:
            rec = torch.zeros_like(arg)
            craft_missing = craft_notable = craft_ok = torch.zeros_like(is_craft)

        # ---------------- Select (pogostick_v1_env.py:338-347) -------------
        is_select = op == S.OP_SELECT
        sel_ok = inv_arg >= 1
        new_selected = torch.where(is_select & sel_ok, arg,
                                   state.selected.long())

        # ================= map write (all ops write the front cell) ========
        write_break = (is_break & break_ok) | (is_chop & chop_ok) \
            | (is_exs & exs_ok)
        write_place = (is_place & place_ok) | (is_fused & fused_place)
        front_new = torch.where(
            write_break, zero_i,
            torch.where(write_place,
                        torch.where(is_fused, torch.full_like(arg, tap_i), arg),
                        front))
        old = m.gather(1, front_idx[:, None])[:, 0].long()
        wr = (write_break | write_place) & front_in
        new_map = m.scatter(1, front_idx[:, None],
                            torch.where(wr, front_new, old)[:, None]
                            .to(m.dtype))

        # ================= inventory =======================================
        gain_break = torch.where(is_break & break_ok, byield,
                                 torch.where(is_chop & chop_ok, 2, zero_i))
        inv_delta = torch.zeros((B, I), dtype=torch.int64, device=dev)
        inv_delta.scatter_add_(1, front[:, None], gain_break[:, None])
        if crate_add is not None:
            inv_delta += t["crate"][None, :] * crate_add.long()[:, None]
        inv_delta.scatter_add_(1, arg_i[:, None],
                               -(is_place & place_ok).long()[:, None])
        if HAS_EXR:
            inv_delta[:, rubber_i] += torch.where(
                is_exr & exr_ok, sp.extract_amount, 0)
        if HAS_FUSED:
            inv_delta[:, rubber_i] += \
                (is_fused & (fused_place | fused_extract)).long()
            inv_delta[:, tap_i] -= (is_fused & fused_place).long()
        if HAS_EXS and sp.extract_yield_item >= 0 \
                and sp.extract_source_item >= 0:
            inv_delta[:, sp.extract_yield_item] += \
                (is_exs & exs_ok).long() * sp.extract_amount
        if HAS_CRAFT:
            inv_delta += (rec_out - need) * (is_craft & craft_ok).long()[:, None]
        new_inv = (inv.long() + inv_delta).to(torch.int32)

        # ================= reward / result / cost / message ================
        reward = full(sp.reward_step)
        reward = torch.where(is_break & break_ok, brk_reward, reward)
        reward = torch.where(is_chop & chop_ok, full(sp.reward_intermediate),
                             reward)
        reward = torch.where(is_place & place_ok & next_to_tree,
                             full(sp.reward_intermediate), reward)
        reward = torch.where(is_exr & exr_ok, full(sp.reward_intermediate),
                             reward)
        reward = torch.where(is_exs & exs_ok, full(sp.reward_intermediate),
                             reward)
        reward = torch.where(is_craft, craft_reward, reward)
        # fused place+extract (v4:291-303) — rewards 20 / 15
        reward = torch.where(is_fused & fused_place, full(20.0), reward)
        reward = torch.where(is_fused & fused_extract, full(15.0), reward)

        result = ~((is_fwd & ~fwd_ok) | (is_jump & ~jump_ok)
                   | (is_break & ~break_ok) | (is_chop & ~chop_ok)
                   | (is_place & ~place_ok) | (is_exr & ~exr_ok)
                   | (is_exs & ~exs_ok) | (is_craft & ~craft_ok)
                   | (is_select & ~sel_ok))

        msg = torch.zeros_like(op)
        msg_arg = torch.zeros_like(op)

        def set_msg(cond, code, marg=None):
            nonlocal msg, msg_arg
            msg = torch.where(cond, torch.full_like(msg, code), msg)
            if marg is not None:
                msg_arg = torch.where(cond, marg, msg_arg)

        set_msg((is_fwd & ~fwd_ok) | (is_jump & ~jump_ok),
                S.MSG_BLOCK_IN_PATH)
        set_msg(is_break & ~breakable, S.MSG_CANNOT_BREAK, front)
        if FENCE:
            set_msg(is_break & breakable & fence_blocked,
                    S.MSG_FENCE_RESTRICTION)
        if sp.axe_mode == S.AXE_REQUIRED:
            set_msg(is_break & breakable & ~fence_blocked & ~axe_sel,
                    S.MSG_NEED_AXE, torch.full_like(front, sp.axe_id))
        set_msg(is_chop & ~chop_ok, S.MSG_CANNOT_CHOP, front)
        set_msg(is_place & place_ok, S.MSG_TAP_PLACED)
        set_msg(is_place & have_place & (front != 0), S.MSG_BLOCK_EXISTS,
                front)
        set_msg(is_place & ~have_place, S.MSG_ITEM_NOT_FOUND)
        set_msg(is_exr & exr_at_tap & ~next_to_tree, S.MSG_NO_TREE_NEAR_TAP)
        set_msg(is_exr & ~exr_at_tap, S.MSG_NO_TAP)
        set_msg(is_exs & ~exs_ok, S.MSG_NO_WOOL)
        set_msg(is_craft & craft_missing, S.MSG_MISSING_ITEMS)
        set_msg(is_craft & craft_notable, S.MSG_NEED_TABLE)
        set_msg(is_craft & craft_ok, S.MSG_CRAFTED)
        msg_arg = torch.where(is_craft, rec, msg_arg)
        set_msg(is_select & ~sel_ok, S.MSG_ITEM_NOT_FOUND)

        # step costs
        cost = torch.where(result, t["cost_ok"][a], t["cost_fail"][a])
        if HAS_BREAK:
            cost = torch.where(is_break, brk_cost, cost)
        if HAS_CRAFT:
            craft_cost = torch.where(
                craft_ok, t["cc_ok"][rec],
                torch.where(craft_notable, t["cc_notable"][rec],
                            t["cc_missing"][rec]))
            cost = torch.where(is_craft, craft_cost, cost)

        # FenceRestriction tail override: every delegated break (breakable,
        # not fence-gated) reports result True, cost 3600, no message and
        # step_count += 2, even where the inner break failed
        # (novelty_wrappers.py:930,950-984); reward and writes are kept
        step_inc = 1
        if FENCE:
            fdel = is_break & breakable & ~fence_blocked
            result = result | fdel
            set_msg(fdel, S.MSG_NONE)
            cost = torch.where(fdel, full(sp.break_cost), cost)
            step_inc = torch.where(fdel, 2, 1).to(torch.int32)

        # ================= grab-entities (pogostick_v1_env.py:538-554) =====
        # every entity in the 3x3 around the agent's new cell moves to the
        # inventory
        if HAS_GRAB:
            for ddr in (-1, 0, 1):
                for ddc in (-1, 0, 1):
                    rr = new_agent[:, 0] + ddr
                    cc = new_agent[:, 1] + ddc
                    inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < H)
                    idx = torch.where(inb, rr * H + cc, zero_i)
                    v = new_map.gather(1, idx[:, None])[:, 0].long()
                    grab = inb & t["entity"][v]
                    new_inv = new_inv + torch.nn.functional.one_hot(
                        v, I).to(torch.int32) * grab.to(torch.int32)[:, None]
                    new_map.scatter_(1, idx[:, None], torch.where(
                        grab, zero_i, v)[:, None].to(new_map.dtype))

        # ================= goal (pogostick_v1_env.py:354-357) ==============
        if sp.goal_mode == S.GOAL_FRONT_ITEM:
            # the block in front AFTER the action
            # (novel_gridworld_v0_env.py:236-239)
            nf = new_facing
            goal_met = read_at(new_agent[:, 0] + t["deltas"][nf, 0],
                               new_agent[:, 1] + t["deltas"][nf, 1],
                               new_map) == sp.goal_front_item
        else:
            counts = t["goal"]
            active = counts > 0
            ge = new_inv >= counts
            if sp.goal_any:
                goal_met = (ge & active).any(dim=1)
            else:
                goal_met = (ge | ~active).all(dim=1)
        reward = torch.where(goal_met, full(sp.reward_done), reward)
        done = goal_met
        if HAS_DEADEND:
            # dead-end termination (novel_gridworld_v2_env.py:263-266): no
            # dead-end recipe is craftable from the post-step inventory
            craftable = (new_inv[:, None, :] >= t["rin"][None]).all(dim=2)
            deadend = ~(craftable & t["deadend"][None]).any(dim=1)
            done = done | (~goal_met & deadend)
        if sp.fire_item >= 0:
            # fire-wall death, a post-everything override
            # (novelty_wrappers.py:1171-1189)
            nr, nc = new_agent[:, 0], new_agent[:, 1]
            on_fire = ((read_at(nr - 1, nc, new_map) == sp.fire_item)
                       | (read_at(nr + 1, nc, new_map) == sp.fire_item)
                       | (read_at(nr, nc - 1, new_map) == sp.fire_item)
                       | (read_at(nr, nc + 1, new_map) == sp.fire_item))
            reward = torch.where(on_fire, full(-(int(sp.reward_done) // 2)),
                                 reward)
            done = done | on_fire
            set_msg(on_fire, S.MSG_DIED_FIREWALL)

        i32 = torch.int32
        new_state = EnvState(
            map=new_map,
            agent=new_agent.to(i32),
            facing=new_facing.to(i32),
            inventory=new_inv,
            selected=new_selected.to(i32),
            step_count=state.step_count + step_inc,
            last_action=a.to(i32),
            last_reward=reward,
            last_cost=cost,
            last_done=done,
        )
        obs = get_obs(new_state) if with_obs else None
        info = StepInfo(result=result, step_cost=cost, msg_code=msg.to(i32),
                        msg_arg=msg_arg.to(i32))
        return new_state, obs, reward, done, info

    step.get_obs = get_obs
    return step
