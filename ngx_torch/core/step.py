"""The batched plain step — the port of ``ngx/core/step.py:57-653`` for the op
families :func:`ngx_torch.core.spec.check_supported` admits.

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
from ..ops.rays import inventory_keep, make_lidar_front


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
            deltas=S.FACING_DELTAS, turn_left=S.TURN_LEFT,
            turn_right=S.TURN_RIGHT,
            keep=np.asarray(inventory_keep(sp), np.int64),
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
    ``OBS_DICT``, ``int32[B, OBS_DIM]`` for ``OBS_LIDAR_FRONT``."""
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
    rubber_i = sp.items.index("rubber") if "rubber" in sp.items else 0
    f32 = torch.float32

    lidar_fn = make_lidar_front(sp) if sp.obs_mode == S.OBS_LIDAR_FRONT \
        else None

    def get_obs(state: EnvState):
        if sp.obs_mode == S.OBS_DICT:
            # pogostick_v1_env.py:214-228 — raw-state dict
            return {
                "map": state.map.reshape(-1, H, H),
                "agent_location": state.agent,
                "agent_facing_id": state.facing,
                "inventory_items_quantity": state.inventory,
            }
        # observation_wrappers.py:70-80 — lidar + inventory over name-sorted
        # items minus unbreakables
        keep = tables.on(state.device)["keep"]
        lidar = lidar_fn(state.map, state.agent, state.facing)
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

        def read_at(rr, cc):
            """m[rr, cc], 0 (air) when out of range."""
            inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < H)
            idx = torch.where(inb, rr * H + cc, zero_i)
            return torch.where(inb, m.gather(1, idx[:, None])[:, 0].long(),
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

        # ---------------- Break (pogostick_v1_env.py:280-294) -------------
        is_break = op == S.OP_BREAK
        breakable = (front != 0) & ~t["unbreakable"][front]
        break_ok = breakable
        brk_reward = t["break_reward"][front]
        byield = t["break_yield"][front]

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

        # ---------------- Craft (pogostick_v1_env.py:413-474) --------------
        is_craft = op == S.OP_CRAFT
        if HAS_CRAFT:
            rec = arg.clamp(0, R - 1)
            need, rec_out = t["rin"][rec], t["rout"][rec]       # [B, I]
            have_all = (inv >= need).all(dim=1)
            at_table = front == sp.crafting_table_id
            craft_missing = ~have_all
            craft_notable = have_all & t["rmulti"][rec] & ~at_table
            craft_ok = ~craft_missing & ~craft_notable
        else:
            rec = torch.zeros_like(arg)
            craft_missing = craft_notable = craft_ok = torch.zeros_like(is_craft)

        # ---------------- Select (pogostick_v1_env.py:338-347) -------------
        is_select = op == S.OP_SELECT
        sel_ok = inv_arg >= 1
        new_selected = torch.where(is_select & sel_ok, arg,
                                   state.selected.long())

        # ================= map write (all ops write the front cell) ========
        write_break = (is_break & break_ok) | (is_exs & exs_ok)
        write_place = is_place & place_ok
        front_new = torch.where(write_break, zero_i,
                                torch.where(write_place, arg, front))
        old = m.gather(1, front_idx[:, None])[:, 0].long()
        wr = (write_break | write_place) & front_in
        new_map = m.scatter(1, front_idx[:, None],
                            torch.where(wr, front_new, old)[:, None]
                            .to(m.dtype))

        # ================= inventory =======================================
        gain_break = torch.where(is_break & break_ok, byield, zero_i)
        inv_delta = torch.zeros((B, I), dtype=torch.int64, device=dev)
        inv_delta.scatter_add_(1, front[:, None], gain_break[:, None])
        inv_delta.scatter_add_(1, arg_i[:, None],
                               -(is_place & place_ok).long()[:, None])
        if HAS_EXR:
            inv_delta[:, rubber_i] += torch.where(
                is_exr & exr_ok, sp.extract_amount, 0)
        if HAS_EXS and sp.extract_yield_item >= 0 \
                and sp.extract_source_item >= 0:
            inv_delta[:, sp.extract_yield_item] += \
                (is_exs & exs_ok).long() * sp.extract_amount
        if HAS_CRAFT:
            inv_delta += (rec_out - need) * (is_craft & craft_ok).long()[:, None]
        new_inv = (inv.long() + inv_delta).to(torch.int32)

        # ================= reward / result / cost / message ================
        def full(v, dtype=f32):
            return torch.full((B,), v, dtype=dtype, device=dev)

        reward = full(sp.reward_step)
        reward = torch.where(is_break & break_ok, brk_reward, reward)
        reward = torch.where(is_place & place_ok & next_to_tree,
                             full(sp.reward_intermediate), reward)
        reward = torch.where(is_exr & exr_ok, full(sp.reward_intermediate),
                             reward)
        reward = torch.where(is_exs & exs_ok, full(sp.reward_intermediate),
                             reward)
        craft_reward = torch.where(craft_ok, full(sp.craft_success_reward),
                                   full(sp.reward_step))
        reward = torch.where(is_craft, craft_reward, reward)

        result = ~((is_fwd & ~fwd_ok) | (is_break & ~break_ok)
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

        set_msg(is_fwd & ~fwd_ok, S.MSG_BLOCK_IN_PATH)
        set_msg(is_break & ~breakable, S.MSG_CANNOT_BREAK, front)
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
            cost = torch.where(is_break, full(sp.break_cost), cost)
        if HAS_CRAFT:
            craft_cost = torch.where(
                craft_ok, t["cc_ok"][rec],
                torch.where(craft_notable, t["cc_notable"][rec],
                            t["cc_missing"][rec]))
            cost = torch.where(is_craft, craft_cost, cost)

        # ================= inventory goal (pogostick_v1_env.py:354-357) ====
        counts = t["goal"]
        active = counts > 0
        ge = new_inv >= counts
        if sp.goal_any:
            goal_met = (ge & active).any(dim=1)
        else:
            goal_met = (ge | ~active).all(dim=1)
        reward = torch.where(goal_met, full(sp.reward_done), reward)
        done = goal_met

        i32 = torch.int32
        new_state = EnvState(
            map=new_map,
            agent=new_agent.to(i32),
            facing=new_facing.to(i32),
            inventory=new_inv,
            selected=new_selected.to(i32),
            step_count=state.step_count + 1,
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
